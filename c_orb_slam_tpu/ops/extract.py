"""Full ORB extraction: pyramid -> FAST -> spatial top-k -> orientation ->
rBRIEF, producing a fixed-capacity keypoint batch.

Reference: src/ORBextractor.cc operator() (1043-1105). The reference
balances keypoints with a recursive quadtree (DistributeOctTree,
ORBextractor.cc:539-763) — inherently pointer/recursion shaped. The
array-program equivalent with the same intent (spatial uniformity + response
ranking): per-cell top-k on the NMS'd score map, then a global top-N per
level; all shapes static, everything one fused XLA program per level.

Output coordinates are level-0 pixels; `octave` records the source level
(scale handling identical to reference Frame usage).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from c_orb_slam_tpu.config import OrbConfig
from c_orb_slam_tpu.ops import brief, fast, orient, pyramid


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint batch (SoA). Invalid slots: valid=False."""

    xy: jnp.ndarray  # (N, 2) float32, level-0 pixel coords (x, y)
    response: jnp.ndarray  # (N,) float32 FAST score
    octave: jnp.ndarray  # (N,) int32 pyramid level
    angle: jnp.ndarray  # (N,) float32 radians
    desc: jnp.ndarray  # (N, 8) uint32 packed 256-bit
    valid: jnp.ndarray  # (N,) bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]

    def count(self) -> jnp.ndarray:
        return jnp.sum(self.valid.astype(jnp.int32))


def select_keypoints(
    score: jnp.ndarray, budget: int, cell: int, k_per_cell: int = 4
):
    """Spatially-balanced top-`budget` selection from an NMS'd score map.

    Returns (yx (budget, 2) int32, response (budget,), valid (budget,)).
    """
    h, w = score.shape
    ph, pw = (-h) % cell, (-w) % cell
    padded = jnp.pad(score, ((0, ph), (0, pw)))
    ncy, ncx = (h + ph) // cell, (w + pw) // cell
    grid = padded.reshape(ncy, cell, ncx, cell).transpose(0, 2, 1, 3)
    grid = grid.reshape(ncy * ncx, cell * cell)

    vals, idx = jax.lax.top_k(grid, k_per_cell)  # (ncells, k)
    cell_ids = jnp.arange(ncy * ncx, dtype=jnp.int32)
    cy = (cell_ids // ncx)[:, None] * cell + (idx // cell)
    cx = (cell_ids % ncx)[:, None] * cell + (idx % cell)

    flat_vals = vals.reshape(-1)
    flat_y = cy.reshape(-1)
    flat_x = cx.reshape(-1)
    if flat_vals.shape[0] < budget:  # tiny images: pad the candidate pool
        pad = budget - flat_vals.shape[0]
        flat_vals = jnp.pad(flat_vals, (0, pad))
        flat_y = jnp.pad(flat_y, (0, pad))
        flat_x = jnp.pad(flat_x, (0, pad))

    top_vals, sel = jax.lax.top_k(flat_vals, budget)
    y = flat_y[sel]
    x = flat_x[sel]
    valid = top_vals > 0.0
    return jnp.stack([y, x], axis=-1), top_vals, valid


def subpixel_refine(score: jnp.ndarray, yx: jnp.ndarray) -> jnp.ndarray:
    """Parabolic subpixel refinement of NMS maxima on the score map.

    Goes beyond the reference (OpenCV FAST returns integer corners): the
    quadratic fit over the 3x3 score neighborhood cuts the +-0.5px
    quantization that otherwise dominates triangulation error.
    Returns (N, 2) float offsets (dy, dx) in [-0.5, 0.5].
    """
    from c_orb_slam_tpu.ops import orient

    patches = orient.gather_patches(score, yx, 1)  # (N, 3, 3)
    c = patches[:, 1, 1]

    def axis_offset(m, p):
        denom = 2.0 * c - m - p
        off = 0.5 * (p - m) / jnp.where(jnp.abs(denom) < 1e-6, 1e-6, denom)
        return jnp.clip(off, -0.5, 0.5)

    dy = axis_offset(patches[:, 0, 1], patches[:, 2, 1])
    dx = axis_offset(patches[:, 1, 0], patches[:, 1, 2])
    return jnp.stack([dy, dx], axis=-1)


def extract_orb(image: jnp.ndarray, cfg: OrbConfig, seed: int = 7) -> Keypoints:
    """Extract ORB keypoints + descriptors from a grayscale image.

    image: (H, W) float32 in [0, 255]. Jit-friendly: the level loop is a
    static Python unroll; every level runs detection, selection,
    orientation, blur and description as fused array ops.
    """
    levels = pyramid.build_pyramid(image, cfg.n_levels, cfg.scale_factor)
    budgets = cfg.features_per_level()
    scales = cfg.scale_factors()

    parts = []
    for lvl, img in enumerate(levels):
        score = fast.detect(
            img,
            float(cfg.ini_th_fast),
            float(cfg.min_th_fast),
            border=cfg.edge_threshold - 3,
            cell=cfg.cell_size,
        )
        yx, resp, valid = select_keypoints(score, budgets[lvl], cfg.cell_size)
        sub = subpixel_refine(score, yx)
        ang = orient.ic_angle(img, yx, cfg.half_patch)
        blurred = pyramid.gaussian_blur(img)
        desc = brief.compute_descriptors(blurred, yx, ang, seed)
        yx_f = yx.astype(jnp.float32) + sub
        xy0 = yx_f[:, ::-1] * scales[lvl]  # (x, y) level-0
        parts.append(
            Keypoints(
                xy=xy0,
                response=resp,
                octave=jnp.full((budgets[lvl],), lvl, dtype=jnp.int32),
                angle=ang,
                desc=desc,
                valid=valid,
            )
        )

    return Keypoints(
        xy=jnp.concatenate([p.xy for p in parts]),
        response=jnp.concatenate([p.response for p in parts]),
        octave=jnp.concatenate([p.octave for p in parts]),
        angle=jnp.concatenate([p.angle for p in parts]),
        desc=jnp.concatenate([p.desc for p in parts]),
        valid=jnp.concatenate([p.valid for p in parts]),
    )
