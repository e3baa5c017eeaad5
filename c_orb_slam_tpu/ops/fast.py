"""FAST-9/16 corner detection as a whole-image batched kernel.

Reference: src/ORBextractor.cc:765-853 runs OpenCV's cv::FAST per 30x30
cell with a threshold fallback 20 -> 7 (ORBextractor.cc:809-835), then
balances keypoints spatially with a quadtree (DistributeOctTree,
ORBextractor.cc:539-763).

Array-program design: no per-cell loops — one pass computes the segment test
for every pixel at once (16 shifted copies of the image, bit-packed arc test as
elementwise ops), a second cheap pass blends the high/low thresholds per cell
(a cell uses the low threshold only if it has no high-threshold corner), 3x3
NMS via reduce_window, and spatial balancing becomes per-cell top-k + global
top-N on the score map (ops/extract.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Bresenham circle of radius 3 — the 16 (dy, dx) offsets of the FAST segment
# test, clockwise from 12 o'clock.
CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC_LEN = 9  # contiguous run required for FAST-9


def _circle_stack(image: jnp.ndarray) -> jnp.ndarray:
    """(16, H, W): the circle neighbors of every pixel (edge-padded)."""
    padded = jnp.pad(image, 3, mode="edge")
    h, w = image.shape
    views = [
        jax.lax.dynamic_slice(padded, (3 + int(dy), 3 + int(dx)), (h, w))
        for dy, dx in CIRCLE
    ]
    return jnp.stack(views, axis=0)


def _arc_mask_any(bits: jnp.ndarray) -> jnp.ndarray:
    """bits: (H, W) uint32 with 16 circle flags in the low bits.

    True where any 9 contiguous (circular) bits are all set.
    """
    wrapped = bits | (bits << 16)  # circular: duplicate into high half
    full = jnp.uint32((1 << ARC_LEN) - 1)
    out = jnp.zeros(bits.shape, dtype=bool)
    for k in range(16):
        out = out | (((wrapped >> k) & full) == full)
    return out


def _segment_test(diff: jnp.ndarray, threshold: float):
    """Corner mask + score from a precomputed circle-difference stack.

    diff: (16, H, W). Returns (corner (H,W) bool, score (H,W) float32).
    The score is the sum of |circle - center| excess over threshold on the
    dominant side — the same ranking OpenCV's FAST NMS uses up to
    normalization."""
    brighter = diff > threshold
    darker = diff < -threshold

    shifts = jnp.arange(16, dtype=jnp.uint32)[:, None, None]
    bright_bits = jnp.sum(
        brighter.astype(jnp.uint32) << shifts, axis=0, dtype=jnp.uint32
    )
    dark_bits = jnp.sum(
        darker.astype(jnp.uint32) << shifts, axis=0, dtype=jnp.uint32
    )
    corner = _arc_mask_any(bright_bits) | _arc_mask_any(dark_bits)

    df = diff.astype(jnp.float32)
    score_b = jnp.sum(jnp.where(brighter, df - threshold, 0.0), axis=0)
    score_d = jnp.sum(jnp.where(darker, -df - threshold, 0.0), axis=0)
    score = jnp.maximum(score_b, score_d)
    return corner, jnp.where(corner, score, 0.0)


def fast_response(
    image: jnp.ndarray, threshold: float
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Segment test + score for every pixel (single-threshold entry)."""
    circle = _circle_stack(image)  # (16, H, W)
    diff = circle - image[None, :, :]
    return _segment_test(diff, threshold)


def _cell_any(mask: jnp.ndarray, cell: int) -> jnp.ndarray:
    """Per-pixel: does this pixel's cell contain any True? (H, W) bool."""
    h, w = mask.shape
    ph = (-h) % cell
    pw = (-w) % cell
    m = jnp.pad(mask, ((0, ph), (0, pw)))
    grid = m.reshape((h + ph) // cell, cell, (w + pw) // cell, cell)
    cell_any = jnp.any(grid, axis=(1, 3))
    up = jnp.repeat(jnp.repeat(cell_any, cell, axis=0), cell, axis=1)
    return up[:h, :w]


def nms3(score: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-maximum suppression: keep strict local maxima."""
    mx = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where((score >= mx) & (score > 0), score, 0.0)


def detect(
    image: jnp.ndarray,
    ini_threshold: float,
    min_threshold: float,
    border: int,
    cell: int = 30,
) -> jnp.ndarray:
    """Full FAST stage for one pyramid level -> NMS'd score map (H, W).

    Threshold-fallback semantics (reference: ORBextractor.cc:809-835): cells
    with at least one high-threshold corner keep only those; empty cells
    fall back to the low threshold.
    """
    # ONE circle-difference stack shared by both threshold passes, held in
    # bfloat16 so the (16, H, W) stack — the bandwidth hot spot of the
    # whole detector — moves at half cost. Level-0 pixels are 0..255
    # integers whose differences are exact in bf16; levels >= 1 are
    # bilinear-resized floats (pyramid.py), where bf16 ulp of 1.0 in
    # [128, 256) can quantize near-threshold diffs by up to ~1 intensity
    # unit (~0.4% of range) — flipping only marginal corners and NMS score
    # ties, measured benign on the e2e tracking suites.
    circle = _circle_stack(image.astype(jnp.bfloat16))
    diff = circle - image.astype(jnp.bfloat16)[None, :, :]
    corner_hi, score_hi = _segment_test(diff, ini_threshold)
    corner_lo, score_lo = _segment_test(diff, min_threshold)
    has_hi = _cell_any(corner_hi, cell)
    score = jnp.where(has_hi, score_hi, score_lo)

    # Exclude the EDGE_THRESHOLD border (reference: ORBextractor.cc:74,774).
    h, w = image.shape
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    inb = (
        (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    )
    return nms3(jnp.where(inb, score, 0.0))
