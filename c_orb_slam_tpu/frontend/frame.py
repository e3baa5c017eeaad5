"""Frame construction: extraction + undistortion (+ stereo depth).

Reference: src/Frame.cc — the three constructors (:61 stereo, :119 RGBD,
:174 mono) run ORB extraction (two CPU threads for stereo L/R,
Frame.cc:78-81), keypoint undistortion (:404), stereo matching (:466) and
grid binning (:230).

Array-program design: one jitted program per sensor type; the L/R "thread pair"
becomes a batched 2-image extraction; the 64x48 search grid is not needed
(matching uses dense masked distance matrices, ops/match.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from c_orb_slam_tpu.config import SlamConfig
from c_orb_slam_tpu.geometry import camera
from c_orb_slam_tpu.ops import extract, hamming, match, orient, pyramid


class FrameData(NamedTuple):
    """Per-frame fixed-capacity data (device arrays)."""

    xy: jnp.ndarray  # (N, 2) undistorted level-0 coords
    xy_raw: jnp.ndarray  # (N, 2) raw (distorted) coords
    octave: jnp.ndarray  # (N,)
    angle: jnp.ndarray  # (N,)
    desc: jnp.ndarray  # (N, 8) uint32
    valid: jnp.ndarray  # (N,)
    ur: jnp.ndarray  # (N,) right-image u coordinate (-1 = mono/no match)
    depth: jnp.ndarray  # (N,) depth (-1 = none)


@functools.partial(jax.jit, static_argnames=("cfg",))
def build_mono(image: jnp.ndarray, cfg: SlamConfig) -> FrameData:
    kps = extract.extract_orb(image, cfg.orb, cfg.vocabulary.seed)
    K = camera.intrinsics_array(cfg.camera)
    dist = camera.distortion_array(cfg.camera)
    xy_u = camera.undistort_points(kps.xy, K, dist)
    n = kps.xy.shape[0]
    return FrameData(
        xy=xy_u,
        xy_raw=kps.xy,
        octave=kps.octave,
        angle=kps.angle,
        desc=kps.desc,
        valid=kps.valid,
        ur=jnp.full((n,), -1.0, jnp.float32),
        depth=jnp.full((n,), -1.0, jnp.float32),
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def build_rgbd(
    image: jnp.ndarray, depth_map: jnp.ndarray, cfg: SlamConfig
) -> FrameData:
    """RGB-D: read depth at keypoint locations, synthesize the virtual
    right coordinate ur = u - bf/d (reference: Frame.cc:643-664)."""
    f = build_mono(image, cfg)
    yx = jnp.stack(
        [
            jnp.clip(jnp.round(f.xy_raw[:, 1]).astype(jnp.int32), 0, depth_map.shape[0] - 1),
            jnp.clip(jnp.round(f.xy_raw[:, 0]).astype(jnp.int32), 0, depth_map.shape[1] - 1),
        ],
        axis=1,
    )
    d = depth_map[yx[:, 0], yx[:, 1]] * (1.0 / cfg.tracking.depth_map_factor)
    has = d > 0
    ur = jnp.where(has, f.xy[:, 0] - cfg.camera.bf / jnp.maximum(d, 1e-6), -1.0)
    return f._replace(depth=jnp.where(has, d, -1.0), ur=ur)


def _stereo_subpixel(
    left: jnp.ndarray,
    right: jnp.ndarray,
    cfg: SlamConfig,
    xy_raw: jnp.ndarray,
    octave: jnp.ndarray,
    ur: jnp.ndarray,
    has: jnp.ndarray,
):
    """SAD parabola refinement of the matched right coordinate at each
    keypoint's pyramid level (reference: Frame.cc:552-618): an 11x11
    center-normalized window slides +-5 px in the scaled right image; the
    quadratic through the best three SADs gives the subpixel correction.
    Returns (refined ur, keep mask, best SAD per keypoint)."""
    W = 5  # reference w=5 (Frame.cc:554)
    n_levels = cfg.orb.n_levels
    sfs = cfg.orb.scale_factors()
    levels_l = pyramid.build_pyramid(left, n_levels, cfg.orb.scale_factor)
    levels_r = pyramid.build_pyramid(right, n_levels, cfg.orb.scale_factor)

    ur_out = ur
    keep = jnp.zeros_like(has)
    sad_out = jnp.full(ur.shape, jnp.inf, jnp.float32)
    for lvl in range(n_levels):
        il, irm = levels_l[lvl], levels_r[lvl]
        inv = 1.0 / sfs[lvl]
        uL = jnp.round(xy_raw[:, 0] * inv).astype(jnp.int32)
        vL = jnp.round(xy_raw[:, 1] * inv).astype(jnp.int32)
        uR0 = jnp.round(ur * inv).astype(jnp.int32)
        pl = orient.gather_patches(il, jnp.stack([vL, uL], 1), W)  # (N,11,11)
        pr = orient.gather_patches(irm, jnp.stack([vL, uR0], 1), 2 * W)
        pr = pr[:, W : 3 * W + 1, :]  # (N, 11, 21)
        pl_n = pl - pl[:, W : W + 1, W : W + 1]
        sads = []
        for inc in range(2 * W + 1):
            win = jax.lax.slice_in_dim(pr, inc, inc + 2 * W + 1, axis=2)
            win_n = win - win[:, W : W + 1, W : W + 1]
            sads.append(jnp.sum(jnp.abs(pl_n - win_n), axis=(1, 2)))
        D = jnp.stack(sads, axis=1)  # (N, 11)
        bi = jnp.argmin(D, axis=1).astype(jnp.int32)
        interior = (bi > 0) & (bi < 2 * W)
        bs = jnp.clip(bi, 1, 2 * W - 1)
        d1 = jnp.take_along_axis(D, (bs - 1)[:, None], 1)[:, 0]
        d2 = jnp.take_along_axis(D, bs[:, None], 1)[:, 0]
        d3 = jnp.take_along_axis(D, (bs + 1)[:, None], 1)[:, 0]
        denom = 2.0 * (d1 + d3 - 2.0 * d2)
        delta = (d1 - d3) / jnp.where(jnp.abs(denom) < 1e-6, 1e-6, denom)
        ok_lvl = interior & (jnp.abs(delta) <= 1.0)
        ur_lvl = sfs[lvl] * (
            uR0.astype(jnp.float32) + (bi - W).astype(jnp.float32) + delta
        )
        sel = (octave == lvl) & has
        ur_out = jnp.where(sel & ok_lvl, ur_lvl, ur_out)
        keep = keep | (sel & ok_lvl)
        sad_out = jnp.where(sel & ok_lvl, d2, sad_out)
    return ur_out, keep, sad_out


@functools.partial(jax.jit, static_argnames=("cfg",))
def build_stereo(
    left: jnp.ndarray, right: jnp.ndarray, cfg: SlamConfig
) -> FrameData:
    """Stereo: extract on both images, row-banded Hamming match, SAD
    subpixel disparity -> depth (reference: Frame.cc:466-640
    ComputeStereoMatches).

    The reference's per-row candidate tables become one masked (L, R)
    distance matrix with a row-band + disparity window mask; the
    per-keypoint sliding-SAD parabola refinement (:552-618) and the
    median-SAD outlier trim (:626-639) run batched over all matches.
    """
    # Both extractions as ONE batch-2 vmapped program: the per-level
    # pyramid/FAST/BRIEF kernels run once with a leading batch axis
    # instead of twice back-to-back (the reference uses two threads,
    # Frame.cc:78-81; the array-program equivalent is batching, not threading).
    kb = jax.vmap(
        lambda im: extract.extract_orb(im, cfg.orb, cfg.vocabulary.seed)
    )(jnp.stack([left, right]))
    kl = jax.tree.map(lambda x: x[0], kb)
    kr = jax.tree.map(lambda x: x[1], kb)
    K = camera.intrinsics_array(cfg.camera)
    dist = camera.distortion_array(cfg.camera)
    # Rectified stereo: keypoints used as-is (reference skips undistortion
    # for stereo, Frame.cc:407-411 assumes rectified input).
    xy_u = kl.xy

    # Row band: |vL - vR| <= 2 * scale(octave); disparity in (minD, maxD].
    sf = jnp.asarray(cfg.orb.scale_factors(), jnp.float32)
    r_band = 2.0 * sf[kl.octave]
    dv = jnp.abs(kl.xy[:, 1:2] - kr.xy[None, :, 1])
    band_ok = dv <= r_band[:, None]
    disp = kl.xy[:, 0:1] - kr.xy[None, :, 0]
    # Disparity bounds: minZ = baseline -> maxD = fx (reference:
    # Frame.cc:470-473).
    disp_ok = (disp > 0.0) & (disp <= cfg.camera.fx)
    oct_ok = jnp.abs(kl.octave[:, None] - kr.octave[None, :]) <= 1
    mask = band_ok & disp_ok & oct_ok

    m = match.match(
        kl.desc, kr.desc, kl.valid, kr.valid, pair_mask=mask,
        max_dist=cfg.matcher.th_high, nn_ratio=1.0, unique_targets=False,
    )
    ur0 = jnp.where(m.valid, kr.xy[m.idx, 0], -1.0)
    ur, keep, sad = _stereo_subpixel(
        left, right, cfg, kl.xy, kl.octave, ur0, m.valid
    )
    good = m.valid & keep
    # Median-SAD outlier trim: drop matches with SAD >= 1.5*1.4*median
    # (reference: Frame.cc:626-639 sorts vDistIdx and erases the tail).
    val = jnp.where(good, sad, jnp.inf)
    srt = jnp.sort(val)
    cnt = jnp.sum(good.astype(jnp.int32))
    med = srt[jnp.maximum((cnt - 1) // 2, 0)]
    good = good & (sad < 1.5 * 1.4 * jnp.maximum(med, 1e-6))

    disparity = jnp.maximum(xy_u[:, 0] - ur, 0.01)
    depth = jnp.where(good, cfg.camera.bf / disparity, -1.0)
    good = good & (depth > 0)
    return FrameData(
        xy=xy_u,
        xy_raw=kl.xy,
        octave=kl.octave,
        angle=kl.angle,
        desc=kl.desc,
        valid=kl.valid,
        ur=jnp.where(good, ur, -1.0),
        depth=jnp.where(good, depth, -1.0),
    )
