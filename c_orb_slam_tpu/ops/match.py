"""Batched descriptor matching — the array-program replacement for ORBmatcher.

The reference implements seven hand-specialized correspondence searches,
each a nest of per-feature loops over grid cells or BoW nodes
(reference: src/ORBmatcher.cc: SearchByProjection x4, SearchByBoW x2,
SearchForInitialization, SearchForTriangulation, Fuse x2, SearchBySim3).

Here they all reduce to one primitive: a masked (Q, T) Hamming distance
matrix + best/second-best reduction, where the mask encodes whatever
gating the variant needs (search window, octave range, epipolar band,
already-matched exclusion). XLA fuses the gating masks, the distance
product and the top-2 reductions; a dense masked matrix replaces
pointer-chasing cell lookups.

Rotation-consistency filtering (reference: ORBmatcher.cc:1601-1642
ComputeThreeMaxima) is a 30-bin histogram vote, batched.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from c_orb_slam_tpu.ops import hamming

TWO_PI = 6.283185307179586


class Matches(NamedTuple):
    """Per-query match result (fixed capacity = number of queries)."""

    idx: jnp.ndarray  # (Q,) int32 index into targets, -1 semantics via valid
    dist: jnp.ndarray  # (Q,) int32 Hamming distance
    valid: jnp.ndarray  # (Q,) bool

    def count(self) -> jnp.ndarray:
        return jnp.sum(self.valid.astype(jnp.int32))


def match(
    desc_q: jnp.ndarray,
    desc_t: jnp.ndarray,
    valid_q: jnp.ndarray | None = None,
    valid_t: jnp.ndarray | None = None,
    pair_mask: jnp.ndarray | None = None,
    max_dist: int = 100,
    nn_ratio: float = 1.0,
    unique_targets: bool = True,
    ratio_octave_t: jnp.ndarray | None = None,
) -> Matches:
    """Best-match per query with distance threshold + NN-ratio test.

    unique_targets resolves target collisions by keeping the lowest
    distance (the reference achieves this with overwrite-if-better loops,
    e.g. ORBmatcher.cc:1445-1459).

    ratio_octave_t: when given (target octaves), the NN-ratio test only
    rejects when best and second-best lie in the SAME octave — the
    reference's projection search does exactly this
    (ORBmatcher.cc:115-121): a runner-up at another scale is usually the
    same physical corner in a different pyramid level, not an ambiguity.
    """
    d = hamming.masked_distance_matrix(desc_q, desc_t, valid_q, valid_t, pair_mask)
    best, idx, second = hamming.best_two(d, axis=1)
    ok = best <= max_dist
    if nn_ratio < 1.0:
        ratio_fail = ~(
            best.astype(jnp.float32) < nn_ratio * second.astype(jnp.float32)
        )
        if ratio_octave_t is not None:
            t = jnp.arange(d.shape[1], dtype=jnp.int32)
            d2 = jnp.where(t[None, :] == idx[:, None], jnp.int32(1 << 20), d)
            idx2 = jnp.argmin(d2, axis=1).astype(jnp.int32)
            same_oct = ratio_octave_t[idx] == ratio_octave_t[idx2]
            ratio_fail = ratio_fail & same_oct
        ok = ok & ~ratio_fail
    if unique_targets:
        ok = ok & _is_target_winner(idx, best, ok, d.shape[1])
    return Matches(idx=idx, dist=best, valid=ok)


def _is_target_winner(
    idx: jnp.ndarray, dist: jnp.ndarray, ok: jnp.ndarray, n_targets: int
) -> jnp.ndarray:
    """True for queries that win their claimed target (min distance, ties
    broken by lowest query index)."""
    big = jnp.int32(1 << 20)
    q = jnp.arange(idx.shape[0], dtype=jnp.int32)
    key = jnp.where(ok, dist * jnp.int32(4096) + q, big)
    per_target_best = jnp.full((n_targets,), big, dtype=jnp.int32)
    per_target_best = per_target_best.at[idx].min(key, mode="drop")
    return ok & (per_target_best[idx] == key)


def rotation_consistency(
    angle_q: jnp.ndarray,
    angle_t_matched: jnp.ndarray,
    valid: jnp.ndarray,
    histo_length: int = 30,
    keep_bins: int = 3,
) -> jnp.ndarray:
    """Keep only matches whose q-t angle difference falls in the top-k
    histogram bins (reference: ORBmatcher.cc:1601-1642)."""
    rot = (angle_q - angle_t_matched) % TWO_PI
    bins = jnp.floor(rot / TWO_PI * histo_length).astype(jnp.int32) % histo_length
    counts = jnp.zeros((histo_length,), jnp.int32).at[bins].add(
        valid.astype(jnp.int32)
    )
    _, top = jax.lax.top_k(counts, keep_bins)
    in_top = jnp.any(bins[:, None] == top[None, :], axis=1)
    return valid & in_top


def window_mask(
    centers: jnp.ndarray,
    radii: jnp.ndarray,
    xy_t: jnp.ndarray,
) -> jnp.ndarray:
    """(Q, T) mask: target keypoint within per-query search radius.

    Replaces Frame::GetFeaturesInArea grid lookups (reference:
    src/Frame.cc:328-366) with a dense window test.
    """
    d = centers[:, None, :] - xy_t[None, :, :]
    return jnp.maximum(jnp.abs(d[..., 0]), jnp.abs(d[..., 1])) <= radii[:, None]


def octave_mask(
    octave_t: jnp.ndarray, lo: jnp.ndarray, hi: jnp.ndarray
) -> jnp.ndarray:
    """(Q, T) mask: target octave within [lo, hi] per query (reference
    scale-gating, e.g. ORBmatcher.cc:91-96,1385-1390)."""
    o = octave_t[None, :]
    return (o >= lo[:, None]) & (o <= hi[:, None])


def epipolar_mask(
    F12: jnp.ndarray,
    xy1: jnp.ndarray,
    xy2: jnp.ndarray,
    level_sigma2_2: jnp.ndarray,
    octave2: jnp.ndarray,
    thresh_chi2: float = 3.84,
) -> jnp.ndarray:
    """(N1, N2) mask: kp2 close to the epipolar line of kp1 under F12.

    Reference: ORBmatcher.cc:140-157 CheckDistEpipolarLine (point-line
    distance chi2 < 3.84 * sigma2 at kp2's octave).
    """
    ones = jnp.ones((xy1.shape[0], 1), dtype=xy1.dtype)
    p1 = jnp.concatenate([xy1, ones], axis=1)  # (N1, 3)
    lines = p1 @ F12.T  # (N1, 3): a, b, c
    a, b, c = lines[:, 0:1], lines[:, 1:2], lines[:, 2:3]
    num = a * xy2[None, :, 0] + b * xy2[None, :, 1] + c  # (N1, N2)
    den = a * a + b * b
    dsqr = (num * num) / jnp.maximum(den, 1e-12)
    sigma2 = level_sigma2_2[octave2][None, :]
    return dsqr < thresh_chi2 * sigma2


def search_by_projection(
    proj_uv: jnp.ndarray,
    radii: jnp.ndarray,
    desc_q: jnp.ndarray,
    valid_q: jnp.ndarray,
    xy_t: jnp.ndarray,
    octave_t: jnp.ndarray,
    desc_t: jnp.ndarray,
    valid_t: jnp.ndarray,
    octave_lo: jnp.ndarray,
    octave_hi: jnp.ndarray,
    max_dist: int = 100,
    nn_ratio: float = 1.0,
) -> Matches:
    """Projection-guided matching: map points (queries) against frame
    keypoints (targets), gated by window + octave.

    Covers reference SearchByProjection variants (ORBmatcher.cc:45-129
    local-map points; :1328-1470 motion model; :1472-1599 reloc).
    """
    mask = window_mask(proj_uv, radii, xy_t) & octave_mask(
        octave_t, octave_lo, octave_hi
    )
    return match(
        desc_q,
        desc_t,
        valid_q,
        valid_t,
        pair_mask=mask,
        max_dist=max_dist,
        nn_ratio=nn_ratio,
        ratio_octave_t=octave_t,
    )


def search_for_initialization(
    kp1_xy: jnp.ndarray,
    kp1_desc: jnp.ndarray,
    kp1_valid: jnp.ndarray,
    kp1_angle: jnp.ndarray,
    kp2_xy: jnp.ndarray,
    kp2_desc: jnp.ndarray,
    kp2_valid: jnp.ndarray,
    kp2_angle: jnp.ndarray,
    kp2_octave: jnp.ndarray,
    window: float = 100.0,
    max_dist: int = 50,
    nn_ratio: float = 0.9,
    check_rotation: bool = True,
) -> Matches:
    """Two-view matching for monocular initialization, level-0 only
    (reference: ORBmatcher.cc:405-520)."""
    radii = jnp.full((kp1_xy.shape[0],), window, dtype=jnp.float32)
    mask = window_mask(kp1_xy, radii, kp2_xy) & (kp2_octave[None, :] == 0)
    m = match(
        kp1_desc,
        kp2_desc,
        kp1_valid,
        kp2_valid,
        pair_mask=mask,
        max_dist=max_dist,
        nn_ratio=nn_ratio,
    )
    if check_rotation:
        ok = rotation_consistency(kp1_angle, kp2_angle[m.idx], m.valid)
        m = m._replace(valid=ok)
    return m
