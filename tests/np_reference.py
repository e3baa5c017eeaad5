"""Plain numpy references for the descriptor kernels.

Independent of the JAX code they check: Hamming distances by XOR and
popcount, a brute-force projection search with the gating and acceptance
rules of ops/match.search_by_projection, and a per-keypoint port of the
reference's steered-BRIEF sampling (ORBextractor.cc:108-147, GET_VALUE).
"""

from __future__ import annotations

import numpy as np

INVALID_DIST = 512  # distance of a masked-out pair (ops/hamming.py)
_BIG = 1 << 20
_POP8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def popcount_distance(a, b, block: int = 256) -> np.ndarray:
    """(Q, 8) x (T, 8) uint32 descriptors -> (Q, T) int32 Hamming
    distances, computed in row blocks to bound the temporaries."""
    a = np.ascontiguousarray(a, np.uint32)
    b = np.ascontiguousarray(b, np.uint32)
    out = np.empty((a.shape[0], b.shape[0]), np.int32)
    for s in range(0, a.shape[0], block):
        x = a[s:s + block, None, :] ^ b[None, :, :]
        out[s:s + block] = _POP8[x.view(np.uint8)].sum(axis=-1, dtype=np.int32)
    return out


def masked_search_distances(proj_uv, radii, desc_q, valid_q, xy_t, octave_t,
                            desc_t, valid_t, octave_lo, octave_hi):
    """(Q, T) distances with INVALID_DIST outside the projection search's
    gate: both sides valid, target inside the query's square window
    (Chebyshev radius) and inside its octave range."""
    d = popcount_distance(desc_q, desc_t)
    off = np.asarray(proj_uv)[:, None, :] - np.asarray(xy_t)[None, :, :]
    window = np.abs(off).max(axis=-1) <= np.asarray(radii)[:, None]
    octave = (
        (np.asarray(octave_t)[None, :] >= np.asarray(octave_lo)[:, None])
        & (np.asarray(octave_t)[None, :] <= np.asarray(octave_hi)[:, None])
    )
    mask = (np.asarray(valid_q)[:, None] & np.asarray(valid_t)[None, :]
            & window & octave)
    return np.where(mask, d, INVALID_DIST).astype(np.int32)


def accept_matches(dm, idx, octave_t, max_dist: int, nn_ratio: float):
    """Best distance, second distance and acceptance of each query's match
    to target idx[q] under the matcher's rules: distance threshold, NN
    ratio (a runner-up at another octave does not count, as in
    ORBmatcher.cc:115-121), and one query per target, the closest (ties
    to the lower query index).

    idx is given, not recomputed, so that a caller can score another
    implementation's choice among exactly tied targets."""
    dm = np.asarray(dm)
    idx = np.asarray(idx)
    q = np.arange(dm.shape[0])
    best = dm[q, idx]
    others = dm.copy()
    others[q, idx] = _BIG
    second = np.minimum(others.min(axis=1), INVALID_DIST)
    ok = best <= max_dist
    if nn_ratio < 1.0:
        idx2 = others.argmin(axis=1)
        octave_t = np.asarray(octave_t)
        ratio_fail = ~(
            best.astype(np.float32)
            < np.float32(nn_ratio) * second.astype(np.float32)
        ) & (octave_t[idx] == octave_t[idx2])
        ok &= ~ratio_fail
    key = np.where(ok, best * 4096 + q, _BIG)
    per_target = np.full(dm.shape[1], _BIG, np.int64)
    np.minimum.at(per_target, idx, key)
    ok &= per_target[idx] == key
    return best, second, ok


def steered_brief(image, yx, angles, pattern):
    """Per-keypoint port of the reference's rotated BRIEF sampling.

    For each keypoint at integer (y, x) and angle a, each pattern point
    (py, px) is read at row y + round(px sin a + py cos a) and column
    x + round(px cos a - py sin a) (ORBextractor.cc:120-121), and bit i is
    sample(a_i) < sample(b_i), packed little-endian into eight uint32
    words. Rows and columns are clipped to the image like the JAX code.

    Returns (desc (N, 8) uint32, ambiguous (N, 256) bool): a bit is
    ambiguous when a rotated coordinate lies within 1e-4 of a rounding
    boundary, where float32 cos/sin may round either way.
    """
    image = np.asarray(image)
    h, w = image.shape
    pattern = np.asarray(pattern, np.float64)
    desc = np.zeros((len(yx), 8), np.uint32)
    ambiguous = np.zeros((len(yx), 256), bool)
    for k, ((y, x), a) in enumerate(zip(np.asarray(yx), np.asarray(angles))):
        c, s = np.cos(float(a)), np.sin(float(a))
        vals, amb = [], np.zeros(256, bool)
        for py, px in ((pattern[:, 0], pattern[:, 1]),
                       (pattern[:, 2], pattern[:, 3])):
            ry = px * s + py * c
            rx = px * c - py * s
            for r in (ry, rx):
                amb |= np.abs(np.abs(r - np.floor(r)) - 0.5) < 1e-4
            iy = np.clip(y + np.rint(ry).astype(np.int64), 0, h - 1)
            ix = np.clip(x + np.rint(rx).astype(np.int64), 0, w - 1)
            vals.append(image[iy, ix])
        for i in np.nonzero(vals[0] < vals[1])[0]:
            desc[k, i // 32] |= np.uint32(1) << np.uint32(i % 32)
        ambiguous[k] = amb
    return desc, ambiguous
