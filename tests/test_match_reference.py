"""The descriptor kernels against plain numpy references (tests/np_reference.py):
projection search by brute force over window, octave and validity, and
steered BRIEF against a per-keypoint port of the reference's GET_VALUE
sampling (ORBextractor.cc:108-147)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import np_reference
from c_orb_slam_tpu.ops import brief, match


def _search_case(name):
    rng = np.random.default_rng(0)
    Q, T = {"unaligned_200x300": (200, 300), "masked_rows": (64, 96),
            "one_query": (1, 40)}[name]
    qd = rng.integers(0, 2**32, (Q, 8), dtype=np.uint32)
    td = rng.integers(0, 2**32, (T, 8), dtype=np.uint32)
    quv = rng.uniform(0, 640, (Q, 2)).astype(np.float32)
    n_near = min(Q, T) * 3 // 4
    txy = np.concatenate([quv[:n_near] + rng.normal(0, 8, (n_near, 2)),
                          rng.uniform(0, 640, (T - n_near, 2))]).astype(np.float32)
    # Near targets carry their query's descriptor with a few bits flipped,
    # so some matches pass the distance and ratio tests.
    td[:n_near] = qd[:n_near] ^ (rng.random((n_near, 8)) < 0.03).astype(np.uint32)
    qr = np.full((Q,), 15.0, np.float32)
    qlo = rng.integers(0, 3, Q).astype(np.int32)
    qhi = qlo + 2
    toct = rng.integers(0, 8, T).astype(np.int32)
    qv = rng.random(Q) > 0.1
    tv = rng.random(T) > 0.1
    if name == "masked_rows":
        qv[::4] = False          # invalid queries
        quv[1::4] = -1000.0      # windows that hold no target
        qlo[2::4], qhi[2::4] = 9, 9  # octave range that holds no target
    if name == "one_query":
        qv[:], quv[0], qlo[0], qhi[0] = True, txy[0], 0, 7
        tv[0], td[0] = True, qd[0]
    return dict(proj_uv=quv, radii=qr, desc_q=qd, valid_q=qv, xy_t=txy,
                octave_t=toct, desc_t=td, valid_t=tv, octave_lo=qlo,
                octave_hi=qhi)


@pytest.mark.parametrize("name", ["unaligned_200x300", "masked_rows",
                                  "one_query"])
def test_search_by_projection_matches_brute_force(name):
    args = _search_case(name)
    m = jax.device_get(jax.jit(
        lambda a: match.search_by_projection(**a, max_dist=100, nn_ratio=0.9)
    )(jax.tree.map(jnp.asarray, args)))
    dm = np_reference.masked_search_distances(**args)
    best_ref = dm.min(axis=1)

    np.testing.assert_array_equal(m.dist, best_ref)
    # Indices may differ only on exact distance ties.
    np.testing.assert_array_equal(dm[np.arange(len(m.idx)), m.idx], best_ref)
    _, _, ok = np_reference.accept_matches(dm, m.idx, args["octave_t"], 100, 0.9)
    np.testing.assert_array_equal(m.valid, ok)
    if name == "masked_rows":
        gated = ~args["valid_q"] | (np.arange(len(ok)) % 4 >= 1) & (
            np.arange(len(ok)) % 4 <= 2)
        assert (m.dist[gated] == np_reference.INVALID_DIST).all()
        assert not m.valid[gated].any()
    if name != "masked_rows":
        assert ok.any(), "the case accepts no match at all"


@pytest.mark.parametrize("seed", [0, 1])
def test_brief_matches_reference_port(seed):
    rng = np.random.default_rng(seed)
    h, w, n = 96, 128, 64
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    # Keypoints at least 19 px from the border (OrbConfig.edge_threshold),
    # so no sample is clipped.
    yx = np.c_[rng.integers(19, h - 19, n), rng.integers(19, w - 19, n)]
    ang = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    got = np.asarray(jax.jit(brief.compute_descriptors)(
        jnp.asarray(img), jnp.asarray(yx, jnp.int32), jnp.asarray(ang)))
    want, ambiguous = np_reference.steered_brief(
        img, yx, ang, brief.brief_pattern())

    bits = lambda d: np.unpackbits(  # noqa: E731
        d.view(np.uint8), axis=-1, bitorder="little").astype(bool)
    differ = bits(got) != bits(want)
    assert not (differ & ~ambiguous).any(), (
        f"{int((differ & ~ambiguous).sum())} unambiguous bits differ")
    assert ambiguous.mean() < 0.01
