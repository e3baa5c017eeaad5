#!/usr/bin/env python3
"""Smoke run of the SLAM main path on an NVIDIA GPU.

    python chip_smoke.py            # one card: device, parity, mono, stereo, loop
    python chip_smoke.py --multi    # four cards: the multi-device solvers only

Every phase prints one line with its result. The card's name and power
limit (from nvidia-smi, read by a child process that does not import JAX)
come on an early line and again on every phase line. The last line of
standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``,
printed only when every phase passed. Without a GPU, outside a checkout
of this repository, or when any phase fails, the script exits non-zero
and prints no result.

Phases on one card:

- ``device``: JAX's first device is a GPU.
- ``parity``: the hot kernels on the GPU against plain references at real
  widths (Hamming matrix and projection search against numpy, ORB
  extraction and the pose / bundle-adjustment solvers against the same
  code on the CPU).
- ``mono``, ``stereo``: ``System`` over rendered sequences at the
  ``mono_tum30`` and ``stereo_kitti`` geometries of bench.py.
- ``loop``: the 240-frame stereo orbit of tests/e2e_loop_debug.py, which
  closes a loop and applies a global BA.

With ``--multi``: the multi-device dry run, the sharded solvers against
the single-device ones on a 256-keyframe map, and the stereo phase with
four cards visible (so the live System dispatches its local BA to
parallel/dba).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# Acceptance gates.
MONO_STEREO_ATE_M = 0.05
LOOP_ATE_M = 0.4  # tests/test_e2e_loop.py; the no-loop run drifts ~0.76 m
LOOP_TRACKED_FRAC = 0.9
# Poses solved on two devices (or sharded against single-device) agree to
# this, in radians and metres. The package's float32 default matmul
# precision keeps TF32 out of the solvers' products, so only summation
# order separates the two runs.
POSE_TOL = 1e-4
# GPU against CPU ORB extraction. The FAST circle stack is bfloat16
# (ops/fast.py), and its near-threshold differences, the bilinear pyramid
# levels and the cos/sin of keypoint angles round differently on the two
# backends, so a few keypoints and descriptor bits may differ.
MIN_SAME_KEYPOINTS = 0.99
MAX_MEAN_DESC_BITS = 2.0


class PhaseFailure(Exception):
    """A phase's check did not hold."""


def check(cond, msg: str) -> None:
    if not cond:
        raise PhaseFailure(msg)


def card_line() -> str:
    """`name, power.limit` of the first visible card, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    check(lines, "nvidia-smi listed no card")
    return lines[0]


def _import_paths() -> None:
    for p in (ROOT, os.path.join(ROOT, "tests")):
        if p not in sys.path:
            sys.path.insert(0, p)


# ---------------------------------------------------------------------------
# Parity helpers: each takes its widths as arguments, so the CPU test suite
# runs the same code at tiny sizes. `dev` is the device under test, `ref`
# the device of the JAX reference (the CPU).
# ---------------------------------------------------------------------------


def parity_hamming(dev, n_q: int = 8192, n_t: int = 2048, seed: int = 0):
    """hamming.distance_matrix on `dev` against numpy XOR+popcount. Bits
    are exact in bfloat16 and the sums (at most 256) exact in float32, so
    the matrices must be equal."""
    import jax
    import numpy as np

    import np_reference
    from c_orb_slam_tpu.ops import hamming

    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, (n_q, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (n_t, 8), dtype=np.uint32)
    # Near-duplicates, so small distances occur as they do in matching.
    k = min(n_q, n_t) // 2
    b[:k] = a[:k] ^ (rng.random((k, 8)) < 0.05).astype(np.uint32)
    d = np.asarray(jax.jit(hamming.distance_matrix)(
        jax.device_put(a, dev), jax.device_put(b, dev)))
    ref = np_reference.popcount_distance(a, b)
    n_bad = int(np.count_nonzero(d != ref))
    check(n_bad == 0, f"hamming {n_q}x{n_t}: {n_bad} entries differ")
    return f"hamming {n_q}x{n_t} exact"


def search_problem(n_q: int, n_t: int, width: int, height: int,
                   n_levels: int = 8, seed: int = 0):
    """A projection-search input shaped like tracking's: targets are one
    frame's keypoints; half the queries project near a target and carry
    its descriptor with some bits flipped, the rest are unrelated."""
    import numpy as np

    from c_orb_slam_tpu.config import OrbConfig

    rng = np.random.default_rng(seed)
    sf = np.asarray(OrbConfig(n_levels=n_levels).scale_factors(), np.float32)
    xy_t = rng.uniform([0, 0], [width, height], (n_t, 2)).astype(np.float32)
    oct_t = rng.integers(0, n_levels, n_t).astype(np.int32)
    desc_t = rng.integers(0, 2**32, (n_t, 8), dtype=np.uint32)
    valid_t = rng.random(n_t) > 0.05

    src = rng.integers(0, n_t, n_q)
    near = rng.random(n_q) < 0.5
    uv = np.where(
        near[:, None], xy_t[src] + rng.normal(0, 3, (n_q, 2)),
        rng.uniform([0, 0], [width, height], (n_q, 2)),
    ).astype(np.float32)
    flips = (rng.random((n_q, 8, 32)) < rng.uniform(0, 0.25, (n_q, 1, 1)))
    noise = np.sum(flips.astype(np.uint64) << np.arange(32, dtype=np.uint64),
                   axis=-1).astype(np.uint32)
    desc_q = np.where(near[:, None], desc_t[src] ^ noise,
                      rng.integers(0, 2**32, (n_q, 8), dtype=np.uint32))
    oct_q = np.where(near, oct_t[src], rng.integers(0, n_levels, n_q))
    radii = (15.0 * sf[oct_q]).astype(np.float32)
    lo = np.maximum(oct_q - 1, 0).astype(np.int32)
    hi = np.minimum(oct_q + 1, n_levels - 1).astype(np.int32)
    valid_q = rng.random(n_q) > 0.1
    return dict(proj_uv=uv, radii=radii, desc_q=desc_q.astype(np.uint32),
                valid_q=valid_q, xy_t=xy_t, octave_t=oct_t, desc_t=desc_t,
                valid_t=valid_t, octave_lo=lo, octave_hi=hi)


def compare_search(args: dict, idx, dist, valid, second, max_dist: int,
                   nn_ratio: float) -> dict:
    """Score one implementation's search_by_projection output against the
    numpy brute force: best and second distances equal, indices equal up
    to exact distance ties, acceptance equal."""
    import numpy as np

    import np_reference

    dm = np_reference.masked_search_distances(**args)
    best_ref = dm.min(axis=1)
    idx = np.asarray(idx)
    best, second_ref, ok = np_reference.accept_matches(
        dm, idx, args["octave_t"], max_dist, nn_ratio)
    return dict(
        dist_diff=int(np.count_nonzero(np.asarray(dist) != best_ref)),
        idx_not_tie=int(np.count_nonzero(best != best_ref)),
        idx_tie_diff=int(np.count_nonzero(idx != dm.argmin(axis=1))),
        second_diff=int(np.count_nonzero(np.asarray(second) != second_ref)),
        valid_diff=int(np.count_nonzero(np.asarray(valid) != ok)),
        n_valid=int(ok.sum()),
    )


def run_search(dev, args: dict, max_dist: int, nn_ratio: float):
    """search_by_projection on `dev`, plus the top-2 of the same gated
    distance matrix (the second distance is internal to the search)."""
    import jax

    from c_orb_slam_tpu.ops import hamming, match

    def fn(a):
        m = match.search_by_projection(
            a["proj_uv"], a["radii"], a["desc_q"], a["valid_q"], a["xy_t"],
            a["octave_t"], a["desc_t"], a["valid_t"], a["octave_lo"],
            a["octave_hi"], max_dist=max_dist, nn_ratio=nn_ratio)
        mask = match.window_mask(a["proj_uv"], a["radii"], a["xy_t"]) & (
            match.octave_mask(a["octave_t"], a["octave_lo"], a["octave_hi"]))
        d = hamming.masked_distance_matrix(
            a["desc_q"], a["desc_t"], a["valid_q"], a["valid_t"], mask)
        _, _, second = hamming.best_two(d, axis=1)
        return m.idx, m.dist, m.valid, second

    return jax.device_get(jax.jit(fn)(jax.device_put(args, dev)))


def parity_search(dev, n_q: int = 8192, n_t: int = 2048,
                  width: int = 1241, height: int = 376, seed: int = 0):
    """match.search_by_projection on `dev` against the numpy brute force
    over window, octave and validity."""
    args = search_problem(n_q, n_t, width, height, seed=seed)
    idx, dist, valid, second = run_search(dev, args, 100, 0.9)
    r = compare_search(args, idx, dist, valid, second, 100, 0.9)
    check(r["dist_diff"] == 0 and r["second_diff"] == 0,
          f"search {n_q}x{n_t}: best/second distances differ: {r}")
    check(r["idx_not_tie"] == 0, f"search {n_q}x{n_t}: index off a tie: {r}")
    check(r["valid_diff"] == 0, f"search {n_q}x{n_t}: acceptance differs: {r}")
    check(r["n_valid"] > 0, f"search {n_q}x{n_t}: no match accepted")
    return (f"search {n_q}x{n_t} exact (valid={r['n_valid']}, "
            f"tie_idx_diff={r['idx_tie_diff']})")


def render_frame(width: int, height: int, seed: int = 5,
                 noise_sigma: float = 0.0):
    """One left frame of the bench's blob world at the given geometry
    (KITTI intrinsics scaled to the width), with optional Gaussian sensor
    noise of `noise_sigma` gray levels."""
    import numpy as np

    from synthetic import blob_world, render_scene, smooth_trajectory

    f = 718.856 * width / 1241.0
    xw, inten, size = blob_world(1200, seed=seed, x_max=22.0)
    T = smooth_trajectory(1)[0]
    img = render_scene(xw, inten, size, T, (f, f, width / 2.0, height / 2.0),
                       h=height, w=width)
    if noise_sigma:
        img = img + np.random.default_rng(seed).normal(0, noise_sigma, img.shape)
    return np.clip(img, 0, 255).astype(np.float32)


def parity_extract(dev, ref, width: int = 1241, height: int = 376,
                   n_features: int = 2000, n_levels: int = 8):
    """extract.extract_orb on `dev` against the same function on `ref`.

    A keypoint is identical when both found the same detection: the same
    octave and the same pixel of that level (positions within half a
    level pixel; 3x3 non-maximum suppression keeps detections >= 2 px
    apart, so the pairing is unique). The sub-pixel offset, refined from
    the score map, is then a value compared like the descriptor: the line
    reports the share also within 1e-2 px, and the mean Hamming distance
    of the identical keypoints' descriptors.

    The frame carries camera-like sensor noise (sigma 2 gray levels). A
    noise-free render is piecewise flat, so many BRIEF pairs on levels >= 1
    compare two values that are equal but for the last bits of the
    bilinear resize, which the two backends round differently; on the
    H100 that alone measured a 2.6-bit mean distance, and 0 with noise.
    BRIEF itself agrees bit for bit on identical inputs."""
    import jax
    import numpy as np

    from c_orb_slam_tpu.config import OrbConfig
    from c_orb_slam_tpu.ops import extract

    cfg = OrbConfig(n_features=n_features, n_levels=n_levels)
    img = render_frame(width, height, noise_sigma=2.0)
    fn = jax.jit(extract.extract_orb, static_argnums=1)
    out = [jax.device_get(fn(jax.device_put(img, d), cfg)) for d in (dev, ref)]
    (a, b) = out
    va, vb = np.asarray(a.valid), np.asarray(b.valid)
    scales = cfg.scale_factors()
    same, same_exact, bits = 0, 0, []
    for lvl in range(n_levels):
        ia = np.nonzero(va & (np.asarray(a.octave) == lvl))[0]
        ib = np.nonzero(vb & (np.asarray(b.octave) == lvl))[0]
        if not len(ia) or not len(ib):
            continue
        gap = np.abs(np.asarray(a.xy)[ia][:, None]
                     - np.asarray(b.xy)[ib][None]).max(axis=-1)
        near = gap <= 0.5 * scales[lvl]
        hit = near.any(axis=1)
        j = near.argmax(axis=1)[hit]
        same += int(hit.sum())
        same_exact += int((gap[hit, j] <= 1e-2).sum())
        x = np.asarray(a.desc)[ia[hit]] ^ np.asarray(b.desc)[ib[j]]
        bits.append(np.unpackbits(x.view(np.uint8), axis=-1).sum(axis=-1))
    n = max(int(va.sum()), int(vb.sum()), 1)
    frac, frac_exact = same / n, same_exact / n
    mean_bits = float(np.concatenate(bits).mean()) if bits else float("nan")
    check(int(va.sum()) > 0, "extract: no keypoints")
    check(frac >= MIN_SAME_KEYPOINTS,
          f"extract: only {frac:.4f} of keypoints identical")
    check(mean_bits <= MAX_MEAN_DESC_BITS,
          f"extract: mean descriptor distance {mean_bits:.3f} bits")
    return (f"extract {width}x{height}/{n_features}f/{n_levels}lv "
            f"same_kp={frac:.4f} same_kp_1e-2px={frac_exact:.4f} "
            f"mean_desc_bits={mean_bits:.3f}")


def pose_error(A, B) -> tuple[float, float]:
    """Largest rotation (rad) and translation (m) difference between two
    stacks of (3, 4) poses."""
    import numpy as np

    A = np.asarray(A, np.float64).reshape(-1, 3, 4)
    B = np.asarray(B, np.float64).reshape(-1, 3, 4)
    dR = np.einsum("nji,njk->nik", A[:, :, :3], B[:, :, :3])
    # |dR - dR^T|_F = 2 sqrt(2) sin(angle), well conditioned near 0.
    skew = np.linalg.norm(dR - np.swapaxes(dR, 1, 2), axis=(1, 2))
    rot = np.arcsin(np.clip(skew / (2.0 * np.sqrt(2.0)), 0.0, 1.0))
    trans = np.linalg.norm(A[:, :, 3] - B[:, :, 3], axis=1)
    return float(rot.max()), float(trans.max())


def ba_problem(C: int, P: int, O: int, n_fixed: int = 2, noise: float = 0.03,
               seed: int = 0):
    """A seeded stereo BA problem (KITTI-like 0.54 m baseline): C cameras
    along a gently turning path, P points in front of them, O observations
    each made by a camera that sees the point; cameras (but the first n_fixed)
    and points perturbed."""
    import jax.numpy as jnp
    import numpy as np

    from c_orb_slam_tpu.optim import ba

    rng = np.random.default_rng(seed)
    K = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
    span = 0.2 * C
    cam_x = np.linspace(0.0, span, C)
    yaw = 0.05 * np.sin(np.linspace(0, 3, C))
    cam_T = np.zeros((C, 3, 4), np.float32)
    for c in range(C):
        cy, sy = np.cos(yaw[c]), np.sin(yaw[c])
        R = np.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]])
        cam_T[c, :, :3] = R
        cam_T[c, :, 3] = -R @ np.array([cam_x[c], 0.0, 0.0])
    pts = np.c_[rng.uniform(-2, span + 2, P), rng.uniform(-2, 2, P),
                rng.uniform(4, 9, P)].astype(np.float32)
    # Each observation is made by a camera that sees the point: within the
    # 64-degree horizontal field of view (|dx| < 0.6 z) of the nearest one.
    obs_pt = np.arange(O) % P
    near_c = np.searchsorted(cam_x, pts[obs_pt, 0]).clip(0, C - 1)
    reach = 0.6 * pts[obs_pt, 2] / (cam_x[1] - cam_x[0])
    obs_cam = (near_c + np.rint(rng.uniform(-1, 1, O) * reach)).clip(
        0, C - 1).astype(np.int32)
    xc = np.einsum("nij,nj->ni", cam_T[obs_cam, :, :3], pts[obs_pt]) \
        + cam_T[obs_cam, :, 3]
    bf = K[0] * 0.54
    u = K[0] * xc[:, 0] / xc[:, 2] + K[2]
    uv = np.stack([u, K[1] * xc[:, 1] / xc[:, 2] + K[3], u - bf / xc[:, 2]],
                  axis=1).astype(np.float32)
    uv += rng.normal(0, 0.5, (O, 3)).astype(np.float32)
    init = cam_T.copy()
    init[n_fixed:, :, 3] += rng.normal(0, noise, (C - n_fixed, 3))
    return ba.BAProblem(
        cam_T=jnp.asarray(init),
        cam_fixed=jnp.asarray(np.arange(C) < n_fixed),
        cam_valid=jnp.ones(C, bool),
        points=jnp.asarray(pts + rng.normal(0, noise, pts.shape)
                           .astype(np.float32)),
        point_valid=jnp.ones(P, bool),
        obs_cam=jnp.asarray(obs_cam),
        obs_pt=jnp.asarray(obs_pt.astype(np.int32)),
        obs_uv=jnp.asarray(uv),
        obs_stereo=jnp.ones(O, bool),
        obs_inv_sigma2=jnp.ones(O, jnp.float32),
        obs_valid=jnp.ones(O, bool),
        K=jnp.asarray(K),
        bf=jnp.asarray(bf, jnp.float32),
    )


def parity_solvers(dev, ref, n_pose: int = 2000, C: int = 32, P: int = 8192,
                   O: int = 16384, seed: int = 0):
    """pose_opt.optimize_pose and a local ba.bundle_adjust (dense Schur)
    on `dev` against the same programs on `ref`."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from c_orb_slam_tpu.geometry import se3
    from c_orb_slam_tpu.optim import ba, pose_opt

    rng = np.random.default_rng(seed)
    K = jnp.asarray([500.0, 500.0, 320.0, 240.0], jnp.float32)
    xw = np.c_[rng.uniform(-3, 3, (n_pose, 2)),
               rng.uniform(3, 9, n_pose)].astype(np.float32)
    T_true = np.asarray(se3.exp(jnp.asarray([0.1, -0.05, 0.2, 0.03, -0.02, 0.01],
                                            jnp.float32)))
    xc = xw @ T_true[:, :3].T + T_true[:, 3]
    obs = np.c_[500 * xc[:, 0] / xc[:, 2] + 320, 500 * xc[:, 1] / xc[:, 2] + 240,
                np.zeros(n_pose)].astype(np.float32)
    obs[:, :2] += rng.normal(0, 0.7, (n_pose, 2)).astype(np.float32)
    outlier = rng.random(n_pose) < 0.1
    obs[outlier, :2] += rng.uniform(-40, 40, (int(outlier.sum()), 2))
    pose_args = (np.eye(3, 4, dtype=np.float32), xw, obs,
                 np.ones(n_pose, np.float32), np.zeros(n_pose, bool),
                 np.ones(n_pose, bool), K)
    poses = [jax.device_get(pose_opt.optimize_pose(
        *jax.device_put(pose_args, d)).pose) for d in (dev, ref)]
    r_pose, t_pose = pose_error(*poses)

    p = ba_problem(C, P, O, seed=seed)
    cams = [jax.device_get(ba.bundle_adjust(
        jax.device_put(p, d), schur="dense").cam_T) for d in (dev, ref)]
    r_ba, t_ba = pose_error(*cams)
    check(max(r_pose, t_pose) <= POSE_TOL,
          f"pose_opt differs: rot {r_pose:.2e} rad, trans {t_pose:.2e} m")
    check(max(r_ba, t_ba) <= POSE_TOL,
          f"local BA differs: rot {r_ba:.2e} rad, trans {t_ba:.2e} m")
    return (f"pose_opt rot={r_pose:.1e} trans={t_pose:.1e}; "
            f"local_ba C={C} P={P} O={O} rot={r_ba:.1e} trans={t_ba:.1e}")


def pose_graph_problem(n: int, seed: int = 0):
    """A drifted odometry ring of n Sim3 vertices with exact loop edges
    every n // 8 vertices (the essential graph after a loop closure)."""
    import jax.numpy as jnp
    import numpy as np

    from c_orb_slam_tpu.geometry import sim3
    from c_orb_slam_tpu.optim import pose_graph

    rng = np.random.default_rng(seed)
    gt = []
    for k in range(n):
        a = 2 * np.pi * k / n
        c = np.array([8 * np.cos(a), 0.0, 8 * np.sin(a)])
        cy, sy = np.cos(-a), np.sin(-a)
        R_cw = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]]).T
        gt.append(np.asarray(sim3.from_se3(jnp.asarray(
            np.c_[R_cw, -R_cw @ c].astype(np.float32)))))
    gt = np.stack(gt)
    rel = lambda i, j: np.asarray(sim3.compose(  # noqa: E731
        jnp.asarray(gt[j]), sim3.inverse(jnp.asarray(gt[i]))))
    est = [gt[0]]
    edges = []
    for k in range(1, n):
        drift = np.asarray(sim3.exp(jnp.asarray(
            rng.normal(0, 0.004, 7).astype(np.float32))))
        meas = np.asarray(sim3.compose(jnp.asarray(drift),
                                       jnp.asarray(rel(k - 1, k))))
        edges.append((k - 1, k, meas))
        est.append(np.asarray(sim3.compose(jnp.asarray(meas),
                                           jnp.asarray(est[-1]))))
    step = max(n // 8, 2)
    for k in range(step, n, step):
        edges.append((0, k, rel(0, k)))
    edges.append((0, n - 1, rel(0, n - 1)))
    E = len(edges)
    return pose_graph.PoseGraphProblem(
        vertices=jnp.asarray(np.stack(est)),
        v_fixed=jnp.asarray(np.arange(n) == 0),
        v_valid=jnp.ones(n, bool),
        edge_i=jnp.asarray([e[0] for e in edges], jnp.int32),
        edge_j=jnp.asarray([e[1] for e in edges], jnp.int32),
        edge_Sji=jnp.asarray(np.stack([e[2] for e in edges])),
        edge_weight=jnp.ones(E, jnp.float32),
        edge_valid=jnp.ones(E, bool),
    )


def parity_parallel(devices, C: int = 256, P: int = 40000, O: int = 400000,
                    seed: int = 0):
    """parallel/sharded_ba, parallel/dba and parallel/dpose_graph over
    `devices` against ba.bundle_adjust and pose_graph on devices[0]."""
    import numpy as np

    from c_orb_slam_tpu.optim import ba, pose_graph
    from c_orb_slam_tpu.parallel import dba, dpose_graph, sharded_ba

    n = len(devices)
    # Uncommitted arrays: the single-device solves run on the default
    # device (devices[0]) and the sharded ones may place them anywhere.
    p = ba_problem(C, P, O, seed=seed)
    # The reference solve is the exact (dense Schur) one. The sharded
    # solver's matrix-free PCG gets enough iterations to converge on this
    # 256-camera chain; with 60 it stops ~1e-4 short, which is then the
    # difference measured, not the sharding.
    it = dict(iters_first=5, iters_second=10, pcg_iters=200)
    single = ba.bundle_adjust(p, schur="dense", **it).cam_T
    (cam_sh, _, _, _), _ = sharded_ba.sharded_bundle_adjust(
        p, sharded_ba.make_mesh(np.asarray(devices)), **it)
    cam_dba = dba.distributed_bundle_adjust(
        dba.pad_observations(p, n), dba.make_mesh(list(devices)),
        schur="dense", **it).cam_T
    r_sh, t_sh = pose_error(np.asarray(cam_sh)[:C], single)
    r_dba, t_dba = pose_error(cam_dba, single)

    g = pose_graph_problem(C, seed=seed)
    single_g = pose_graph.optimize_pose_graph(g, iters=20, pcg_iters=50)
    dist_g = dpose_graph.distributed_pose_graph(
        g, dpose_graph.make_mesh(np.asarray(devices)), iters=20, pcg_iters=50)
    r_pg, t_pg = pose_error(pose_graph.recover_se3(dist_g)[0],
                            pose_graph.recover_se3(single_g)[0])
    for name, (r, t) in (("sharded_ba", (r_sh, t_sh)), ("dba", (r_dba, t_dba)),
                         ("dpose_graph", (r_pg, t_pg))):
        check(max(r, t) <= POSE_TOL,
              f"{name} differs from single device: rot {r:.2e} trans {t:.2e}")
    return (f"{n} devices C={C} P={P} O={O}: sharded_ba rot={r_sh:.1e} "
            f"trans={t_sh:.1e}; dba rot={r_dba:.1e} trans={t_dba:.1e}; "
            f"dpose_graph rot={r_pg:.1e} trans={t_pg:.1e}")


# ---------------------------------------------------------------------------
# End-to-end phases through System.
# ---------------------------------------------------------------------------


def run_sequence(name: str) -> str:
    """Track one of bench.py's configurations through System: set-up time
    is construction, warmup and the first frame; frames/s covers the rest,
    and again its second half (after the mid-run first calls of the
    mapping and keyframe programs have compiled)."""
    import numpy as np

    import bench
    from c_orb_slam_tpu.config import (
        CameraConfig, OrbConfig, Sensor, SlamConfig, TrackingConfig)
    from c_orb_slam_tpu.io import trajectory as traj_io
    from c_orb_slam_tpu.system import System
    from c_orb_slam_tpu.tracking import TrackState
    from synthetic import (
        blob_world, render_scene, render_stereo_pair, smooth_trajectory)

    c = bench.CONFIGS[name]
    cam = CameraConfig(**c["cam_kwargs"])
    stereo = c["sensor"] == "STEREO"
    cfg = SlamConfig(
        sensor=Sensor.STEREO if stereo else Sensor.MONOCULAR, camera=cam,
        orb=OrbConfig(**c["orb_kwargs"]),
        tracking=TrackingConfig(**c.get("tracking_kwargs", {})),
    )
    n, dt = c["n_frames"], c["dt_frame"]
    xw, inten, size = blob_world(c.get("world_n", 400), seed=5,
                                 x_max=c.get("world_x_max", 10.0))
    traj = smooth_trajectory(n, speed=c["speed"])
    K4 = (cam.fx, cam.fy, cam.cx, cam.cy)
    wh = dict(h=cam.height, w=cam.width)
    u8 = lambda im: np.clip(im, 0, 255).astype(np.uint8)  # noqa: E731
    if stereo:
        frames = [tuple(u8(im) for im in render_stereo_pair(
            xw, inten, size, traj[i], K4, 0.2, **wh)) for i in range(n)]
    else:
        frames = [u8(render_scene(xw, inten, size, traj[i], K4, **wh))
                  for i in range(n)]

    t0 = time.perf_counter()
    sysm = System(cfg)
    sysm.warmup()
    t_warm = time.perf_counter() - t0

    def track(i):
        if stereo:
            return sysm.track_stereo(frames[i][0], frames[i][1], i * dt)
        return sysm.track_monocular(frames[i], i * dt)

    track(0)
    t_setup = time.perf_counter() - t0
    t1 = time.perf_counter()
    for i in range(1, n):
        if i == n // 2:
            t_half = time.perf_counter()
        track(i)
    sysm.tracker.flush_pending()
    t_end = time.perf_counter()
    fps = (n - 1) / (t_end - t1)
    fps_half = (n - n // 2) / (t_end - t_half)
    state_ok = sysm.tracker.state == TrackState.OK
    poses, stamps = sysm.frame_poses()
    ids = [int(round(t / dt)) for t in stamps]
    ate = traj_io.ate_rmse(poses, traj[ids], with_scale=not stereo)
    check(state_ok, f"{name}: tracking not OK at the end")
    check(ate <= MONO_STEREO_ATE_M, f"{name}: ATE {ate:.4f} m")
    return (f"{name} {cam.width}x{cam.height} frames={n} tracked={len(poses)} "
            f"ate_m={ate:.4f} fps={fps:.2f} fps_2nd_half={fps_half:.2f} "
            f"setup_s={t_setup:.2f} "
            f"(warmup_s={t_warm:.2f})")


def run_loop() -> str:
    """The stereo orbit with a loop closure, gated as in
    tests/test_e2e_loop.py."""
    import numpy as np

    import e2e_loop_debug
    from c_orb_slam_tpu.config import Sensor

    t0 = time.perf_counter()
    ate, n_loops, n_ok, n = e2e_loop_debug.run(
        Sensor.STEREO, n_frames=240, verbose=False, world_n=1400)
    wall = time.perf_counter() - t0
    run = e2e_loop_debug.run
    times = np.asarray(run.last_frame_times)
    corr = (f"{times[run.last_loops_at[0]]:.3f}" if run.last_loops_at
            else "none")
    line = (f"loop frames={n} tracked={n_ok} loops={n_loops} "
            f"gba_applied={run.last_n_gba_applied} ate_m={ate:.4f} "
            f"wall_s={wall:.1f} median_frame_s={np.median(times):.4f} "
            f"correction_frame_s={corr}")
    check(n_ok > LOOP_TRACKED_FRAC * n, f"{line}: too few frames tracked")
    check(n_loops >= 1, f"{line}: no loop closed")
    check(ate < LOOP_ATE_M, f"{line}: ATE too large")
    check(run.last_n_gba_applied >= 1, f"{line}: global BA never applied")
    return line


def run_dryrun(n_devices: int) -> str:
    """__graft_entry__.dryrun_multichip: the distributed BA, map-sharded
    BA and essential graph on tiny shapes, then a loop correction through
    a live System with the sharded GBA."""
    import __graft_entry__

    __graft_entry__.dryrun_multichip(n_devices)
    return f"dryrun_multichip({n_devices}) ok"


def run_stereo_sharded() -> str:
    """The stereo phase with every card visible, counting the local-BA
    solves that LocalMapping routed to parallel/dba."""
    from c_orb_slam_tpu.parallel import dba

    inner = dba.distributed_bundle_adjust
    calls = [0]

    def counted(*a, **k):
        calls[0] += 1
        return inner(*a, **k)

    dba.distributed_bundle_adjust = counted
    try:
        line = run_sequence("stereo_kitti")
    finally:
        dba.distributed_bundle_adjust = inner
    check(calls[0] > 1, f"{line}: local BA never ran sharded")
    return f"{line} dba_solves={calls[0]}"


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card path and its comparisons")
    args = ap.parse_args(argv)

    n_cards = 4 if args.multi else 1
    if "CUDA_VISIBLE_DEVICES" not in os.environ:
        os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(
            str(i) for i in range(n_cards))
    # The parity phase also needs the CPU backend beside the GPU.
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's first device is {devs[0]}); "
              "nothing was run", file=sys.stderr)
        return 2
    if len(devs) != n_cards:
        print(f"chip_smoke: expected {n_cards} GPU(s), JAX sees {len(devs)}",
              file=sys.stderr)
        return 2
    _import_paths()
    import c_orb_slam_tpu  # noqa: F401  (package-wide JAX settings)

    card = card_line()
    print(f"card: {card}", flush=True)
    dev, cpu = devs[0], jax.devices("cpu")[0]

    if args.multi:
        phases = [
            ("dryrun_multichip", lambda: run_dryrun(n_cards)),
            ("parallel_parity", lambda: parity_parallel(devs)),
            ("stereo", run_stereo_sharded),
        ]
    else:
        phases = [
            ("device", lambda: f"platform={dev.platform} "
                               f"kind={dev.device_kind} count={len(devs)}"),
            ("parity", lambda: "; ".join((
                parity_hamming(dev), parity_search(dev),
                parity_extract(dev, cpu), parity_solvers(dev, cpu)))),
            ("mono", lambda: run_sequence("mono_tum30")),
            ("stereo", lambda: run_sequence("stereo_kitti")),
            ("loop", run_loop),
        ]

    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            detail = fn()
            status = "ok"
        except Exception as e:  # report every phase, then fail the run
            traceback.print_exc(file=sys.stderr)
            detail, status = f"{type(e).__name__}: {e}", "FAIL"
            failed.append(name)
        print(f"phase {name} {status} [{time.perf_counter() - t0:.1f} s] "
              f"{detail} | card: {card}", flush=True)

    peak = [d.memory_stats().get("peak_bytes_in_use") for d in devs]
    print(f"peak_bytes_in_use: {peak}", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
