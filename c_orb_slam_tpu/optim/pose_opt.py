"""Motion-only pose optimization (the per-frame hot solver).

Reference: src/Optimizer.cc:239-451 PoseOptimization — g2o graph with one
SE3 vertex and unary mono/stereo edges, 4 rounds x 10 LM iterations,
inlier reclassification at chi2 = 5.991 / 7.815 between rounds, Huber
kernel dropped from round 3 (Optimizer.cc:407-437).

Array-program design: the whole thing is one jitted fixed-shape program —
residuals and Jacobians for all observations are vmapped, the 6x6 normal system
is a batched reduce, rounds/iterations are static unrolls. No graph building,
no per-edge virtual calls.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from c_orb_slam_tpu.geometry import se3
from c_orb_slam_tpu.optim import residuals as res


class PoseOptResult(NamedTuple):
    pose: jnp.ndarray  # (3, 4) optimized Tcw
    inliers: jnp.ndarray  # (N,) bool
    n_inliers: jnp.ndarray  # () int32


@functools.partial(
    jax.jit,
    static_argnames=("rounds", "iters", "chi2_mono", "chi2_stereo", "bf"),
)
def optimize_pose(
    T0: jnp.ndarray,
    xw: jnp.ndarray,
    obs: jnp.ndarray,
    inv_sigma2: jnp.ndarray,
    is_stereo: jnp.ndarray,
    valid: jnp.ndarray,
    K: jnp.ndarray,
    bf: float = 0.0,
    rounds: int = 4,
    iters: int = 10,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    damping: float = 1e-5,
) -> PoseOptResult:
    """Optimize camera pose against fixed 3D points.

    xw: (N, 3) world points; obs: (N, 3) (u, v, ur) with ur ignored for
    mono rows; valid: initial match mask. Returns pose + final inliers.
    """
    chi2_th = jnp.where(is_stereo, chi2_stereo, chi2_mono)

    def gn_iters(T, weight_mask, use_huber):
        def body(T, _):
            r, J, _ = res.residual_and_jacobians(T, xw, obs, K, bf, is_stereo)
            c2 = res.chi2(r, inv_sigma2)
            w = inv_sigma2 * weight_mask
            if use_huber:
                # Huber delta^2 = the chi2 gate, as in the reference
                # (Optimizer.cc:365-366 deltaMono/deltaStereo).
                w = w * res.huber_weight(c2, chi2_th)
            H = jnp.einsum("nij,nik,n->jk", J, J, w)
            b = jnp.einsum("nij,ni,n->j", J, r, w)
            H = H + damping * jnp.eye(6, dtype=H.dtype)
            # r = obs - pred; J = d r / d xi  =>  normal eq H dx = -b
            dx = jnp.linalg.solve(H, -b)
            T_new = se3.compose(se3.exp(dx), T)
            return T_new, None

        T, _ = jax.lax.scan(body, T, None, length=iters)
        return T

    T = T0
    inlier_mask = valid
    for rnd in range(rounds):
        use_huber = rnd < 2  # reference drops the kernel from round 3
        T = gn_iters(T, inlier_mask.astype(jnp.float32), use_huber)
        r, _, _ = res.residual_and_jacobians(T, xw, obs, K, bf, is_stereo)
        c2 = res.chi2(r, inv_sigma2)
        inlier_mask = valid & (c2 <= chi2_th)

    return PoseOptResult(
        pose=T,
        inliers=inlier_mask,
        n_inliers=jnp.sum(inlier_mask.astype(jnp.int32)),
    )
