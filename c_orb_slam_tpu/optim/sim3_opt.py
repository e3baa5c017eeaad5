"""Gauss-Newton refinement of a single Sim(3): the loop-alignment polish.

Reference: src/Optimizer.cc OptimizeSim3 (:1046-1241) — one g2o
VertexSim3Expmap plus paired fixed points with bidirectional reprojection
edges (EdgeSim3ProjectXYZ / Inverse, :1140-1173), Huber sqrt(10), two
stages with chi2>10 inlier pruning between them (:1180-1217); scale fixed
for stereo/RGB-D (`_fix_scale`, types_seven_dof_expmap.h:48).

Array-program design: all matches are one fixed-shape batch; the 7-dof (or
6-dof fixed-scale) Jacobians come from vmapped jax.jacrev of the residual wrt
the left-multiplied tangent update — a (M, 4, 7) tensor contracted into a 7x7
normal system; the two stages and iterations are lax.scan bodies.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from c_orb_slam_tpu.geometry import sim3


class Sim3OptResult(NamedTuple):
    S12: jnp.ndarray  # (8,) refined Sim3
    inliers: jnp.ndarray  # (M,) bool
    n_inliers: jnp.ndarray


def _project(K, x):
    z = jnp.maximum(x[..., 2], 1e-9)
    return jnp.stack(
        [K[0] * x[..., 0] / z + K[2], K[1] * x[..., 1] / z + K[3]], axis=-1
    )


def _residual(xi, S12, x1, x2, uv1, uv2, K1, K2):
    """(4,) stacked bidirectional reprojection residual for one match,
    at the left-perturbed pose S = exp(xi) ∘ S12."""
    S = sim3.compose(sim3.exp(xi), S12)
    S21 = sim3.inverse(S)
    e1 = uv1 - _project(K1, sim3.apply(S, x2))
    e2 = uv2 - _project(K2, sim3.apply(S21, x1))
    return jnp.concatenate([e1, e2])


@functools.partial(
    jax.jit, static_argnames=("fix_scale", "iters_per_stage", "chi2_gate")
)
def optimize_sim3(
    S12: jnp.ndarray,
    x1: jnp.ndarray,
    x2: jnp.ndarray,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    inv_sigma2_1: jnp.ndarray,
    inv_sigma2_2: jnp.ndarray,
    valid: jnp.ndarray,
    K1: jnp.ndarray,
    K2: jnp.ndarray,
    fix_scale: bool = False,
    iters_per_stage: int = 5,
    chi2_gate: float = 10.0,
) -> Sim3OptResult:
    """Two-stage GN on S12 (maps camera-2 coords into camera-1).

    x1/x2: (M, 3) matched points in each camera frame; uv1/uv2 observed
    pixels; inv_sigma2_*: per-match information (by octave).
    """
    delta2 = chi2_gate  # Huber delta^2 = 10 (reference: :1134 sqrt(10))

    def chi2_parts(S, mask):
        S21 = sim3.inverse(S)
        e1 = uv1 - _project(K1, sim3.apply(S, x2))
        e2 = uv2 - _project(K2, sim3.apply(S21, x1))
        c1 = jnp.sum(e1 * e1, axis=-1) * inv_sigma2_1
        c2 = jnp.sum(e2 * e2, axis=-1) * inv_sigma2_2
        return c1, c2

    def gn_stage(S, mask):
        def body(S, _):
            res_fn = lambda xi, a, b, u, v: _residual(xi, S, a, b, u, v, K1, K2)
            xi0 = jnp.zeros(7, jnp.float32)
            r = jax.vmap(res_fn, in_axes=(None, 0, 0, 0, 0))(xi0, x1, x2, uv1, uv2)
            J = jax.vmap(
                jax.jacrev(res_fn), in_axes=(None, 0, 0, 0, 0)
            )(xi0, x1, x2, uv1, uv2)  # (M, 4, 7)
            w_info = jnp.concatenate(
                [
                    jnp.repeat(inv_sigma2_1[:, None], 2, axis=1),
                    jnp.repeat(inv_sigma2_2[:, None], 2, axis=1),
                ],
                axis=1,
            )  # (M, 4)
            # Huber on the per-direction chi2.
            c1 = jnp.sum(r[:, :2] ** 2, axis=1) * inv_sigma2_1
            c2 = jnp.sum(r[:, 2:] ** 2, axis=1) * inv_sigma2_2
            hw1 = jnp.where(c1 > delta2, jnp.sqrt(delta2 / jnp.maximum(c1, 1e-12)), 1.0)
            hw2 = jnp.where(c2 > delta2, jnp.sqrt(delta2 / jnp.maximum(c2, 1e-12)), 1.0)
            hw = jnp.concatenate(
                [jnp.repeat(hw1[:, None], 2, 1), jnp.repeat(hw2[:, None], 2, 1)], 1
            )
            w = w_info * hw * mask[:, None]
            H = jnp.einsum("mia,mi,mib->ab", J, w, J)
            g = -jnp.einsum("mia,mi,mi->a", J, w, r)
            if fix_scale:
                # zero out the scale dof (last tangent coordinate).
                H = H.at[7 - 1, :].set(0.0).at[:, 7 - 1].set(0.0)
                H = H.at[6, 6].set(1.0)
                g = g.at[6].set(0.0)
            H = H + 1e-6 * jnp.eye(7)
            xi = jnp.linalg.solve(H, g)
            return sim3.compose(sim3.exp(xi), S), None

        S_out, _ = jax.lax.scan(body, S, None, length=iters_per_stage)
        return S_out

    mask0 = valid.astype(jnp.float32)
    S1 = gn_stage(S12, mask0)
    c1, c2 = chi2_parts(S1, mask0)
    keep = valid & (c1 < chi2_gate) & (c2 < chi2_gate)
    S2 = gn_stage(S1, keep.astype(jnp.float32))
    c1, c2 = chi2_parts(S2, keep)
    inl = keep & (c1 < chi2_gate) & (c2 < chi2_gate)
    return Sim3OptResult(
        S12=S2, inliers=inl, n_inliers=jnp.sum(inl.astype(jnp.int32))
    )
