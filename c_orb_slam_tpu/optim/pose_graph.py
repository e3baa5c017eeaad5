"""Sim(3) pose-graph optimization: the essential-graph loop corrector.

Reference: src/Optimizer.cc OptimizeEssentialGraph (:781-1044) — vertices
are ALL keyframes as Sim3 (:809-844, scale locked for stereo/RGB-D via
`_fix_scale`), edges are new loop connections with covisibility weight>=100
(:851-880), spanning-tree edges (:898-923), prior loop edges (:925-949) and
strong covisibility edges (:951-982); 20 LM iterations on g2o's
BlockSolver_7_3 (:985-988); afterwards poses are recovered as SE3 with the
scale divided out (:991-1010).

Array-program design: vertices (K, 8) packed Sim3, edges fixed-shape index
arrays. Each GN iteration: vmapped jacrev of the 7-dof relative-log residual
wrt both endpoint tangents -> per-edge (7, 14) Jacobian blocks; the normal
system is never materialized — PCG runs on an implicit matvec built from two
gathers and a segment-sum, with the block-diagonal (7x7 per vertex) inverse as
preconditioner. Distributed scaling shards the edge axis exactly like
parallel/dba.py shards observations.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from c_orb_slam_tpu.geometry import sim3


class PoseGraphProblem(NamedTuple):
    vertices: jnp.ndarray  # (K, 8) Sim3 world->cam
    v_fixed: jnp.ndarray  # (K,) bool
    v_valid: jnp.ndarray  # (K,) bool
    edge_i: jnp.ndarray  # (E,) int32
    edge_j: jnp.ndarray  # (E,) int32
    edge_Sji: jnp.ndarray  # (E, 8) measured Sim3 cam_i -> cam_j
    edge_weight: jnp.ndarray  # (E,) float32 information scale
    edge_valid: jnp.ndarray  # (E,) bool


def _edge_residual(xi_i, xi_j, S_i, S_j, S_ji):
    """r = log(S_ji_meas ∘ (exp(xi_i) S_i) ∘ (exp(xi_j) S_j)^-1) — zero when
    the relative pose matches the measurement (g2o EdgeSim3 error,
    types_seven_dof_expmap.h:99)."""
    Si = sim3.compose(sim3.exp(xi_i), S_i)
    Sj = sim3.compose(sim3.exp(xi_j), S_j)
    return sim3.log(sim3.compose(S_ji, sim3.compose(Si, sim3.inverse(Sj))))


def _gn_iter_impl(p: PoseGraphProblem, verts, pcg_iters: int,
                  fix_scale: bool):
    """One Gauss-Newton iteration on the Sim3 pose graph (traceable)."""
    K = p.vertices.shape[0]
    zero = jnp.zeros(7, jnp.float32)

    free = (p.v_valid & ~p.v_fixed).astype(jnp.float32)[:, None]  # (K, 1)
    scale_mask = jnp.ones(7, jnp.float32)
    if fix_scale:
        scale_mask = scale_mask.at[6].set(0.0)

    S_i = verts[p.edge_i]
    S_j = verts[p.edge_j]

    r = jax.vmap(_edge_residual, in_axes=(None, None, 0, 0, 0))(
        zero, zero, S_i, S_j, p.edge_Sji
    )  # (E, 7)
    Ji = jax.vmap(
        jax.jacrev(_edge_residual, argnums=0), in_axes=(None, None, 0, 0, 0)
    )(zero, zero, S_i, S_j, p.edge_Sji)  # (E, 7, 7)
    Jj = jax.vmap(
        jax.jacrev(_edge_residual, argnums=1), in_axes=(None, None, 0, 0, 0)
    )(zero, zero, S_i, S_j, p.edge_Sji)

    w = (p.edge_weight * p.edge_valid).astype(jnp.float32)  # (E,)

    # Gradient: g = -J^T W r, scattered to vertices.
    gi = -jnp.einsum("eab,ea,e->eb", Ji, r, w)
    gj = -jnp.einsum("eab,ea,e->eb", Jj, r, w)
    g = jnp.zeros((K, 7), jnp.float32)
    g = g.at[p.edge_i].add(gi).at[p.edge_j].add(gj)
    g = g * free * scale_mask

    # Block-diagonal preconditioner blocks.
    Hii = jnp.einsum("eab,eac,e->ebc", Ji, Ji, w)
    Hjj = jnp.einsum("eab,eac,e->ebc", Jj, Jj, w)
    Hdiag = jnp.zeros((K, 7, 7), jnp.float32)
    Hdiag = Hdiag.at[p.edge_i].add(Hii).at[p.edge_j].add(Hjj)
    Hdiag = Hdiag + 1e-5 * jnp.eye(7)
    Hdiag_inv = jnp.linalg.inv(Hdiag)

    def matvec(x):  # x: (K, 7)
        x = x * free * scale_mask
        xi = x[p.edge_i]
        xj = x[p.edge_j]
        y = jnp.einsum("eab,eb->ea", Ji, xi) + jnp.einsum(
            "eab,eb->ea", Jj, xj
        )  # (E, 7) residual-space
        y = y * w[:, None]
        out = jnp.zeros((K, 7), jnp.float32)
        out = out.at[p.edge_i].add(jnp.einsum("eab,ea->eb", Ji, y))
        out = out.at[p.edge_j].add(jnp.einsum("eab,ea->eb", Jj, y))
        out = out + 1e-5 * x  # tiny damping keeps PCG positive-definite
        return out * free * scale_mask

    def precond(x):
        return jnp.einsum("kab,kb->ka", Hdiag_inv, x) * free * scale_mask

    # PCG on H dx = g.
    x = jnp.zeros((K, 7), jnp.float32)
    rr = g - matvec(x)
    z = precond(rr)
    d = z
    rz = jnp.sum(rr * z)

    def pcg_body(state, _):
        x, rr, d, rz = state
        Hd = matvec(d)
        alpha = rz / jnp.maximum(jnp.sum(d * Hd), 1e-20)
        x = x + alpha * d
        rr = rr - alpha * Hd
        z = precond(rr)
        rz_new = jnp.sum(rr * z)
        beta = rz_new / jnp.maximum(rz, 1e-20)
        d = z + beta * d
        return (x, rr, d, rz_new), None

    (x, _, _, _), _ = jax.lax.scan(
        pcg_body, (x, rr, d, rz), None, length=pcg_iters
    )
    dx = x * free * scale_mask

    verts_new = jax.vmap(lambda xi, S: sim3.compose(sim3.exp(xi), S))(
        dx, verts
    )
    keep = (p.v_valid & ~p.v_fixed)[:, None]
    return jnp.where(keep, verts_new, verts)


@functools.partial(jax.jit, static_argnames=("pcg_iters", "fix_scale"))
def gn_step(
    p: PoseGraphProblem,
    verts: jnp.ndarray,
    pcg_iters: int = 50,
    fix_scale: bool = False,
) -> jnp.ndarray:
    """ONE jitted Gauss-Newton iteration on the pose graph.

    The chunking unit for LoopClosing's background essential-graph job:
    one step dispatched per tracked frame, so the solve interleaves with
    tracking programs on the device instead of stalling the correction frame
    (the reference runs OptimizeEssentialGraph on its loop thread while
    Tracking continues, src/LoopClosing.cc:567 / Tracking.cc:277)."""
    return _gn_iter_impl(p, verts, pcg_iters, fix_scale)


@functools.partial(jax.jit, static_argnames=("iters", "pcg_iters", "fix_scale"))
def optimize_pose_graph(
    p: PoseGraphProblem,
    iters: int = 20,
    pcg_iters: int = 50,
    fix_scale: bool = False,
) -> jnp.ndarray:
    """Returns optimized (K, 8) Sim3 vertices (whole solve in one jit —
    the unit-test / dryrun surface; the live System chunks via gn_step)."""

    def body(verts, _):
        return _gn_iter_impl(p, verts, pcg_iters, fix_scale), None

    verts, _ = jax.lax.scan(body, p.vertices, None, length=iters)
    return verts


def recover_se3(verts: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Sim3 -> (SE3 (K, 3, 4), scale (K,)): t /= s (reference:
    Optimizer.cc:991-1010)."""
    Ts = jax.vmap(sim3.to_se3)(verts)
    s = jax.vmap(sim3.scale)(verts)
    return Ts, s
