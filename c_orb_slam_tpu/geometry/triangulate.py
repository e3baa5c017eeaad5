"""Two-view triangulation, batched.

Replaces the per-match SVD-DLT loops in the reference
(reference: src/Initializer.cc:734-747 Triangulate,
src/LocalMapping.cc:322-337 CreateNewMapPoints) with a vmapped linear
triangulation over all candidate matches at once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from c_orb_slam_tpu.geometry import se3


def projection_matrix(T: jnp.ndarray, K: jnp.ndarray) -> jnp.ndarray:
    """3x4 projection P = K_mat @ [R | t] from a (3,4) pose and (4,) K."""
    Km = jnp.array(
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], dtype=T.dtype
    )
    Km = Km.at[0, 0].set(K[0]).at[1, 1].set(K[1]).at[0, 2].set(K[2]).at[1, 2].set(K[3])
    return Km @ T


def triangulate_dlt(
    uv1: jnp.ndarray, uv2: jnp.ndarray, P1: jnp.ndarray, P2: jnp.ndarray
) -> jnp.ndarray:
    """Linear (DLT) triangulation of pixel pairs.

    uv1, uv2: (N, 2) pixel coords; P1, P2: (3, 4) projection matrices.
    Returns (N, 3) world points.

    The reference solves the homogeneous system with a per-point SVD
    (Initializer.cc:744). Batched tiny SVDs lower to iterative Jacobi
    sweeps, far more work than the matching around them. Instead we
    fix X4=1 (inhomogeneous DLT) and solve the 3x3 normal equations in
    closed form via the adjugate — a handful of fused elementwise ops. Points
    where the X4=1 chart degenerates (near infinity / zero parallax)
    produce wild solutions that the caller's depth/parallax/reprojection
    gates cull, exactly as they cull the SVD version's low-parallax
    points.
    """

    def rows(u, P):
        return jnp.stack([u[..., 0:1] * P[2] - P[0], u[..., 1:2] * P[2] - P[1]], -2)

    A = jnp.concatenate([rows(uv1, P1), rows(uv2, P2)], axis=-2)  # (N, 4, 4)
    A = A / jnp.maximum(jnp.linalg.norm(A, axis=-1, keepdims=True), 1e-12)
    B = A[..., :3]  # (N, 4, 3)
    c = A[..., 3]  # (N, 4)
    H = jnp.einsum("nij,nik->njk", B, B)  # (N, 3, 3) BᵀB
    g = -jnp.einsum("nij,ni->nj", B, c)  # (N, 3) -Bᵀc
    # Adjugate solve: x = adj(H) g / det(H).
    a, b_, cc = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 1], H[..., 1, 2], H[..., 2, 2]
    A00 = d * f - e * e
    A01 = cc * e - b_ * f
    A02 = b_ * e - cc * d
    A11 = a * f - cc * cc
    A12 = cc * b_ - a * e
    A22 = a * d - b_ * b_
    det = a * A00 + b_ * A01 + cc * A02
    adj = jnp.stack(
        [
            jnp.stack([A00, A01, A02], -1),
            jnp.stack([A01, A11, A12], -1),
            jnp.stack([A02, A12, A22], -1),
        ],
        -2,
    )
    inv_det = jnp.where(jnp.abs(det) < 1e-18, 0.0, 1.0 / det)
    return jnp.einsum("nij,nj->ni", adj, g) * inv_det[..., None]


def triangulate_rays(
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    T1w: jnp.ndarray,
    T2w: jnp.ndarray,
    K1: jnp.ndarray,
    K2: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Triangulate + parallax cosine, from camera poses (world->cam).

    Returns (points_world (N,3), cos_parallax (N,)). The parallax cosine
    feeds the acceptance gate the reference applies per new map point
    (reference: LocalMapping.cc:299-320).
    """
    P1 = projection_matrix(T1w, K1)
    P2 = projection_matrix(T2w, K2)
    xw = triangulate_dlt(uv1, uv2, P1, P2)

    c1 = se3.translation(se3.inverse(T1w))
    c2 = se3.translation(se3.inverse(T2w))
    r1 = xw - c1
    r2 = xw - c2
    cos_par = jnp.sum(r1 * r2, axis=-1) / jnp.maximum(
        jnp.linalg.norm(r1, axis=-1) * jnp.linalg.norm(r2, axis=-1), 1e-12
    )
    return xw, cos_par


def depth_in(T: jnp.ndarray, xw: jnp.ndarray) -> jnp.ndarray:
    """z-coordinate of world points in camera frame T (world->cam)."""
    return se3.apply(T, xw)[..., 2]
