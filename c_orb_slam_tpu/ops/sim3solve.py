"""Batched Horn closed-form Sim(3) RANSAC for loop alignment.

Reference: src/Sim3Solver.cc — sequential RANSAC (5 iterations per outer
call, LoopClosing.cc:286-301) over 3-point Horn 1987 quaternion alignment
(ComputeSim3 :226-337), inliers checked by two-way reprojection
(CheckInliers :340-364); scale fixed for stereo/RGB-D (:292-311).

Array-program design: all hypotheses in one vmapped pass; the 4x4 quaternion N
matrix is diagonalized with jnp.linalg.eigh.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from c_orb_slam_tpu.geometry import se3, sim3, so3


class Sim3Result(NamedTuple):
    ok: jnp.ndarray
    S12: jnp.ndarray  # (8,) packed Sim3 mapping frame-2 coords to frame-1
    inliers: jnp.ndarray  # (M,) bool
    n_inliers: jnp.ndarray


def horn_sim3(
    p1: jnp.ndarray, p2: jnp.ndarray, fix_scale: bool = False
) -> jnp.ndarray:
    """Closed-form Sim3 aligning point sets: x1 ≈ s R x2 + t.

    p1, p2: (k, 3) corresponding points (camera-frame coordinates in the
    reference's usage). Horn 1987 quaternion method, as Sim3Solver.cc:226.
    """
    c1 = jnp.mean(p1, axis=0)
    c2 = jnp.mean(p2, axis=0)
    q1 = p1 - c1
    q2 = p2 - c2
    M = q2.T @ q1  # (3, 3): note order — maps 2 into 1

    # 4x4 symmetric N matrix from M (Horn eq. 25).
    Sxx, Sxy, Sxz = M[0, 0], M[0, 1], M[0, 2]
    Syx, Syy, Syz = M[1, 0], M[1, 1], M[1, 2]
    Szx, Szy, Szz = M[2, 0], M[2, 1], M[2, 2]
    N = jnp.array(
        [
            [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
            [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
            [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
            [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
        ]
    )
    vals, vecs = jnp.linalg.eigh(N)
    q = vecs[:, -1]  # top eigenvector = rotation quaternion (w,x,y,z)
    q = q * jnp.where(q[0] < 0, -1.0, 1.0)

    r2 = so3.rotate(q[None, :], q2)  # rotated centered set 2
    if fix_scale:
        s = jnp.asarray(1.0, p1.dtype)
    else:
        # s = dot(q1, R q2) / |q2|^2 (reference: Sim3Solver.cc:294-308).
        s = jnp.sum(q1 * r2) / jnp.maximum(jnp.sum(q2 * q2), 1e-12)
    t = c1 - s * so3.rotate(q, c2)
    return sim3.make(q, t, jnp.maximum(s, 1e-8))


def _project(K, x):
    z = jnp.maximum(x[..., 2], 1e-9)
    return jnp.stack(
        [K[0] * x[..., 0] / z + K[2], K[1] * x[..., 1] / z + K[3]], axis=-1
    )


@functools.partial(jax.jit, static_argnames=("n_hypotheses", "fix_scale", "min_inliers"))
def solve_sim3_ransac(
    x1: jnp.ndarray,
    x2: jnp.ndarray,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    valid: jnp.ndarray,
    max_err2_1: jnp.ndarray,
    max_err2_2: jnp.ndarray,
    K1: jnp.ndarray,
    K2: jnp.ndarray,
    key: jnp.ndarray,
    fix_scale: bool = False,
    n_hypotheses: int = 256,
    min_inliers: int = 20,
) -> Sim3Result:
    """RANSAC Sim3 between two keyframes' matched points.

    x1/x2: (M, 3) matched map points in each camera frame; uv1/uv2 their
    observed pixels; max_err2_*: per-match squared-pixel gates
    (9.21 * sigma2, reference Sim3Solver.cc:106-112).
    """
    m = x1.shape[0]
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = jax.random.choice(key, m, shape=(n_hypotheses, 3), replace=True, p=probs)

    S12s = jax.vmap(lambda i: horn_sim3(x1[i], x2[i], fix_scale))(idx)

    def count(S12):
        S21 = sim3.inverse(S12)
        uv2to1 = _project(K1, sim3.apply(S12, x2))
        uv1to2 = _project(K2, sim3.apply(S21, x1))
        e1 = jnp.sum((uv2to1 - uv1) ** 2, axis=-1)
        e2 = jnp.sum((uv1to2 - uv2) ** 2, axis=-1)
        inl = (e1 < max_err2_1) & (e2 < max_err2_2) & valid
        return jnp.sum(inl.astype(jnp.int32)), inl

    counts, inls = jax.vmap(count)(S12s)
    best = jnp.argmax(counts)
    n = counts[best]
    return Sim3Result(
        ok=n >= min_inliers,
        S12=S12s[best],
        inliers=inls[best],
        n_inliers=n,
    )
