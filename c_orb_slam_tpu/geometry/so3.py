"""SO(3) rotations: exp/log maps, quaternion conversions.

Pure, vmappable functions over float32 arrays — the array-program replacement
for the Eigen/g2o rotation plumbing the reference leans on
(reference: Thirdparty/g2o/g2o/types/se3quat.h, src/Converter.cc).

All functions take/return plain jnp arrays; batch with jax.vmap.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-8


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """3-vector -> skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zeros, -wz, wy], axis=-1),
            jnp.stack([wz, zeros, -wx], axis=-1),
            jnp.stack([-wy, wx, zeros], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jnp.ndarray) -> jnp.ndarray:
    return jnp.stack(
        [W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1
    )


def exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: axis-angle 3-vector -> rotation matrix.

    Taylor-safe near zero so it is jit/grad friendly.
    """
    theta2 = jnp.sum(w * w, axis=-1, keepdims=True)[..., None]
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS**2))
    small = theta2 < _EPS
    # sin(t)/t and (1-cos t)/t^2 with Taylor fallbacks.
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    W = hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a * W + b * (W @ W)


def log(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> axis-angle 3-vector (|w| < pi).

    Uses the quaternion route for numerical robustness near pi.
    """
    return quat_log(from_matrix(R))


def left_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """SO(3) left Jacobian J_l(w) (used by SE(3)/Sim(3) exp)."""
    theta2 = jnp.sum(w * w, axis=-1, keepdims=True)[..., None]
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS**2))
    small = theta2 < _EPS
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    c = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta)
    )
    W = hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + b * W + c * (W @ W)


def left_jacobian_inv(w: jnp.ndarray) -> jnp.ndarray:
    theta2 = jnp.sum(w * w, axis=-1, keepdims=True)[..., None]
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS**2))
    small = theta2 < _EPS
    half = theta / 2.0
    cot = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * jnp.cos(half) / jnp.maximum(jnp.sin(half), _EPS)) / theta2,
    )
    W = hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - 0.5 * W + cot * (W @ W)


# --- quaternions (w, x, y, z), Hamilton convention -------------------------


def quat_normalize(q: jnp.ndarray) -> jnp.ndarray:
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q / jnp.maximum(n, _EPS)


def quat_multiply(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion -> rotation matrix."""
    q = quat_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def from_matrix(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> unit quaternion (w>=0), branch-free (Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate quaternions (un-normalized) from the four diagonals.
    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)

    scores = jnp.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        axis=-1,
    )
    best = jnp.argmax(scores, axis=-1)
    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # (..., 4, 4)
    q = jnp.take_along_axis(cands, best[..., None, None].astype(jnp.int32), axis=-2)[
        ..., 0, :
    ]
    q = quat_normalize(q)
    # Canonicalize sign: w >= 0.
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def quat_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Axis-angle -> unit quaternion."""
    theta2 = jnp.sum(w * w, axis=-1, keepdims=True)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS**2))
    small = theta2 < _EPS
    half = theta / 2.0
    s = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / theta)
    cw = jnp.where(small[..., 0], 1.0 - theta2[..., 0] / 8.0, jnp.cos(half[..., 0]))
    return jnp.concatenate([cw[..., None], s * w], axis=-1)


def quat_log(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion -> axis-angle (|w| < pi when q has w>=0)."""
    q = quat_normalize(q)
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
    v = q[..., 1:]
    # Safe norm: jnp.linalg.norm has a NaN gradient at v = 0 (0/0 in the
    # VJP), which poisons jacrev of any residual built on quat_log at the
    # identity — the common linearization point of pose-graph edges.
    sv = jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), _EPS**2))
    w = q[..., :1]
    angle = 2.0 * jnp.arctan2(sv, w)
    scale = jnp.where(sv < _EPS, 2.0 / jnp.maximum(w, _EPS), angle / jnp.maximum(sv, _EPS))
    return scale * v


def rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vector(s) v by quaternion q without building the matrix."""
    u = q[..., 1:]
    w = q[..., :1]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))
