"""Pinhole camera model with radial-tangential distortion.

array-program replacement for the reference's scattered OpenCV calls:
- cv::undistortPoints (reference: src/Frame.cc:404-434 UndistortKeyPoints)
  becomes an iterative fixed-point undistortion, vmapped over keypoints.
- projection helpers used by matchers/optimizers (reference:
  src/ORBmatcher.cc:57-66, src/Optimizer.cc edge cam_project) become pure
  functions with analytic Jacobians for the GN engine.

Intrinsics are passed as a flat (4,) array [fx, fy, cx, cy]; distortion as a
(5,) array [k1, k2, p1, p2, k3]. All functions are batch-friendly.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-8


def intrinsics_array(cam) -> jnp.ndarray:
    return jnp.array([cam.fx, cam.fy, cam.cx, cam.cy], dtype=jnp.float32)


def distortion_array(cam) -> jnp.ndarray:
    return jnp.array([cam.k1, cam.k2, cam.p1, cam.p2, cam.k3], dtype=jnp.float32)


def project(xc: jnp.ndarray, K: jnp.ndarray) -> jnp.ndarray:
    """Camera-frame 3D point(s) -> pixel(s). No distortion (the reference
    tracks on *undistorted* keypoints, so internal projections are ideal
    pinhole; reference: Frame.cc:404, Optimizer.cc cam_project)."""
    z = jnp.maximum(xc[..., 2], _EPS)
    u = K[..., 0] * xc[..., 0] / z + K[..., 2]
    v = K[..., 1] * xc[..., 1] / z + K[..., 3]
    return jnp.stack([u, v], axis=-1)


def project_stereo(xc: jnp.ndarray, K: jnp.ndarray, bf) -> jnp.ndarray:
    """(u_left, v, u_right) triplet as used by stereo edges
    (reference: types_six_dof_expmap EdgeStereoSE3ProjectXYZ)."""
    z = jnp.maximum(xc[..., 2], _EPS)
    u = K[..., 0] * xc[..., 0] / z + K[..., 2]
    v = K[..., 1] * xc[..., 1] / z + K[..., 3]
    ur = u - bf / z
    return jnp.stack([u, v, ur], axis=-1)


def backproject(uv: jnp.ndarray, z: jnp.ndarray, K: jnp.ndarray) -> jnp.ndarray:
    """Pixel + depth -> camera-frame 3D (reference: Frame.cc:666
    UnprojectStereo)."""
    x = (uv[..., 0] - K[..., 2]) * z / K[..., 0]
    y = (uv[..., 1] - K[..., 3]) * z / K[..., 1]
    return jnp.stack([x, y, z], axis=-1)


def distort_normalized(xn: jnp.ndarray, dist: jnp.ndarray) -> jnp.ndarray:
    """Apply radial-tangential distortion to normalized coords (x, y)."""
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return jnp.stack([xd, yd], axis=-1)


def undistort_points(
    uv: jnp.ndarray, K: jnp.ndarray, dist: jnp.ndarray, iters: int = 8
) -> jnp.ndarray:
    """Undistort pixel coordinates by fixed-point iteration (the same
    scheme cv::undistortPoints uses; reference: Frame.cc:420-431).

    uv: (..., 2) distorted pixels -> undistorted pixels under the same K.
    """
    xn = jnp.stack(
        [
            (uv[..., 0] - K[..., 2]) / K[..., 0],
            (uv[..., 1] - K[..., 3]) / K[..., 1],
        ],
        axis=-1,
    )
    x = xn
    for _ in range(iters):
        d = distort_normalized(x, dist)
        x = x + (xn - d)
    u = K[..., 0] * x[..., 0] + K[..., 2]
    v = K[..., 1] * x[..., 1] + K[..., 3]
    return jnp.stack([u, v], axis=-1)


def project_jacobian_point(xc: jnp.ndarray, K: jnp.ndarray) -> jnp.ndarray:
    """d(u,v)/d(xc): (..., 2, 3) Jacobian of pinhole projection w.r.t. the
    camera-frame point (used for both pose and point Jacobians via chain
    rule; reference analytic form: types_six_dof_expmap.cpp:103-140)."""
    fx, fy = K[..., 0], K[..., 1]
    x, y = xc[..., 0], xc[..., 1]
    z = jnp.maximum(xc[..., 2], _EPS)
    zinv = 1.0 / z
    zinv2 = zinv * zinv
    zero = jnp.zeros_like(x)
    row_u = jnp.stack([fx * zinv, zero, -fx * x * zinv2], axis=-1)
    row_v = jnp.stack([zero, fy * zinv, -fy * y * zinv2], axis=-1)
    return jnp.stack([row_u, row_v], axis=-2)


def project_stereo_jacobian_point(
    xc: jnp.ndarray, K: jnp.ndarray, bf
) -> jnp.ndarray:
    """d(u,v,ur)/d(xc): (..., 3, 3)."""
    J2 = project_jacobian_point(xc, K)
    z = jnp.maximum(xc[..., 2], _EPS)
    zinv2 = 1.0 / (z * z)
    zero = jnp.zeros_like(z)
    row_ur = J2[..., 0, :] + jnp.stack([zero, zero, bf * zinv2], axis=-1)
    return jnp.concatenate([J2, row_ur[..., None, :]], axis=-2)
