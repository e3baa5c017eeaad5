"""Bundle adjustment: LM with implicit Schur-complement PCG.

Replaces g2o's BlockSolver machinery (reference:
Thirdparty/g2o/g2o/core/block_solver.hpp — buildStructure :143,
buildSystem :502, Schur solve via _Hschur/_DInvSchur :354-447, used by
Optimizer::BundleAdjustment / LocalBundleAdjustment, src/Optimizer.cc:49,453).

Array-program design (SURVEY.md §7.1): the bipartite camera-point graph is a
flat observation list (obs_cam, obs_pt index arrays). One LM iteration is:

  vmapped residuals/Jacobians  ->  segment-sum Hcc/Hpp/g  ->
  PCG on the *implicit* Schur system S dc = rhs  ->  back-substitute dp

The Schur matvec S·x = Hcc·x − W·Hpp⁻¹·Wᵀ·x never materializes S or W:
it is two gathers + two segment-sums per application — exactly the shape
that scales to sharded observation arrays with psum (parallel/dba.py).
Fixed cameras (the reference's frontier keyframes, Optimizer.cc:489-504)
are handled by zeroing their Jacobians. All shapes static; invalid slots
masked. The LM loop is a lax.scan with accept/reject damping control.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from c_orb_slam_tpu.geometry import se3
from c_orb_slam_tpu.optim import residuals as res


class BAProblem(NamedTuple):
    """Fixed-shape bundle-adjustment problem (SoA)."""

    cam_T: jnp.ndarray  # (C, 3, 4) world->cam poses
    cam_fixed: jnp.ndarray  # (C,) bool: pose held constant
    cam_valid: jnp.ndarray  # (C,) bool: slot live
    points: jnp.ndarray  # (P, 3)
    point_valid: jnp.ndarray  # (P,) bool
    obs_cam: jnp.ndarray  # (O,) int32
    obs_pt: jnp.ndarray  # (O,) int32
    obs_uv: jnp.ndarray  # (O, 3) (u, v, ur); ur ignored for mono rows
    obs_stereo: jnp.ndarray  # (O,) bool
    obs_inv_sigma2: jnp.ndarray  # (O,)
    obs_valid: jnp.ndarray  # (O,) bool
    K: jnp.ndarray  # (4,)
    bf: jnp.ndarray  # () float


class BAResult(NamedTuple):
    cam_T: jnp.ndarray
    points: jnp.ndarray
    obs_inlier: jnp.ndarray  # (O,) bool post-optimization gate
    final_chi2: jnp.ndarray  # () mean inlier chi2


def _obs_terms(p: BAProblem, cam_T, points, use_huber, chi2_mono, chi2_stereo):
    """Residuals, Jacobians, IRLS weights for every observation."""
    T = cam_T[p.obs_cam]  # (O, 3, 4)
    xw = points[p.obs_pt]  # (O, 3)
    r, Jc, Jp = res.residual_and_jacobians(
        T, xw, p.obs_uv, p.K, p.bf, p.obs_stereo
    )
    c2 = res.chi2(r, p.obs_inv_sigma2)
    chi2_th = jnp.where(p.obs_stereo, chi2_stereo, chi2_mono)
    w = p.obs_inv_sigma2 * p.obs_valid.astype(r.dtype)
    if use_huber:
        w = w * res.huber_weight(c2, chi2_th)
    # Behind-camera points poison the linearization: drop them this iter.
    z = se3.apply(T, xw)[..., 2]
    w = w * (z > 1e-3).astype(r.dtype)
    # Fixed cameras contribute no pose Jacobian.
    Jc = Jc * (1.0 - p.cam_fixed[p.obs_cam].astype(r.dtype))[:, None, None]
    return r, Jc, Jp, w, c2


def _assemble(p: BAProblem, r, Jc, Jp, w, lm_lambda, obs_pt_sorted=False):
    """Normal-equation blocks. Camera-side reductions go through a
    one-hot f32 matmul instead of a scatter-add (a formulation chosen for
    an earlier accelerator's serialized scatter; whether it pays on the
    H100 is not measured), and point-side reductions
    use segment_sum (fast when observations are pre-sorted by point —
    optimize() sorts once per call)."""
    C = p.cam_T.shape[0]
    P = p.points.shape[0]
    oh_c = jax.nn.one_hot(p.obs_cam, C, dtype=r.dtype)  # (O, C)
    cam_blocks = jnp.concatenate(
        [
            jnp.einsum("nij,nik,n->njk", Jc, Jc, w).reshape(-1, 36),
            jnp.einsum("nij,ni,n->nj", Jc, r, w),
        ],
        axis=1,
    )  # (O, 42)
    cam_acc = jnp.dot(oh_c.T, cam_blocks, preferred_element_type=r.dtype)
    Hcc = cam_acc[:, :36].reshape(C, 6, 6)
    gc = cam_acc[:, 36:]
    pt_blocks = jnp.concatenate(
        [
            jnp.einsum("nij,nik,n->njk", Jp, Jp, w).reshape(-1, 9),
            jnp.einsum("nij,ni,n->nj", Jp, r, w),
        ],
        axis=1,
    )  # (O, 12)
    pt_acc = jax.ops.segment_sum(
        pt_blocks, p.obs_pt, num_segments=P, indices_are_sorted=obs_pt_sorted
    )
    Hpp = pt_acc[:, :9].reshape(P, 3, 3)
    gp = pt_acc[:, 9:]
    eye6 = jnp.eye(6, dtype=r.dtype)
    eye3 = jnp.eye(3, dtype=r.dtype)
    # LM damping; dead camera/point slots get identity so inverses exist.
    free_cam = (p.cam_valid & ~p.cam_fixed).astype(r.dtype)[:, None, None]
    Hcc = Hcc + lm_lambda * eye6 + (1.0 - free_cam) * eye6
    live_pt = p.point_valid.astype(r.dtype)[:, None, None]
    Hpp = Hpp + lm_lambda * eye3 + (1.0 - live_pt) * eye3
    Hpp_inv = _inv3x3(Hpp)
    return Hcc, Hpp_inv, gc, gp


def _inv3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form batched 3x3 inverse (adjugate / determinant): pure
    elementwise math instead of batched LU (g2o marginalizes point
    blocks the same way, block_solver.hpp:354-447)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    adj = jnp.stack(
        [
            jnp.stack([A00, A01, A02], axis=-1),
            jnp.stack([A10, A11, A12], axis=-1),
            jnp.stack([A20, A21, A22], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def _schur_matvec(
    p: BAProblem, Jc, Jp, w, Hcc, Hpp_inv, x, free_cam_mask,
    obs_pt_sorted=False,
):
    """S @ x without materializing S. x: (C, 6)."""
    P = Hpp_inv.shape[0]
    x = x * free_cam_mask[:, None]
    hx = jnp.einsum("cij,cj->ci", Hcc, x)
    u = jnp.einsum("nij,nj->ni", Jc, x[p.obs_cam]) * w[:, None]  # (O, 3)
    v = jax.ops.segment_sum(
        jnp.einsum("nij,ni->nj", Jp, u), p.obs_pt, num_segments=P,
        indices_are_sorted=obs_pt_sorted,
    )  # (P, 3) = Wᵀ x
    y = jnp.einsum("pij,pj->pi", Hpp_inv, v)
    s = jnp.einsum("nij,nj->ni", Jp, y[p.obs_pt]) * w[:, None]  # (O, 3)
    oh_c = jax.nn.one_hot(p.obs_cam, x.shape[0], dtype=x.dtype)
    z = jnp.dot(
        oh_c.T, jnp.einsum("nij,ni->nj", Jc, s),
        preferred_element_type=x.dtype,
    )  # (C, 6) = W y
    return (hx - z) * free_cam_mask[:, None]


def _pcg(matvec, precond, b, iters):
    """Fixed-iteration preconditioned conjugate gradients."""
    x = jnp.zeros_like(b)
    r = b
    z = precond(r)
    d = z
    rz = jnp.sum(r * z)

    def body(state, _):
        x, r, d, rz = state
        Ad = matvec(d)
        dAd = jnp.sum(d * Ad)
        alpha = rz / jnp.maximum(dAd, 1e-20)
        x = x + alpha * d
        r = r - alpha * Ad
        z = precond(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.maximum(rz, 1e-20)
        d = z + beta * d
        return (x, r, d, rz_new), None

    (x, _, _, _), _ = jax.lax.scan(body, (x, r, d, rz), None, length=iters)
    return x


def _solve_cameras_dense(p: BAProblem, Jc, Jp, w, Hcc, Hpp_inv, gc, gp, free_cam):
    """Explicit dense Schur complement + direct solve.

    For windowed/local BA the reduced camera system is small (6C x 6C with
    C <= ~64), so forming S = Hcc - W Hpp^-1 Wt as ONE big matmul and
    solving directly is far cheaper than a long sequential PCG
    chain (the reference's g2o does exactly this dense-Schur route,
    block_solver.hpp:354-447 with a dense-Cholesky linear solver).
    Returns dc (C, 6)."""
    C = p.cam_T.shape[0]
    P = p.points.shape[0]
    dt = gc.dtype
    # Dense W (6C x 3P): per-observation 6x3 blocks accumulated by the
    # flat (point, camera) key with segment_sum (obs pre-sorted by point
    # in optimize(), so the keys are near-sorted — fast path).
    B = jnp.einsum("nij,nik,n->njk", Jc, Jp, w)  # (O, 6, 3)
    key = p.obs_pt * C + p.obs_cam
    Wpc = jax.ops.segment_sum(
        B.reshape(-1, 18), key, num_segments=P * C
    )  # (P*C, 18)
    W = (
        Wpc.reshape(P, C, 6, 3)
        .transpose(1, 2, 0, 3)
        .reshape(C * 6, P * 3)
    )
    # W Hpp^-1 (blockwise), then S and rhs.
    WH = jnp.einsum(
        "cpj,pjk->cpk", W.reshape(C * 6, P, 3), Hpp_inv
    )  # (6C, P, 3)
    S = -jnp.dot(
        WH.reshape(C * 6, P * 3), W.T, preferred_element_type=jnp.float32
    )
    # Add the Hcc block diagonal.
    bi = (jnp.arange(C) * 6)[:, None, None] + jnp.arange(6)[None, :, None]
    bj = (jnp.arange(C) * 6)[:, None, None] + jnp.arange(6)[None, None, :]
    S = S.at[
        jnp.broadcast_to(bi, (C, 6, 6)), jnp.broadcast_to(bj, (C, 6, 6))
    ].add(Hcc)
    rhs = -(gc - jnp.einsum("cpj,pj->c", WH, gp).reshape(C, 6))
    # Fixed/dead cameras: identity rows/cols, zero rhs.
    free6 = jnp.repeat(free_cam, 6)
    S = S * free6[:, None] * free6[None, :] + jnp.diag(1.0 - free6)
    rhs = rhs * free_cam[:, None]
    # S is SPD after masking: Cholesky solve.
    dc = jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(S), rhs.reshape(C * 6)
    ).reshape(C, 6)
    return dc * free_cam[:, None]


def ba_iteration(
    p: BAProblem,
    lm_lambda,
    use_huber: bool,
    chi2_mono: float,
    chi2_stereo: float,
    pcg_iters: int,
    schur: str = "pcg",
    obs_pt_sorted: bool = False,
):
    """One damped GN step. Returns (new_cam_T, new_points, total_error)."""
    r, Jc, Jp, w, c2 = _obs_terms(
        p, p.cam_T, p.points, use_huber, chi2_mono, chi2_stereo
    )
    Hcc, Hpp_inv, gc, gp = _assemble(
        p, r, Jc, Jp, w, lm_lambda, obs_pt_sorted=obs_pt_sorted
    )
    free_cam = (p.cam_valid & ~p.cam_fixed).astype(r.dtype)
    P = p.points.shape[0]

    def back_substitute(dc):
        # dp = Hpp^{-1} (-gp - Wᵀ dc)
        u = jnp.einsum("nij,nj->ni", Jc, dc[p.obs_cam]) * w[:, None]
        Wt_dc = jax.ops.segment_sum(
            jnp.einsum("nij,ni->nj", Jp, u), p.obs_pt, num_segments=P,
            indices_are_sorted=obs_pt_sorted,
        )
        dp = jnp.einsum("pij,pj->pi", Hpp_inv, -gp - Wt_dc)
        return dp * p.point_valid.astype(dp.dtype)[:, None]

    if schur == "dense":
        dc = _solve_cameras_dense(
            p, Jc, Jp, w, Hcc, Hpp_inv, gc, gp, free_cam
        )
    else:
        # Schur RHS: -(gc - W Hpp^{-1} gp)
        y = jnp.einsum("pij,pj->pi", Hpp_inv, gp)
        s = jnp.einsum("nij,nj->ni", Jp, y[p.obs_pt]) * w[:, None]
        oh_c = jax.nn.one_hot(p.obs_cam, gc.shape[0], dtype=gc.dtype)
        Wy = jnp.dot(
            oh_c.T, jnp.einsum("nij,ni->nj", Jc, s),
            preferred_element_type=gc.dtype,
        )
        rhs = -(gc - Wy) * free_cam[:, None]

        Hcc_inv = jnp.linalg.inv(Hcc)

        def matvec(x):
            return _schur_matvec(
                p, Jc, Jp, w, Hcc, Hpp_inv, x, free_cam,
                obs_pt_sorted=obs_pt_sorted,
            )

        def precond(x):
            return jnp.einsum("cij,cj->ci", Hcc_inv, x) * free_cam[:, None]

        dc = _pcg(matvec, precond, rhs, pcg_iters)  # (C, 6)

    dp = back_substitute(dc)
    new_T = jax.vmap(lambda d, T: se3.compose(se3.exp(d), T))(dc, p.cam_T)
    new_T = jnp.where(free_cam[:, None, None] > 0, new_T, p.cam_T)
    return new_T, p.points + dp, dc, dp


def _total_error(p, cam_T, points, use_huber, chi2_mono, chi2_stereo):
    r, _, _, w, c2 = _obs_terms(
        p, cam_T, points, use_huber, chi2_mono, chi2_stereo
    )
    chi2_th = jnp.where(p.obs_stereo, chi2_stereo, chi2_mono)
    mask = p.obs_valid.astype(r.dtype)
    # Huber-robustified total (rho(chi2)), like g2o's activeRobustChi2.
    robust = jnp.where(
        c2 <= chi2_th,
        c2,
        2.0 * jnp.sqrt(chi2_th) * jnp.sqrt(jnp.maximum(c2, 1e-12)) - chi2_th,
    )
    return jnp.sum((robust if use_huber else c2) * mask)


@functools.partial(
    jax.jit,
    static_argnames=(
        "iters", "use_huber", "chi2_mono", "chi2_stereo", "pcg_iters",
        "schur",
    ),
)
def optimize(
    p: BAProblem,
    iters: int = 10,
    use_huber: bool = True,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    pcg_iters: int = 40,
    lm_lambda0: float = 1e-4,
    schur: str = "pcg",
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """LM loop with accept/reject damping. Returns (cam_T, points).

    schur="dense" forms the reduced camera system explicitly (one
    matmul + direct solve — right for windowed/local problems);
    schur="pcg" keeps the implicit matrix-free solve (right for global
    BA, where the dense W would not fit)."""
    # Sort observations by (point, camera) once: every per-point reduction
    # in the LM loop becomes a sorted segment_sum (XLA's fast path).
    C = p.cam_T.shape[0]
    perm = jnp.argsort(p.obs_pt * C + p.obs_cam)
    p = p._replace(
        obs_cam=p.obs_cam[perm],
        obs_pt=p.obs_pt[perm],
        obs_uv=p.obs_uv[perm],
        obs_stereo=p.obs_stereo[perm],
        obs_inv_sigma2=p.obs_inv_sigma2[perm],
        obs_valid=p.obs_valid[perm],
    )

    def body(state, _):
        cam_T, points, lam, err = state
        p_cur = p._replace(cam_T=cam_T, points=points)
        new_T, new_pts, _, _ = ba_iteration(
            p_cur, lam, use_huber, chi2_mono, chi2_stereo, pcg_iters,
            schur=schur, obs_pt_sorted=True,
        )
        new_err = _total_error(
            p, new_T, new_pts, use_huber, chi2_mono, chi2_stereo
        )
        accept = new_err < err
        cam_T = jnp.where(accept, new_T, cam_T)
        points = jnp.where(accept, new_pts, points)
        lam = jnp.where(accept, lam * 0.5, lam * 4.0)
        err = jnp.where(accept, new_err, err)
        return (cam_T, points, lam, err), None

    err0 = _total_error(
        p, p.cam_T, p.points, use_huber, chi2_mono, chi2_stereo
    )
    (cam_T, points, _, _), _ = jax.lax.scan(
        body,
        (p.cam_T, p.points, jnp.asarray(lm_lambda0, jnp.float32), err0),
        None,
        length=iters,
    )
    return cam_T, points


def sort_by_point(p: BAProblem) -> BAProblem:
    """Sort observations by (point, camera) so per-point segment_sums take
    XLA's sorted fast path (optimize() does this internally; the chunked
    lm_step API expects the caller to sort ONCE up front)."""
    C = p.cam_T.shape[0]
    perm = jnp.argsort(p.obs_pt * C + p.obs_cam)
    return p._replace(
        obs_cam=p.obs_cam[perm],
        obs_pt=p.obs_pt[perm],
        obs_uv=p.obs_uv[perm],
        obs_stereo=p.obs_stereo[perm],
        obs_inv_sigma2=p.obs_inv_sigma2[perm],
        obs_valid=p.obs_valid[perm],
    )


@functools.partial(
    jax.jit,
    static_argnames=("use_huber", "chi2_mono", "chi2_stereo"),
)
def stage_error(
    p: BAProblem,
    use_huber: bool = True,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
) -> jnp.ndarray:
    """Initial total error for an LM stage (pairs with lm_step)."""
    return _total_error(
        p, p.cam_T, p.points, use_huber, chi2_mono, chi2_stereo
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "use_huber", "chi2_mono", "chi2_stereo", "pcg_iters", "schur",
    ),
)
def lm_step(
    p: BAProblem,
    lam: jnp.ndarray,
    err: jnp.ndarray,
    use_huber: bool = True,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    pcg_iters: int = 40,
    schur: str = "pcg",
):
    """ONE damped LM iteration with accept/reject, as a standalone jitted
    program: the incremental (spread-across-frames) global BA dispatches
    one of these per tracked frame instead of a single monolithic solve,
    so tracking programs interleave with the solve on the device — the
    functional analog of the reference's background GBA thread
    (LoopClosing.cc:645-749). The problem must be pre-sorted with
    sort_by_point(). Returns (cam_T, points, lam, err)."""
    new_T, new_pts, _, _ = ba_iteration(
        p, lam, use_huber, chi2_mono, chi2_stereo, pcg_iters,
        schur=schur, obs_pt_sorted=True,
    )
    new_err = _total_error(
        p, new_T, new_pts, use_huber, chi2_mono, chi2_stereo
    )
    accept = new_err < err
    cam_T = jnp.where(accept, new_T, p.cam_T)
    points = jnp.where(accept, new_pts, p.points)
    lam = jnp.where(accept, lam * 0.5, lam * 4.0)
    err = jnp.where(accept, new_err, err)
    return cam_T, points, lam, err


def classify_inliers(
    p: BAProblem, chi2_mono: float = 5.991, chi2_stereo: float = 7.815
) -> jnp.ndarray:
    """Post-optimization observation gate: chi2 within threshold AND
    positive depth (reference: Optimizer.cc:676-705 outlier erase)."""
    T = p.cam_T[p.obs_cam]
    xw = p.points[p.obs_pt]
    r, _, _ = res.residual_and_jacobians(
        T, xw, p.obs_uv, p.K, p.bf, p.obs_stereo
    )
    c2 = res.chi2(r, p.obs_inv_sigma2)
    chi2_th = jnp.where(p.obs_stereo, chi2_stereo, chi2_mono)
    z = se3.apply(T, xw)[..., 2]
    return p.obs_valid & (c2 <= chi2_th) & (z > 0)


@functools.partial(
    jax.jit,
    static_argnames=(
        "iters_first", "iters_second", "chi2_mono", "chi2_stereo",
        "pcg_iters", "schur",
    ),
)
def bundle_adjust(
    p: BAProblem,
    iters_first: int = 5,
    iters_second: int = 10,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    pcg_iters: int = 40,
    schur: str = "pcg",
) -> BAResult:
    """Two-stage BA with outlier re-classification between stages
    (reference: Optimizer.cc:659-709 LocalBundleAdjustment flow).

    Jitted end-to-end: no eager op-by-op dispatch between the stages."""
    cam_T, points = optimize(
        p, iters=iters_first, use_huber=True,
        chi2_mono=chi2_mono, chi2_stereo=chi2_stereo, pcg_iters=pcg_iters,
        schur=schur,
    )
    p = p._replace(cam_T=cam_T, points=points)
    inlier = classify_inliers(p, chi2_mono, chi2_stereo)
    p = p._replace(obs_valid=inlier)
    cam_T, points = optimize(
        p, iters=iters_second, use_huber=False,
        chi2_mono=chi2_mono, chi2_stereo=chi2_stereo, pcg_iters=pcg_iters,
        schur=schur,
    )
    p = p._replace(cam_T=cam_T, points=points)
    inlier = classify_inliers(p, chi2_mono, chi2_stereo)

    T = cam_T[p.obs_cam]
    r, _, _ = res.residual_and_jacobians(
        T, points[p.obs_pt], p.obs_uv, p.K, p.bf, p.obs_stereo
    )
    c2 = res.chi2(r, p.obs_inv_sigma2)
    n = jnp.maximum(jnp.sum(inlier.astype(jnp.float32)), 1.0)
    mean_chi2 = jnp.sum(jnp.where(inlier, c2, 0.0)) / n
    return BAResult(cam_T=cam_T, points=points, obs_inlier=inlier, final_chi2=mean_chi2)
