"""Two-view monocular initialization: batched H/F RANSAC + reconstruction.

Reference: src/Initializer.cc — 200 sequential RANSAC iterations on two
CPU threads (one for homography H, one for fundamental F,
Initializer.cc:104-109), model selection by score ratio RH>0.40 (:112-118),
then motion recovery: ReconstructF (:470-570, E-decomposition with
cheirality disambiguation CheckRT :798-907) or ReconstructH (:572-732,
Faugeras 8-hypothesis decomposition).

Array-program design: ALL hypotheses for BOTH models are evaluated in one
vmapped pass (SURVEY.md §7.1 "everything RANSAC becomes batched") — there is no
iterate loop at all; candidate motions from both decompositions are scored by a
single batched cheirality/parallax check.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from c_orb_slam_tpu.geometry import se3

CHI2_2DOF = 5.991
CHI2_1DOF = 3.841


class TwoViewResult(NamedTuple):
    ok: jnp.ndarray  # () bool
    T21: jnp.ndarray  # (3, 4) pose of view 2 w.r.t. view 1 (world = view 1)
    points: jnp.ndarray  # (M, 3) triangulated points in view-1 frame
    good: jnp.ndarray  # (M,) bool triangulation-accepted matches
    used_homography: jnp.ndarray  # () bool
    score_h: jnp.ndarray
    score_f: jnp.ndarray


def _normalize(uv: jnp.ndarray, valid: jnp.ndarray):
    """Zero-mean / unit-mean-abs-dev normalization (reference:
    Initializer.cc:749-795). Returns (normalized (M,2), T (3,3))."""
    w = valid.astype(uv.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(uv * w[:, None], axis=0) / n
    d = (uv - mean) * w[:, None]
    mdev = jnp.sum(jnp.abs(d), axis=0) / n
    s = 1.0 / jnp.maximum(mdev, 1e-8)
    un = (uv - mean) * s
    T = jnp.array(
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], dtype=uv.dtype
    )
    T = T.at[0, 0].set(s[0]).at[1, 1].set(s[1])
    T = T.at[0, 2].set(-mean[0] * s[0]).at[1, 2].set(-mean[1] * s[1])
    return un, T


def _sample_indices(key, n_hyp: int, m: int, valid, k: int = 8):
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    return jax.random.choice(key, m, shape=(n_hyp, k), replace=True, p=probs)


def _solve_nullvec(A: jnp.ndarray) -> jnp.ndarray:
    """min |A v|, |v|=1 via smallest eigenvector of AᵀA. A: (..., R, 9)."""
    AtA = jnp.einsum("...ri,...rj->...ij", A, A)
    _, V = jnp.linalg.eigh(AtA)
    return V[..., :, 0]


def _fundamental_from_sets(p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """8-point F for each hypothesis set. p1, p2: (B, 8, 2) normalized.

    Reference: Initializer.cc:268-303 ComputeF21 (+ rank-2 projection).
    """
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    ones = jnp.ones_like(x1)
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], axis=-1
    )  # (B, 8, 9)
    f = _solve_nullvec(A)
    F = f.reshape(*f.shape[:-1], 3, 3)
    U, S, Vt = jnp.linalg.svd(F)
    S = S.at[..., 2].set(0.0)
    return U @ (S[..., :, None] * Vt)


def _homography_from_sets(p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """DLT H (p2 ~ H p1) per hypothesis set (B, 8, 2) -> (B, 3, 3).

    Reference: Initializer.cc:226-266 ComputeH21.
    """
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    zeros = jnp.zeros_like(x1)
    ones = jnp.ones_like(x1)
    rows_a = jnp.stack(
        [zeros, zeros, zeros, -x1, -y1, -ones, y2 * x1, y2 * y1, y2], axis=-1
    )
    rows_b = jnp.stack(
        [x1, y1, ones, zeros, zeros, zeros, -x2 * x1, -x2 * y1, -x2], axis=-1
    )
    A = jnp.concatenate([rows_a, rows_b], axis=-2)  # (B, 16, 9)
    h = _solve_nullvec(A)
    return h.reshape(*h.shape[:-1], 3, 3)


def _refit_f(n1, n2, w):
    """Weighted all-inlier 8-point refit (goes beyond the reference, which
    keeps the raw best minimal-set model; one 9x9 eigh)."""
    x1, y1 = n1[:, 0], n1[:, 1]
    x2, y2 = n2[:, 0], n2[:, 1]
    ones = jnp.ones_like(x1)
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], axis=-1
    ) * jnp.sqrt(w)[:, None]
    f = _solve_nullvec(A)
    F = f.reshape(3, 3)
    U, S, Vt = jnp.linalg.svd(F)
    S = S.at[2].set(0.0)
    return U @ (S[:, None] * Vt)


def _refit_h(n1, n2, w):
    x1, y1 = n1[:, 0], n1[:, 1]
    x2, y2 = n2[:, 0], n2[:, 1]
    zeros = jnp.zeros_like(x1)
    ones = jnp.ones_like(x1)
    sw = jnp.sqrt(w)[:, None]
    rows_a = jnp.stack(
        [zeros, zeros, zeros, -x1, -y1, -ones, y2 * x1, y2 * y1, y2], axis=-1
    ) * sw
    rows_b = jnp.stack(
        [x1, y1, ones, zeros, zeros, zeros, -x2 * x1, -x2 * y1, -x2], axis=-1
    ) * sw
    A = jnp.concatenate([rows_a, rows_b], axis=0)
    h = _solve_nullvec(A)
    return h.reshape(3, 3)


def _score_f(F, uv1, uv2, valid, sigma2):
    """Symmetric epipolar-distance score (reference:
    Initializer.cc:390-468 CheckFundamental). F: (B,3,3)."""
    ones = jnp.ones((uv1.shape[0], 1), uv1.dtype)
    p1 = jnp.concatenate([uv1, ones], axis=1)  # (M,3)
    p2 = jnp.concatenate([uv2, ones], axis=1)
    l2 = jnp.einsum("bij,mj->bmi", F, p1)  # line in image 2
    l1 = jnp.einsum("bji,mj->bmi", F, p2)  # line in image 1
    num2 = jnp.einsum("bmi,mi->bm", l2, p2)
    num1 = jnp.einsum("bmi,mi->bm", l1, p1)
    d2 = num2 * num2 / jnp.maximum(
        l2[..., 0] ** 2 + l2[..., 1] ** 2, 1e-12
    )
    d1 = num1 * num1 / jnp.maximum(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, 1e-12
    )
    chi1 = d1 / sigma2
    chi2 = d2 / sigma2
    in1 = chi1 <= CHI2_1DOF
    in2 = chi2 <= CHI2_1DOF
    sc = jnp.where(in1, CHI2_2DOF - chi1, 0.0) + jnp.where(
        in2, CHI2_2DOF - chi2, 0.0
    )
    inlier = in1 & in2 & valid[None, :]
    score = jnp.sum(sc * (inlier.astype(sc.dtype)), axis=1)
    return score, inlier


def _score_h(H, uv1, uv2, valid, sigma2):
    """Symmetric transfer score (reference: Initializer.cc:305-388)."""
    Hinv = jnp.linalg.inv(H)

    def transfer(M, src):
        ones = jnp.ones((src.shape[0], 1), src.dtype)
        p = jnp.concatenate([src, ones], axis=1)
        q = jnp.einsum("bij,mj->bmi", M, p)
        return q[..., :2] / jnp.maximum(jnp.abs(q[..., 2:3]), 1e-12) * jnp.sign(
            jnp.where(q[..., 2:3] == 0, 1.0, q[..., 2:3])
        )

    e12 = jnp.sum((transfer(H, uv1) - uv2[None]) ** 2, axis=-1)
    e21 = jnp.sum((transfer(Hinv, uv2) - uv1[None]) ** 2, axis=-1)
    chi12 = e12 / sigma2
    chi21 = e21 / sigma2
    in12 = chi12 <= CHI2_2DOF
    in21 = chi21 <= CHI2_2DOF
    sc = jnp.where(in12, CHI2_2DOF - chi12, 0.0) + jnp.where(
        in21, CHI2_2DOF - chi21, 0.0
    )
    inlier = in12 & in21 & valid[None, :]
    score = jnp.sum(sc * inlier.astype(sc.dtype), axis=1)
    return score, inlier


def _check_rt(R, t, uv1, uv2, K, inlier, sigma2):
    """Count cheirality/parallax/reprojection-valid points for one (R, t)
    (reference: Initializer.cc:798-907 CheckRT). Returns
    (n_good, points (M,3), good (M,), parallax_ok)."""
    Km = jnp.array(
        [
            [K[0], 0.0, K[2]],
            [0.0, K[1], K[3]],
            [0.0, 0.0, 1.0],
        ],
        dtype=uv1.dtype,
    )
    P1 = Km @ jnp.concatenate([jnp.eye(3, dtype=R.dtype), jnp.zeros((3, 1), R.dtype)], axis=1)
    P2 = Km @ jnp.concatenate([R, t[:, None]], axis=1)

    def tri(u1, u2):
        A = jnp.stack(
            [
                u1[0] * P1[2] - P1[0],
                u1[1] * P1[2] - P1[1],
                u2[0] * P2[2] - P2[0],
                u2[1] * P2[2] - P2[1],
            ]
        )
        _, V = jnp.linalg.eigh(A.T @ A)
        X = V[:, 0]
        return X[:3] / jnp.where(jnp.abs(X[3]) < 1e-12, 1e-12, X[3])

    x1 = jax.vmap(tri)(uv1, uv2)  # (M, 3) in view-1 frame
    x2 = x1 @ R.T + t

    finite = jnp.all(jnp.isfinite(x1), axis=1)
    # Parallax between the two viewing rays.
    c2 = -R.T @ t
    r1 = x1
    r2 = x1 - c2
    cos_par = jnp.sum(r1 * r2, axis=1) / jnp.maximum(
        jnp.linalg.norm(r1, axis=1) * jnp.linalg.norm(r2, axis=1), 1e-12
    )
    depth_ok = (x1[:, 2] > 0) & (x2[:, 2] > 0)
    # Reprojection errors in both views.
    uv1_hat = jnp.stack(
        [K[0] * x1[:, 0] / x1[:, 2] + K[2], K[1] * x1[:, 1] / x1[:, 2] + K[3]],
        axis=1,
    )
    uv2_hat = jnp.stack(
        [K[0] * x2[:, 0] / x2[:, 2] + K[2], K[1] * x2[:, 1] / x2[:, 2] + K[3]],
        axis=1,
    )
    e1 = jnp.sum((uv1_hat - uv1) ** 2, axis=1)
    e2 = jnp.sum((uv2_hat - uv2) ** 2, axis=1)
    reproj_ok = (e1 < 4.0 * sigma2) & (e2 < 4.0 * sigma2)
    good = finite & depth_ok & reproj_ok & (cos_par < 0.99998) & inlier
    n_good = jnp.sum(good.astype(jnp.int32))
    # Median-ish parallax of good points: use the 50th best like reference
    # takes element min(50, n)-1 of sorted parallax (Initializer.cc:887-895).
    cosp = jnp.where(good, cos_par, 1.0)
    cos_sorted = jnp.sort(cosp)
    idx = jnp.minimum(50, jnp.maximum(n_good, 1)) - 1
    parallax_cos = cos_sorted[idx]
    return n_good, x1, good, parallax_cos


def _motions_from_f(F, K):
    """4 (R, t) hypotheses from E = KᵀFK (reference:
    Initializer.cc:470-500, DecomposeE :909-929)."""
    Km = jnp.array(
        [[K[0], 0.0, K[2]], [0.0, K[1], K[3]], [0.0, 0.0, 1.0]], dtype=F.dtype
    )
    E = Km.T @ F @ Km
    U, _, Vt = jnp.linalg.svd(E)
    t = U[:, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], F.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = R1 * jnp.sign(jnp.linalg.det(R1))
    R2 = R2 * jnp.sign(jnp.linalg.det(R2))
    Rs = jnp.stack([R1, R1, R2, R2])
    ts = jnp.stack([t, -t, t, -t])
    return Rs, ts


def _motions_from_h(H, K):
    """8 (R, t) hypotheses via Faugeras SVD decomposition of K⁻¹HK
    (reference: Initializer.cc:572-686 ReconstructH)."""
    Km = jnp.array(
        [[K[0], 0.0, K[2]], [0.0, K[1], K[3]], [0.0, 0.0, 1.0]], dtype=H.dtype
    )
    Kinv = jnp.linalg.inv(Km)
    A = Kinv @ H @ Km
    U, S, Vt = jnp.linalg.svd(A)
    V = Vt.T
    s_det = jnp.linalg.det(U) * jnp.linalg.det(V)
    d1, d2, d3 = S[0], S[1], S[2]

    safe = jnp.maximum(d1 - d3, 1e-12)
    aux1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    aux3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    x1s = jnp.array([aux1, aux1, -aux1, -aux1])
    x3s = jnp.array([aux3, -aux3, aux3, -aux3])

    # case d' > 0 (n'=+): R' = rot about y by theta
    aux_st = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / jnp.maximum((d1 + d3) * d2, 1e-12)
    ct = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)
    sts = jnp.array([1.0, -1.0, -1.0, 1.0]) * aux_st

    def make_pos(i):
        Rp = jnp.array(
            [[ct, 0.0, -sts[i]], [0.0, 1.0, 0.0], [sts[i], 0.0, ct]], H.dtype
        )
        tp = (d1 - d3) * jnp.array([x1s[i], 0.0, -x3s[i]])
        R = s_det * U @ Rp @ Vt
        t = U @ tp
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    # case d' < 0: R' = rot about y by phi with reflection
    aux_sp = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / jnp.maximum((d1 - d3) * d2, 1e-12)
    cp = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)
    sps = jnp.array([1.0, -1.0, -1.0, 1.0]) * aux_sp

    def make_neg(i):
        Rp = jnp.array(
            [[cp, 0.0, sps[i]], [0.0, -1.0, 0.0], [sps[i], 0.0, -cp]], H.dtype
        )
        tp = (d1 + d3) * jnp.array([x1s[i], 0.0, x3s[i]])
        R = s_det * U @ Rp @ Vt
        t = U @ tp
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    Rs, ts = [], []
    for i in range(4):
        R, t = make_pos(i)
        Rs.append(R)
        ts.append(t)
    for i in range(4):
        R, t = make_neg(i)
        Rs.append(R)
        ts.append(t)
    return jnp.stack(Rs), jnp.stack(ts)


@functools.partial(
    jax.jit, static_argnames=("n_hypotheses", "min_triangulated")
)
def initialize(
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    valid: jnp.ndarray,
    K: jnp.ndarray,
    key: jnp.ndarray,
    sigma: float = 1.0,
    n_hypotheses: int = 256,
    min_triangulated: int = 50,
) -> TwoViewResult:
    """Full two-view bootstrap from matched (undistorted) pixels.

    uv1/uv2: (M, 2) matched coordinates in views 1/2; valid: (M,) mask.
    Returns pose of view 2 in the view-1 world frame + triangulated points.
    """
    sigma2 = sigma * sigma
    m = uv1.shape[0]
    n1, T1 = _normalize(uv1, valid)
    n2, T2 = _normalize(uv2, valid)

    idx = _sample_indices(key, n_hypotheses, m, valid)
    s1 = n1[idx]  # (B, 8, 2)
    s2 = n2[idx]

    Fn = _fundamental_from_sets(s1, s2)
    F = T2.T @ Fn @ T1  # denormalize: p2ᵀ F p1 with raw pixels
    f_scores, f_inl = _score_f(F, uv1, uv2, valid, sigma2)
    bf = jnp.argmax(f_scores)
    # Refit on the best hypothesis's inliers, then rescore (2 rounds).
    f_w = f_inl[bf].astype(jnp.float32)
    for _ in range(2):
        F_best = T2.T @ _refit_f(n1, n2, f_w) @ T1
        f_score_r, f_inl_r = _score_f(F_best[None], uv1, uv2, valid, sigma2)
        f_w = f_inl_r[0].astype(jnp.float32)
    score_f, f_inliers = f_score_r[0], f_inl_r[0]

    Hn = _homography_from_sets(s1, s2)
    H = jnp.linalg.inv(T2) @ Hn @ T1
    h_scores, h_inl = _score_h(H, uv1, uv2, valid, sigma2)
    bh = jnp.argmax(h_scores)
    h_w = h_inl[bh].astype(jnp.float32)
    for _ in range(2):
        H_best = jnp.linalg.inv(T2) @ _refit_h(n1, n2, h_w) @ T1
        h_score_r, h_inl_r = _score_h(H_best[None], uv1, uv2, valid, sigma2)
        h_w = h_inl_r[0].astype(jnp.float32)
    score_h, h_inliers = h_score_r[0], h_inl_r[0]

    rh = score_h / jnp.maximum(score_h + score_f, 1e-12)
    use_h = rh > 0.40  # reference: Initializer.cc:115

    # Evaluate all 12 candidate motions (4 from F, 8 from H) with the
    # matching inlier set; select by good-point count.
    Rf, tf = _motions_from_f(F_best, K)
    Rh, th = _motions_from_h(H_best, K)
    Rs = jnp.concatenate([Rf, Rh])  # (12, 3, 3)
    ts = jnp.concatenate([tf, th])
    from_h = jnp.arange(12) >= 4
    cand_inl = jnp.where(use_h, h_inliers, f_inliers)
    cand_valid = jnp.where(use_h, from_h, ~from_h)

    n_good, pts, good, par_cos = jax.vmap(
        lambda R, t: _check_rt(R, t, uv1, uv2, K, cand_inl, sigma2)
    )(Rs, ts)
    n_good = jnp.where(cand_valid, n_good, -1)
    best = jnp.argmax(n_good)
    best_good = n_good[best]
    second = jnp.sort(n_good)[-2]

    n_inliers = jnp.sum(
        jnp.where(use_h, h_inliers, f_inliers).astype(jnp.int32)
    )
    # Acceptance (reference: Initializer.cc:522-556): clear winner, enough
    # points, enough parallax (cos < cos(1 deg)).
    ok = (
        (best_good >= jnp.maximum((0.9 * n_inliers).astype(jnp.int32), min_triangulated))
        & (second < (0.75 * best_good).astype(second.dtype))
        & (par_cos[best] < 0.9998476)  # cos(1 deg)
    )

    T21 = se3.make(Rs[best], ts[best])
    return TwoViewResult(
        ok=ok,
        T21=T21,
        points=pts[best],
        good=good[best],
        used_homography=use_h,
        score_h=score_h,
        score_f=score_f,
    )
