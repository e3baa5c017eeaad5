"""Per-frame tracking: the SLAM front state machine.

Reference: src/Tracking.cc — Track() (:267-506) drives per-frame pose
estimation: motion-model tracking (:867), reference-keyframe fallback
(:757), relocalization (:1341), then local-map tracking (:930) and the
keyframe decision (:977). It runs in the caller's thread under the map
mutex.

Array-program design: a host state machine dispatching jitted fixed-shape
kernels — projection/frustum culling, masked-matrix matching, batched RANSAC,
motion-only GN. The host keeps only index bookkeeping; there are no locks (the
host loop owns the map; see slam_map/mapstate.py).
"""

from __future__ import annotations

import collections
import functools
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from c_orb_slam_tpu.config import SlamConfig, Sensor
from c_orb_slam_tpu.frontend import frame as frame_mod
from c_orb_slam_tpu.geometry import camera, np_se3, se3
from c_orb_slam_tpu.ops import hamming, match, pnp, twoview
from c_orb_slam_tpu.optim import pose_opt
from c_orb_slam_tpu.slam_map.mapstate import MapState
from c_orb_slam_tpu.utils.host import fetch, fetch_async, prefetch

import os

_DEBUG = bool(os.environ.get("SLAM_DEBUG"))


def _dbg(*args):
    if _DEBUG:
        print("[track]", *args)


class TrackState:
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


@functools.partial(jax.jit, static_argnames=("img_w", "img_h", "n_levels"))
def frustum_check(
    T: jnp.ndarray,
    xyz: jnp.ndarray,
    normal: jnp.ndarray,
    min_dist: jnp.ndarray,
    max_dist: jnp.ndarray,
    pt_valid: jnp.ndarray,
    K: jnp.ndarray,
    img_w: int,
    img_h: int,
    log_scale: float,
    n_levels: int,
    view_cos_limit: float = 0.5,
):
    """Batched Frame::isInFrustum (reference: src/Frame.cc:269-325).

    Returns (in_view, uv, predicted_octave, view_cos).
    """
    xc = se3.apply(T, xyz)
    z = xc[:, 2]
    uv = camera.project(xc, K)
    in_img = (
        (uv[:, 0] >= 0) & (uv[:, 0] < img_w) & (uv[:, 1] >= 0) & (uv[:, 1] < img_h)
    )
    center = se3.translation(se3.inverse(T))
    po = xyz - center
    dist = jnp.linalg.norm(po, axis=1)
    range_ok = (dist >= 0.8 * min_dist) & (dist <= 1.2 * max_dist)
    view_cos = jnp.sum(po * normal, axis=1) / jnp.maximum(dist, 1e-12)
    # Predicted octave (reference: MapPoint::PredictScale, MapPoint.cc:385).
    ratio = jnp.maximum(max_dist, 1e-12) / jnp.maximum(dist, 1e-12)
    octave = jnp.ceil(jnp.log(ratio) / log_scale).astype(jnp.int32)
    octave = jnp.clip(octave, 0, n_levels - 1)
    in_view = pt_valid & (z > 0) & in_img & range_ok & (view_cos > view_cos_limit)
    return in_view, uv, octave, view_cos


def _pose_opt_over_queries(cfg: SlamConfig, T0, q_xyz, m, f, inv_sigma2_levels, K):
    """Motion-only GN where each row is a matched map point (query):
    observation = the frame keypoint the query matched."""
    obs_uv = f.xy[m.idx]
    ur = f.ur[m.idx]
    is_stereo = (ur > 0) & m.valid
    obs = jnp.concatenate(
        [obs_uv, jnp.where(is_stereo, ur, 0.0)[:, None]], axis=1
    )
    inv_s2 = inv_sigma2_levels[f.octave[m.idx]]
    return pose_opt.optimize_pose(
        T0, q_xyz, obs, inv_s2, is_stereo, m.valid, K,
        float(cfg.camera.bf),
        rounds=cfg.optimizer.pose_opt_rounds,
        iters=cfg.optimizer.pose_opt_its,
        chi2_mono=cfg.optimizer.chi2_mono,
        chi2_stereo=cfg.optimizer.chi2_stereo,
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def _ref_kf_step(
    cfg: SlamConfig,
    T0: jnp.ndarray,
    k: jnp.ndarray,
    kf_mp_k: jnp.ndarray,
    KF_desc: jnp.ndarray,
    KF_angle: jnp.ndarray,
    KF_kp_valid: jnp.ndarray,
    PT_xyz: jnp.ndarray,
    PT_valid: jnp.ndarray,
    f: frame_mod.FrameData,
    K: jnp.ndarray,
    inv_sigma2_levels: jnp.ndarray,
):
    """Fused reference-keyframe tracking step (reference:
    Tracking.cc:757-799; BoW-accelerated there, dense masked here).

    Reads the keyframe's descriptors and the matched points' positions
    from the device-resident map (slam_map/devicemap.py) — the only
    upload is the keyframe's feature->point index column."""
    q_desc = KF_desc[k]
    q_angle = KF_angle[k]
    safe = jnp.maximum(kf_mp_k, 0)
    q_xyz = PT_xyz[safe]
    q_valid = (kf_mp_k >= 0) & KF_kp_valid[k] & PT_valid[safe]
    m = match.match(
        q_desc, f.desc, q_valid, f.valid,
        max_dist=cfg.matcher.th_low, nn_ratio=0.7,
    )
    ok = match.rotation_consistency(q_angle, f.angle[m.idx], m.valid)
    m = m._replace(valid=ok)
    result = _pose_opt_over_queries(
        cfg, T0, q_xyz, m, f, inv_sigma2_levels, K
    )
    return m.idx, m.valid, result.pose, result.inliers, result.n_inliers


@functools.partial(
    jax.jit, static_argnames=("cfg", "radius_override", "nn_ratio_override")
)
def _local_map_step(
    cfg: SlamConfig,
    T0: jnp.ndarray,
    local_idx: jnp.ndarray,
    pt_fresh: jnp.ndarray,
    seed_mp: jnp.ndarray,
    PT_xyz: jnp.ndarray,
    PT_normal: jnp.ndarray,
    PT_mind: jnp.ndarray,
    PT_maxd: jnp.ndarray,
    PT_desc: jnp.ndarray,
    PT_valid: jnp.ndarray,
    f: frame_mod.FrameData,
    K: jnp.ndarray,
    inv_sigma2_levels: jnp.ndarray,
    sf: jnp.ndarray,
    radius_override: Optional[float] = None,
    nn_ratio_override: Optional[float] = None,
):
    """Fused local-map tracking: frustum cull, projection search over the
    covisibility-local point set, pose GN over seed+new matches — one
    dispatch, one readback (reference: Tracking.cc:930-974, 1143-1230).

    The point set is addressed by index into the device-resident map
    (local_idx, -1 padded); seeds likewise (seed_mp: per-feature map
    index). Uploads shrink to the index vectors.

    Search radius: 2.5 px scaled, widened to 4.0 for oblique views
    (reference: ORBmatcher.cc:131-137 RadiusByViewingCos). Octave gate
    widened vs the reference's [o-1, o] — the predicted octave degrades
    with scale drift, and a tight gate turns drift into match starvation
    (observed in synthetic runs)."""
    safe_l = jnp.maximum(local_idx, 0)
    pt_xyz = PT_xyz[safe_l]
    pt_normal = PT_normal[safe_l]
    pt_min_dist = PT_mind[safe_l]
    pt_max_dist = PT_maxd[safe_l]
    pt_desc = PT_desc[safe_l]
    pt_valid = (local_idx >= 0) & PT_valid[safe_l]
    seed_valid = seed_mp >= 0
    seed_xyz = PT_xyz[jnp.maximum(seed_mp, 0)]
    in_view, uv, octave, view_cos = frustum_check(
        T0, pt_xyz, pt_normal, pt_min_dist, pt_max_dist, pt_valid, K,
        img_w=cfg.camera.width,
        img_h=cfg.camera.height,
        log_scale=float(np.log(cfg.orb.scale_factor)),
        n_levels=cfg.orb.n_levels,
    )
    if radius_override is None:
        r = jnp.where(view_cos > 0.998, 4.0, 6.0)
    else:
        r = jnp.full_like(view_cos, radius_override)
    radii = r * sf[octave]
    lo = jnp.maximum(octave - 3, 0)
    hi = jnp.minimum(octave + 2, cfg.orb.n_levels - 1)
    free_t = f.valid & ~seed_valid
    m = match.search_by_projection(
        uv, radii, pt_desc, in_view & pt_fresh,
        f.xy, f.octave, f.desc, free_t, lo, hi,
        max_dist=cfg.matcher.th_high,
        nn_ratio=(
            cfg.matcher.nn_ratio_mapping + 0.2
            if nn_ratio_override is None
            else nn_ratio_override
        ),
    )
    # Per-feature assignment: scatter query index to its matched feature
    # (unique_targets guarantees injectivity; invalid rows land out of
    # bounds and drop).
    n_feat = f.xy.shape[0]
    n_q = pt_xyz.shape[0]
    feat_q = jnp.full((n_feat,), -1, jnp.int32)
    feat_q = feat_q.at[jnp.where(m.valid, m.idx, n_feat)].set(
        jnp.arange(n_q, dtype=jnp.int32), mode="drop"
    )
    feat_new = feat_q >= 0
    xyz_feat = jnp.where(
        feat_new[:, None], pt_xyz[jnp.maximum(feat_q, 0)], seed_xyz
    )
    valid_feat = feat_new | seed_valid
    is_stereo = (f.ur > 0) & valid_feat
    obs = jnp.concatenate(
        [f.xy, jnp.where(is_stereo, f.ur, 0.0)[:, None]], axis=1
    )
    result = pose_opt.optimize_pose(
        T0, xyz_feat, obs, inv_sigma2_levels[f.octave], is_stereo,
        valid_feat, K, float(cfg.camera.bf),
        rounds=cfg.optimizer.pose_opt_rounds,
        iters=cfg.optimizer.pose_opt_its,
        chi2_mono=cfg.optimizer.chi2_mono,
        chi2_stereo=cfg.optimizer.chi2_stereo,
    )
    return (
        in_view, m.idx, m.valid,
        result.pose, result.inliers, result.n_inliers,
    )


@functools.partial(jax.jit, static_argnames=("cfg", "radius_mult"))
def _full_track_step(
    cfg: SlamConfig,
    T_pred: jnp.ndarray,
    last_mp: jnp.ndarray,
    last_octave: jnp.ndarray,
    last_desc: jnp.ndarray,
    vo_xyz: jnp.ndarray,
    vo_valid: jnp.ndarray,
    local_idx: jnp.ndarray,
    PT_xyz: jnp.ndarray,
    PT_normal: jnp.ndarray,
    PT_mind: jnp.ndarray,
    PT_maxd: jnp.ndarray,
    PT_desc: jnp.ndarray,
    PT_valid: jnp.ndarray,
    f: frame_mod.FrameData,
    K: jnp.ndarray,
    inv_sigma2_levels: jnp.ndarray,
    sf: jnp.ndarray,
    radius_mult: float = 1.0,
):
    """The ENTIRE per-frame tracking compute as one program / one readback:
    motion-model projection matching -> pose GN -> frustum cull of the
    covisibility-local points -> projection matching -> pose GN again
    (reference: the Track() pipeline, Tracking.cc:313 + :930).

    All map data is read from the device-resident mirror
    (slam_map/devicemap.py): queries are addressed by last frame's
    feature->point indices (last_mp), the local set by local_idx. The
    per-frame upload is the pose prior + two index vectors (~40 KB), in
    place of a dozen uploads of gathered map rows.

    VO temporal points (localization mode, reference Tracking.cc:801-865):
    rows with vo_valid get position vo_xyz and last frame's descriptor
    instead of map data; their last_mp is -1 so they never bind to map
    points.

    The local point set is chosen by the host from the PREVIOUS frame's
    covisibility — one frame stale, exactly as the reference's tracking
    reads a map its mapping thread mutates concurrently."""
    safe_q = jnp.maximum(last_mp, 0)
    q_xyz = jnp.where(vo_valid[:, None], vo_xyz, PT_xyz[safe_q])
    q_desc = jnp.where(vo_valid[:, None], last_desc, PT_desc[safe_q])
    q_valid = ((last_mp >= 0) & PT_valid[safe_q]) | vo_valid
    q_octave = last_octave
    q_ids = last_mp
    safe_l = jnp.maximum(local_idx, 0)
    pt_xyz = PT_xyz[safe_l]
    pt_normal = PT_normal[safe_l]
    pt_min_dist = PT_mind[safe_l]
    pt_max_dist = PT_maxd[safe_l]
    pt_desc = PT_desc[safe_l]
    pt_valid = (local_idx >= 0) & PT_valid[safe_l]
    pt_ids = local_idx
    # --- Stage 1: motion model (Tracking.cc:867) ---
    xc = se3.apply(T_pred, q_xyz)
    uv = camera.project(xc, K)
    z_ok = xc[:, 2] > 0
    # radius_mult widens the window with the pipeline's prediction lag
    # (the reference widens 2x on a failed first pass, Tracking.cc:888).
    radii = 15.0 * radius_mult * sf[q_octave]
    lo = jnp.maximum(q_octave - 1, 0)
    hi = jnp.minimum(q_octave + 1, cfg.orb.n_levels - 1)
    m1 = match.search_by_projection(
        uv, radii, q_desc, q_valid & z_ok,
        f.xy, f.octave, f.desc, f.valid, lo, hi,
        max_dist=cfg.matcher.th_high,
        nn_ratio=cfg.matcher.nn_ratio_tracking,
    )
    r1 = _pose_opt_over_queries(
        cfg, T_pred, q_xyz, m1, f, inv_sigma2_levels, K
    )
    mm_ok = (
        (jnp.sum(m1.valid) >= 20)
        & (r1.n_inliers >= cfg.tracking.min_inliers_pose)
    )
    pose1 = jnp.where(mm_ok, r1.pose, T_pred)

    # Per-feature seed assignment from stage-1 inliers.
    n_feat = f.xy.shape[0]
    n_q = q_xyz.shape[0]
    good_q = m1.valid & r1.inliers & mm_ok
    feat_q1 = jnp.full((n_feat,), -1, jnp.int32)
    feat_q1 = feat_q1.at[jnp.where(good_q, m1.idx, n_feat)].set(
        jnp.arange(n_q, dtype=jnp.int32), mode="drop"
    )
    seed_new = feat_q1 >= 0
    seed_xyz = jnp.where(
        seed_new[:, None], q_xyz[jnp.maximum(feat_q1, 0)], 0.0
    )
    seed_valid = seed_new

    # --- Stage 2: local map (Tracking.cc:930, 1143) ---
    in_view, uv2, octave2, view_cos = frustum_check(
        pose1, pt_xyz, pt_normal, pt_min_dist, pt_max_dist, pt_valid, K,
        img_w=cfg.camera.width,
        img_h=cfg.camera.height,
        log_scale=float(np.log(cfg.orb.scale_factor)),
        n_levels=cfg.orb.n_levels,
    )
    # Exclude local points already matched by stage 1 (device membership
    # test: sorted matched ids + searchsorted).
    matched_ids = jnp.sort(jnp.where(good_q, q_ids, jnp.int32(2**30)))
    pos = jnp.searchsorted(matched_ids, pt_ids)
    already = matched_ids[jnp.minimum(pos, n_q - 1)] == pt_ids
    fresh = pt_valid & ~already

    # Radius 4/6 px (reference: 2.5/4, ORBmatcher.cc:131-137) and octave
    # gate [-3, +2] (reference: [-1, 0]): PredictScale assumes a corner
    # fires at ONE scale per distance; measured on synthetic texture the
    # true keypoint's octave spreads +-3 levels around the prediction and
    # the tight gate rejected ~40% of geometrically correct candidates.
    r = jnp.where(view_cos > 0.998, 4.0, 6.0)
    radii2 = r * sf[octave2]
    lo2 = jnp.maximum(octave2 - 3, 0)
    hi2 = jnp.minimum(octave2 + 2, cfg.orb.n_levels - 1)
    free_t = f.valid & ~seed_valid
    m2 = match.search_by_projection(
        uv2, radii2, pt_desc, in_view & fresh,
        f.xy, f.octave, f.desc, free_t, lo2, hi2,
        max_dist=cfg.matcher.th_high,
        nn_ratio=cfg.matcher.nn_ratio_mapping + 0.2,
    )
    n_q2 = pt_xyz.shape[0]
    feat_q2 = jnp.full((n_feat,), -1, jnp.int32)
    feat_q2 = feat_q2.at[jnp.where(m2.valid, m2.idx, n_feat)].set(
        jnp.arange(n_q2, dtype=jnp.int32), mode="drop"
    )
    feat_new2 = feat_q2 >= 0
    xyz_feat = jnp.where(
        feat_new2[:, None], pt_xyz[jnp.maximum(feat_q2, 0)], seed_xyz
    )
    valid_feat = feat_new2 | seed_valid
    is_stereo = (f.ur > 0) & valid_feat
    obs = jnp.concatenate(
        [f.xy, jnp.where(is_stereo, f.ur, 0.0)[:, None]], axis=1
    )
    r2 = pose_opt.optimize_pose(
        pose1, xyz_feat, obs, inv_sigma2_levels[f.octave], is_stereo,
        valid_feat, K, float(cfg.camera.bf),
        rounds=cfg.optimizer.pose_opt_rounds,
        iters=cfg.optimizer.pose_opt_its,
        chi2_mono=cfg.optimizer.chi2_mono,
        chi2_stereo=cfg.optimizer.chi2_stereo,
    )
    # Device-chained pose: the next frame's dispatch reads this WITHOUT a
    # host round trip (see _fused_dispatch), so the constant-velocity
    # prediction always has 1-frame lag no matter how deep the host
    # readback pipeline runs. Guarded: on a failed step it falls back to
    # the propagated prediction instead of a divergent pose estimate.
    chain_ok = mm_ok & (r2.n_inliers >= cfg.tracking.min_inliers_pose)
    chain_pose = jnp.where(chain_ok, r2.pose, pose1)
    return (
        mm_ok, m1.idx, good_q,
        in_view, m2.idx, m2.valid,
        r2.pose, r2.inliers, r2.n_inliers,
    ), chain_pose


def _chain_predict(T_prev: jnp.ndarray, T_prev2: jnp.ndarray, frac: float):
    """Constant-velocity prediction from the two most recent DEVICE poses
    of the chained tracking recursion — no host round trip. frac scales
    the rotation part like the host path (TrackingConfig
    .velocity_rotation_fraction; 0 = translation-only prediction).

    Deliberately NOT jitted: on an earlier accelerator, wrapping it in
    jax.jit destabilized MONOCULAR tracking on the 240-frame orbit,
    although isolated eager and jitted outputs were bitwise-comparable —
    a frame-timing interaction with the pipelined mapper, not math. The
    mechanism is unexplained and not measured on the H100; revisit only
    with the orbit e2e as the gate."""
    from c_orb_slam_tpu.geometry import so3

    vel = se3.compose(T_prev, se3.inverse(T_prev2))
    if frac == 0.0:
        R = jnp.eye(3, dtype=T_prev.dtype)
    elif frac == 1.0:
        R = se3.rotation(vel)
    else:
        R = so3.exp(so3.log(se3.rotation(vel)) * frac)
    vel_d = jnp.concatenate([R, se3.translation(vel)[:, None]], axis=1)
    return se3.compose(vel_d, T_prev)


class Tracking:
    """Host tracking loop. One instance per System."""

    def __init__(self, cfg: SlamConfig, mapstate: MapState):
        self.cfg = cfg
        self.map = mapstate
        self.state = TrackState.NOT_INITIALIZED
        # Localization-only: track against a frozen map, never insert
        # keyframes (reference: Tracking.mbOnlyTracking, Tracking.cc:272).
        self.only_tracking = False
        self.K = camera.intrinsics_array(cfg.camera)
        self.sf = np.asarray(cfg.orb.scale_factors(), np.float32)
        self._sf_dev = jnp.asarray(self.sf)  # cached: no re-upload per frame
        self._vo_zeros = None
        self.inv_sigma2_levels = jnp.asarray(
            1.0 / np.asarray(cfg.orb.level_sigma2(), np.float32)
        )
        self.velocity: Optional[np.ndarray] = None  # T_{cur<-last}
        self.last_pose: Optional[np.ndarray] = None
        self.last_frame: Optional[frame_mod.FrameData] = None
        self.last_mp: Optional[np.ndarray] = None  # (N,) point idx / -1
        self.ref_kf: int = -1
        self.request_reset = False  # set on early loss; System consumes
        self._vo_mode = False  # localization-only: tracking on VO points
        self.frames_since_kf = 0
        self.frame_id = -1
        self.last_kf_frame_id = -1
        self.last_reloc_frame_id = -1000000
        # Mono init state
        self._init_frame: Optional[frame_mod.FrameData] = None
        self._init_frame_id = -1
        self._init_timestamp = 0.0
        self._rng = jax.random.PRNGKey(cfg.vocabulary.seed)
        # Per-frame trajectory log: (frame_id, T_cr (3,4) pose RELATIVE to
        # ref_kf, ref_kf, state). Storing relative poses means loop/GBA
        # corrections retroactively fix the whole exported trajectory
        # (reference: Tracking.cc:488-505 mlRelativeFramePoses +
        # System.cc:345-380 reconstruction).
        self.trajectory: list = []
        self.current_inliers = 0
        # Hot-path sub-stage wall-time accumulators (ms), read by
        # tools/profile_track_fine.py — kept in the real code path so the
        # profile can never go stale against a duplicated copy.
        self.stage_ms: dict = {}
        # Tracking pipeline: deque of (frame, dispatch record, timestamp)
        # for frames whose device step is in flight (see track()); deeper
        # pipelines hide more dispatch->host-visible latency.
        self._pending = collections.deque()
        self.pipeline_depth = cfg.tracking.pipeline_depth
        # Device pose chain (chain_pose_t, pose_{t-1}) of the most recent
        # dispatch; None whenever the last pose did not come from the
        # steady fused path (recovery, sync fallback, loop correction).
        self._chain = None
        # Dataset timestamp of the frame being tracked (System sets it);
        # stored on created keyframes (reference: KeyFrame.mTimeStamp,
        # written by SaveKeyFrameTrajectoryTUM, System.cc:383-417).
        self.current_timestamp = 0.0
        # Rewrite trajectory references when a culled keyframe's slot is
        # recycled (see MapState._release_slot).
        mapstate.on_slot_reuse = self._on_kf_slot_reuse

    def _on_kf_slot_reuse(self, k: int, Tcp_k: np.ndarray, parent_k: int):
        """A culled keyframe slot is being recycled: fold its stored
        relative pose into every trajectory entry that references it and
        re-point them at its spanning parent (eager version of the
        reference's lazy mTcp walk, System.cc:361-366)."""
        Tcp_h = np.vstack([Tcp_k, [0, 0, 0, 1.0]])
        for i, (fid, T_cr, ref, state, stamp) in enumerate(self.trajectory):
            if ref == k:
                T_new = (
                    np.vstack([T_cr, [0, 0, 0, 1.0]]) @ Tcp_h
                )[:3].astype(np.float32)
                self.trajectory[i] = (fid, T_new, parent_k, state, stamp)
        if self.ref_kf == k:
            self.ref_kf = parent_k

    def _mark(self, name: str, t0: float) -> float:
        t = time.perf_counter()
        self.stage_ms[name] = self.stage_ms.get(name, 0.0) + (t - t0) * 1000
        return t

    # ------------------------------------------------------------------
    def _next_key(self):
        self._rng, k = jax.random.split(self._rng)
        return k

    def track(self, f: frame_mod.FrameData) -> Optional[np.ndarray]:
        """Process one frame; returns the most recent resolved Tcw (3,4)
        numpy pose, or None if lost.

        Steady-state frames are PIPELINED `pipeline_depth` deep: the fused
        device step for frame t is dispatched here, but its readback is
        applied `depth` frames later — the background worker's blocking
        d2h completes while the host builds and dispatches the following
        frames, so the latency-bound fetch rarely blocks. The returned
        pose lags `depth` frames in the hot path (the
        reference's viewer tolerates similar lag from its concurrent
        threads). flush_pending() forces completion (shutdown, trajectory
        export).

        Non-steady frames (initialization, loss, relocalization, VO-mode
        localization) run synchronously — latency is irrelevant there.
        """
        # Opportunistic drain: apply any in-flight frame whose readback
        # has already landed (future done), and block for the oldest once
        # the queue is at depth. The effective prediction lag thus adapts:
        # ~1 when frames are slow enough to cover the readback latency,
        # up to `pipeline_depth` when the host loop outruns the device.
        # Depth itself adapts to the tracking margin: when inliers run
        # thin the bookkeeping lag of a deep pipeline (late keyframes,
        # stale local map) is what kills tracking, so fall back to
        # lock-step until the margin recovers.
        depth = (
            self.pipeline_depth
            if self.current_inliers >= 2 * self.cfg.tracking.min_inliers_local_map
            else 1
        )
        # Rotation-adaptive depth: under fast yaw the view leaves the
        # stale local map faster than the pipelined bookkeeping refreshes
        # it (the device pose chain keeps the POSE prediction at 1-frame
        # lag, but keyframe decisions and local-map selection lag `depth`
        # frames) — on the orbit e2e (1.6 deg/frame) depth 3 lost
        # tracking mid-orbit on an earlier accelerator while depth 1
        # tracked 240/240. Smooth dataset trajectories (~0.2 deg/frame)
        # keep full depth.
        if depth > 1 and self.velocity is not None:
            cos_r = 0.5 * (np.trace(self.velocity[:, :3]) - 1.0)
            if cos_r < 0.99995:  # rotation > ~0.57 deg/frame
                depth = 1
        while self._pending and (
            len(self._pending) >= depth
            or self._pending[0][1][0].done()
        ):
            self._apply_oldest()
        self.frame_id += 1

        if self.state == TrackState.NOT_INITIALIZED:
            self.flush_pending()
            if self.cfg.sensor == Sensor.MONOCULAR:
                self._monocular_initialization(f)
            else:
                self._stereo_initialization(f)
            self._log_frame()
            return self.last_pose

        if (
            self.state == TrackState.OK
            and self.velocity is not None
            and not (self.only_tracking and self._vo_mode)
        ):
            self._check_replaced_last()
            disp = self._fused_dispatch(f)
            if disp is not None:
                self._pending.append((f, disp, self.current_timestamp))
                if self.only_tracking:
                    # Localization mode is lock-step: the caller is using
                    # the returned pose per frame (the reference's
                    # TrackMonocular contract — current frame's Tcw), so
                    # the pipelined stale-pose return is not acceptable
                    # here. The fused step still runs as one device
                    # program; we just wait out its readback now.
                    self.flush_pending()
                    return (
                        self.last_pose
                        if self.state == TrackState.OK
                        else None
                    )
                return self.last_pose

        # Sync path: drain in-flight frames first so the slow-path logic
        # sees fully up-to-date tracker state.
        self.flush_pending()
        ok, pose, cur_mp = self._track_sync(f)
        self._finalize(f, ok, pose, cur_mp)
        return self.last_pose if ok else None

    def _apply_oldest(self):
        """Complete the oldest in-flight frame's dispatched track step:
        fetch its (already-landed) results, run the host bookkeeping,
        decide/create its keyframe. Falls back to the synchronous slow
        paths when the fused step failed."""
        if not self._pending:
            return
        f, disp, stamp = self._pending.popleft()
        saved_stamp = self.current_timestamp
        self.current_timestamp = stamp  # the pending frame's timestamp
        ok, pose, cur_mp = self._fused_apply(f, disp)
        if not ok:
            # The newer in-flight dispatches were predicted off state that
            # just failed: drain them through the fused apply too (their
            # results are already in flight), worst case they also fall
            # through to the recovery paths below on their own turn. The
            # device pose chain is broken either way.
            self._chain = None
            ok, pose, cur_mp = self._track_reference_kf(f)
            if self.state == TrackState.LOST or not ok:
                ok, pose, cur_mp = self._relocalize(f)
                if ok:
                    self.last_reloc_frame_id = self.frame_id
            if ok:
                ok, pose, cur_mp = self._track_local_map(f, pose, cur_mp)
        self._finalize(f, ok, pose, cur_mp)
        self.current_timestamp = saved_stamp

    def apply_pending(self):
        self._apply_oldest()

    def flush_pending(self):
        """Drain every in-flight frame (shutdown, trajectory export, any
        transition to a synchronous tracking path)."""
        while self._pending:
            self._apply_oldest()

    def _track_sync(self, f: frame_mod.FrameData):
        """Synchronous (same-frame) tracking: the non-pipelined paths."""
        self._chain = None
        ok = False
        fused_done = False
        pose = None
        cur_mp = np.full(f.xy.shape[0], -1, np.int64)
        if self.state == TrackState.OK:
            self._check_replaced_last()
            if self.velocity is not None:
                disp = self._fused_dispatch(f)
                if disp is not None:
                    ok, pose, cur_mp = self._fused_apply(f, disp)
                    fused_done = ok
            if not ok:
                ok, pose, cur_mp = self._track_reference_kf(f)
        if ok and self.only_tracking and self._vo_mode:
            # VO mode: tracking holds on temporal points; keep trying to
            # relocalize into the map (reference: Tracking.cc:296-330).
            ok_r, pose_r, mp_r = self._relocalize(f)
            if ok_r:
                pose, cur_mp = pose_r, mp_r
                self._vo_mode = False
                self.last_reloc_frame_id = self.frame_id
        if self.state == TrackState.LOST or not ok:
            ok, pose, cur_mp = self._relocalize(f)
            if ok:
                self.last_reloc_frame_id = self.frame_id

        if ok and not fused_done:
            ok, pose, cur_mp = self._track_local_map(f, pose, cur_mp)
        return ok, pose, cur_mp

    def _finalize(self, f, ok, pose, cur_mp):
        """Post-tracking bookkeeping for one frame (motion model update,
        keyframe decision, loss handling, trajectory log)."""
        if cur_mp is None:
            cur_mp = np.full(f.xy.shape[0], -1, np.int64)
        if ok:
            # Motion model: velocity = T_cur * T_last^-1, with the rotation
            # part damped (see TrackingConfig.velocity_rotation_fraction).
            # Pure host math (numpy): no device round trip per frame.
            if self.last_pose is not None:
                vel = np_se3.compose(pose, np_se3.inverse(self.last_pose))
                frac = self.cfg.tracking.velocity_rotation_fraction
                if frac < 1.0:
                    vel = np_se3.scale_rotation(vel, frac)
                self.velocity = vel
            self.state = TrackState.OK
            self.last_pose = np.asarray(pose)
            if not self.only_tracking and self._need_new_keyframe(f, cur_mp):
                self._create_keyframe(f, cur_mp)
                self.frames_since_kf = 0
            else:
                self.frames_since_kf += 1
        else:
            self.state = TrackState.LOST
            self.velocity = None
            # Lost soon after initialization: the map is too thin to ever
            # relocalize against — request a full system reset (reference:
            # Tracking.cc:472-479; System consumes the flag).
            if len(self.map.live_keyframes()) <= 5 and not self.only_tracking:
                self.request_reset = True

        self.last_frame = f
        self.last_mp = cur_mp
        self._log_frame()

    # ------------------------------------------------------------------
    def _log_frame(self):
        if self.last_pose is not None:
            T_cr = self.last_pose
            if self.ref_kf >= 0:
                Tr = self.map.kf_pose[self.ref_kf]
                Rr, tr = Tr[:, :3], Tr[:, 3]
                Tr_inv = np.concatenate(
                    [Rr.T, (-Rr.T @ tr)[:, None]], axis=1
                )
                T_cr = (
                    np.vstack([self.last_pose, [0, 0, 0, 1.0]])[:3]
                    @ np.vstack([Tr_inv, [0, 0, 0, 1.0]])
                ).astype(np.float32)
            # The entry carries its own timestamp: frames before
            # initialization produce no entry, so zipping against a
            # per-call timestamp list would shift every pose one frame
            # early (exactly the bug a position-based pairing had).
            self.trajectory.append(
                (
                    self.frame_id,
                    T_cr.copy(),
                    self.ref_kf,
                    self.state,
                    self.current_timestamp,
                )
            )

    def _check_replaced_last(self):
        """Follow point-forwarding on last frame's matches (reference:
        Tracking::CheckReplacedInLastFrame, Tracking.cc:739-754)."""
        if self.last_mp is not None:
            self.last_mp = self.map.resolve(self.last_mp)
            dead = (self.last_mp >= 0) & ~self.map.pt_valid[
                np.maximum(self.last_mp, 0)
            ]
            self.last_mp[dead] = -1

    # ------------------------------------------------------------------
    # Initialization
    # ------------------------------------------------------------------
    def _monocular_initialization(self, f: frame_mod.FrameData):
        """Two-view bootstrap (reference: Tracking.cc:563-737)."""
        n_valid = int(jnp.sum(f.valid))
        if self._init_frame is None:
            if n_valid >= self.cfg.tracking.min_init_matches:
                self._init_frame = f
                self._init_frame_id = self.frame_id
                self._init_timestamp = self.current_timestamp
            return
        if n_valid < self.cfg.tracking.min_init_matches:
            self._init_frame = None
            return

        f0 = self._init_frame
        m = match.search_for_initialization(
            f0.xy, f0.desc, f0.valid, f0.angle,
            f.xy, f.desc, f.valid, f.angle, jnp.zeros_like(f.octave),
            window=100.0, max_dist=self.cfg.matcher.th_low,
            nn_ratio=self.cfg.matcher.nn_ratio_tracking,
        )
        # Deviation from the reference (which restricts init matching to
        # pyramid level 0, ORBmatcher.cc:415): all octaves participate —
        # our per-cell selection yields ~4x fewer level-0 features than
        # OpenCV FAST, and H/F estimation is octave-agnostic.
        # Run match + two-view RANSAC back-to-back on device and read all
        # results down in one batched transfer.
        res = twoview.initialize(
            f0.xy, f.xy[m.idx], m.valid, self.K, self._next_key(),
            n_hypotheses=self.cfg.capacity.ransac_init_iters,
        )
        valid0, idx1, res_ok, good, pts, T21d = fetch(
            m.valid, m.idx, res.ok, res.good, res.points, res.T21
        )
        if valid0.sum() < self.cfg.tracking.min_init_matches:
            self._init_frame = None
            return
        if not bool(res_ok):
            return
        # Median-depth scale normalization (reference: Tracking.cc:689-713).
        depths = pts[good, 2]
        med = float(np.median(depths))
        if med <= 0:
            self._init_frame = None
            return
        inv_med = 1.0 / med
        pts = pts * inv_med
        T21 = np.array(T21d)
        T21[:, 3] *= inv_med

        # Create the two keyframes + points.
        mp0 = self._create_initial_map(f0, f, idx1, good, pts, T21)
        self.state = TrackState.OK
        self.last_pose = T21
        self.velocity = None
        self.last_mp = mp0
        self._init_frame = None

    def _create_initial_map(self, f0, f1, idx1, good, pts, T21):
        mp = self.map
        f0h = frame_mod.FrameData(*fetch(*f0))
        f1h = frame_mod.FrameData(*fetch(*f1))
        k0 = mp.add_keyframe(
            self._init_frame_id, np.eye(3, 4, dtype=np.float32),
            f0h.xy, f0h.octave, f0h.angle, f0h.desc, f0h.valid,
            timestamp=self._init_timestamp,
        )
        k1 = mp.add_keyframe(
            self.frame_id, T21,
            f1h.xy, f1h.octave, f1h.angle, f1h.desc, f1h.valid,
            timestamp=self.current_timestamp,
        )
        cur_mp = np.full(f1h.xy.shape[0], -1, np.int64)
        gi = np.nonzero(good)[0]
        new_idx = mp.add_points_batch(pts[gi], f0h.desc[gi], k0)
        mp.pt_obs_kf[new_idx, 0] = k0
        mp.pt_obs_feat[new_idx, 0] = gi
        mp.pt_obs_kf[new_idx, 1] = k1
        mp.pt_obs_feat[new_idx, 1] = idx1[gi]
        mp.pt_n_obs[new_idx] = 2
        mp.kf_mp[k0, gi] = new_idx
        mp.kf_mp[k1, idx1[gi]] = new_idx
        mp.update_points_batch(new_idx)
        cur_mp[idx1[gi]] = new_idx
        mp.update_connections(k0)
        mp.update_connections(k1)
        self.ref_kf = k1
        self.last_kf_frame_id = self.frame_id
        self.frames_since_kf = 0
        mp.big_change_idx += 1
        # Full BA on the initial two-view map (reference: Tracking.cc:686
        # GlobalBundleAdjustemnt(pMap, 20)) — without it the init map's
        # depth errors poison every later epipolar/reprojection gate.
        self._initial_bundle_adjustment(k0, k1, cur_mp)
        return cur_mp

    def _initial_bundle_adjustment(self, k0: int, k1: int, cur_mp):
        from c_orb_slam_tpu.optim import ba as ba_mod

        mp = self.map
        pts = mp.live_points()
        P = len(pts)
        obs_list = []
        for si, p in enumerate(pts):
            n = mp.pt_n_obs[p]
            for k, feat in zip(mp.pt_obs_kf[p, :n], mp.pt_obs_feat[p, :n]):
                if k < 0:
                    continue
                uv = mp.kf_xy[k, feat]
                obs_list.append(
                    (0 if k == k0 else 1, si, uv[0], uv[1],
                     1.0 / float(self.cfg.orb.level_sigma2()[mp.kf_octave[k, feat]]))
                )
        O = len(obs_list)
        arr = np.asarray(obs_list, np.float32)
        problem = ba_mod.BAProblem(
            cam_T=jnp.asarray(
                np.stack([mp.kf_pose[k0], mp.kf_pose[k1]])
            ),
            cam_fixed=jnp.asarray([True, False]),
            cam_valid=jnp.ones(2, bool),
            points=jnp.asarray(mp.pt_xyz[pts]),
            point_valid=jnp.ones(P, bool),
            obs_cam=jnp.asarray(arr[:, 0], jnp.int32),
            obs_pt=jnp.asarray(arr[:, 1], jnp.int32),
            obs_uv=jnp.asarray(
                np.concatenate([arr[:, 2:4], np.zeros((O, 1), np.float32)], axis=1)
            ),
            obs_stereo=jnp.zeros(O, bool),
            obs_inv_sigma2=jnp.asarray(arr[:, 4]),
            obs_valid=jnp.ones(O, bool),
            K=self.K,
            bf=jnp.asarray(0.0),
        )
        cam_T, points = fetch(
            *ba_mod.optimize(
                problem, iters=self.cfg.optimizer.init_ba_its, use_huber=True,
                pcg_iters=self.cfg.optimizer.pcg_iters, schur="dense",
            )
        )
        mp.kf_pose[k1] = cam_T[1]
        mp.pt_xyz[pts] = points
        mp.mark_kf_pose_dirty([k1])
        mp.mark_points_dirty(pts)
        # Re-normalize to median depth 1 after BA (the BA can drift the
        # free scale gauge of a two-view mono map).
        T = mp.kf_pose[k0]
        z = mp.pt_xyz[pts] @ T[2, :3] + T[2, 3]
        med = float(np.median(z))
        if med > 0:
            mp.pt_xyz[pts] /= med
            mp.kf_pose[k1][:, 3] /= med
            mp.mark_points_dirty(pts)
            mp.mark_kf_pose_dirty([k1])
        self.last_pose = mp.kf_pose[k1].copy()

    def _stereo_initialization(self, f: frame_mod.FrameData):
        """Bootstrap from depth (reference: Tracking.cc:509-561)."""
        fh = frame_mod.FrameData(*fetch(*f))
        # Gate on total keypoints like the reference (Tracking.cc:511
        # checks mCurrentFrame.N>500, NOT the depth-point count).
        if int(fh.valid.sum()) < self.cfg.tracking.min_stereo_init_points:
            return
        if int(((fh.depth > 0) & fh.valid).sum()) < 50:
            return  # degenerate: almost no stereo depth to seed the map
        mp = self.map
        pose = np.eye(3, 4, dtype=np.float32)
        k0 = mp.add_keyframe(
            self.frame_id, pose,
            fh.xy, fh.octave, fh.angle, fh.desc, fh.valid,
            ur=fh.ur, depth=fh.depth,
            timestamp=self.current_timestamp,
        )
        Kc = np.asarray(self.K)
        xyz = np.stack(
            [
                (fh.xy[:, 0] - Kc[2]) * fh.depth / Kc[0],
                (fh.xy[:, 1] - Kc[3]) * fh.depth / Kc[1],
                fh.depth,
            ],
            axis=1,
        ).astype(np.float32)
        cur_mp = np.full(fh.xy.shape[0], -1, np.int64)
        sel = np.nonzero(fh.valid & (fh.depth > 0))[0]
        new_idx = mp.add_points_batch(xyz[sel], fh.desc[sel], k0)
        mp.add_observations_batch(new_idx, k0, sel)
        mp.update_points_batch(new_idx)
        cur_mp[sel] = new_idx
        mp.update_connections(k0)
        self.ref_kf = k0
        self.last_kf_frame_id = self.frame_id
        self.state = TrackState.OK
        self.last_pose = pose
        self.last_mp = cur_mp
        self.frames_since_kf = 0
        mp.big_change_idx += 1

    # ------------------------------------------------------------------
    # Per-frame pose tracking
    # ------------------------------------------------------------------
    def _gather_points(self, idx: np.ndarray):
        """Device arrays for point subsets (idx may contain -1)."""
        safe = np.maximum(idx, 0)
        return (
            jnp.asarray(self.map.pt_xyz[safe]),
            jnp.asarray(self.map.pt_desc[safe]),
        )

    def _optimize_frame_pose(self, f, T0, mp_idx: np.ndarray):
        """Run motion-only GN against current matches; returns
        (pose np, inlier mask np, n_inliers)."""
        has = mp_idx >= 0
        xyz, _ = self._gather_points(mp_idx)
        obs = jnp.concatenate(
            [f.xy, jnp.asarray(np.where(has, np.asarray(f.ur), -1.0))[:, None]],
            axis=1,
        )
        is_stereo = (obs[:, 2] > 0) & jnp.asarray(has)
        obs = jnp.where(is_stereo[:, None], obs, obs.at[:, 2].set(0.0))
        inv_s2 = self.inv_sigma2_levels[f.octave]
        result = pose_opt.optimize_pose(
            jnp.asarray(T0), xyz, obs, inv_s2, is_stereo,
            jnp.asarray(has), self.K, float(self.cfg.camera.bf),
            rounds=self.cfg.optimizer.pose_opt_rounds,
            iters=self.cfg.optimizer.pose_opt_its,
            chi2_mono=self.cfg.optimizer.chi2_mono,
            chi2_stereo=self.cfg.optimizer.chi2_stereo,
        )
        pose, inl, n = fetch(result.pose, result.inliers, result.n_inliers)
        return pose, inl, int(n)

    def _vo_arrays(self, n_feat: int):
        """Visual-odometry temporal points (reference: UpdateLastFrame,
        Tracking.cc:801-865): in localization mode, stereo/RGB-D augments
        the motion-model query set with the last frame's close depth
        points that have no map association, so tracking survives outside
        the mapped region. These rows carry last_mp = -1, so they never
        create map associations — they only constrain pose.

        Returns (vo_xyz, vo_valid) as HOST arrays when active, else the
        cached device-resident zero arrays (no upload)."""
        if (
            self.only_tracking
            and self.cfg.sensor != Sensor.MONOCULAR
            and self.last_pose is not None
        ):
            depth = np.asarray(self.last_frame.depth)
            lf_valid = np.asarray(self.last_frame.valid)
            close = (
                (depth > 0)
                & (depth < self.cfg.tracking.th_depth * self.cfg.camera.baseline)
            )
            vo = close & (self.last_mp < 0) & lf_valid
            if vo.any():
                xyl = np.asarray(self.last_frame.xy)
                Kc = np.asarray(self.K)
                xc = np.stack(
                    [
                        (xyl[:, 0] - Kc[2]) * depth / Kc[0],
                        (xyl[:, 1] - Kc[3]) * depth / Kc[1],
                        depth,
                    ],
                    axis=1,
                )
                Tinv = np_se3.inverse(self.last_pose)
                xw = (xc @ Tinv[:, :3].T + Tinv[:, 3]).astype(np.float32)
                return xw, vo
        if self._vo_zeros is None or self._vo_zeros[0].shape[0] != n_feat:
            self._vo_zeros = (
                jnp.zeros((n_feat, 3), jnp.float32),
                jnp.zeros((n_feat,), bool),
            )
        return self._vo_zeros

    def _fused_dispatch(self, f: frame_mod.FrameData):
        """Steady-state hot path, dispatch half: enqueue the whole frame's
        tracking compute as ONE device program (see _full_track_step) and
        start its readback. Returns the dispatch record for _fused_apply,
        or None if the frame can't take the fused path. The local point
        set comes from the previous frame's covisibility (one frame stale
        — the reference's tracking likewise races its mapping thread's
        map updates)."""
        t0 = time.perf_counter()
        last_has = self.last_mp >= 0
        if last_has.sum() < 10:
            return None
        local_kfs = self._local_keyframes(self.last_mp)
        local_pts = self._local_points(local_kfs)
        if len(local_pts) == 0:
            return None
        t0 = self._mark("select", t0)
        # Fixed capacity: ONE compiled program for the whole run (dynamic
        # bucketing was tried and recompile stalls at bucket transitions
        # cost far more than the padded compute).
        cap = self.cfg.capacity.local_map_max_points
        pts_pad = np.full(cap, -1, np.int32)
        pts_pad[: min(len(local_pts), cap)] = local_pts[:cap]
        safe = np.maximum(pts_pad, 0)

        # Constant-velocity prediction. Steady state uses the DEVICE pose
        # chain: the previous dispatch's (still in flight) chained pose
        # feeds this prediction without any host readback, so prediction
        # lag is 1 frame regardless of how deep the host apply pipeline
        # runs. Off-chain (first frame after a sync path / recovery), the
        # prediction is extrapolated on host across the actual lag.
        frac = self.cfg.tracking.velocity_rotation_fraction
        if self._chain is not None:
            T_pred = None  # computed on device below
            T_prev = None
        else:
            # Extrapolate across the actual lag. T_prev is the estimate at
            # frame t-1 (NOT last_pose, which is frame t-L-1 when the
            # pipeline holds L frames): seeding the chain's prev2 at
            # 1-frame spacing keeps the NEXT on-chain _chain_predict a
            # 1-frame velocity instead of an ~L× overshoot.
            T_pred = np.vstack([self.last_pose, [0, 0, 0, 1]])
            vel_h = np.vstack([self.velocity, [0, 0, 0, 1]])
            T_prev = T_pred
            for _ in range(len(self._pending) + 1):
                T_prev = T_pred
                T_pred = vel_h @ T_pred
            T_pred = T_pred[:3].astype(np.float32)
            T_prev = T_prev[:3].astype(np.float32)

        vo_xyz, vo_valid = self._vo_arrays(f.xy.shape[0])
        t0 = self._mark("prep", t0)
        dev = self.map.device
        dev.flush()
        t0 = self._mark("flush", t0)
        # ONE batched h2d for all small host-side inputs.
        if T_pred is None:
            last_mp_d, local_idx_d, vo_xyz_d, vo_valid_d = jax.device_put(
                (self.last_mp.astype(np.int32), pts_pad, vo_xyz, vo_valid)
            )
            T_pred_d = _chain_predict(self._chain[0], self._chain[1], frac)
            prev_pose_d = self._chain[0]
        else:
            T_pred_d, prev_pose_d, last_mp_d, local_idx_d, vo_xyz_d, vo_valid_d = (
                jax.device_put(
                    (T_pred, T_prev,
                     self.last_mp.astype(np.int32), pts_pad,
                     vo_xyz, vo_valid)
                )
            )
        t0 = self._mark("upload", t0)
        # Head args are retained for the failed-apply wide retry; the
        # devicemap columns are NOT retained (flush() replaces/donates
        # them) — the retry re-reads the current mirror.
        head_args = (
            self.cfg,
            T_pred_d,
            last_mp_d,
            self.last_frame.octave,
            self.last_frame.desc,
            vo_xyz_d,
            vo_valid_d,
            local_idx_d,
        )
        tail_args = (f, self.K, self.inv_sigma2_levels, self._sf_dev)
        # Lag-scaled stage-1 window: at pipeline lag L the constant-
        # velocity prediction is L frames of extrapolation, so the
        # projection window grows with it (static arg — one compiled
        # variant per lag value).
        # With the device pose chain the prediction lag is 1 regardless
        # of host apply depth; off-chain dispatches extrapolate across the
        # actual lag and widen the stage-1 window accordingly.
        if self._chain is not None:
            radius_mult = 1.0
        else:
            lag = len(self._pending) + 1
            radius_mult = (1.0, 1.5, 2.0)[min(lag - 1, 2)]
        out, chain_pose = _full_track_step(
            *head_args,
            dev.pt_xyz, dev.pt_normal, dev.pt_min_dist, dev.pt_max_dist,
            dev.pt_desc, dev.pt_valid,
            *tail_args,
            radius_mult=radius_mult,
        )
        # Advance the device pose chain (prev, prev2) for the next
        # dispatch's prediction.
        self._chain = (chain_pose, prev_pose_d)
        t0 = self._mark("dispatch", t0)
        # Start the readback on a background worker now: the blocking
        # device_get waits out the readback latency concurrently with the
        # host's mapping stages / next frame build, so apply's .result()
        # is (usually) an already-landed local value. The frame
        # descriptors (for the per-frame point-descriptor refresh) ride
        # the SAME transfer — a second worker fetch cost a second d2h
        # round trip per frame.
        fut = fetch_async(*out, f.desc)
        t0 = self._mark("prefetch", t0)
        # Record the last_mp snapshot: apply must translate match rows
        # through the SAME index view the dispatch used, even if the map
        # mutates in between. head/tail args are kept so a failed apply
        # can retry synchronously with a wide window.
        return (fut, pts_pad, safe, self.last_mp, (head_args, tail_args))

    def _fused_apply(self, f: frame_mod.FrameData, disp):
        """Steady-state hot path, apply half: one (prefetched) readback +
        host bookkeeping. In the pipelined flow this runs at the START of
        the NEXT frame's track() call. On failure, ONE synchronous retry
        re-runs the step with a 3x stage-1 window (the reference's widened
        second search pass, Tracking.cc:888-892) before the caller falls
        through to the reference-keyframe / relocalization chain."""
        fut, pts_pad, safe, last_mp, (head_args, tail_args) = disp
        t0 = time.perf_counter()
        *fetched, f_desc = fut.result()
        t0 = self._mark("fetch", t0)
        ok, pose, mp = self._fused_postprocess(
            f, fetched, pts_pad, safe, last_mp, f_desc
        )
        if ok:
            return ok, pose, mp
        dev = self.map.device
        dev.flush()
        wide, _chain_unused = _full_track_step(
            *head_args,
            dev.pt_xyz, dev.pt_normal, dev.pt_min_dist, dev.pt_max_dist,
            dev.pt_desc, dev.pt_valid,
            *tail_args,
            radius_mult=3.0,
        )
        return self._fused_postprocess(
            f, fetch(*wide), pts_pad, safe, last_mp, f_desc
        )

    def _fused_postprocess(self, f, fetched, pts_pad, safe, last_mp,
                           f_desc=None):
        (
            mm_ok, m1_idx, good_q,
            in_view, m2_idx, m2_valid,
            pose2, inl_feat, n2,
        ) = fetched
        if not bool(mm_ok):
            return False, None, None
        new_mp = np.full(f.xy.shape[0], -1, np.int64)
        new_mp[m1_idx[good_q]] = last_mp[good_q]
        new_mp[m2_idx[m2_valid]] = pts_pad[m2_valid]
        # Mapping stages ran between this frame's dispatch and apply:
        # follow point forwarding and drop tombstones before recording
        # associations (the pipelined analog of _check_replaced_last; the
        # reference's per-object locks prevent this use-after-replace
        # window, MapPoint.cc:177).
        new_mp = self.map.resolve(new_mp)
        dead = (new_mp >= 0) & ~self.map.pt_valid[np.maximum(new_mp, 0)]
        new_mp[dead] = -1
        found = new_mp.copy()
        found[~inl_feat] = -1
        new_mp[~inl_feat] = -1
        n = int(n2)
        vo_mode = self.only_tracking and int((new_mp >= 0).sum()) < 10
        recent_reloc = self.frame_id - self.last_reloc_frame_id < int(
            self.cfg.camera.fps
        )
        need = (
            self.cfg.tracking.min_inliers_local_map_strict
            if recent_reloc
            else self.cfg.tracking.min_inliers_local_map
        )
        if vo_mode:
            # mbVO (reference: Tracking.cc:283-361): few MAP-point matches
            # means we drifted off the mapped region — VO points carry the
            # pose, and relocalization is attempted every frame until the
            # map is reacquired. Accept on pose-opt inliers (VO rows
            # included): the map gate would spuriously drop to LOST
            # outside the mapped region.
            accept = n >= self.cfg.tracking.min_inliers_pose
        else:
            accept = n >= need
        if not accept:
            # No side effects on the MAP on a rejected pass: the wide
            # retry in _fused_apply re-runs this postprocess, and
            # committing visible/found increments or descriptor refreshes
            # here would double-count the frame (skewing the found/visible
            # culling ratio) and bake in stats from a rejected pose. The
            # tracker-local inlier count IS updated so System's thin-drain
            # heuristic and per-frame metrics see this frame, not the
            # previous one, when the sync fallback also fails.
            self.current_inliers = n
            return False, pose2, new_mp
        self.map.pt_visible[safe[in_view]] += 1
        self.map.pt_found[found[found >= 0]] += 1
        # Per-frame descriptor refresh (beyond the reference, which only
        # recomputes representative descriptors on keyframe events,
        # MapPoint.cc:242): an inlier-matched point takes the CURRENT
        # frame's descriptor, so its appearance tracks viewpoint change
        # instead of decaying toward unmatchability. The frame descriptors
        # were prefetched at build; the fetch here is a landed copy.
        feat_sel = np.nonzero(new_mp >= 0)[0]
        if len(feat_sel) and not self.only_tracking:
            if f_desc is None:
                f_desc = fetch(f.desc)
            f_desc = np.asarray(f_desc)
            pt_sel = new_mp[feat_sel]
            self.map.pt_desc[pt_sel] = f_desc[feat_sel]
            self.map.mark_points_dirty(pt_sel)
        self.current_inliers = n
        if self.only_tracking:
            self._vo_mode = vo_mode
        return True, pose2, new_mp

    def _track_reference_kf(self, f: frame_mod.FrameData):
        """Match against the reference keyframe's map points (reference:
        Tracking.cc:757-799; BoW-accelerated there, dense masked here).

        One fused device step and one readback; keyframe descriptors and
        point positions come from the device-resident map."""
        k = self.ref_kf
        if k < 0:
            return False, None, None
        kf_mp = self.map.kf_mp[k]
        T0 = (
            self.last_pose
            if self.last_pose is not None
            else np.eye(3, 4, dtype=np.float32)
        )
        dev = self.map.device
        dev.flush()
        T0_d, k_d, kf_mp_d = jax.device_put(
            (T0.astype(np.float32), np.int32(k), kf_mp.astype(np.int32))
        )
        m_idx, m_valid, pose, inl, n = fetch(
            *_ref_kf_step(
                self.cfg,
                T0_d,
                k_d,
                kf_mp_d,
                dev.kf_desc,
                dev.kf_angle,
                dev.kf_kp_valid,
                dev.pt_xyz,
                dev.pt_valid,
                f,
                self.K,
                self.inv_sigma2_levels,
            )
        )
        if m_valid.sum() < 15:
            return False, None, None
        cur_mp = np.full(f.xy.shape[0], -1, np.int64)
        good_q = m_valid & inl
        cur_mp[m_idx[good_q]] = kf_mp[good_q]
        if n < self.cfg.tracking.min_inliers_pose:
            return False, None, None
        return True, pose, cur_mp

    def _relocalize(self, f: frame_mod.FrameData):
        """Global relocalization (reference: Tracking.cc:1341-1502):
        BoW candidates from the keyframe database when available
        (reloc_provider, set by System), else recent keyframes; then the
        same match -> P4P RANSAC -> pose-opt flow.
        """
        live = self.map.live_keyframes()
        if len(live) == 0:
            return False, None, None
        candidates = []
        provider = getattr(self, "reloc_provider", None)
        if provider is not None:
            f_desc, f_kp_valid = fetch(f.desc, f.valid)
            candidates = list(provider.reloc_candidates(f_desc, f_kp_valid))
        # Always ALSO try the most recent keyframes (by insertion serial —
        # slot ids recycle at capacity): tracking is usually lost near the
        # map frontier, where inverted-file BoW retrieval is weakest (the
        # newest keyframes have the fewest indexed words and observed
        # failures returned only old keyframes). The reference's reloc
        # searches whatever the database returns (Tracking.cc:1355); the
        # union costs one extra batched match dispatch and removes the
        # lost-forever failure mode.
        order = np.argsort(self.map.kf_serial[live])
        recent = [int(k) for k in live[order[-10:]]]
        candidates = list(dict.fromkeys([int(c) for c in candidates] + recent))
        # Dispatch every candidate's match, then read all counts + results
        # down in ONE batched transfer (the reference iterates candidates
        # with early exits, Tracking.cc:1370-1439; latency dominates here).
        pending = []
        for k in candidates:
            kf_mp = self.map.kf_mp[k]
            has = kf_mp >= 0
            if has.sum() < 15:
                continue
            m = match.match(
                jnp.asarray(self.map.kf_desc[k]), f.desc,
                jnp.asarray(has & self.map.kf_kp_valid[k]), f.valid,
                max_dist=self.cfg.matcher.th_low, nn_ratio=0.75,
            )
            pending.append((int(k), m))
        if not pending:
            return False, None, None
        fetched = fetch(*[x for _, m in pending for x in (m.idx, m.valid)])
        best = None
        for (k, _), i in zip(pending, range(0, len(fetched), 2)):
            m_idx, m_valid = fetched[i], fetched[i + 1]
            n = int(m_valid.sum())
            if best is None or n > best[0]:
                best = (n, k, m_idx, m_valid)
        if best is None or best[0] < 15:
            _dbg(f"reloc: best bow match {best[0] if best else 0} < 15")
            return False, None, None
        _, k, m_idx, ok_np = best
        kf_mp = self.map.kf_mp[k]
        cap = f.xy.shape[0]  # pad to keypoint capacity: compile once
        sel = np.full(cap, -1, np.int64)
        nz = np.nonzero(ok_np)[0]
        sel[: len(nz)] = nz
        safe = np.maximum(sel, 0)
        pt_idx = np.where(sel >= 0, kf_mp[safe], 0)
        res = pnp.solve_pnp_ransac(
            jnp.asarray(self.map.pt_xyz[pt_idx]),
            f.xy[jnp.asarray(m_idx[safe])],
            jnp.asarray(sel >= 0),
            self.inv_sigma2_levels[f.octave[jnp.asarray(m_idx[safe])]],
            self.K,
            self._next_key(),
            n_hypotheses=self.cfg.capacity.ransac_pnp_iters,
        )
        res_ok, res_inliers, res_pose = fetch(res.ok, res.inliers, res.pose)
        if not bool(res_ok):
            _dbg(f"reloc: kf {k} matches={best[0]} pnp failed")
            return False, None, None
        cur_mp = np.full(f.xy.shape[0], -1, np.int64)
        inl = res_inliers & (sel >= 0)
        cur_mp[m_idx[safe[inl]]] = pt_idx[inl]
        pose, pin, n = self._optimize_frame_pose(f, res_pose, cur_mp)
        cur_mp[~pin] = -1
        if n < self.cfg.tracking.min_inliers_pose:
            _dbg(f"reloc: kf {k} pose-opt inliers {n} < min")
            return False, None, None
        # Guided-reprojection widening (reference: Tracking.cc:1441-1480):
        # when the pose is supported by too few inliers, project the
        # candidate keyframe's map points at the estimated pose and
        # re-optimize — a coarse 10px round, then a 3px round if close.
        need = self.cfg.tracking.min_inliers_reloc
        if n < need:
            pose, cur_mp, n = self._reloc_widen(f, pose, cur_mp, k, 10.0)
            if self.cfg.tracking.min_inliers_local_map <= n < need:
                pose, cur_mp, n = self._reloc_widen(f, pose, cur_mp, k, 3.0)
        # Final acceptance at >=50 inliers (reference: Tracking.cc:1483).
        if n < need:
            _dbg(f"reloc: kf {k} widened inliers {n} < {need}")
            return False, None, None
        _dbg(f"reloc OK: kf {k} inliers {n}")
        return True, pose, cur_mp

    def _reloc_widen(self, f, pose, cur_mp, k: int, radius: float):
        """One guided-reprojection round against keyframe k's map points
        (reference: ORBmatcher::SearchByProjection reloc variant,
        ORBmatcher.cc:1472-1599, + pose re-optimization)."""
        kf_mp = self.map.kf_mp[k]
        pts = np.unique(kf_mp[kf_mp >= 0])
        pts = pts[self.map.pt_valid[pts]]
        cap = self.cfg.capacity.local_map_max_points
        pts_pad = np.full(cap, -1, np.int32)
        pts_pad[: min(len(pts), cap)] = pts[:cap]
        fresh = (pts_pad >= 0) & ~np.isin(pts_pad, cur_mp[cur_mp >= 0])
        dev = self.map.device
        dev.flush()
        pose_d, local_idx_d, fresh_d, seed_mp_d = jax.device_put(
            (pose.astype(np.float32), pts_pad, fresh,
             cur_mp.astype(np.int32))
        )
        in_view, m_idx, m_valid, pose2, inl, n = fetch(
            *_local_map_step(
                self.cfg,
                pose_d,
                local_idx_d,
                fresh_d,
                seed_mp_d,
                dev.pt_xyz, dev.pt_normal, dev.pt_min_dist,
                dev.pt_max_dist, dev.pt_desc, dev.pt_valid,
                f,
                self.K,
                self.inv_sigma2_levels,
                self._sf_dev,
                radius_override=radius,
                nn_ratio_override=1.0,
            )
        )
        new_mp = cur_mp.copy()
        new_mp[m_idx[m_valid]] = pts_pad[m_valid]
        new_mp[~inl] = -1
        return pose2, new_mp, int(n)

    def _track_local_map(self, f, pose, cur_mp):
        """Widen matches to the covisibility-local map and re-optimize
        (reference: Tracking.cc:930-974, 1143-1230)."""
        local_kfs = self._local_keyframes(cur_mp)
        local_pts = self._local_points(local_kfs)
        if len(local_pts) == 0:
            n = (cur_mp >= 0).sum()
            self.current_inliers = int(n)
            return n >= self.cfg.tracking.min_inliers_pose, pose, cur_mp

        cap = self.cfg.capacity.local_map_max_points
        if len(local_pts) > cap:
            local_pts = local_pts[:cap]
        pts_pad = np.full(cap, -1, np.int32)
        pts_pad[: len(local_pts)] = local_pts
        safe = np.maximum(pts_pad, 0)

        # Exclude points already matched in this frame; frustum check,
        # projection search and pose GN run as ONE fused device step with
        # a single readback. (Search-radius and widened-octave-gate notes:
        # see _local_map_step.)
        fresh = (pts_pad >= 0) & ~np.isin(pts_pad, cur_mp[cur_mp >= 0])
        dev = self.map.device
        dev.flush()
        pose_d, local_idx_d, fresh_d, seed_mp_d = jax.device_put(
            (np.asarray(pose, np.float32), pts_pad, fresh,
             cur_mp.astype(np.int32))
        )
        in_view, m_idx, m_valid, pose2, inl, n = fetch(
            *_local_map_step(
                self.cfg,
                pose_d,
                local_idx_d,
                fresh_d,
                seed_mp_d,
                dev.pt_xyz, dev.pt_normal, dev.pt_min_dist,
                dev.pt_max_dist, dev.pt_desc, dev.pt_valid,
                f,
                self.K,
                self.inv_sigma2_levels,
                self._sf_dev,
            )
        )
        self.map.pt_visible[safe[in_view]] += 1
        new_mp = cur_mp.copy()
        new_mp[m_idx[m_valid]] = pts_pad[m_valid]
        _dbg(
            f"localmap: kfs={len(local_kfs)} pts={len(local_pts)}"
            f" in_view={int(in_view.sum())} fresh={int(fresh.sum())}"
            f" new_matches={int(m_valid.sum())}"
            f" seed_matches={(cur_mp >= 0).sum()}"
        )
        found = new_mp.copy()
        found[~inl] = -1
        self.map.pt_found[found[found >= 0]] += 1
        new_mp[~inl] = -1
        self.current_inliers = n = int(n)

        recent_reloc = self.frame_id - self.last_reloc_frame_id < int(
            self.cfg.camera.fps
        )
        need = (
            self.cfg.tracking.min_inliers_local_map_strict
            if recent_reloc
            else self.cfg.tracking.min_inliers_local_map
        )
        return n >= need, pose2, new_mp

    def _local_keyframes(self, cur_mp) -> list[int]:
        """Covisibility vote (reference: Tracking.cc:1231-1300).

        Vectorized: one bincount over the observation table of the matched
        points (the reference iterates a map<KF*,int>; a Python dict here
        cost ~1 ms/frame at map scale)."""
        pts = cur_mp[cur_mp >= 0]
        Nk = self.map.kf_pose.shape[0]
        if len(pts):
            obs = self.map.pt_obs_kf[pts]
            obs = obs[obs >= 0]
            votes = np.bincount(obs, minlength=Nk)
        else:
            votes = np.zeros(Nk, np.int64)
        if not votes.any():
            return [self.ref_kf] if self.ref_kf >= 0 else []
        order = np.argsort(-votes, kind="stable")
        n_vote = int((votes > 0).sum())
        local = order[: min(n_vote, self.cfg.tracking.max_local_keyframes)]
        local = [int(k) for k in local]
        # Reference KF = most-voting keyframe.
        self.ref_kf = local[0]
        # Add one covisibility ring (K2 set, capped).
        ring = []
        for k in local[:10]:
            ring.extend(self.map.covisible_keyframes(k, n=5, min_weight=15))
        seen = set(local)
        for k in ring:
            if k not in seen and len(local) < self.cfg.tracking.max_local_keyframes:
                local.append(k)
                seen.add(k)
        return local

    def _local_points(self, local_kfs) -> np.ndarray:
        if len(local_kfs) == 0:
            return np.zeros(0, np.int64)
        cols = self.map.kf_mp[np.asarray(local_kfs)].ravel()
        pts = np.unique(cols[cols >= 0])
        if len(pts):
            pts = pts[self.map.pt_valid[pts]]
        return pts

    # ------------------------------------------------------------------
    # Keyframe policy
    # ------------------------------------------------------------------
    def _need_new_keyframe(self, f, cur_mp) -> bool:
        """Reference: Tracking.cc:977-1061 (conditions c1a/c1b/c2 plus the
        mapper-idle gating): when the mapping pipeline is busy, monocular
        drops the keyframe entirely and stereo/RGB-D inserts only while
        the queue is short (Tracking.cc:1039-1057)."""
        n_kf = len(self.map.live_keyframes())
        if n_kf == 0:
            return False
        mapper = getattr(self, "mapper", None)
        if mapper is not None and getattr(mapper, "paused", False):
            # A loop correction's staged window froze the map topology
            # (reference: NeedNewKeyFrame bails while LocalMapping is
            # stopped by a loop closure, Tracking.cc:992-996).
            return False
        # "Accepting keyframes" (reference: AcceptKeyFrames,
        # LocalMapping.cc:55,103): the reference's mapper drains a whole
        # keyframe in one slice, so it is idle between keyframes; our
        # budget-sliced mapper is mid-stage most frames BY DESIGN, and
        # gating c1b on full drain starved keyframe creation down to the
        # c1a floor (~1 KF per max_frames — halved cadence, collapsed
        # covisibility, killed loop detection). No QUEUED keyframe is the
        # equivalent signal; stage-in-flight is the normal state.
        idle = mapper.queue_len() == 0 if mapper is not None else True
        frames = self.frame_id - self.last_kf_frame_id
        # Matches the reference keyframe currently tracks.
        ref_matches = (self.map.kf_mp[self.ref_kf] >= 0).sum() if self.ref_kf >= 0 else 0
        inliers = self.current_inliers
        theta = 0.9 if self.cfg.sensor == Sensor.MONOCULAR else 0.75
        c1a = frames >= self.cfg.tracking.max_frames_between_kf
        c1b = frames >= self.cfg.tracking.min_frames_between_kf and idle
        c2 = inliers < ref_matches * theta and inliers > 15
        # Urgency: tracking is close to the loss threshold — the map needs
        # new points NOW (the reference reaches this state rarely because
        # its mapper drains a keyframe in one slice; our pipelined mapper
        # spreads it over frames, so starvation must not block insertion).
        urgent = c2 and inliers < 2 * self.cfg.tracking.min_inliers_local_map
        if not (c1a or ((c1b or urgent) and c2)):
            return False
        if idle:
            return True
        # Mapper busy. The reference interrupts local BA and queues the
        # keyframe for stereo/RGBD (queue<3) but drops it for monocular
        # (Tracking.cc:1039-1057). Deviation: monocular also queues (with a
        # tighter bound) — dropping starves the pipelined mapper and loses
        # tracking where the reference's fast in-thread mapper would not.
        # The queue cap binds EVERY insertion (urgency only raises it):
        # an uncapped urgent path measured a 28-deep queue on the orbit
        # e2e — triangulated points then arrive ~30 frames late, tracking
        # starves further, and the urgency flood self-sustains.
        limit = 2 if self.cfg.sensor == Sensor.MONOCULAR else 3
        if c1a or urgent:
            limit += 2
        return mapper.queue_len() < limit

    def _create_keyframe(self, f, cur_mp):
        """Promote the frame (reference: Tracking.cc:1063-1141); stereo/RGBD
        also seeds new close points from depth (:1077-1131). All frame
        arrays come down in a single batched readback."""
        mp = self.map
        fh = frame_mod.FrameData(*fetch(*f))
        k = mp.add_keyframe(
            self.frame_id, self.last_pose,
            fh.xy, fh.octave, fh.angle, fh.desc, fh.valid,
            ur=fh.ur, depth=fh.depth,
            timestamp=self.current_timestamp,
        )
        has = np.nonzero(cur_mp >= 0)[0]
        # Dedupe (first feature wins if a point matched twice) then one
        # vectorized observation append.
        _, first = np.unique(cur_mp[has], return_index=True)
        sel = has[np.sort(first)]
        mp.add_observations_batch(cur_mp[sel], k, sel)
        # Stereo/RGBD: create close points for unmatched keypoints.
        if self.cfg.sensor != Sensor.MONOCULAR:
            depth = fh.depth
            close = (
                (depth > 0)
                & (depth < self.cfg.tracking.th_depth * self.cfg.camera.baseline)
                & (cur_mp < 0)
                & fh.valid
            )
            order = np.argsort(np.where(close, depth, np.inf))
            n_new = min(
                int(close.sum()), self.cfg.tracking.max_new_stereo_points
            )
            # Host backprojection (numpy): cheap, avoids a device readback.
            Kc = np.asarray(self.K)
            z = fh.depth
            xc = np.stack(
                [
                    (fh.xy[:, 0] - Kc[2]) * z / Kc[0],
                    (fh.xy[:, 1] - Kc[3]) * z / Kc[1],
                    z,
                ],
                axis=1,
            ).astype(np.float32)
            Tinv = np_se3.inverse(self.last_pose)
            xyz_w = xc @ Tinv[:, :3].T + Tinv[:, 3]
            sel_new = order[:n_new]
            new_idx = mp.add_points_batch(
                xyz_w[sel_new], fh.desc[sel_new], k
            )
            mp.add_observations_batch(new_idx, k, sel_new)
            cur_mp[sel_new] = new_idx
        mp.update_points_batch(np.unique(cur_mp[cur_mp >= 0]))
        mp.update_connections(k)
        self.ref_kf = k
        self.last_kf_frame_id = self.frame_id
        self.new_keyframe = k
        return k
