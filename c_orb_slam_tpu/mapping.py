"""Local mapping: point culling, triangulation, fusion, local BA, KF culling.

Reference: src/LocalMapping.cc — a persistent thread consuming a keyframe
queue (Run :47-112): ProcessNewKeyFrame (:128), MapPointCulling (:170),
CreateNewMapPoints (:207, epipolar search + SVD triangulation + 6 gates),
SearchInNeighbors fusion (:454), Optimizer::LocalBundleAdjustment (:81),
KeyFrameCulling (:632).

Array-program design: a stage invoked by the host loop after each keyframe
insertion (SURVEY.md §2.3: stages instead of threads; "abort BA" becomes a
bounded iteration budget). Triangulation candidates for each neighbor pair are
matched with one epipolar-masked Hamming matrix and triangulated in one vmapped
pass; local BA assembles a fixed-capacity BAProblem and runs the implicit-Schur
PCG solver.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from c_orb_slam_tpu.config import SlamConfig, Sensor
from c_orb_slam_tpu.geometry import camera, se3, triangulate
from c_orb_slam_tpu.ops import match
from c_orb_slam_tpu.optim import ba
from c_orb_slam_tpu.slam_map.mapstate import MapState
from c_orb_slam_tpu.utils.host import fetch, fetch_async, prefetch

import os

_DEBUG = bool(os.environ.get("SLAM_DEBUG"))


def _dbg(*args):
    if _DEBUG:
        print("[map]", *args)


# Sentinel: a pipelined apply stage whose device result has not landed yet
# asks the scheduler to retry next frame instead of blocking the frame loop.
NOT_READY = object()

# Mapping stages run per tracked frame (times 1 + queued keyframes). The
# budget counts stages, not wall-clock ms: a wall-clock budget made mapping
# progress depend on machine load (the orbit e2e flipped between clean and
# lost runs purely with background contention).
_STAGES_PER_FRAME = 4


def _fundamental_from_poses(T1, T2, K):
    """F12 such that x2ᵀ F12 x1 = 0 (reference: LocalMapping.cc:536-553
    ComputeF12 — here x1 in image of KF1, x2 in image of KF2)."""
    T12 = se3.compose(jnp.asarray(T2), se3.inverse(jnp.asarray(T1)))
    R = se3.rotation(T12)
    t = se3.translation(T12)
    tx = jnp.array(
        [[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]], jnp.float32
    )
    Km = jnp.array(
        [[K[0], 0, K[2]], [0, K[1], K[3]], [0, 0, 1]], jnp.float32
    )
    Kinv = jnp.linalg.inv(Km)
    return Kinv.T @ tx @ R @ Kinv


@functools.partial(jax.jit, static_argnames=("cfg",))
def _triangulate_pairs_batch(
    cfg: SlamConfig,
    k1: jnp.ndarray,
    ks: jnp.ndarray,
    free1: jnp.ndarray,
    free2s: jnp.ndarray,
    pair_valid: jnp.ndarray,
    KF_pose: jnp.ndarray,
    KF_xy: jnp.ndarray,
    KF_octave: jnp.ndarray,
    KF_desc: jnp.ndarray,
    K: jnp.ndarray,
    sigma2: jnp.ndarray,
):
    """Epipolar match + ray triangulation + acceptance gates for ALL
    covisible neighbor pairs in one dispatch (reference:
    LocalMapping.cc:207-452 loops neighbors sequentially; here lax.map
    keeps a single program and a single readback).

    Keyframe rows are read from the device-resident mirror by index —
    the host uploads only the free-keypoint masks (kf_mp bookkeeping is
    host-owned) and the neighbor list.

    Gate notes: reprojection at 5.991·sigma2 (reference :363-393); scale
    consistency within 1.5·scaleFactor (reference :395-431). Parallax —
    the reference accepts >1.15 deg (cos<0.9998, :299-320); our corner
    noise floor is higher than OpenCV-FAST-on-real-texture, so ~2 deg.
    """
    sf = cfg.orb.scale_factor
    rf = 1.5 * sf
    T1 = KF_pose[k1]
    xy1 = KF_xy[k1]
    oct1 = KF_octave[k1]
    desc1 = KF_desc[k1]
    c1 = se3.translation(se3.inverse(T1))
    s1 = sigma2[oct1]

    def per_pair(args):
        k2, free2, pv = args
        T2 = KF_pose[k2]
        xy2 = KF_xy[k2]
        oct2 = KF_octave[k2]
        desc2 = KF_desc[k2]
        F12 = _fundamental_from_poses(T1, T2, K)
        emask = match.epipolar_mask(F12, xy1, xy2, sigma2, oct2)
        # Octave agreement +-2 (reference implies +-1 via GetFeaturesInArea
        # level bounds): measured on synthetic texture the same corner
        # fires 1-3 levels apart between views; the tight gate starved
        # triangulation and the map frontier thinned until tracking died.
        oct_ok = jnp.abs(oct1[:, None] - oct2[None, :]) <= 2
        m = match.match(
            desc1, desc2, free1 & pv, free2,
            pair_mask=emask & oct_ok,
            max_dist=cfg.matcher.th_low,
            nn_ratio=cfg.matcher.nn_ratio_mapping,
        )
        uv2 = xy2[m.idx]
        xw, cos_par = triangulate.triangulate_rays(xy1, uv2, T1, T2, K, K)
        z1 = triangulate.depth_in(T1, xw)
        z2 = triangulate.depth_in(T2, xw)
        e1 = jnp.sum((camera.project(se3.apply(T1, xw), K) - xy1) ** 2, axis=1)
        e2 = jnp.sum((camera.project(se3.apply(T2, xw), K) - uv2) ** 2, axis=1)
        s2 = sigma2[oct2[m.idx]]
        c2 = se3.translation(se3.inverse(T2))
        d1 = jnp.linalg.norm(xw - c1, axis=1)
        d2 = jnp.linalg.norm(xw - c2, axis=1)
        ratio_dist = d2 / jnp.maximum(d1, 1e-9)
        ratio_oct = sf ** oct1.astype(jnp.float32) / sf ** oct2[m.idx].astype(
            jnp.float32
        )
        good = (
            m.valid
            & (cos_par < 0.99939)
            & (z1 > 0) & (z2 > 0)
            & (e1 < 5.991 * s1) & (e2 < 5.991 * s2)
            & (ratio_dist * rf > ratio_oct) & (ratio_dist < ratio_oct * rf)
        )
        # Compact: surviving candidates first (device-side), so the host
        # readback is K rows instead of the full keypoint capacity —
        # readback bytes, not FLOPs, bound this stage. n_good rides along
        # so the host can COUNT survivors dropped by the cap (metrics
        # counter tri_compact_dropped — silent truncation is a perf lie).
        order = jnp.argsort(~good)[:TRI_COMPACT_K]
        return (
            order.astype(jnp.int32),
            m.idx[order],
            good[order],
            xw[order],
            jnp.sum(good).astype(jnp.int32),
        )

    # Pairs are independent: run them vmapped (batch_size) instead of the
    # sequential lax.map default — P sequential small-kernel chains are
    # launch-latency-bound; batched they are a handful of large launches.
    return jax.lax.map(
        per_pair, (ks, free2s, pair_valid),
        batch_size=ks.shape[0],
    )


# Max new-point candidates kept per neighbor pair (readback compaction).
TRI_COMPACT_K = 384


@functools.partial(jax.jit, static_argnames=("cfg",))
def _fuse_pairs_batch(
    cfg: SlamConfig,
    dsts: jnp.ndarray,
    pts_idx: jnp.ndarray,
    KF_pose: jnp.ndarray,
    KF_xy: jnp.ndarray,
    KF_octave: jnp.ndarray,
    KF_desc: jnp.ndarray,
    KF_kp_valid: jnp.ndarray,
    PT_xyz: jnp.ndarray,
    PT_normal: jnp.ndarray,
    PT_mind: jnp.ndarray,
    PT_maxd: jnp.ndarray,
    PT_desc: jnp.ndarray,
    PT_valid: jnp.ndarray,
    K: jnp.ndarray,
    sf: jnp.ndarray,
):
    """Frustum + projection-guided fuse matching for ALL (src→dst) pairs
    in one dispatch (reference: ORBmatcher.cc:825-975 Fuse, called per
    neighbor from LocalMapping::SearchInNeighbors :454-534).

    Keyframe and point rows come from the device-resident mirror; the
    host uploads only the pair index table (dst keyframe + candidate
    point indices per pair)."""
    from c_orb_slam_tpu.tracking import frustum_check

    def per_pair(args):
        dst_k, prow = args
        T = KF_pose[dst_k]
        xy = KF_xy[dst_k]
        octv = KF_octave[dst_k]
        desc = KF_desc[dst_k]
        kp_valid = KF_kp_valid[dst_k]
        safe = jnp.maximum(prow, 0)
        xyz = PT_xyz[safe]
        normal = PT_normal[safe]
        dmin = PT_mind[safe]
        dmax = PT_maxd[safe]
        pdesc = PT_desc[safe]
        pmask = (prow >= 0) & PT_valid[safe]
        in_view, uv, octave, _ = frustum_check(
            T, xyz, normal, dmin, dmax, pmask, K,
            img_w=cfg.camera.width,
            img_h=cfg.camera.height,
            log_scale=float(np.log(cfg.orb.scale_factor)),
            n_levels=cfg.orb.n_levels,
        )
        # Radius 4 (reference 3, ORBmatcher.cc:848) and octave gate
        # [-3, +2] (reference [-1, +1]): same scale-prediction spread as
        # the tracking projection search — see _local_map_step.
        radii = 4.0 * sf[octave]
        m = match.search_by_projection(
            uv, radii, pdesc, in_view,
            xy, octv, desc, kp_valid,
            jnp.maximum(octave - 3, 0),
            jnp.minimum(octave + 2, cfg.orb.n_levels - 1),
            max_dist=cfg.matcher.th_low,
            nn_ratio=1.0,
        )
        # Compact matches first: the host readback shrinks from the point
        # capacity to K rows per pair. n_valid rides along so the host can
        # COUNT matches dropped by the cap (metrics counter
        # fuse_compact_dropped).
        order = jnp.argsort(~m.valid)[:FUSE_COMPACT_K]
        return (
            order.astype(jnp.int32), m.idx[order], m.valid[order],
            jnp.sum(m.valid).astype(jnp.int32),
        )

    # Independent pairs: vmap in chunks of 8 (a full vmap over the 32-pair
    # capacity would hold ~1 GB of (point_cap, kp_cap) distance matrices
    # live; chunking keeps the working set ~256 MB while still amortizing
    # kernel launch latency).
    return jax.lax.map(per_pair, (dsts, pts_idx), batch_size=8)


# Max fuse matches kept per (src,dst) pair (readback compaction).
FUSE_COMPACT_K = 384


class LocalMapping:
    def __init__(self, cfg: SlamConfig, mapstate: MapState):
        self.cfg = cfg
        self.map = mapstate
        self.recent_points: list[tuple[int, int]] = []  # (pt, born_serial)
        self.K = camera.intrinsics_array(cfg.camera)
        self.sigma2 = np.asarray(cfg.orb.level_sigma2(), np.float32)
        self.sf = np.asarray(cfg.orb.scale_factors(), np.float32)
        # Cached device constants: jnp.asarray of the same numpy array is
        # a fresh host->device transfer every call.
        self._sigma2_dev = jnp.asarray(self.sigma2)
        self._sf_dev = jnp.asarray(self.sf)
        # Deferred (NOT_READY) apply halves let XLA's async execution
        # overlap mapping compute with tracking: each apply waits exactly
        # ONE frame for its readback, on every backend. Probing fut.done()
        # instead made mapping progress depend on background-thread
        # scheduling (the orbit e2e flipped outcomes between runs). The
        # System's thin-margin catch-up drain (system.py) rescues tracking
        # when mapping falls behind.
        self._defer_applies = True
        # Pipeline state: pending keyframes + remaining stages of the one
        # being processed (reference: the LocalMapping thread's queue,
        # LocalMapping.cc:114-119; stage interleaving replaces the thread,
        # SURVEY.md §2.3 item 1).
        self.queue: list[int] = []
        self._stages: list = []
        self._current_kf: int = -1
        self.on_keyframe_done = None  # callback(kf) -> feeds LoopClosing
        self.metrics = None  # optional Metrics registry (set by System)
        # Set by LoopClosing for the staged-correction window: keyframes
        # queue but no stage runs, so the map topology is frozen while
        # the essential graph solves (reference: RequestStop/Release,
        # LoopClosing.cc:408,582).
        self.paused = False

    # ------------------------------------------------------------------
    def warm_programs(self):
        """Pre-compile (or pre-load from the persistent cache) the local
        BA programs for BOTH size buckets used by _ba_dispatch. The
        small->full bucket transition otherwise lands a first-call compile
        on an arbitrary mid-sequence frame. The reference pays its
        startup cost loading ORBvoc.txt (System.cc:64); pre-compiling at
        init is the array-program analog."""
        cap = self.cfg.capacity
        outs = []
        for small, (C, P, O) in (
            (True, (16, 2048, 4096)),
            (False, (cap.local_ba_max_kfs * 2, cap.local_ba_max_points,
                     cap.local_ba_max_obs)),
        ):
            prob = ba.BAProblem(
                cam_T=jnp.tile(jnp.eye(3, 4, dtype=jnp.float32), (C, 1, 1)),
                cam_fixed=jnp.zeros(C, bool).at[0].set(True),
                cam_valid=jnp.zeros(C, bool).at[:2].set(True),
                points=jnp.tile(
                    jnp.asarray([0.0, 0.0, 5.0], jnp.float32), (P, 1)
                ),
                point_valid=jnp.zeros(P, bool).at[:4].set(True),
                obs_cam=jnp.zeros(O, jnp.int32),
                obs_pt=jnp.zeros(O, jnp.int32),
                obs_uv=jnp.zeros((O, 3), jnp.float32),
                obs_stereo=jnp.zeros(O, bool),
                obs_inv_sigma2=jnp.ones(O, jnp.float32),
                obs_valid=jnp.zeros(O, bool).at[:8].set(True),
                K=self.K,
                bf=jnp.asarray(np.float32(self.cfg.camera.bf)),
            )
            # Route through the SAME dispatch point as the live path so
            # the warmed program is the one that actually runs (at >1
            # device the full bucket goes through parallel/dba).
            outs.append(self._solve_local_ba(prob, small, O).cam_T)
        jax.block_until_ready(outs)

    def insert_keyframe(self, kf: int):
        """Enqueue a keyframe for mapping (reference:
        LocalMapping::InsertKeyFrame, LocalMapping.cc:114-119)."""
        self.queue.append(kf)

    def idle(self) -> bool:
        """The reference's AcceptKeyFrames signal (LocalMapping.cc:55,103):
        tracking consults this for the keyframe decision."""
        return not self.queue and not self._stages

    def queue_len(self) -> int:
        return len(self.queue) + (1 if self._stages else 0)

    def step(self):
        """Run mapping stages under a per-frame stage budget. Called once
        per tracked frame: mapping proceeds at keyframe rate while tracking
        continues — the host-loop equivalent of the reference's mapping
        thread.

        Dispatch halves are async and apply halves defer one frame via
        NOT_READY while their background readback lands, so several stages fit
        one budget and a keyframe clears the pipeline in 2-3 frames. (The
        earlier one-stage-per-frame schedule kept the mapper 'busy' for ~10
        frames per keyframe, which suppressed the c1b keyframe condition until
        tracking was nearly starved — keyframes arrived reactively instead of
        proactively.)

        The budget scales with queue depth: a backed-up mapper is behind
        the map's needs (its new points arrive late, starving tracking),
        so it spends more of each frame catching up until the queue
        clears."""
        if self.paused:
            return
        stage_budget = _STAGES_PER_FRAME * (1 + len(self.queue))
        n_stages = 0
        while True:
            if not self._stages:
                if not self.queue:
                    return
                self._current_kf = self.queue.pop(0)
                kf = self._current_kf
                # Each batched stage is split into a dispatch half (enqueue
                # device work, return immediately) and an apply half (one
                # readback + host bookkeeping) run on the NEXT frame — so
                # the device crunches mapping work while the host tracks,
                # like the reference's concurrent mapping thread.
                self._stages = [
                    ("cull_pts", lambda k=kf: self._cull_recent_points(k)),
                    ("tri_dispatch", lambda k=kf: self._triangulate_dispatch(k)),
                    ("tri_apply", lambda: self._triangulate_apply(
                        defer_ok=self._defer_applies)),
                    ("fuse_dispatch", lambda k=kf: self._fuse_dispatch(k)),
                    ("fuse_apply", lambda: self._fuse_apply(
                        defer_ok=self._defer_applies)),
                    ("ba_dispatch", lambda k=kf: self._ba_dispatch_if_ready(k)),
                    ("ba_apply", lambda: self._ba_apply(
                        defer_ok=self._defer_applies)),
                    ("finish_kf", lambda k=kf: self._finish_keyframe(k)),
                ]
            name, fn = self._stages[0]
            if self.metrics is not None:
                with self.metrics.stage("map." + name):
                    r = fn()
            else:
                r = fn()
            if r is NOT_READY:
                # Deferred one frame: leave the stage queued and give the
                # frame loop its slot back.
                return
            self._stages.pop(0)
            n_stages += 1
            if n_stages >= stage_budget:
                return

    def drain(self):
        """Run the pipeline to empty (shutdown/reset/loop-closing barrier —
        the reference's RequestStop + spin-wait, LoopClosing.cc:408-429).
        A no-op while paused: the correction window owns the map; the
        System's shutdown loop drains the correction first."""
        while not self.paused and (self.queue or self._stages):
            self.step()

    def _ba_dispatch_if_ready(self, kf: int):
        if len(self.map.live_keyframes()) > 2:
            self._ba_dispatch(kf)

    def _finish_keyframe(self, kf: int):
        self._cull_keyframes(kf)
        self.map.big_change_idx += 1
        if self.on_keyframe_done is not None and self.map.kf_valid[kf]:
            self.on_keyframe_done(kf)

    # ------------------------------------------------------------------
    def process_keyframe(self, kf: int):
        """Full synchronous mapping pass for one keyframe (reference Run
        loop order, LocalMapping.cc:62-87). The live System pipelines the
        same stages through step(); this entry point remains for tests,
        drains, and offline use."""
        n0 = int(self.map.pt_valid.sum())
        self._cull_recent_points(kf)
        n1 = int(self.map.pt_valid.sum())
        self._create_new_points(kf)
        n2 = int(self.map.pt_valid.sum())
        self._fuse_neighbors(kf)
        n3 = int(self.map.pt_valid.sum())
        if len(self.map.live_keyframes()) > 2:
            self._local_ba(kf)
        n4 = int(self.map.pt_valid.sum())
        self._finish_keyframe(kf)
        n5 = int(self.map.pt_valid.sum())
        _dbg(f"pts: start={n0} cull:{n1-n0:+d} tri:{n2-n1:+d} fuse:{n3-n2:+d} ba:{n4-n3:+d} kfcull:{n5-n4:+d}")

    # ------------------------------------------------------------------
    def _cull_recent_points(self, kf: int):
        """Found-ratio and observation-count gates (reference:
        LocalMapping.cc:170-205)."""
        keep = []
        serial_now = int(self.map.kf_serial[kf])
        for pt, born in self.recent_points:
            if not self.map.pt_valid[pt]:
                continue
            age = serial_now - born
            found_ratio = self.map.pt_found[pt] / max(self.map.pt_visible[pt], 1)
            min_obs = 2 if self.cfg.sensor == Sensor.MONOCULAR else 3
            if found_ratio < self.cfg.mapping.min_found_ratio:
                self.map.erase_point(pt)
            elif age >= 2 and self.map.pt_n_obs[pt] <= min_obs:
                self.map.erase_point(pt)
            elif age >= 3:
                pass  # graduated
            else:
                keep.append((pt, born))
        self.recent_points = keep

    # ------------------------------------------------------------------
    def _create_new_points(self, kf: int):
        """Triangulate unmatched keypoints against covisible neighbors
        (reference: LocalMapping.cc:207-452): one batched dispatch + one
        readback. Synchronous wrapper; the pipeline runs the dispatch and
        apply halves on different frames so device compute overlaps the
        next tracked frame."""
        self._triangulate_dispatch(kf)
        self._triangulate_apply()

    def _triangulate_dispatch(self, kf: int):
        self._pending_tri = None
        n_neigh = (
            self.cfg.mapping.triangulation_neighbors_mono
            if self.cfg.sensor == Sensor.MONOCULAR
            else self.cfg.mapping.triangulation_neighbors_stereo
        )
        neighbors = self.map.covisible_keyframes(kf, n=n_neigh, min_weight=1)
        c1 = self.map.keyframe_center(kf)
        med_depth = self._median_depth(kf)

        k2s = []
        for k2 in neighbors:
            c2 = self.map.keyframe_center(k2)
            baseline = float(np.linalg.norm(c2 - c1))
            if self.cfg.sensor == Sensor.MONOCULAR:
                # Require baseline/scene-depth ratio (reference :246-254).
                if med_depth > 0 and baseline / med_depth < 0.01:
                    continue
            else:
                if baseline < self.cfg.camera.baseline:
                    continue
            k2s.append(k2)
        if not k2s:
            return
        mp = self.map
        k1 = kf
        free1 = mp.kf_kp_valid[k1] & (mp.kf_mp[k1] < 0)
        if free1.sum() < 5:
            return
        P = n_neigh  # static pair capacity: compile once per config
        ks = (k2s + [k2s[-1]] * P)[:P]
        pair_valid = np.zeros(P, bool)
        pair_valid[: min(len(k2s), P)] = True
        free2 = mp.kf_kp_valid[ks] & (mp.kf_mp[ks] < 0)
        pair_valid &= free2.sum(axis=1) >= 5
        if not pair_valid.any():
            return

        dev = mp.device
        dev.flush()
        k1_d, ks_d, free1_d, free2_d, pv_d = jax.device_put(
            (np.int32(k1), np.asarray(ks, np.int32), free1, free2,
             pair_valid)
        )
        result = _triangulate_pairs_batch(
            self.cfg,
            k1_d,
            ks_d,
            free1_d,
            free2_d,
            pv_d,
            dev.kf_pose, dev.kf_xy, dev.kf_octave, dev.kf_desc,
            self.K,
            self._sigma2_dev,
        )
        fut = fetch_async(*result)  # lands during the next tracked frame
        self._pending_tri = (k1, ks, k2s, pair_valid, fut)

    def _triangulate_apply(self, defer_ok: bool = False):
        if getattr(self, "_pending_tri", None) is None:
            return
        if defer_ok and not getattr(self, "_tri_waits", 0):
            self._tri_waits = 1
            return NOT_READY
        self._tri_waits = 0
        k1, ks, k2s, pair_valid, fut = self._pending_tri
        self._pending_tri = None
        mp = self.map
        src1, idx2, good, xw, n_good = fut.result()  # (P,K) x4 + (P,)
        dropped = int(
            np.maximum(n_good[pair_valid] - good.shape[1], 0).sum()
        )
        if dropped and self.metrics is not None:
            self.metrics.count("tri_compact_dropped", dropped)
        # Vectorized insertion (the reference creates MapPoints one at a
        # time in the neighbor loop, LocalMapping.cc:286-449; a Python loop
        # here cost ~300 ms/keyframe at map scale).
        P, Kc = good.shape
        k2_arr = np.asarray(ks, np.int64)
        ok = good & pair_valid[:, None]
        # Conflict gates against current map state.
        ok &= mp.kf_mp[k1, src1] < 0
        ok &= mp.kf_mp[k2_arr[:, None], idx2] < 0
        pi_f, j_f = np.nonzero(ok)
        i_f = src1[pi_f, j_f]
        # First winner per k1-feature across pairs (pair order = covisibility
        # order, matching the reference's sequential neighbor loop).
        _, first = np.unique(i_f, return_index=True)
        first = np.sort(first)
        pi_f, j_f, i_f = pi_f[first], j_f[first], i_f[first]
        k2_f = k2_arr[pi_f]
        n_new = len(i_f)
        if n_new:
            new_idx = mp.add_points_batch(
                xw[pi_f, j_f], mp.kf_desc[k1][i_f], k1
            )
            j2 = idx2[pi_f, j_f]
            mp.pt_obs_kf[new_idx, 0] = k1
            mp.pt_obs_feat[new_idx, 0] = i_f
            mp.pt_obs_kf[new_idx, 1] = k2_f
            mp.pt_obs_feat[new_idx, 1] = j2
            mp.pt_n_obs[new_idx] = 2
            mp.kf_mp[k1, i_f] = new_idx
            mp.kf_mp[k2_f, j2] = new_idx
            mp.update_points_batch(new_idx)
            born = int(mp.kf_serial[k1])
            self.recent_points.extend((int(p), born) for p in new_idx)
            mp.update_connections(k1)
            for k2 in set(k2s):
                mp.update_connections(k2)
        _dbg(f"tri batch kf={k1}: pairs={len(k2s)} new={n_new}")

    def _median_depth(self, kf: int) -> float:
        mp = self.map.kf_mp[kf]
        pts = mp[mp >= 0]
        if len(pts) == 0:
            return -1.0
        T = self.map.kf_pose[kf]
        z = self.map.pt_xyz[pts] @ T[2, :3] + T[2, 3]
        return float(np.median(z))

    # ------------------------------------------------------------------
    def _fuse_neighbors(self, kf: int):
        """Two-way duplicate fusion with first/second-order neighbors
        (reference: LocalMapping.cc:454-534 SearchInNeighbors) — every
        (src→dst) pair matched in one batched dispatch + one readback;
        the merge bookkeeping stays on host. Synchronous wrapper; the
        pipeline splits dispatch and apply across frames."""
        self._fuse_dispatch(kf)
        self._fuse_apply()

    def _fuse_dispatch(self, kf: int):
        self._pending_fuse = None
        mp = self.map
        neighbors = mp.covisible_keyframes(kf, n=10, min_weight=15)
        ring = set(neighbors)
        for k in list(neighbors)[:5]:
            for k2 in mp.covisible_keyframes(k, n=5, min_weight=15):
                if k2 != kf:
                    ring.add(k2)
        if not ring:
            return
        pairs = []
        for k2 in sorted(ring):
            pairs.append((kf, k2))  # kf's points into k2
            pairs.append((k2, kf))  # k2's points into kf

        # Gather per-pair host data; skip pairs with no live src points.
        cap = mp.kf_mp.shape[1]
        live_pairs, pts_per_pair = [], []
        for src, dst in pairs:
            src_pts = mp.kf_mp[src]
            has = src_pts >= 0
            if not has.any():
                continue
            pts_live = np.unique(src_pts[has])
            pts_live = pts_live[mp.pt_valid[pts_live]]
            if len(pts_live) == 0:
                continue
            pts = np.full(cap, -1, np.int64)
            pts[: len(pts_live)] = pts_live[:cap]
            live_pairs.append((src, dst))
            pts_per_pair.append(pts)
        if not live_pairs:
            return
        # FIXED pair capacity: one compile for the whole run. A growing
        # power-of-two bucket recompiled _fuse_pairs_batch mid-run,
        # stalling the frames at bucket transitions. Pairs
        # beyond the cap are dropped (ring neighbors are sorted by
        # covisibility order, so the strongest pairs survive).
        P = self.cfg.capacity.fuse_max_pairs
        n_real = min(len(live_pairs), P)
        if len(live_pairs) > P:
            _dbg(f"fuse: dropping {len(live_pairs) - P} pairs beyond cap {P}")
            if self.metrics is not None:
                self.metrics.count("fuse_pairs_dropped", len(live_pairs) - P)
            live_pairs = live_pairs[:P]
            pts_per_pair = pts_per_pair[:P]
        while len(live_pairs) < P:
            live_pairs.append(live_pairs[-1])
            pts_per_pair.append(np.full(cap, -1, np.int64))
        pts_arr = np.stack(pts_per_pair)  # (P, cap)
        dsts = [d for _, d in live_pairs]

        dev = mp.device
        dev.flush()
        dsts_d, pts_idx_d = jax.device_put(
            (np.asarray(dsts, np.int32), pts_arr.astype(np.int32))
        )
        result = _fuse_pairs_batch(
            self.cfg,
            dsts_d,
            pts_idx_d,
            dev.kf_pose, dev.kf_xy, dev.kf_octave, dev.kf_desc,
            dev.kf_kp_valid,
            dev.pt_xyz, dev.pt_normal, dev.pt_min_dist, dev.pt_max_dist,
            dev.pt_desc, dev.pt_valid,
            self.K,
            self._sf_dev,
        )
        fut = fetch_async(*result)  # lands during the next tracked frame
        self._pending_fuse = (kf, live_pairs, pts_arr, n_real, fut)

    def _fuse_apply(self, defer_ok: bool = False):
        if getattr(self, "_pending_fuse", None) is None:
            return
        if defer_ok and not getattr(self, "_fuse_waits", 0):
            self._fuse_waits = 1
            return NOT_READY
        self._fuse_waits = 0
        kf, live_pairs, pts_arr, n_real, fut = self._pending_fuse
        self._pending_fuse = None
        mp = self.map
        src_rows, m_idx, m_valid, n_valid = fut.result()
        dropped = int(
            np.maximum(n_valid[:n_real] - m_valid.shape[1], 0).sum()
        )
        if dropped and self.metrics is not None:
            self.metrics.count("fuse_compact_dropped", dropped)
        for pi in range(n_real):
            _, dst = live_pairs[pi]
            pts = pts_arr[pi]
            rows = src_rows[pi]
            ok = m_valid[pi] & (pts[rows] >= 0)
            sel = np.nonzero(ok)[0]
            if len(sel) == 0:
                continue
            p_sel = pts[rows[sel]]
            f_sel = m_idx[pi][sel].astype(np.int64)
            alive = mp.pt_valid[p_sel]  # not merged away by earlier pair
            p_sel, f_sel = p_sel[alive], f_sel[alive]
            existing = mp.kf_mp[dst, f_sel]
            ex_live = (existing >= 0) & mp.pt_valid[np.maximum(existing, 0)]
            # Plain additions (no conflicting point at the feature):
            # vectorized append. Dedupe points within the batch (a point may
            # project onto two features; keep the first, like the
            # sequential reference loop ORBmatcher.cc:952-971).
            add_p, add_f = p_sel[~ex_live], f_sel[~ex_live]
            _, first = np.unique(add_p, return_index=True)
            first = np.sort(first)
            mp.add_observations_batch(add_p[first], dst, add_f[first])
            # Conflicts: merge keeping the better-observed point (rare —
            # host loop over the handful of collisions only).
            for p, ex in zip(p_sel[ex_live], existing[ex_live]):
                p, ex = int(p), int(ex)
                if p == ex or not mp.pt_valid[p] or not mp.pt_valid[ex]:
                    continue
                if mp.pt_n_obs[ex] >= mp.pt_n_obs[p]:
                    mp.replace_point(p, ex)
                else:
                    mp.replace_point(ex, p)
        mp.update_connections(kf)

    # ------------------------------------------------------------------
    def _local_ba(self, kf: int):
        """Windowed BA on the covisibility neighborhood (reference:
        Optimizer.cc:453-778 LocalBundleAdjustment). Synchronous wrapper;
        the pipeline splits dispatch and apply across frames."""
        self._ba_dispatch(kf)
        self._ba_apply()

    def _ba_dispatch(self, kf: int):
        self._pending_ba = None
        mp = self.map
        cap = self.cfg.capacity
        local = [kf] + mp.covisible_keyframes(
            kf, n=cap.local_ba_max_kfs - 1, min_weight=1
        )
        local = local[: cap.local_ba_max_kfs]
        local_set = set(local)

        pts = set()
        for k in local:
            col = mp.kf_mp[k]
            pts.update(col[col >= 0].tolist())
        pts = np.asarray(sorted(pts), np.int64)
        if len(pts):
            pts = pts[mp.pt_valid[pts]]
        pts = pts[: cap.local_ba_max_points]

        # Fixed frontier: keyframes observing local points but not local
        # (vectorized — the per-point Python walk cost O(points) host ms).
        if len(pts):
            okf = mp.pt_obs_kf[pts]  # (Pl, Mo)
            is_local = np.zeros(mp.kf_pose.shape[0] + 1, bool)
            is_local[list(local_set)] = True
            seen = okf[(okf >= 0) & ~is_local[okf]]
            frontier = np.unique(seen).tolist()
        else:
            frontier = []
        cams = local + sorted(frontier)
        cams = cams[: cap.local_ba_max_kfs * 2]
        cam_slot = {k: i for i, k in enumerate(cams)}
        # Problem capacities: TWO size buckets (small / full). The solver
        # is compiled once per bucket; early maps fit the small bucket
        # where one LM iteration is ~7x cheaper than at full padding
        # (measured: 134 ms -> 40 ms for the whole 15-iteration solve).
        # More buckets were tried round 1 and the mid-run recompiles
        # dominated; with exactly two (plus the persistent compilation
        # cache) the transition costs one compile per process lifetime.
        n_obs_est = int(np.count_nonzero(mp.pt_obs_kf[pts] >= 0)) if len(pts) else 0
        small = (
            len(cams) <= 16
            and len(pts) <= 2048
            and n_obs_est <= 4096
        )
        if small:
            C, P, O = 16, 2048, 4096
        else:
            C = cap.local_ba_max_kfs * 2
            P = cap.local_ba_max_points
            O = cap.local_ba_max_obs

        cam_T = np.tile(np.eye(3, 4, dtype=np.float32), (C, 1, 1))
        cam_fixed = np.ones(C, bool)
        cam_valid = np.zeros(C, bool)
        for k, i in cam_slot.items():
            cam_T[i] = mp.kf_pose[k]
            cam_valid[i] = True
            cam_fixed[i] = k not in local_set
        # Gauge: fix the oldest local keyframe too (reference fixes KF 0 or
        # the frontier; with no frontier early on, pin the oldest). Age by
        # serial — slot ids recycle.
        if len(frontier) == 0 and len(local) > 0:
            by_age = sorted(local, key=lambda k: mp.kf_serial[k])
            cam_fixed[cam_slot[by_age[0]]] = True
            if self.cfg.sensor == Sensor.MONOCULAR and len(local) > 1:
                # Pin scale gauge with a second fixed camera.
                cam_fixed[cam_slot[by_age[1]]] = True

        points = np.zeros((P, 3), np.float32)
        point_valid = np.zeros(P, bool)
        points[: len(pts)] = mp.pt_xyz[pts]
        point_valid[: len(pts)] = True

        # Vectorized observation assembly (the reference builds g2o edges
        # one virtual call at a time, Optimizer.cc:520-650).
        inv_sigma2 = 1.0 / self.sigma2
        Mo = mp.pt_obs_kf.shape[1]
        obs_kf_all = mp.pt_obs_kf[pts]  # (Pl, Mo)
        obs_feat_all = mp.pt_obs_feat[pts]
        slot_of_kf = np.full(mp.kf_pose.shape[0], -1, np.int32)
        for k, i in cam_slot.items():
            slot_of_kf[k] = i
        ci_all = np.where(obs_kf_all >= 0, slot_of_kf[obs_kf_all], -1)
        keep = ci_all >= 0
        si_all = np.broadcast_to(
            np.arange(len(pts), dtype=np.int32)[:, None], keep.shape
        )
        sel_p, sel_o = np.nonzero(keep)
        sel_p, sel_o = sel_p[:O], sel_o[:O]
        n_obs = len(sel_p)
        kfs_sel = obs_kf_all[sel_p, sel_o]
        feats_sel = obs_feat_all[sel_p, sel_o]

        obs_cam = np.zeros(O, np.int32)
        obs_pt = np.zeros(O, np.int32)
        obs_uv = np.zeros((O, 3), np.float32)
        obs_stereo = np.zeros(O, bool)
        obs_isig = np.ones(O, np.float32)
        obs_valid = np.zeros(O, bool)
        obs_cam[:n_obs] = ci_all[sel_p, sel_o]
        obs_pt[:n_obs] = si_all[sel_p, sel_o]
        uv_sel = mp.kf_xy[kfs_sel, feats_sel]
        ur_sel = mp.kf_ur[kfs_sel, feats_sel]
        stereo_sel = ur_sel > 0
        obs_uv[:n_obs, :2] = uv_sel
        obs_uv[:n_obs, 2] = np.where(stereo_sel, ur_sel, 0.0)
        obs_stereo[:n_obs] = stereo_sel
        obs_isig[:n_obs] = inv_sigma2[mp.kf_octave[kfs_sel, feats_sel]]
        obs_valid[:n_obs] = True

        # One batched h2d for the whole problem: one transfer call in
        # place of a dozen.
        up = jax.device_put(
            (cam_T, cam_fixed, cam_valid, points, point_valid, obs_cam,
             obs_pt, obs_uv, obs_stereo, obs_isig, obs_valid,
             np.float32(self.cfg.camera.bf))
        )
        problem = ba.BAProblem(
            cam_T=up[0], cam_fixed=up[1], cam_valid=up[2], points=up[3],
            point_valid=up[4], obs_cam=up[5], obs_pt=up[6], obs_uv=up[7],
            obs_stereo=up[8], obs_inv_sigma2=up[9], obs_valid=up[10],
            K=self.K, bf=up[11],
        )
        result = self._solve_local_ba(problem, small, O)
        fut = fetch_async(result.cam_T, result.points, result.obs_inlier)
        self._pending_ba = (
            cam_slot, cam_fixed, pts, n_obs, obs_pt, obs_valid, kfs_sel,
            fut,
        )

    def _solve_local_ba(self, problem, small: bool, O: int):
        """Dispatch the local BA solve — the ONE routing point shared by
        _ba_dispatch and warm_programs (so warmup compiles exactly the
        programs the live path runs)."""
        if not small and len(jax.devices()) > 1:
            # Full-bucket window on a multi-device mesh: shard the
            # observation axis (parallel/dba — GSPMD partitions the
            # per-obs work, psum reduces the small camera system over
            # NVLink). Small buckets stay single-device: sharding a tiny
            # problem costs more in collectives than it saves.
            from c_orb_slam_tpu.parallel import dba as dba_mod

            mesh = dba_mod.make_mesh(jax.devices())
            result = dba_mod.distributed_bundle_adjust(
                dba_mod.pad_observations(problem, len(jax.devices())),
                mesh,
                iters_first=self.cfg.optimizer.local_ba_its_first,
                iters_second=self.cfg.optimizer.local_ba_its_second,
                chi2_mono=self.cfg.optimizer.chi2_mono,
                chi2_stereo=self.cfg.optimizer.chi2_stereo,
                pcg_iters=self.cfg.optimizer.pcg_iters,
                schur="dense",
            )
            # Slice the obs padding back off so apply-side indexing is
            # unchanged (padding is appended).
            return result._replace(obs_inlier=result.obs_inlier[:O])
        return ba.bundle_adjust(
            problem,
            iters_first=self.cfg.optimizer.local_ba_its_first,
            iters_second=self.cfg.optimizer.local_ba_its_second,
            chi2_mono=self.cfg.optimizer.chi2_mono,
            chi2_stereo=self.cfg.optimizer.chi2_stereo,
            pcg_iters=self.cfg.optimizer.pcg_iters,
            schur="dense",  # local window: direct dense Schur solve
        )

    def _ba_apply(self, defer_ok: bool = False):
        if getattr(self, "_pending_ba", None) is None:
            return
        if defer_ok and not getattr(self, "_ba_waits", 0):
            self._ba_waits = 1
            return NOT_READY
        self._ba_waits = 0
        (cam_slot, cam_fixed, pts, n_obs, obs_pt, obs_valid, kfs_sel,
         fut) = self._pending_ba
        self._pending_ba = None
        mp = self.map
        new_T, new_pts, inlier = fut.result()
        _dbg(
            f"localBA: cams={len(cam_slot)} pts={len(pts)} obs={n_obs}"
            f" inliers={int(inlier.sum())}"
        )
        for k, i in cam_slot.items():
            if not cam_fixed[i]:
                mp.kf_pose[k] = new_T[i]
        mp.pt_xyz[pts] = new_pts[: len(pts)]
        mp.mark_kf_pose_dirty([k for k, i in cam_slot.items() if not cam_fixed[i]])
        mp.mark_points_dirty(pts)
        # Erase outlier observations (reference: Optimizer.cc:745-757).
        for oi in np.nonzero(~inlier[:n_obs] & obs_valid[:n_obs])[0]:
            p = int(pts[obs_pt[oi]])
            if not mp.pt_valid[p]:
                continue
            mp.erase_observation(p, int(kfs_sel[oi]))
            if mp.pt_n_obs[p] <= 1:
                mp.erase_point(p)

    # ------------------------------------------------------------------
    def _cull_keyframes(self, kf: int):
        """Cull local keyframes whose points are >=90% seen by at least 3
        OTHER keyframes at the same or finer scale (reference:
        LocalMapping.cc:632-696). The newest keyframes and the current
        reference are never culled, and at most 2 go per pass (the
        reference's thread interleaving produces a similar throttle)."""
        mp = self.map
        culled = 0
        for k in mp.covisible_keyframes(kf, n=20, min_weight=1):
            if (
                mp.kf_serial[k] == 0  # never cull the map origin
                or k == kf
                or not mp.kf_valid[k]
                or culled >= 2
            ):
                continue
            # Keep the most recent window intact (serial, not slot:
            # slots are recycled at capacity).
            if mp.kf_serial[kf] - mp.kf_serial[k] < 3:
                continue
            col = mp.kf_mp[k]
            feats = np.nonzero(col >= 0)[0]
            p = col[feats]
            alive = mp.pt_valid[p]
            p, feats = p[alive], feats[alive]
            total = len(p)
            if total:
                scale_k = mp.kf_octave[k, feats]  # (T,)
                obs_kf = mp.pt_obs_kf[p]  # (T, Mo)
                obs_oct = mp.kf_octave[
                    np.maximum(obs_kf, 0), np.maximum(mp.pt_obs_feat[p], 0)
                ]
                seen = (
                    (obs_kf >= 0)
                    & (obs_kf != k)
                    & (obs_oct <= scale_k[:, None] + 1)
                )
                n_finer = seen.sum(axis=1)
                redundant = int(
                    (n_finer >= self.cfg.mapping.kf_cull_min_obs).sum()
                )
            else:
                redundant = 0
            if total > 0 and redundant > self.cfg.mapping.kf_cull_redundancy * total:
                self._erase_keyframe(k)
                culled += 1

    def _erase_keyframe(self, k: int):
        # Map surgery lives in MapState (erase_keyframe) so the capacity
        # force-cull path can reuse it (slam_map/mapstate.py).
        self.map.erase_keyframe(k)
