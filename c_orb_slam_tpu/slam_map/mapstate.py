"""The map as struct-of-arrays with capacity padding + validity masks.

Replaces the reference's pointer-graph data model — Map (src/Map.cc),
KeyFrame (src/KeyFrame.cc), MapPoint (src/MapPoint.cc) with their ~10
mutexes and deferred-delete flag protocols (KeyFrame.cc:431-464,
MapPoint::Replace MapPoint.cc:177) — with flat index tables:

- keyframe slots: pose + per-keypoint arrays + keypoint->point index map
- point slots: position, descriptor, normal, scale range, stats,
  observation (kf, feature) lists
- lifecycle: validity masks + a point-forwarding table (replaced_by)
  instead of SetBadFlag/mbToBeErased
- covisibility: weights recomputed incrementally from shared points

Host-side bookkeeping is numpy (index juggling is latency-bound, not
FLOP-bound); every hot kernel (matching, BA) consumes gathered fixed-shape
device arrays. There is no lock anywhere: the host loop owns the map, and
device work is pure (SURVEY.md §2.3 array-program plan, items 3/5).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from c_orb_slam_tpu.config import SlamConfig



@dataclass
class MapState:
    cfg: SlamConfig

    # --- keyframes -------------------------------------------------------
    kf_pose: np.ndarray = None  # (Nk, 3, 4) Tcw
    kf_valid: np.ndarray = None  # (Nk,)
    kf_frame_id: np.ndarray = None  # (Nk,) source frame id
    # Monotonic insertion counter per slot: slot ids are REUSED after
    # culling (the reference's map is bounded only by RAM because culled
    # KeyFrames are deleted, KeyFrame.cc:453-545; here slots recycle), so
    # any "is k newer than j" question must compare kf_serial, never slot.
    kf_serial: np.ndarray = None  # (Nk,) int64
    kf_timestamp: np.ndarray = None  # (Nk,) float64 dataset timestamp
    kf_xy: np.ndarray = None  # (Nk, Kp, 2) undistorted level-0 coords
    kf_octave: np.ndarray = None  # (Nk, Kp)
    kf_angle: np.ndarray = None  # (Nk, Kp)
    kf_desc: np.ndarray = None  # (Nk, Kp, 8) uint32
    kf_ur: np.ndarray = None  # (Nk, Kp) right-image u (-1 if mono)
    kf_depth: np.ndarray = None  # (Nk, Kp) stereo/RGBD depth (-1 if none)
    kf_kp_valid: np.ndarray = None  # (Nk, Kp)
    kf_mp: np.ndarray = None  # (Nk, Kp) int64 point index or -1

    # --- points ----------------------------------------------------------
    pt_xyz: np.ndarray = None  # (Np, 3)
    pt_desc: np.ndarray = None  # (Np, 8) uint32 representative descriptor
    pt_normal: np.ndarray = None  # (Np, 3) mean viewing direction
    pt_min_dist: np.ndarray = None  # (Np,) scale-invariance range
    pt_max_dist: np.ndarray = None
    pt_valid: np.ndarray = None  # (Np,)
    pt_ref_kf: np.ndarray = None  # (Np,)
    pt_first_kf: np.ndarray = None  # (Np,) for culling age
    pt_visible: np.ndarray = None  # (Np,) times predicted visible
    pt_found: np.ndarray = None  # (Np,) times actually matched
    pt_replaced_by: np.ndarray = None  # (Np,) forwarding index or -1
    # Monotonic insertion serial per point slot (-1 when dead). Point
    # slots recycle like keyframe slots, so any snapshot taken across
    # frames (e.g. the background global-BA epoch) must verify identity
    # by serial, never by slot id.
    pt_serial: np.ndarray = None  # (Np,) int64
    # Observations: point -> list of (kf, feature_idx)
    pt_obs_kf: np.ndarray = None  # (Np, MaxObs) int32, -1 empty
    pt_obs_feat: np.ndarray = None  # (Np, MaxObs)
    pt_n_obs: np.ndarray = None  # (Np,)

    # --- graph ------------------------------------------------------------
    covis: np.ndarray = None  # (Nk, Nk) int32 shared-point weights
    spanning_parent: np.ndarray = None  # (Nk,) parent kf or -1
    loop_edges: list = field(default_factory=list)  # [(kf_i, kf_j), ...]

    n_keyframes: int = 0
    n_added_keyframes: int = 0  # monotonic; source of kf_serial
    n_added_points: int = 0  # monotonic; source of pt_serial
    # Slots of recently added keyframes, appended by add_keyframe; the
    # System drains this to route new KFs into the mapping pipeline
    # (slot reuse makes "n_keyframes grew" an unreliable signal).
    added_kfs: list = field(default_factory=list)
    # Callback(k, Tcp_k, parent_k) fired just before a culled slot is
    # recycled: the Tracking rewrites trajectory references through the
    # stored relative pose (System.cc:361-366 walks these lazily; with
    # slot reuse the walk must be folded eagerly).
    on_slot_reuse: object = None
    # Callback(k) fired when a keyframe is culled — LoopClosing evicts
    # its place-recognition database row (the reference erases from
    # KeyFrameDatabase in SetBadFlag, KeyFrame.cc:543).
    on_kf_erased: object = None
    n_points: int = 0
    next_free_pt: int = 0
    # Monotonic version for "map changed" queries (reference:
    # Map::InformNewBigChange, src/Map.cc:70-80).
    big_change_idx: int = 0
    # Device-resident mirror (slam_map/devicemap.py), created lazily by
    # the first hot-path consumer. None until then so pure-host users
    # (tests, tools) never allocate device memory.
    _device: object = None

    def __post_init__(self):
        cap = self.cfg.capacity
        Nk = cap.max_keyframes
        Kp = sum(self.cfg.orb.features_per_level())
        Np = cap.max_points
        Mo = cap.max_obs_per_point
        f32, i32, i64 = np.float32, np.int32, np.int64
        self.kf_pose = np.tile(np.eye(3, 4, dtype=f32), (Nk, 1, 1))
        self.kf_valid = np.zeros(Nk, bool)
        self.kf_frame_id = np.zeros(Nk, i64)
        self.kf_serial = np.full(Nk, -1, i64)
        self.kf_timestamp = np.zeros(Nk, np.float64)
        self.kf_xy = np.zeros((Nk, Kp, 2), f32)
        self.kf_octave = np.zeros((Nk, Kp), i32)
        self.kf_angle = np.zeros((Nk, Kp), f32)
        self.kf_desc = np.zeros((Nk, Kp, 8), np.uint32)
        self.kf_ur = np.full((Nk, Kp), -1.0, f32)
        self.kf_depth = np.full((Nk, Kp), -1.0, f32)
        self.kf_kp_valid = np.zeros((Nk, Kp), bool)
        self.kf_mp = np.full((Nk, Kp), -1, i64)
        # Pose relative to spanning parent, recorded when a keyframe is
        # culled (reference: KeyFrame::SetBadFlag stores mTcp for the
        # trajectory-recovery walk, KeyFrame.cc:538 / System.cc:361-366).
        self.kf_Tcp = np.tile(np.eye(3, 4, dtype=f32), (Nk, 1, 1))
        self.pt_xyz = np.zeros((Np, 3), f32)
        self.pt_desc = np.zeros((Np, 8), np.uint32)
        self.pt_normal = np.zeros((Np, 3), f32)
        self.pt_min_dist = np.zeros(Np, f32)
        self.pt_max_dist = np.zeros(Np, f32)
        self.pt_valid = np.zeros(Np, bool)
        self.pt_ref_kf = np.full(Np, -1, i32)
        self.pt_first_kf = np.full(Np, -1, i32)
        self.pt_visible = np.ones(Np, i32)
        self.pt_found = np.ones(Np, i32)
        self.pt_replaced_by = np.full(Np, -1, i64)
        self.pt_serial = np.full(Np, -1, i64)
        self.pt_obs_kf = np.full((Np, Mo), -1, i32)
        self.pt_obs_feat = np.full((Np, Mo), -1, i32)
        self.pt_n_obs = np.zeros(Np, i32)
        self.covis = np.zeros((Nk, Nk), i32)
        self.spanning_parent = np.full(Nk, -1, i32)

    # --- device mirror -----------------------------------------------------

    @property
    def device(self):
        """Lazily-created device-resident mirror (flush() before use)."""
        if self._device is None:
            from c_orb_slam_tpu.slam_map.devicemap import DeviceMap

            self._device = DeviceMap(self)
        return self._device

    def mark_points_dirty(self, idx):
        if self._device is not None:
            self._device.mark_points(idx)

    def mark_kf_pose_dirty(self, idx):
        if self._device is not None:
            self._device.mark_kf_pose(idx)

    # --- keyframe ops ------------------------------------------------------

    def add_keyframe(self, frame_id, pose, xy, octave, angle, desc, kp_valid,
                     ur=None, depth=None, timestamp: float = 0.0) -> int:
        k = self._allocate_kf_slot()
        self.kf_pose[k] = pose
        self.kf_valid[k] = True
        self.kf_frame_id[k] = frame_id
        n = xy.shape[0]
        self.kf_xy[k, :n] = xy
        self.kf_octave[k, :n] = octave
        self.kf_angle[k, :n] = angle
        self.kf_desc[k, :n] = desc
        self.kf_kp_valid[k, :n] = kp_valid
        if ur is not None:
            self.kf_ur[k, :n] = ur
        if depth is not None:
            self.kf_depth[k, :n] = depth
        self.kf_serial[k] = self.n_added_keyframes
        self.kf_timestamp[k] = timestamp
        self.n_added_keyframes += 1
        self.added_kfs.append(k)
        if self._device is not None:
            self._device.mark_kf_content(k)
            self._device.mark_kf_pose([k])
        return k

    def _allocate_kf_slot(self) -> int:
        """Next keyframe slot: monotonic while capacity lasts, then reuse
        of culled slots, then force-culling the least-connected redundant
        keyframe (the reference stays bounded because culling deletes
        KeyFrames outright, LocalMapping.cc:632-696 + KeyFrame.cc:453; a
        fixed-capacity slot array needs explicit recycling instead)."""
        Nk = self.kf_pose.shape[0]
        if self.n_keyframes < Nk:
            k = self.n_keyframes
            self.n_keyframes += 1
            return k
        free = np.nonzero(~self.kf_valid)[0]
        if len(free) == 0:
            self.erase_keyframe(self._force_cull_candidate())
            free = np.nonzero(~self.kf_valid)[0]
        k = int(free[0])
        self._release_slot(k)
        return k

    def _force_cull_candidate(self) -> int:
        """At hard capacity with no culled slot to recycle: sacrifice the
        live keyframe with the weakest covisibility, protecting the map
        origin and the newest window (graceful-degradation analog of the
        reference's redundancy culling, LocalMapping.cc:693)."""
        live = self.live_keyframes()
        serial = self.kf_serial[live]
        protect = set(live[np.argsort(serial)[-5:]].tolist())
        protect.add(int(live[np.argmin(serial)]))
        cand = [k for k in live if int(k) not in protect]
        if not cand:
            raise RuntimeError("keyframe capacity exceeded (all protected)")
        weights = self.covis[cand].sum(axis=1)
        return int(cand[int(np.argmin(weights))])

    def _release_slot(self, k: int):
        """Detach a culled keyframe's residual roles before its slot is
        recycled: fold it out of culled spanning chains (so recover_pose
        walks stay correct), notify the tracker to rewrite trajectory
        references, and clear stale point back-references."""
        Tcp_k = self.kf_Tcp[k].copy()
        parent_k = int(self.spanning_parent[k])
        # Culled keyframes whose recovery walk passes through k: compose
        # k's relative pose into theirs and skip to k's parent.
        chain = np.nonzero((self.spanning_parent == k) & ~self.kf_valid)[0]
        for j in chain:
            self.kf_Tcp[j] = (
                np.vstack([self.kf_Tcp[j], [0, 0, 0, 1.0]])[:3]
                @ np.vstack([Tcp_k, [0, 0, 0, 1.0]])
            ).astype(np.float32)
            self.spanning_parent[j] = parent_k
        # Live keyframes never keep a culled parent (re-parented at cull),
        # but guard anyway.
        live_child = np.nonzero((self.spanning_parent == k) & self.kf_valid)[0]
        self.spanning_parent[live_child] = parent_k
        if self.on_slot_reuse is not None:
            self.on_slot_reuse(k, Tcp_k, parent_k)
        # Point back-references to the recycled slot.
        self.pt_ref_kf[self.pt_ref_kf == k] = -1
        self.pt_first_kf[self.pt_first_kf == k] = -1
        stale = np.nonzero((self.pt_obs_kf == k).any(axis=1))[0]
        for p in stale:
            self.erase_observation(int(p), k)
        self.kf_mp[k] = -1
        self.spanning_parent[k] = -1
        self.kf_Tcp[k] = np.eye(3, 4, dtype=np.float32)
        self.kf_serial[k] = -1

    def erase_keyframe(self, k: int):
        """Cull keyframe k (reference: KeyFrame::SetBadFlag,
        KeyFrame.cc:453-545): erase its observations, store the relative
        pose to its spanning parent for trajectory recovery (mTcp,
        KeyFrame.cc:538), and re-parent its children along covisibility."""
        col = self.kf_mp[k]
        for feat in np.nonzero(col >= 0)[0]:
            self.erase_observation(int(col[feat]), k)
        parent0 = self.spanning_parent[k]
        if parent0 >= 0:
            Tp = self.kf_pose[parent0]
            Rp, tp = Tp[:, :3], Tp[:, 3]
            Tp_inv = np.concatenate([Rp.T, (-Rp.T @ tp)[:, None]], axis=1)
            self.kf_Tcp[k] = (
                np.vstack([self.kf_pose[k], [0, 0, 0, 1.0]])[:3]
                @ np.vstack([Tp_inv, [0, 0, 0, 1.0]])
            ).astype(np.float32)
        self.kf_valid[k] = False
        self.covis[k, :] = 0
        self.covis[:, k] = 0
        if self.on_kf_erased is not None:
            self.on_kf_erased(k)
        # Spanning-tree re-parenting by max covisibility (reference:
        # KeyFrame.cc:480-535): children adopt, one at a time, the
        # candidate parent (initially the culled KF's parent, then any
        # already re-parented sibling) with the strongest covisibility
        # edge — keeping the tree aligned with the covisibility structure
        # for the trajectory-recovery walk.
        parent = int(self.spanning_parent[k])
        children = set(
            np.nonzero((self.spanning_parent == k) & self.kf_valid)[0].tolist()
        )
        candidates = {parent} if parent >= 0 else set()
        while children and candidates:
            cand_list = sorted(candidates)
            best_w, best_c, best_p = 0, -1, -1
            for c in children:
                w = self.covis[c, cand_list]
                j = int(np.argmax(w))
                if w[j] > best_w:
                    best_w, best_c, best_p = int(w[j]), c, cand_list[j]
            if best_c < 0:
                break
            self.spanning_parent[best_c] = best_p
            children.remove(best_c)
            candidates.add(best_c)
        # Orphans with no covisibility to any candidate fall back to the
        # culled KF's own parent (reference: KeyFrame.cc:527-531).
        for c in children:
            self.spanning_parent[c] = parent

    def add_point(self, xyz, desc, ref_kf) -> int:
        return int(self.add_points_batch(
            np.asarray(xyz, np.float32)[None],
            np.asarray(desc)[None], ref_kf,
        )[0])

    def add_points_batch(self, xyz, desc, ref_kf) -> np.ndarray:
        """Insert M points at once (one vectorized free-slot scan instead
        of the reference's per-point `new MapPoint`). Returns (M,) indices."""
        M = xyz.shape[0]
        if M == 0:
            return np.zeros(0, np.int64)
        free = np.nonzero(~self.pt_valid)[0]
        if len(free) < M:
            raise RuntimeError("map point capacity exceeded")
        idx = free[:M]
        self.pt_xyz[idx] = xyz
        self.pt_desc[idx] = desc
        self.pt_valid[idx] = True
        self.pt_ref_kf[idx] = ref_kf
        self.pt_first_kf[idx] = ref_kf
        self.pt_visible[idx] = 1
        self.pt_found[idx] = 1
        self.pt_replaced_by[idx] = -1
        self.pt_serial[idx] = np.arange(
            self.n_added_points, self.n_added_points + M, dtype=np.int64
        )
        self.n_added_points += M
        self.pt_obs_kf[idx] = -1
        self.pt_obs_feat[idx] = -1
        self.pt_n_obs[idx] = 0
        self.n_points = max(self.n_points, int(idx.max()) + 1)
        self.mark_points_dirty(idx)
        return idx.astype(np.int64)

    def add_observation(self, pt: int, kf: int, feat: int):
        n = self.pt_n_obs[pt]
        if n >= self.pt_obs_kf.shape[1]:
            return  # observation list full — drop (oldest stays)
        # Skip duplicate observation of the same keyframe.
        if (self.pt_obs_kf[pt, :n] == kf).any():
            return
        self.pt_obs_kf[pt, n] = kf
        self.pt_obs_feat[pt, n] = feat
        self.pt_n_obs[pt] = n + 1
        self.kf_mp[kf, feat] = pt

    def add_observations_batch(self, pts: np.ndarray, kf: int, feats: np.ndarray):
        """Append observation (kf, feats[i]) to each point in pts (distinct
        points; duplicates of the same point must be pre-deduped). Vectorized
        equivalent of per-point AddObservation (MapPoint.cc:98)."""
        pts = np.asarray(pts)
        if len(pts) == 0:
            return
        feats = np.asarray(feats)
        n = self.pt_n_obs[pts]
        already = (self.pt_obs_kf[pts] == kf).any(axis=1)
        ok = ~already & (n < self.pt_obs_kf.shape[1])
        p, nn, ft = pts[ok], n[ok], feats[ok]
        self.pt_obs_kf[p, nn] = kf
        self.pt_obs_feat[p, nn] = ft
        self.pt_n_obs[p] = nn + 1
        self.kf_mp[kf, ft] = p

    def erase_observation(self, pt: int, kf: int):
        n = self.pt_n_obs[pt]
        obs = self.pt_obs_kf[pt, :n]
        keep = obs != kf
        if keep.all():
            return
        feat = self.pt_obs_feat[pt, :n][~keep]
        for f in feat:
            if self.kf_mp[kf, f] == pt:
                self.kf_mp[kf, f] = -1
        self.pt_obs_kf[pt, : keep.sum()] = obs[keep]
        self.pt_obs_feat[pt, : keep.sum()] = self.pt_obs_feat[pt, :n][keep]
        self.pt_obs_kf[pt, keep.sum():n] = -1
        self.pt_obs_feat[pt, keep.sum():n] = -1
        self.pt_n_obs[pt] = keep.sum()
        # Auto-erase at <=2 observations like the reference
        # (MapPoint.cc:130-131) is the caller's policy (mapping.cull).

    def erase_point(self, pt: int):
        n = self.pt_n_obs[pt]
        for kf, f in zip(self.pt_obs_kf[pt, :n], self.pt_obs_feat[pt, :n]):
            if kf >= 0 and self.kf_mp[kf, f] == pt:
                self.kf_mp[kf, f] = -1
        self.pt_valid[pt] = False
        self.pt_serial[pt] = -1
        self.pt_n_obs[pt] = 0
        self.pt_obs_kf[pt] = -1
        self.pt_obs_feat[pt] = -1
        self.mark_points_dirty([pt])

    def replace_point(self, old: int, new: int):
        """Merge old into new (reference: MapPoint::Replace
        MapPoint.cc:177-215): transfer observations and stats, forward."""
        if old == new:
            return
        n = self.pt_n_obs[old]
        for kf, f in zip(
            self.pt_obs_kf[old, :n].copy(), self.pt_obs_feat[old, :n].copy()
        ):
            if kf < 0:
                continue
            if (self.pt_obs_kf[new, : self.pt_n_obs[new]] == kf).any():
                # new already seen in this kf: drop old's binding
                if self.kf_mp[kf, f] == old:
                    self.kf_mp[kf, f] = -1
            else:
                self.kf_mp[kf, f] = new
                m = self.pt_n_obs[new]
                if m < self.pt_obs_kf.shape[1]:
                    self.pt_obs_kf[new, m] = kf
                    self.pt_obs_feat[new, m] = f
                    self.pt_n_obs[new] = m + 1
        self.pt_visible[new] += self.pt_visible[old]
        self.pt_found[new] += self.pt_found[old]
        self.pt_valid[old] = False
        self.pt_serial[old] = -1
        self.pt_n_obs[old] = 0
        self.pt_obs_kf[old] = -1
        self.pt_replaced_by[old] = new
        self.mark_points_dirty([old, new])

    def resolve(self, idx: np.ndarray) -> np.ndarray:
        """Follow the replaced_by forwarding chain (reference:
        Tracking::CheckReplacedInLastFrame, Tracking.cc:739-754)."""
        idx = np.asarray(idx).copy()
        for _ in range(4):  # chains are short
            fwd = np.where(idx >= 0, self.pt_replaced_by[idx], -1)
            step = fwd >= 0
            if not step.any():
                break
            idx[step] = fwd[step]
        return idx

    # --- covisibility -------------------------------------------------------

    def update_connections(self, kf: int):
        """Recount shared map points between kf and all others; set
        spanning-tree parent on first connection (reference:
        KeyFrame::UpdateConnections, KeyFrame.cc:289-379)."""
        mp = self.kf_mp[kf]
        pts = mp[mp >= 0]
        Nk = self.kf_pose.shape[0]
        if len(pts):
            obs = self.pt_obs_kf[pts]  # (P, Mo)
            counts = np.bincount(obs[obs >= 0], minlength=Nk).astype(np.int32)
        else:
            counts = np.zeros(Nk, np.int32)
        counts[kf] = 0
        self.covis[kf, :] = counts
        self.covis[:, kf] = counts
        if self.spanning_parent[kf] < 0 and counts.max() > 0 and kf > 0:
            self.spanning_parent[kf] = int(np.argmax(counts))

    def recover_pose(self, k: int):
        """Current Tcw of keyframe k, walking culled keyframes to a live
        spanning-tree ancestor via the stored relative poses (reference:
        the SaveTrajectory walk, System.cc:361-366). None if no live
        ancestor exists."""
        acc = np.eye(4, dtype=np.float32)
        guard = 0
        while k >= 0 and not self.kf_valid[k] and guard < 256:
            acc = acc @ np.vstack([self.kf_Tcp[k], [0, 0, 0, 1.0]])
            k = int(self.spanning_parent[k])
            guard += 1
        if k < 0 or not self.kf_valid[k]:
            return None
        return (acc @ np.vstack([self.kf_pose[k], [0, 0, 0, 1.0]]))[:3].astype(
            np.float32
        )

    def covisible_keyframes(self, kf: int, n: int = 10, min_weight: int = 15):
        w = self.covis[kf].copy()
        w[~self.kf_valid] = 0
        order = np.argsort(-w)
        out = [int(i) for i in order[:n] if w[i] >= min_weight]
        return out

    # --- point attribute maintenance ----------------------------------------

    def update_point_descriptor_and_normal(self, pt: int):
        self.update_points_batch(np.asarray([pt], np.int64))

    def update_points_batch(self, pts: np.ndarray):
        """Representative descriptor (min median Hamming) + viewing normal +
        scale range, for M points at once (reference: MapPoint.cc:242-307,
        330-371 — there per point under a mutex; here one vectorized pass)."""
        pts = np.asarray(pts)
        if len(pts) == 0:
            return
        n = self.pt_n_obs[pts]
        live = n > 0
        pts, n = pts[live], n[live]
        M = len(pts)
        if M == 0:
            return
        Mo = self.pt_obs_kf.shape[1]
        kfs = self.pt_obs_kf[pts]  # (M, Mo)
        feats = self.pt_obs_feat[pts]
        mask = np.arange(Mo)[None, :] < n[:, None]
        sk = np.maximum(kfs, 0)
        sf_ = np.maximum(feats, 0)
        descs = self.kf_desc[sk, sf_]  # (M, Mo, 8) uint32

        # Min-median-Hamming representative descriptor (np.bitwise_count is
        # a ufunc — the LUT gather cost 130 ms/keyframe at map scale).
        x = descs[:, :, None, :] ^ descs[:, None, :, :]
        d = np.bitwise_count(x).sum(axis=-1, dtype=np.int32)  # (M, Mo, Mo)
        big = np.int32(1 << 20)
        d = np.where(mask[:, None, :], d, big)  # invalid cols -> +inf
        ds = np.sort(d, axis=2)
        mid = np.broadcast_to(((n - 1) // 2)[:, None, None], (M, Mo, 1))
        med = np.take_along_axis(ds, mid, axis=2)[..., 0]  # (M, Mo)
        med = np.where(mask, med, big)  # invalid rows can't win
        best = np.argmin(med, axis=1)
        self.pt_desc[pts] = descs[np.arange(M), best]

        # Viewing normal: mean unit ray from observing camera centers.
        R = self.kf_pose[:, :, :3]
        t = self.kf_pose[:, :, 3]
        centers_all = -np.einsum("kji,kj->ki", R, t)  # (Nk, 3)
        xyz = self.pt_xyz[pts]  # (M, 3)
        rays = xyz[:, None, :] - centers_all[sk]  # (M, Mo, 3)
        rays /= np.maximum(np.linalg.norm(rays, axis=2, keepdims=True), 1e-12)
        rays = np.where(mask[:, :, None], rays, 0.0)
        normal = rays.sum(axis=1) / n[:, None]
        self.pt_normal[pts] = normal / np.maximum(
            np.linalg.norm(normal, axis=1, keepdims=True), 1e-12
        )

        # Scale-invariance range from the reference keyframe's octave.
        is_ref = (kfs == self.pt_ref_kf[pts][:, None]) & mask
        sel = np.where(is_ref.any(axis=1), np.argmax(is_ref, axis=1), 0)
        k_ref = kfs[np.arange(M), sel]
        f_ref = feats[np.arange(M), sel]
        dist = np.linalg.norm(xyz - centers_all[k_ref], axis=1)
        level = self.kf_octave[k_ref, f_ref]
        sf = self.cfg.orb.scale_factor
        n_lv = self.cfg.orb.n_levels
        self.pt_max_dist[pts] = dist * sf ** level.astype(np.float32)
        self.pt_min_dist[pts] = self.pt_max_dist[pts] / (sf ** (n_lv - 1))
        self.mark_points_dirty(pts)

    # --- queries -------------------------------------------------------------

    def keyframe_center(self, kf: int) -> np.ndarray:
        T = self.kf_pose[kf]
        return -T[:, :3].T @ T[:, 3]

    def live_points(self) -> np.ndarray:
        return np.nonzero(self.pt_valid)[0]

    def live_keyframes(self) -> np.ndarray:
        return np.nonzero(self.kf_valid[: self.n_keyframes])[0]
