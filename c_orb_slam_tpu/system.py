"""Public API facade — the equivalent of ORB_SLAM2::System.

Reference: include/System.h / src/System.cc — constructor wires vocabulary,
map, tracking and the worker threads (:32-114); TrackMonocular/Stereo/RGBD
(:116-280) route frames; localization-only mode (:127-145); Reset (:295);
Shutdown (:301); trajectory savers (:322-472).

Array-program design: one host loop, no threads — LocalMapping (and later
LoopClosing) run as stages after keyframe insertion (SURVEY.md §2.3).
Images are accepted as numpy/JAX arrays (H, W) grayscale float32 or uint8;
color conversion is the caller's concern (the reference converts with
cvtColor, Tracking.cc:172-197).
"""

from __future__ import annotations

import time
from typing import Optional

import jax.numpy as jnp
import numpy as np

from c_orb_slam_tpu.config import SlamConfig, Sensor
from c_orb_slam_tpu.frontend import frame as frame_mod
from c_orb_slam_tpu.io import trajectory as traj_io
from c_orb_slam_tpu.loop_closing import LoopClosing
from c_orb_slam_tpu.mapping import LocalMapping
from c_orb_slam_tpu.slam_map.mapstate import MapState
from c_orb_slam_tpu.tracking import Tracking, TrackState
from c_orb_slam_tpu.utils.host import prefetch


def _to_gray_f32(image) -> jnp.ndarray:
    img = jnp.asarray(image)
    if img.ndim == 3:  # (H, W, 3) -> grayscale (Rec.601 like cvtColor)
        img = (
            0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
        )
    return img.astype(jnp.float32)


class System:
    def __init__(self, cfg: SlamConfig, enable_loop_closing: bool = True):
        self.cfg = cfg
        self._enable_loop_closing = enable_loop_closing
        # Structured observability (SURVEY.md §5): per-frame records +
        # per-stage timers, exportable as JSONL. Built before the pipeline
        # so stage objects can hold a reference to it.
        from c_orb_slam_tpu.utils.metrics import Metrics

        self.metrics = Metrics()
        vocabulary = None
        path = cfg.vocabulary.path
        if path is None:
            # Default: the shipped pretrained artifact (the analog of the
            # reference's ORBvoc.txt load, System.cc:64). Set
            # vocabulary.path="online" to force training from the run's
            # first keyframes instead.
            from c_orb_slam_tpu.bow.vocab import builtin_vocabulary_path

            path = builtin_vocabulary_path()
        if path and path != "online":
            from c_orb_slam_tpu.bow import vocab as vocab_mod

            if path.endswith(".txt"):
                vocabulary = vocab_mod.load_dbow2_text(path)
            else:
                vocabulary = vocab_mod.load(path)
        self._build_pipeline(MapState(cfg), vocabulary)
        self.localization_only = False

    def _build_pipeline(self, map_state: MapState, vocabulary):
        """Construct tracker/mapper/loop-closer over `map_state` and wire
        their cross-references. Shared by __init__, reset() and
        from_saved_map() so no path can drop the wiring (the reference
        keeps its threads alive across Reset; here the stage objects are
        rebuilt, so the cross-pointer wiring of System.cc:106-113 must be
        repeated every time)."""
        self.map = map_state
        self.tracker = Tracking(self.cfg, self.map)
        self.local_mapping = LocalMapping(self.cfg, self.map)
        self.loop_closing = (
            LoopClosing(self.cfg, self.map, vocabulary)
            if self._enable_loop_closing
            else None
        )
        if self.loop_closing is not None:
            self.loop_closing.on_pose_correction = self._on_loop_correction
            self.loop_closing.on_before_correction = (
                self.tracker.flush_pending
            )
            self.loop_closing.mapper = self.local_mapping
            self.tracker.reloc_provider = self.loop_closing
        self.tracker.mapper = self.local_mapping
        self.local_mapping.on_keyframe_done = self._on_mapping_done
        self.local_mapping.metrics = self.metrics

    # ------------------------------------------------------------------
    def track_monocular(self, image, timestamp: float) -> Optional[np.ndarray]:
        assert self.cfg.sensor == Sensor.MONOCULAR
        with self.metrics.stage("frame_build"):
            f = frame_mod.build_mono(_to_gray_f32(image), self.cfg)
            prefetch(f)  # host copies land before any later fetch(*f)
        return self._track(f, timestamp)

    def track_stereo(self, left, right, timestamp: float) -> Optional[np.ndarray]:
        assert self.cfg.sensor == Sensor.STEREO
        with self.metrics.stage("frame_build"):
            f = frame_mod.build_stereo(
                _to_gray_f32(left), _to_gray_f32(right), self.cfg
            )
            prefetch(f)
        return self._track(f, timestamp)

    def track_rgbd(self, image, depth, timestamp: float) -> Optional[np.ndarray]:
        assert self.cfg.sensor == Sensor.RGBD
        with self.metrics.stage("frame_build"):
            f = frame_mod.build_rgbd(
                _to_gray_f32(image), jnp.asarray(depth, jnp.float32), self.cfg
            )
            prefetch(f)
        return self._track(f, timestamp)

    def _track(self, f, timestamp: float) -> Optional[np.ndarray]:
        t0 = time.perf_counter()
        self.tracker.current_timestamp = timestamp
        with self.metrics.stage("tracking"):
            pose = self.tracker.track(f)
        if self.tracker.request_reset:
            # Lost with <=5 keyframes: restart from scratch (reference:
            # Tracking.cc:472-479 "Track lost soon after initialisation,
            # reseting...").
            self.metrics.count("auto_resets")
            self.reset()
            return None
        # New keyframes come from the map's insertion log (slot ids are
        # recycled at capacity, so "n_keyframes grew" is not a signal).
        new_kfs = self.map.added_kfs
        self.map.added_kfs = []
        made_kf = bool(new_kfs)
        if not self.localization_only:
            if made_kf:
                self.metrics.count("keyframes_created", len(new_kfs))
                for k in new_kfs:
                    if self.map.n_added_keyframes > 2:
                        # Regular keyframe: enqueue for the mapping
                        # pipeline; LoopClosing is fed on completion.
                        self.local_mapping.insert_keyframe(k)
                    elif self.loop_closing is not None:
                        # Initialization keyframes skip mapping (the
                        # reference's mapper ignores them too) — index
                        # them for place recognition directly.
                        self.loop_closing.process_keyframe(k)
            # One mapping stage per tracked frame, run while frame t's
            # tracking step executes on device and its readback streams
            # back (the tracker applies them at frame t+1) — the host-loop
            # analog of the reference's concurrent LocalMapping thread
            # (LocalMapping.cc:47).
            # Thin tracking margin while the mapper is behind: spend one
            # slow frame draining it so new triangulated points land
            # BEFORE the view moves on (the latency analog of the
            # reference's in-thread mapper finishing a keyframe in one
            # slice while Tracking blocks on mMutexMapUpdate). This is
            # the deterministic rescue that makes tracking robust to
            # mapping falling behind under machine load.
            thin = (
                self.tracker.state == TrackState.OK
                and self.tracker.current_inliers
                < 2 * self.cfg.tracking.min_inliers_local_map
                and self.local_mapping.queue_len() > 0
            )
            if thin:
                with self.metrics.stage("mapping_catchup"):
                    self.local_mapping.drain()
            else:
                with self.metrics.stage("mapping_stage"):
                    self.local_mapping.step()
            if self.loop_closing is not None:
                with self.metrics.stage("loop_stage"):
                    self.loop_closing.step()
                    # One background-GBA chunk per frame (see
                    # LoopClosing.advance_background).
                    self.loop_closing.advance_background()
        elif self.loop_closing is not None and (
            self.loop_closing.gba_job is not None
            or self.loop_closing.correction_job is not None
            or self.loop_closing.sim3_job is not None
        ):
            # Localization mode stops mapping and NEW loop detection, but
            # work already in flight at the switch (Sim3 computation,
            # correction, GBA) still advances — it mutates only the map,
            # not the mapper (the reference likewise keeps its LoopClosing
            # thread running in localization mode, System.cc:127-135) —
            # otherwise the job freezes, queries serve the uncorrected map
            # until shutdown, and the drain then mutates the 'frozen' map
            # synchronously.
            with self.metrics.stage("loop_stage"):
                self.loop_closing.advance_background()
        self.metrics.end_frame(
            frame_id=self.tracker.frame_id,
            timestamp=timestamp,
            state=self.tracker.state,
            n_inliers=self.tracker.current_inliers,
            n_keyframes=len(self.map.live_keyframes()),
            n_points=int(self.map.pt_valid.sum()),
            is_keyframe=made_kf,
            total_ms=(time.perf_counter() - t0) * 1000.0,
        )
        return pose

    def _on_mapping_done(self, kf: int):
        if self.loop_closing is not None:
            self.loop_closing.process_keyframe(kf)

    def _on_loop_correction(self, kf: int, T_old: np.ndarray, T_new: np.ndarray):
        """Re-anchor the tracker after a loop correction moved the map
        (the reference's Tracking reads corrected poses through shared
        memory; here the host hands the correction over explicitly)."""
        import numpy as _np

        # In-flight pipelined frames were already drained by the
        # on_before_correction hook (fired before any map mutation); any
        # frame dispatched since would be a bug, so drain defensively.
        self.tracker.flush_pending()

        # T_corr = T_new ∘ T_old^-1 (both world->cam).
        R_old, t_old = T_old[:, :3], T_old[:, 3]
        T_old_inv = _np.concatenate(
            [R_old.T, (-R_old.T @ t_old)[:, None]], axis=1
        ).astype(_np.float32)
        T_corr = (
            T_new @ _np.vstack([T_old_inv, [0, 0, 0, 1.0]])
        ).astype(_np.float32)
        if self.tracker.last_pose is not None:
            self.tracker.last_pose = (
                T_corr @ _np.vstack([self.tracker.last_pose, [0, 0, 0, 1.0]])
            ).astype(_np.float32)
        # The device pose chain predates the correction: break it so the
        # next dispatch re-seeds from the corrected host pose.
        self.tracker._chain = None

    # ------------------------------------------------------------------
    def activate_localization_mode(self):
        """Reference: System::ActivateLocalizationMode (System.cc:127-135):
        stops mapping; tracking continues against the frozen map."""
        self.localization_only = True
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self):
        self.localization_only = False
        self.tracker.only_tracking = False

    def reset(self):
        """Reference: System::Reset -> Tracking::Reset (Tracking.cc:1504)."""
        voc = self.loop_closing.voc if self.loop_closing else None
        self._build_pipeline(MapState(self.cfg), voc)
        self.metrics.reset()

    def shutdown(self):
        """Drain the tracking, mapping and loop pipelines (the reference
        joins its threads incl. the GBA wait, System.cc:301-320)."""
        self._drain_all()

    def _drain_all(self):
        """Settle every pipeline: the loop closer first (an in-flight
        staged correction holds the mapper paused), then mapping (whose
        finished keyframes may arm a NEW loop event), iterating to a
        fixed point."""
        self.tracker.flush_pending()
        for _ in range(8):
            if self.loop_closing is not None:
                self.loop_closing.drain()
            self.local_mapping.drain()
            if self.local_mapping.queue_len() == 0 and (
                self.loop_closing is None or self.loop_closing.idle()
            ):
                break

    def warmup(self):
        """Pre-compile the per-process device-program set whose first
        call would otherwise land mid-sequence (currently: both local-BA
        size buckets). Optional; call once after
        construction when steady-state latency matters from frame one
        (the reference pays an analogous startup cost parsing ORBvoc.txt,
        System.cc:64)."""
        self.local_mapping.warm_programs()

    def map_changed(self) -> bool:
        """Reference: System::MapChanged (System.cc:282-293)."""
        idx = self.map.big_change_idx
        changed = getattr(self, "_last_big_change", -1) < idx
        self._last_big_change = idx
        return changed

    # ------------------------------------------------------------------
    def tracking_state(self) -> int:
        return self.tracker.state

    def tracked_map_points(self) -> np.ndarray:
        """World positions of the map points matched in the most recent
        frame (reference: System::GetTrackedMapPoints, System.cc:295 —
        pointers there; positions here, the array-native equivalent)."""
        self.tracker.flush_pending()
        mp = self.tracker.last_mp
        if mp is None:
            return np.zeros((0, 3), np.float32)
        ids = mp[mp >= 0]
        ids = ids[self.map.pt_valid[ids]]
        return self.map.pt_xyz[ids].copy()

    def tracked_keypoints(self) -> np.ndarray:
        """(N, 2) undistorted keypoint coordinates of the most recent
        frame (reference: System::GetTrackedKeyPointsUn, System.cc:300)."""
        from c_orb_slam_tpu.utils.host import fetch

        self.tracker.flush_pending()
        f = self.tracker.last_frame
        if f is None:
            return np.zeros((0, 2), np.float32)
        xy, valid = fetch(f.xy, f.valid)
        return np.asarray(xy)[np.asarray(valid)]

    def frame_poses(self) -> tuple[np.ndarray, list]:
        """(F, 3, 4) per-frame Tcw for frames where tracking succeeded,
        with matching timestamps. Reconstructed as T_cr · T_rw from the
        CURRENT map pose of each frame's reference keyframe (walking culled
        keyframes through the spanning tree) so loop/GBA corrections are
        reflected retroactively (reference: System.cc:345-380)."""
        self.tracker.flush_pending()
        poses, stamps = [], []
        for fid, T_cr, ref, state, t in self.tracker.trajectory:
            if state != TrackState.OK:
                continue
            if ref >= 0:
                T_rw = self.map.recover_pose(ref)
                if T_rw is None:
                    continue
                pose = (
                    np.vstack([T_cr, [0, 0, 0, 1.0]])[:3]
                    @ np.vstack([T_rw, [0, 0, 0, 1.0]])
                ).astype(np.float32)
            else:
                pose = T_cr
            poses.append(pose)
            stamps.append(t)
        return np.asarray(poses), stamps

    def keyframe_poses(self) -> np.ndarray:
        live = self.map.live_keyframes()
        return self.map.kf_pose[live]

    def save_map(self, path: str):
        """Checkpoint the full map + vocabulary (the reference's
        never-implemented SaveMap TODO, System.h:115-117). Drains the
        mapping pipeline first so the snapshot is fully processed."""
        from c_orb_slam_tpu.io import checkpoint

        self._drain_all()
        voc = self.loop_closing.voc if self.loop_closing else None
        checkpoint.save_map(path, self.map, voc)

    @classmethod
    def from_saved_map(
        cls, path: str, cfg: SlamConfig, localization_only: bool = True
    ) -> "System":
        """Start from a stored map: relocalize-then-track (enables the
        localization mode the reference gates behind its missing LoadMap)."""
        from c_orb_slam_tpu.io import checkpoint
        from c_orb_slam_tpu.tracking import TrackState

        sysm = cls(cfg)
        m, voc = checkpoint.load_map(path, cfg)
        sysm._build_pipeline(m, voc)
        if sysm.loop_closing is not None and voc is not None:
            for k in m.live_keyframes():
                sysm.loop_closing._index_keyframe(int(k))
        live = m.live_keyframes()
        sysm.tracker.ref_kf = (
            int(live[np.argmax(m.kf_serial[live])]) if len(live) else -1
        )
        sysm.tracker.state = TrackState.LOST  # relocalize on first frame
        sysm.localization_only = localization_only
        sysm.tracker.only_tracking = localization_only
        return sysm

    def save_trajectory_tum(self, path: str):
        poses, stamps = self.frame_poses()
        traj_io.save_tum(path, stamps, poses)

    def save_trajectory_kitti(self, path: str):
        poses, _ = self.frame_poses()
        traj_io.save_kitti(path, poses)

    def save_keyframe_trajectory_tum(self, path: str):
        """Reference: System::SaveKeyFrameTrajectoryTUM (System.cc:383-417)
        — keyframes in temporal order with their DATASET timestamps, so
        the export is comparable against TUM ground-truth tooling."""
        live = self.map.live_keyframes()
        order = np.argsort(self.map.kf_serial[live])
        live = live[order]
        stamps = [float(self.map.kf_timestamp[k]) for k in live]
        traj_io.save_tum(path, stamps, self.map.kf_pose[live])
