"""Standalone end-to-end stereo / RGB-D runs on a synthetic sequence
(debug driver; run directly: python tests/e2e_stereo_debug.py [rgbd])."""

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from c_orb_slam_tpu.config import (
    CameraConfig,
    OrbConfig,
    Sensor,
    SlamConfig,
    TrackingConfig,
)
from c_orb_slam_tpu.io import trajectory as traj_io
from c_orb_slam_tpu.system import System

from synthetic import (
    blob_world,
    render_depth,
    render_scene,
    render_stereo_pair,
    smooth_trajectory,
)

BASELINE = 0.2  # meters — KITTI-ish baseline scaled to the blob world


def run(sensor=Sensor.STEREO, n_frames=30, n_feat=800, verbose=True):
    cam = CameraConfig(
        fx=500, fy=500, cx=320, cy=240, width=640, height=480, fps=10,
        bf=500.0 * BASELINE,
    )
    cfg = SlamConfig(
        sensor=sensor,
        camera=cam,
        orb=OrbConfig(n_features=n_feat, n_levels=4),
        # Synthetic frames yield ~200-400 keypoints, far below the
        # reference's 500-point stereo-init gate (Tracking.cc:511).
        # velocity_rotation_fraction matches e2e_loop_debug so BOTH
        # drivers (and the stereo-KITTI CLI test's YAML) share one
        # SlamConfig -> one compiled program set per suite run (cfg is a
        # static jit arg; any field difference recompiles everything).
        tracking=TrackingConfig(
            min_stereo_init_points=60, velocity_rotation_fraction=0.5,
            max_frames_between_kf=10,
        ),
    )
    xw, inten, size = blob_world(400, seed=5)
    traj = smooth_trajectory(n_frames)
    K4 = (cam.fx, cam.fy, cam.cx, cam.cy)

    sysm = System(cfg)
    t0 = time.time()
    for i in range(n_frames):
        if sensor == Sensor.STEREO:
            left, right = render_stereo_pair(xw, inten, size, traj[i], K4, BASELINE)
            pose = sysm.track_stereo(left, right, i * 0.1)
        else:
            img = render_scene(xw, inten, size, traj[i], K4)
            depth = render_depth(xw, size, traj[i], K4)
            pose = sysm.track_rgbd(img, depth, i * 0.1)
        err_s = ""
        if pose is not None:
            c_est = -pose[:, :3].T @ pose[:, 3]
            c_gt = -traj[i][:, :3].T @ traj[i][:, 3]
            err_s = f" gt_err={np.linalg.norm(c_est - c_gt):.3f}"
        if verbose:
            print(
                f"frame {i:3d} state={sysm.tracking_state()}"
                f" inliers={sysm.tracker.current_inliers}"
                f" kfs={len(sysm.map.live_keyframes())}"
                f" pts={int(sysm.map.pt_valid.sum())}"
                f" pose={'ok' if pose is not None else '--'}" + err_s
            )
    dt = time.time() - t0

    poses, stamps = sysm.frame_poses()
    ids = [int(round(t * 10)) for t in stamps]  # stamps are i*0.1
    gt = traj[ids]
    # Stereo/RGB-D recover absolute scale — evaluate WITHOUT scale alignment.
    ate = traj_io.ate_rmse(poses, gt, with_scale=False)
    name = "stereo" if sensor == Sensor.STEREO else "rgbd"
    print(f"\n[{name}] tracked {len(poses)}/{n_frames} frames, ATE = {ate:.4f} m")
    print(f"wall: {dt:.1f}s ({dt/n_frames*1000:.0f} ms/frame incl. render+compile)")
    return ate, len(poses), n_frames


if __name__ == "__main__":
    # Debug runs default to the CPU (E2E_PLATFORM names another platform);
    # importing this module never changes the platform.
    jax.config.update("jax_platforms", os.environ.get("E2E_PLATFORM", "cpu"))
    sensor = Sensor.RGBD if "rgbd" in sys.argv[1:] else Sensor.STEREO
    ate, n_ok, n = run(sensor)
    assert n_ok > 0.8 * n, f"tracked only {n_ok}/{n}"
    assert ate < 0.05, f"ATE {ate}"
    print("E2E PASS")
