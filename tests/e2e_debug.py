"""Standalone end-to-end monocular run on a synthetic sequence (debug
driver for the integration test; run directly: python tests/e2e_debug.py)."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from c_orb_slam_tpu.config import SlamConfig, CameraConfig, OrbConfig, Sensor
from c_orb_slam_tpu.io import trajectory as traj_io
from c_orb_slam_tpu.system import System

from synthetic import blob_world, render_scene, smooth_trajectory


def run(n_frames=30, n_feat=800, verbose=True):
    cam = CameraConfig(fx=500, fy=500, cx=320, cy=240, width=640, height=480, fps=10)
    cfg = SlamConfig(
        sensor=Sensor.MONOCULAR,
        camera=cam,
        orb=OrbConfig(n_features=n_feat, n_levels=4),
    )
    xw, inten, size = blob_world(400, seed=5)
    traj = smooth_trajectory(n_frames)
    K4 = (cam.fx, cam.fy, cam.cx, cam.cy)

    sysm = System(cfg)
    if os.environ.get("E2E_NO_BA"):
        sysm.local_mapping._local_ba = lambda kf: None
    if os.environ.get("E2E_NO_MAPPING"):
        sysm.local_mapping.process_keyframe = lambda kf: None
    t0 = time.time()
    scale = None
    for i in range(n_frames):
        img = render_scene(xw, inten, size, traj[i], K4)
        pose = sysm.track_monocular(img, i * 0.1)
        err_s = ""
        if pose is not None:
            c_est = -pose[:, :3].T @ pose[:, 3]
            c_gt = -traj[i][:, :3].T @ traj[i][:, 3]
            if scale is None and np.linalg.norm(c_est) > 1e-6:
                scale = np.linalg.norm(c_gt) / np.linalg.norm(c_est)
            if scale is not None:
                err_s = f" gt_err={np.linalg.norm(c_est*scale - c_gt):.3f}"
        if verbose:
            st = sysm.tracking_state()
            print(
                f"frame {i:3d} state={st} inliers={sysm.tracker.current_inliers}"
                f" kfs={len(sysm.map.live_keyframes())}"
                f" pts={int(sysm.map.pt_valid.sum())}"
                f" pose={'ok' if pose is not None else '--'}" + err_s
            )
    dt = time.time() - t0

    poses, stamps = sysm.frame_poses()
    # Ground truth for the frames that produced poses.
    ids = [int(round(t * 10)) for t in stamps]  # stamps are i*0.1
    gt = traj[ids]
    ate = traj_io.ate_rmse(poses, gt, with_scale=True)
    print(f"\ntracked {len(poses)}/{n_frames} frames, ATE (scaled) = {ate:.4f} m")
    print(f"wall: {dt:.1f}s ({dt/n_frames*1000:.0f} ms/frame incl. render+compile)")
    return ate, len(poses), n_frames


if __name__ == "__main__":
    # Debug runs default to the CPU (E2E_PLATFORM names another platform);
    # importing this module never changes the platform.
    jax.config.update("jax_platforms", os.environ.get("E2E_PLATFORM", "cpu"))
    ate, n_ok, n = run()
    assert n_ok > 0.8 * n, f"tracked only {n_ok}/{n}"
    assert ate < 0.10, f"ATE {ate}"
    print("E2E PASS")
