"""Standalone end-to-end loop-closure run: outward-facing orbit revisiting
its start sector (debug driver; run directly: python tests/e2e_loop_debug.py
[stereo], on the CPU unless E2E_PLATFORM names another platform)."""

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

from synthetic import render_scene, render_stereo_pair

BASELINE = 0.2


def orbit_world(n=900, r_path=8.0, seed=7):
    """Blobs in an annulus OUTSIDE an orbit of radius r_path: an
    outward-looking camera sees only its local sector, so covisibility
    breaks and the return to the start is a true loop."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = rng.uniform(r_path + 3.0, r_path + 9.0, n)
    y = rng.uniform(-3.0, 3.0, n)
    xw = np.stack(
        [rad * np.cos(ang), y, rad * np.sin(ang)], axis=1
    ).astype(np.float32)
    intensity = rng.uniform(40, 215, n).astype(np.float32)
    world_size = rng.uniform(0.10, 0.22, n).astype(np.float32)
    return xw, intensity, world_size


def orbit_trajectory(n_frames, r_path=8.0, frac=1.18):
    """World->cam poses on a circle of radius r_path, camera looking
    radially outward; frac > 1 overlaps the start sector at the end."""
    poses = []
    for i in range(n_frames):
        a = 2 * np.pi * frac * i / n_frames
        c_w = np.array([r_path * np.cos(a), 0.0, r_path * np.sin(a)])
        # Camera +z (viewing axis) = outward radial direction.
        z_axis = np.array([np.cos(a), 0.0, np.sin(a)])
        y_axis = np.array([0.0, 1.0, 0.0])
        x_axis = np.cross(y_axis, z_axis)
        R_wc = np.stack([x_axis, y_axis, z_axis], axis=1)
        R_cw = R_wc.T
        t_cw = -R_cw @ c_w
        poses.append(np.concatenate([R_cw, t_cw[:, None]], axis=1))
    return np.stack(poses).astype(np.float32)


def run(sensor=Sensor.MONOCULAR, n_frames=240, n_feat=800, verbose=True,
        vel_rot=0.5, scale=1.0, world_n=900, world_seed=7):
    """scale < 1 shrinks the image (and intrinsics) for a faster run."""
    cam = CameraConfig(
        fx=500 * scale, fy=500 * scale, cx=320 * scale, cy=240 * scale,
        width=int(640 * scale), height=int(480 * scale), fps=10,
        bf=(500.0 * scale * BASELINE) if sensor != Sensor.MONOCULAR else 0.0,
    )
    cfg = SlamConfig(
        sensor=sensor,
        camera=cam,
        orb=OrbConfig(n_features=n_feat, n_levels=4),
        # Half-damped rotation extrapolation: full extrapolation feeds the
        # aliasing lock-in loop (error doubles per frame, see
        # TrackingConfig.velocity_rotation_fraction); zero extrapolation
        # cannot bridge the orbit's steady yaw. 0.5 tracks the whole orbit.
        tracking=TrackingConfig(
            min_stereo_init_points=60, velocity_rotation_fraction=vel_rot,
            max_frames_between_kf=10,
        ),
    )
    xw, inten, size = orbit_world(n=world_n, seed=world_seed)
    traj = orbit_trajectory(n_frames)
    K4 = (cam.fx, cam.fy, cam.cx, cam.cy)

    sysm = System(cfg)
    t0 = time.time()
    loops_at = []
    frame_times = []
    lost_frames = []
    gba_at = []
    for i in range(n_frames):
        tf0 = time.perf_counter()
        if sensor == Sensor.STEREO:
            left, right = render_stereo_pair(xw, inten, size, traj[i], K4, BASELINE)
            pose = sysm.track_stereo(left, right, i * 0.1)
        else:
            img = render_scene(xw, inten, size, traj[i], K4)
            pose = sysm.track_monocular(img, i * 0.1)
        frame_times.append(time.perf_counter() - tf0)
        if pose is None:
            lost_frames.append(i)
        if sysm.loop_closing and sysm.loop_closing.n_gba_applied > len(gba_at):
            gba_at.append(i)
        n_loops = sysm.loop_closing.n_loops_closed if sysm.loop_closing else 0
        if loops_at and n_loops > len(loops_at) or (not loops_at and n_loops):
            loops_at.append(i)
        if verbose:
            err_s = ""
            if pose is not None:
                c_est = -pose[:, :3].T @ pose[:, 3]
                c_gt = -traj[i][:, :3].T @ traj[i][:, 3]
                err_s = f" gt_err={np.linalg.norm(c_est - c_gt):.3f}"
            print(
                f"frame {i:3d} state={sysm.tracking_state()}"
                f" inliers={sysm.tracker.current_inliers}"
                f" kfs={len(sysm.map.live_keyframes())}"
                f" pts={int(sysm.map.pt_valid.sum())}"
                f" loops={n_loops}"
                f" pose={'ok' if pose is not None else '--'}" + err_s,
                flush=True,
            )
    dt = time.time() - t0

    # Settle the pipelines (incl. any in-flight background global BA) the
    # way the reference's Shutdown waits for its GBA thread
    # (System.cc:313) before trajectories are exported.
    sysm.shutdown()
    poses, stamps = sysm.frame_poses()
    ids = [int(round(t * 10)) for t in stamps]  # stamps are i*0.1
    gt = traj[ids]
    with_scale = sensor == Sensor.MONOCULAR
    ate = traj_io.ate_rmse(poses, gt, with_scale=with_scale)
    n_loops = sysm.loop_closing.n_loops_closed if sysm.loop_closing else 0
    print(
        f"\ntracked {len(poses)}/{n_frames}, loops closed: {n_loops} at {loops_at},"
        f" ATE{'(scaled)' if with_scale else ''} = {ate:.4f} m"
    )
    print(f"wall: {dt:.1f}s ({dt/n_frames*1000:.0f} ms/frame)")
    if loops_at:
        med = float(np.median(frame_times))
        print(
            f"correction frame {loops_at[0]}: "
            f"{frame_times[loops_at[0]]*1000:.0f} ms "
            f"(median frame {med*1000:.0f} ms)"
        )
    # Per-frame wall times (frame build + track + mapping/loop stages),
    # exposed for the loop-event latency assertion in test_e2e_loop.
    run.last_frame_times = frame_times
    run.last_loops_at = loops_at
    run.last_lost_frames = lost_frames
    run.last_n_gba_applied = (
        sysm.loop_closing.n_gba_applied if sysm.loop_closing else 0
    )
    run.last_gba_at = gba_at
    run.last_gba_kind = (
        sysm.loop_closing.last_gba_kind if sysm.loop_closing else None
    )
    return ate, n_loops, len(poses), n_frames


if __name__ == "__main__":
    # Debug runs default to the CPU; E2E_PLATFORM=default keeps JAX's own
    # choice of device. Importing this module never changes the platform.
    _plat = os.environ.get("E2E_PLATFORM", "cpu")
    if _plat != "default":
        jax.config.update("jax_platforms", _plat)
    sensor = Sensor.STEREO if "stereo" in sys.argv[1:] else Sensor.MONOCULAR
    ate, n_loops, n_ok, n = run(sensor)
    assert n_ok > 0.8 * n, f"tracked only {n_ok}/{n}"
    assert n_loops >= 1, "no loop closed"
    print("E2E LOOP PASS")
