"""Benchmark: end-to-end tracking throughput + accuracy on one chip.

Default run prints ONE JSON line (the driver contract):
  {"metric", "value", "unit", "vs_baseline", "ate_m", ...}
for the headline config (mono, 30 Hz TUM-like pacing — the reference's
real-time bar is dataset-rate tracking, README.md:10; TUM runs at 30 Hz).

`python bench.py --all` additionally runs the continuity config (the
round-1/2 10 Hz fast-motion pacing), a KITTI-geometry stereo config
(1241x376, 2000 features, 8 levels, 10 Hz) and the 300-frame
long-trajectory variant and prints one JSON line per config (headline
LAST).

Honesty gates: every config measures ATE against the synthetic ground
truth and fails (vs_baseline=0) if tracking is lost or ATE exceeds its
gate — throughput cannot improve by dropping quality.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def _run_config(name, sensor, cam_kwargs, orb_kwargs, n_frames, warmup,
                dt_frame, speed, ate_gate, baseline_fps, tracking_kwargs=None,
                baseline=0.2, world_n=400, world_x_max=10.0):
    from c_orb_slam_tpu.config import (
        CameraConfig, OrbConfig, SlamConfig, Sensor, TrackingConfig,
    )
    from c_orb_slam_tpu.io import trajectory as traj_io
    from c_orb_slam_tpu.system import System
    from c_orb_slam_tpu.tracking import TrackState
    from synthetic import blob_world, render_scene, render_stereo_pair, smooth_trajectory

    cam = CameraConfig(**cam_kwargs)
    cfg = SlamConfig(
        sensor=sensor, camera=cam, orb=OrbConfig(**orb_kwargs),
        tracking=TrackingConfig(**(tracking_kwargs or {})),
    )
    xw, inten, size = blob_world(world_n, seed=5, x_max=world_x_max)
    traj = smooth_trajectory(n_frames, speed=speed)
    K4 = (cam.fx, cam.fy, cam.cx, cam.cy)
    stereo = sensor == Sensor.STEREO
    wh = dict(h=cam.height, w=cam.width)

    def _u8(im):
        # Feed 8-bit images like the real datasets (the reference reads
        # 8-bit PNGs, Examples/Stereo/stereo_kitti.cc:85): the System
        # uploads uint8 and casts on device, quartering the image h2d
        # payload — the dominant per-frame transfer at KITTI geometry
        # (2x 1.9MB float32 -> 2x 0.47MB).
        return np.clip(im, 0, 255).astype(np.uint8)

    frames = []
    for i in range(n_frames):
        if stereo:
            frames.append(tuple(_u8(im) for im in render_stereo_pair(
                xw, inten, size, traj[i], K4, baseline, **wh)))
        else:
            frames.append(_u8(render_scene(xw, inten, size, traj[i], K4, **wh)))

    sysm = System(cfg)
    # Pre-compile the program set (both local-BA buckets) so no first
    # call lands inside the timed region — the bench measures steady
    # state, and a real deployment warms up once at startup.
    sysm.warmup()

    def track(i):
        if stereo:
            return sysm.track_stereo(frames[i][0], frames[i][1], i * dt_frame)
        return sysm.track_monocular(frames[i], i * dt_frame)

    for i in range(warmup):
        track(i)
    t0 = time.perf_counter()
    n_timed = 0
    for i in range(warmup, n_frames):
        track(i)
        n_timed += 1
    dt = time.perf_counter() - t0
    fps = n_timed / dt

    rec = {
        "metric": f"tracked_frames_per_sec_1chip_{name}",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / baseline_fps, 3),
    }
    # Quality gates: lost tracking or excess ATE zeroes the score.
    if sysm.tracker.state != TrackState.OK:
        rec.update(vs_baseline=0.0, error="tracking lost during bench")
        return rec
    poses, stamps = sysm.frame_poses()
    ids = [int(round(t / dt_frame)) for t in stamps]
    ate = traj_io.ate_rmse(
        poses, traj[ids], with_scale=not stereo
    )
    rec["ate_m"] = round(float(ate), 4)
    rec["ate_gate_m"] = ate_gate
    rec["n_tracked"] = len(poses)
    if ate > ate_gate:
        rec.update(vs_baseline=0.0, error=f"ATE {ate:.4f} > gate {ate_gate}")
    return rec


CONFIGS = {
    # Headline: TUM-like 30 Hz pacing (speed 0.4 = ~0.3-1% of scene depth
    # per frame, the TUM inter-frame motion at 30 Hz). The ATE gate sits
    # well above healthy runs: it exists to catch quality rot, not
    # day-to-day mapper nondeterminism.
    "mono_tum30": dict(
        sensor="MONOCULAR", n_frames=70, warmup=15, dt_frame=1 / 30.0,
        speed=0.4, ate_gate=0.05, baseline_fps=30.0,
        cam_kwargs=dict(fx=500, fy=500, cx=320, cy=240, width=640,
                        height=480, fps=30),
        orb_kwargs=dict(n_features=1000, n_levels=8),
    ),
    # 10 Hz fast motion (speed 1.0 = 2-4% of scene depth per frame).
    "mono_fast10": dict(
        sensor="MONOCULAR", n_frames=40, warmup=12, dt_frame=0.1,
        speed=1.0, ate_gate=0.08, baseline_fps=10.0,
        cam_kwargs=dict(fx=500, fy=500, cx=320, cy=240, width=640,
                        height=480, fps=10),
        orb_kwargs=dict(n_features=1000, n_levels=8),
    ),
    # Long KITTI-geometry run (part of --all since round 5): several
    # hundred frames at dataset geometry — the long-trajectory evidence
    # row, regression-gated on both tracking survival and ATE (loopy
    # trajectories are covered by tests/test_e2e_loop.py at 640x480).
    "stereo_kitti_long": dict(
        sensor="STEREO", n_frames=300, warmup=15, dt_frame=0.1,
        speed=0.35, ate_gate=0.08, baseline_fps=10.0,
        world_n=1200, world_x_max=22.0,
        cam_kwargs=dict(fx=718.856, fy=718.856, cx=607.19, cy=185.22,
                        width=1241, height=376, fps=10,
                        bf=718.856 * 0.2),
        orb_kwargs=dict(n_features=2000, n_levels=8),
        tracking_kwargs=dict(min_stereo_init_points=60),
    ),
    # KITTI geometry: 1241x376 stereo, 2000 features, 8 levels, 10 Hz.
    "stereo_kitti": dict(
        sensor="STEREO", n_frames=120, warmup=15, dt_frame=0.1,
        speed=0.5, ate_gate=0.05, baseline_fps=10.0,
        cam_kwargs=dict(fx=718.856, fy=718.856, cx=607.19, cy=185.22,
                        width=1241, height=376, fps=10,
                        bf=718.856 * 0.2),
        orb_kwargs=dict(n_features=2000, n_levels=8),
        tracking_kwargs=dict(min_stereo_init_points=60),
    ),
}


def run_named(name):
    from c_orb_slam_tpu.config import Sensor

    c = dict(CONFIGS[name])
    c["sensor"] = getattr(Sensor, c["sensor"])
    return _run_config(name, **c)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--all", action="store_true",
                    help="run every config")
    ap.add_argument("--config", default=None, choices=list(CONFIGS))
    args = ap.parse_args()

    if args.config:
        print(json.dumps(run_named(args.config)))
        return
    if not args.all:
        rec = run_named("mono_tum30")
        # Driver contract: the headline metric keeps its historical name.
        rec["metric"] = "tracked_frames_per_sec_1chip"
        print(json.dumps(rec))
        return

    recs = {}
    for name in ("mono_fast10", "stereo_kitti", "stereo_kitti_long",
                 "mono_tum30"):
        recs[name] = run_named(name)
        if name != "mono_tum30":
            print(json.dumps(recs[name]))
    rec = recs["mono_tum30"]
    rec["metric"] = "tracked_frames_per_sec_1chip"
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
