"""Regression-gate the PRODUCT SURFACE with an accuracy number.

Generates a KITTI-format sequence tree (PNG images + times.txt +
reference-key settings.yaml) from the synthetic renderer, drives the
REAL CLI (`examples/stereo_kitti.py` — YAML parsing, dataset loader,
native decoder, System, trajectory saver), then computes ATE of the
saved KITTI trajectory against the rendered ground truth.

This exercises the same path a user runs (reference anchor:
Examples/Stereo/stereo_kitti.cc:54-126), unlike bench.py which calls the
System API directly. Output: one JSON line naming the device.

Usage: python tools/eval_cli_kitti.py [n_frames]
"""

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
sys.path.insert(0, REPO)

import numpy as np

SETTINGS_YAML = """%YAML:1.0
Camera.fx: 718.856
Camera.fy: 718.856
Camera.cx: 607.1928
Camera.cy: 185.2157
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 1241
Camera.height: 376
Camera.fps: 10.0
Camera.bf: 143.7712
Camera.RGB: 1
ThDepth: 35.0
ORBextractor.nFeatures: 2000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
Tracking.minStereoInitPoints: 60
"""

BASELINE = 0.2  # world-units stereo baseline; bf = fx * BASELINE


def generate_tree(d: str, n: int):
    from PIL import Image

    from synthetic import blob_world, render_stereo_pair, smooth_trajectory

    os.makedirs(os.path.join(d, "image_0"))
    os.makedirs(os.path.join(d, "image_1"))
    xw, inten, size = blob_world(1200, seed=5, x_max=22.0)
    traj = smooth_trajectory(n, speed=0.35)
    K4 = (718.856, 718.856, 607.1928, 185.2157)
    with open(os.path.join(d, "times.txt"), "w") as f:
        for i in range(n):
            f.write(f"{i * 0.1:.6e}\n")
    for i in range(n):
        l, r = render_stereo_pair(
            xw, inten, size, traj[i], K4, BASELINE, h=376, w=1241
        )
        Image.fromarray(np.clip(l, 0, 255).astype(np.uint8), "L").save(
            os.path.join(d, "image_0", f"{i:06d}.png"))
        Image.fromarray(np.clip(r, 0, 255).astype(np.uint8), "L").save(
            os.path.join(d, "image_1", f"{i:06d}.png"))
    with open(os.path.join(d, "settings.yaml"), "w") as f:
        f.write(SETTINGS_YAML)
    return traj


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 80
    d = tempfile.mkdtemp(prefix="cli_kitti_")
    traj = generate_tree(d, n)
    out = os.path.join(d, "traj.txt")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "stereo_kitti.py"),
         os.path.join(d, "settings.yaml"), d,
         "--out", out, "--kf-out", os.path.join(d, "kf.txt"),
         "--no-realtime"],
        capture_output=True, text=True, timeout=3600,
    )
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        sys.stderr.write(r.stdout[-2000:] + "\n" + r.stderr[-3000:])
        raise SystemExit("CLI failed")

    # KITTI rows are flattened 3x4 camera-to-world, one per OK frame in
    # order; with zero losses the association to ground truth is row i
    # <-> frame i (asserted).
    rows = np.loadtxt(out).reshape(-1, 3, 4)
    from c_orb_slam_tpu.io import trajectory as traj_io

    poses_cw = np.stack([
        np.concatenate([T[:, :3].T, (-T[:, :3].T @ T[:, 3])[:, None]], axis=1)
        for T in rows
    ])
    rec = {
        "metric": "cli_stereo_kitti_ate_m",
        "n_frames": n,
        "n_tracked": int(len(rows)),
        "cli_wall_s": round(wall, 1),
    }
    if len(rows) != n:
        rec["error"] = f"tracked {len(rows)}/{n} — association broken"
        print(json.dumps(rec))
        raise SystemExit(1)
    ate = traj_io.ate_rmse(poses_cw, traj[:n], with_scale=False)
    rec["value"] = round(float(ate), 4)
    # This process opens the device only now, after the CLI child has
    # exited: one process per card.
    import jax

    dev = jax.devices()[0]
    rec["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                     "count": len(jax.devices())}
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
