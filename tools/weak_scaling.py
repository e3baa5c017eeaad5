"""Weak-scaling harness for the map-sharded distributed BA.

Holds the per-device problem size fixed (points + observations per
device constant) while growing the mesh, and reports the efficiency
t(1) / t(D) — ideal weak scaling keeps the step time flat at 1.0.
The communication design predicts near-flat: per PCG iteration the
collective volume is one all_gather(6C) + one psum_scatter(6C),
independent of the observation count (parallel/sharded_ba.py).

Runs on a virtual CPU mesh by default; --ambient runs the same code on
the devices JAX finds (for instance four GPUs):

    python tools/weak_scaling.py [--devices 1 2 4 8] [--obs-per-dev 4096]
    python tools/weak_scaling.py --ambient --devices 1 2 4

Prints one JSON line per mesh size plus a summary line.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_problem(C, Pn, O, seed=0):
    import jax.numpy as jnp
    import numpy as np

    from c_orb_slam_tpu.optim import ba

    rng = np.random.default_rng(seed)
    cam_T = np.tile(np.eye(3, 4, dtype=np.float32), (C, 1, 1))
    for c in range(C):
        cam_T[c, 0, 3] = -0.05 * c
    pts = np.c_[rng.uniform(-3, 3, (Pn, 2)), rng.uniform(4, 9, Pn)].astype(
        np.float32
    )
    obs_cam = rng.integers(0, C, O).astype(np.int32)
    obs_pt = rng.integers(0, Pn, O).astype(np.int32)
    xc = pts[obs_pt] + cam_T[obs_cam][:, :, 3]
    uv = np.stack(
        [
            500 * xc[:, 0] / xc[:, 2] + 320,
            500 * xc[:, 1] / xc[:, 2] + 240,
            np.zeros(O, np.float32),
        ],
        axis=1,
    ).astype(np.float32)
    return ba.BAProblem(
        cam_T=jnp.asarray(cam_T),
        cam_fixed=jnp.asarray([True, True] + [False] * (C - 2)),
        cam_valid=jnp.ones(C, bool),
        points=jnp.asarray(
            pts + rng.normal(0, 0.01, pts.shape).astype(np.float32)
        ),
        point_valid=jnp.ones(Pn, bool),
        obs_cam=jnp.asarray(obs_cam),
        obs_pt=jnp.asarray(obs_pt),
        obs_uv=jnp.asarray(uv),
        obs_stereo=jnp.zeros(O, bool),
        obs_inv_sigma2=jnp.ones(O, jnp.float32),
        obs_valid=jnp.ones(O, bool),
        K=jnp.array([500.0, 500.0, 320.0, 240.0], jnp.float32),
        bf=jnp.asarray(0.0),
    )


def collective_bytes(d: int, obs_per_dev: int, pts_per_dev: int, cams: int):
    """Account the compiled program's collective traffic from its
    optimized HLO: total bytes moved by all-gather / reduce-scatter /
    all-reduce per solve, at mesh size d.

    This is the measurement a shared-core virtual mesh CAN make honestly:
    the sharded-BA design claims per-PCG-iteration collective volume
    O(cameras), independent of the (per-device) observation count — so
    doubling obs_per_dev must leave the collective bytes unchanged, and
    growing the mesh must grow them at most linearly in mesh size (the
    replicated-camera all-gather).
    """
    import re

    import jax
    import numpy as np

    from c_orb_slam_tpu.parallel import sharded_ba

    p = make_problem(cams, pts_per_dev * d, obs_per_dev * d)
    mesh = sharded_ba.make_mesh(np.asarray(jax.devices()[:d]))
    pp = sharded_ba.partition_problem(p, d)
    import jax.numpy as jnp

    pp = jax.tree.map(jnp.asarray, pp)
    # StableHLO (pre-backend): collective ops appear as
    # stablehlo.all_gather / reduce_scatter / all_reduce with the result
    # type after '->'. Counts are static per trace — lax.scan bodies count
    # once — so the numbers compare shapes/volume across mesh sizes, not
    # absolute executed bytes.
    text = sharded_ba.lower_solve(pp, mesh, 3, 3, 20).as_text()
    nbytes = 0
    counts = {}
    for m in re.finditer(
        r"stablehlo\.(all_gather|reduce_scatter|all_reduce"
        r"|collective_permute)\"?[^\n]*->\s*tensor<([0-9x]*)x?(\w+)>",
        text,
    ):
        op, dims, dtype = m.group(1), m.group(2), m.group(3)
        n = 1
        for x in dims.split("x"):
            if x:
                n *= int(x)
        size = {"f32": 4, "bf16": 2, "f64": 8, "i32": 4, "ui32": 4,
                "i1": 1}.get(dtype, 4)
        nbytes += n * size
        counts[op] = counts.get(op, 0) + 1
    return nbytes, counts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--obs-per-dev", type=int, default=4096)
    ap.add_argument("--pts-per-dev", type=int, default=1024)
    ap.add_argument("--cams", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument(
        "--ambient", action="store_true",
        help="run on the devices JAX finds instead of a virtual CPU mesh",
    )
    args = ap.parse_args()

    max_d = max(args.devices)
    if not args.ambient:
        # Virtual CPU mesh (real devices run the same code).
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={max_d}"
        ).strip()
    import jax

    if not args.ambient:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from c_orb_slam_tpu.parallel import sharded_ba

    avail = len(jax.devices())
    results = []
    for d in args.devices:
        if d > avail:
            print(json.dumps({"devices": d, "skipped": f"only {avail}"}))
            continue
        p = make_problem(args.cams, args.pts_per_dev * d, args.obs_per_dev * d)
        mesh = sharded_ba.make_mesh(np.asarray(jax.devices()[:d]))
        run = lambda: sharded_ba.sharded_bundle_adjust(
            p, mesh, iters_first=3, iters_second=3, pcg_iters=20
        )
        (cam_T, *_), _ = run()  # compile + warmup
        jax.block_until_ready(cam_T)
        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            (cam_T, *_), _ = run()
            jax.block_until_ready(cam_T)
            ts.append(time.perf_counter() - t0)
        t = min(ts)
        results.append((d, t))
        print(
            json.dumps(
                {
                    "devices": d,
                    "obs": args.obs_per_dev * d,
                    "points": args.pts_per_dev * d,
                    "step_s": round(t, 4),
                }
            )
        )
    # Collective-traffic accounting from compiled HLO: the check a
    # shared-core virtual mesh CAN make honestly (see collective_bytes).
    if not args.ambient:
        acct = {}
        for d in [x for x in args.devices if 1 < x <= avail]:
            b1, c1 = collective_bytes(d, args.obs_per_dev, args.pts_per_dev,
                                      args.cams)
            b2, _ = collective_bytes(d, args.obs_per_dev * 2,
                                     args.pts_per_dev, args.cams)
            acct[f"{d}dev"] = {
                "collective_bytes": b1,
                "collective_bytes_2x_obs": b2,
                "obs_independent": bool(b2 == b1),
                "ops": c1,
            }
        print(json.dumps({"collective_accounting": acct}))

    if len(results) >= 2:
        t1 = results[0][1]
        eff = {f"{d}x": round(t1 / t, 3) for d, t in results}
        out = {"weak_scaling_efficiency": eff, "target": 0.8}
        # Work-normalized view: aggregate observation throughput. On a
        # shared-core virtual mesh, wall-clock efficiency conflates
        # oversubscription (D devices' FLOPs on c cores) with the
        # algorithm; throughput growth separates them — the algorithm
        # scales if TOTAL work/s grows toward the host's core ceiling
        # while per-solve collective bytes stay flat (accounting above).
        d1, tt1 = results[0]
        thr = {
            f"{d}x": round((args.obs_per_dev * d / t)
                           / (args.obs_per_dev * d1 / tt1), 3)
            for d, t in results
        }
        out["aggregate_throughput_vs_1dev"] = thr
        try:
            out["host_cores"] = os.cpu_count()
        except Exception:
            pass
        if not args.ambient:
            # All virtual devices share this host's physical cores, so the
            # measured efficiency is a LOWER bound: D virtual devices do
            # D× total FLOPs on fixed silicon. The architecture-level
            # check (collective volume independent of obs count) is
            # tests/test_sharded_ba.py::test_sharded_point_side_is_local.
            out["note"] = (
                "virtual CPU mesh: devices share host cores; efficiency "
                "is a lower bound, run with --ambient on real devices"
            )
        print(json.dumps(out))


if __name__ == "__main__":
    main()
