"""Distributed bundle adjustment over a device mesh.

The reference has no distributed backend at all (single process, pthreads +
shared memory; SURVEY.md §2.3). This module is where this build goes beyond it:
the observation list of a BA problem is sharded across devices (`obs` axis),
while camera poses and points are replicated. Every segment-sum in the
implicit-Schur PCG matvec (optim/ba.py) then becomes a local partial sum
followed by an XLA all-reduce across devices (NCCL over NVLink on GPUs) — GSPMD
inserts the psum from the sharding annotations; no hand-written collectives are
needed for the data-parallel layout. Per-iteration communication is O(C*6*6 +
P*3*3) independent of the observation count, which is the right weak-scaling
shape: adding devices adds observation capacity at constant collective volume.

For map-sharded scaling (keyframe blocks per host, reduce-scatter of the
camera system) see the round roadmap — this module establishes the mesh
plumbing and the observation-parallel path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from c_orb_slam_tpu.optim import ba


def make_mesh(devices=None, axis: str = "obs") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def shard_problem(p: ba.BAProblem, mesh: Mesh, axis: str = "obs") -> ba.BAProblem:
    """Place observation arrays sharded over the mesh; parameters
    replicated. Observation count must divide the device count (pad the
    problem with obs_valid=False slots first)."""
    sh_obs = NamedSharding(mesh, P(axis))
    sh_rep = NamedSharding(mesh, P())

    def put(x, sharded):
        return jax.device_put(x, sh_obs if sharded else sh_rep)

    return ba.BAProblem(
        cam_T=put(p.cam_T, False),
        cam_fixed=put(p.cam_fixed, False),
        cam_valid=put(p.cam_valid, False),
        points=put(p.points, False),
        point_valid=put(p.point_valid, False),
        obs_cam=put(p.obs_cam, True),
        obs_pt=put(p.obs_pt, True),
        obs_uv=put(p.obs_uv, True),
        obs_stereo=put(p.obs_stereo, True),
        obs_inv_sigma2=put(p.obs_inv_sigma2, True),
        obs_valid=put(p.obs_valid, True),
        K=put(p.K, False),
        bf=put(p.bf, False),
    )


def distributed_bundle_adjust(
    p: ba.BAProblem,
    mesh: Mesh,
    axis: str = "obs",
    iters_first: int = 5,
    iters_second: int = 10,
    pcg_iters: int = 40,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    schur: str = "pcg",
) -> ba.BAResult:
    """Two-stage BA with observations sharded across the mesh.

    The solver body is the SAME code as single-chip optim/ba.py — the
    sharding annotations on the inputs make GSPMD partition every
    per-observation op and all-reduce the segment-sums across devices.
    This is the LOCAL-BA scale-out twin of parallel/sharded_ba (which
    shards the map itself for the global solve): a local window has few
    cameras but a dense observation set, so the observation axis is the
    one worth splitting — LocalMapping dispatches through here for
    full-bucket windows at >1 device (mapping.py _ba_dispatch).
    """
    p_sharded = shard_problem(p, mesh, axis)
    out_rep = NamedSharding(mesh, P())
    fn = jax.jit(
        lambda pp: ba.bundle_adjust(
            pp,
            iters_first=iters_first,
            iters_second=iters_second,
            pcg_iters=pcg_iters,
            chi2_mono=chi2_mono,
            chi2_stereo=chi2_stereo,
            schur=schur,
        ),
        out_shardings=ba.BAResult(
            cam_T=out_rep,
            points=out_rep,
            obs_inlier=NamedSharding(mesh, P(axis)),
            final_chi2=out_rep,
        ),
    )
    return fn(p_sharded)


def pad_observations(p: ba.BAProblem, multiple: int) -> ba.BAProblem:
    """Pad the observation axis so it divides the device count."""
    O = p.obs_cam.shape[0]
    pad = (-O) % multiple
    if pad == 0:
        return p
    z = lambda x, fill=0: jnp.concatenate(
        [x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)]
    )
    return p._replace(
        obs_cam=z(p.obs_cam),
        obs_pt=z(p.obs_pt),
        obs_uv=z(p.obs_uv),
        obs_stereo=z(p.obs_stereo),
        obs_inv_sigma2=z(p.obs_inv_sigma2, 1),
        obs_valid=z(p.obs_valid),
    )
