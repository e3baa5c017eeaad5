"""Multi-host bring-up for the distributed solvers.

The reference is strictly single-process shared memory (SURVEY.md §2.3:
no MPI/NCCL/Gloo — its scale ceiling is one machine's RAM). The
scale-out path here instead runs one process per host:
`jax.distributed.initialize` joins the JAX runtime, after which
`jax.devices()` spans every host's devices and the `shard_map` solvers
in parallel/{sharded_ba,dpose_graph,dba}.py run their collectives across
hosts with no further changes — the mesh helpers already accept the
global device list.

Usage (one call at process start, before any jax compute):

    from c_orb_slam_tpu.parallel import multihost
    multihost.initialize()            # env-driven (JAX_COORDINATOR_ADDRESS)
    # or explicitly:
    multihost.initialize(
        coordinator_address="10.0.0.1:8476",
        num_processes=4, process_id=hostno,
    )

A bare `initialize()` joins only when the environment names a
coordinator, and is a no-op on single-process runs, keeping one code
path.

Division of labor across hosts (SURVEY.md §5 long-context plan):
- every host runs the same System host loop for its share of the
  camera stream (or host 0 tracks and broadcasts keyframes);
- global solves (sharded BA, essential graph) are SPMD: each host
  enters the same jitted program with its device shards;
- host-side dataset feeding and checkpoints stay on each host.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join (or skip joining) the multi-host JAX runtime.

    Returns True when a multi-process runtime is active after the call.
    Safe to call unconditionally: single-process runs (no coordinator
    configured anywhere) are a no-op, and repeated calls are idempotent.
    """
    global _initialized
    if _initialized:
        return jax.process_count() > 1
    # Join only on an explicit coordinator (argument or env).
    # NOTE: no jax.process_count()/jax.devices() probe before the join —
    # any backend-initialising call makes jax.distributed.initialize()
    # a hard error (it must run before the XLA backend exists).
    env_configured = any(
        os.environ.get(k)
        for k in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")
    )
    if coordinator_address is None and not env_configured:
        return False  # single process — nothing to join
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        # Idempotency: a pod runtime auto-initialised earlier is fine;
        # calling after backend init is a caller bug and re-raises.
        if "only be called once" not in str(e):
            raise
    _initialized = True
    return jax.process_count() > 1


def is_primary() -> bool:
    """True on the host that should own logging/checkpoint writes."""
    return jax.process_index() == 0
