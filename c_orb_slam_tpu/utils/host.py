"""Host↔device transfer discipline.

The reference is a shared-memory C++ program where "reading a result" is
free. Here every device→host readback is a round trip over the runtime
transport (PCIe to the GPU) that also waits for the producing program;
its latency on the H100 is not measured. The per-frame SLAM loop
therefore follows two rules, enforced via this module:

1. ONE `fetch()` per pipeline stage — `jax.device_get` of a pytree batches
   arbitrarily many arrays into a single transfer.
2. Pull only small things (poses, index vectors, masks); anything large
   stays device-resident.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor

import jax

# Background d2h workers: a blocking device_get on a worker thread runs
# concurrently with main-thread dispatches (the GIL is released during the
# transfer wait), so the dispatch->host-visible latency is hidden whenever
# the result is consumed at least one pipeline stage later. Enough workers
# that every outstanding readback starts immediately — with a small pool
# the frame-critical tracking fetch was observed queuing behind slow
# mapping fetches (priority inversion); workers spend their time blocked
# on the transport, so oversubscription is free.
_EXECUTOR = ThreadPoolExecutor(max_workers=8, thread_name_prefix="d2h")


def fetch_async(*arrays) -> Future:
    """Start a blocking fetch of `arrays` on a background worker.

    Returns a Future whose .result() is exactly `fetch(*arrays)`. Use at
    dispatch time; call .result() at apply time (usually already done).
    Unlike `prefetch` (copy_to_host_async), the worker genuinely waits for
    completion, so .result() never re-pays the round-trip latency.
    """
    return _EXECUTOR.submit(fetch, *arrays)


def fetch(*arrays):
    """Single-round-trip device→host transfer of all given arrays.

    Returns numpy arrays (or scalars unchanged), one per argument.
    """
    out = jax.device_get(arrays)
    return out if len(arrays) != 1 else out[0]


def prefetch(*arrays):
    """Start device→host copies in the background (copy_to_host_async).

    The copy proceeds concurrently with host and device work, so stages
    prefetch their results at DISPATCH time and `fetch` them one frame (or one
    stage) later, when the transfer has usually landed. Arguments that are not
    device arrays are ignored; pytrees are walked.
    """
    for a in jax.tree_util.tree_leaves(arrays):
        copy = getattr(a, "copy_to_host_async", None)
        if copy is not None:
            copy()
