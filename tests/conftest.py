"""Test configuration: run everything on a virtual 8-device CPU mesh.

The answer to the reference's total absence of automated tests
(SURVEY.md §4): kernels and sharded collectives are exercised on the CPU,
where the same code paths run as on the GPU. Run the suite on the CPU
with

    python -m pytest tests/ -q -m 'not slow' -n 6 --dist loadfile

The program itself is checked on the GPU by `python chip_smoke.py`
(one card) and `python chip_smoke.py --multi` (four cards), run on a
machine with the cards.
"""

import os

# Must be set before jax initializes its backends. Force-set (not
# setdefault): tests always run on the virtual CPU mesh, even on a
# machine whose JAX would pick a GPU.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)


def pytest_collection_modifyitems(config, items):
    """Run the e2e stereo tests BEFORE the stereo-KITTI CLI test.

    The CLI test spawns a fresh python subprocess; its jitted programs are
    identical (by construction — same SlamConfig) to the ones the e2e
    stereo tests compile, so running e2e first warms the persistent
    compile cache (the checkout's .jax_cache/, shared by every process,
    c_orb_slam_tpu/__init__.py) and the subprocess starts at full speed
    instead of paying a ~6 min cold compile against its 560 s timeout.
    """
    cli = [i for i in items if "test_stereo_kitti_cli_runs" in i.nodeid]
    if not cli:
        return
    rest = [i for i in items if "test_stereo_kitti_cli_runs" not in i.nodeid]
    items[:] = rest + cli
