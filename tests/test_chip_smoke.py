"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its parity
helpers hold at tiny widths. Also where the package keeps its compile
cache."""

import json
import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_smoke_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


@pytest.fixture(scope="module")
def cpu():
    return jax.devices("cpu")[0]


@pytest.mark.parametrize("helper", ["hamming", "search", "extract", "solvers"])
def test_parity_helper_tiny(helper, cpu):
    line = {
        "hamming": lambda: chip_smoke.parity_hamming(cpu, 96, 160),
        "search": lambda: chip_smoke.parity_search(cpu, 256, 128, 320, 240),
        "extract": lambda: chip_smoke.parity_extract(cpu, cpu, 160, 120, 150, 2),
        "solvers": lambda: chip_smoke.parity_solvers(cpu, cpu, 120, 6, 200, 800),
    }[helper]()
    assert line  # each helper raises PhaseFailure when its check fails


def test_parallel_parity_tiny():
    """The four-device comparison on virtual CPU devices, at a map small
    enough for the tests."""
    devs = jax.devices()[:4]
    if len(devs) < 4:
        pytest.skip("needs 4 virtual devices")
    line = chip_smoke.parity_parallel(devs, C=16, P=400, O=4000)
    assert line.startswith("4 devices")


def test_pose_error_measures_angle_and_offset():
    import numpy as np

    th = 1e-3
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]])
    A = np.c_[np.eye(3), np.zeros(3)]
    B = np.c_[R, [0.0, 0.0, 2e-4]]
    rot, trans = chip_smoke.pose_error(A, B)
    assert abs(rot - th) < 1e-9 and abs(trans - 2e-4) < 1e-12


def test_parity_detects_a_wrong_kernel(cpu, monkeypatch):
    """A parity helper fails when the kernel under test is wrong."""
    from c_orb_slam_tpu.ops import hamming

    inner = hamming.distance_matrix
    monkeypatch.setattr(hamming, "distance_matrix",
                        lambda a, b: inner(a, b).at[0, 0].add(1))
    with pytest.raises(chip_smoke.PhaseFailure):
        chip_smoke.parity_hamming(cpu, 16, 16)


@pytest.mark.parametrize("env_set", [True, False], ids=["env_set", "env_unset"])
def test_compile_cache_location(env_set, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    want = str(tmp_path / "cache") if env_set else os.path.join(ROOT, ".jax_cache")
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = want
    code = (
        "import json, jax, jax.numpy as jnp, c_orb_slam_tpu\n"
        "jax.jit(lambda x: x * 3.0 + 1.0)(jnp.arange(7.0)).block_until_ready()\n"
        "print(json.dumps(jax.config.jax_compilation_cache_dir))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert os.path.abspath(got) == os.path.abspath(want)
    assert os.path.isdir(want) and os.listdir(want), "nothing was cached"
