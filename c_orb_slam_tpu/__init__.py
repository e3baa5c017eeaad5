"""c_orb_slam_tpu — a visual SLAM framework written as JAX array programs.

A from-scratch re-design of the capabilities of ORB-SLAM2 (reference:
/root/reference, C++/pthreads) as batched, fixed-shape array programs:

- ORB extraction (pyramid + FAST + orientation + rBRIEF) as fused XLA
  programs over whole images (reference: src/ORBextractor.cc).
- Descriptor matching as masked batched Hamming distance (popcount) kernels
  (reference: src/ORBmatcher.cc).
- RANSAC solvers (H/F two-view init, PnP relocalization, Horn Sim3 loop
  alignment) as vmapped hypothesis batches evaluated in one pass
  (reference: src/Initializer.cc, src/PnPsolver.cc, src/Sim3Solver.cc).
- One Gauss-Newton/LM engine with implicit Schur-complement PCG replacing g2o
  (reference: src/Optimizer.cc, Thirdparty/g2o).
- Map state as struct-of-arrays with capacity padding + validity masks instead
  of pointer graphs (reference: src/{Map,KeyFrame,MapPoint}.cc).
- Multi-device scaling via jax.sharding meshes with psum/reduce-scatter
  collectives for distributed bundle adjustment (the reference is
  single-process shared memory; see SURVEY.md §2.3).
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Geometry (pose chains, 3x3 rotations, Schur blocks) needs full float32
# products: a GPU runs float32 matmuls in TF32 (10-bit mantissa) unless
# asked for more, and trajectories then drift from rounding alone. Hot
# kernels that want low precision (the bfloat16 descriptor product in
# ops/hamming.py) choose their operand types locally.
_jax.config.update("jax_default_matmul_precision", "float32")

# Persistent compilation cache: the pipeline is a few dozen jitted
# fixed-shape programs, and a cold compile of the set dominates start-up.
# JAX reads JAX_COMPILATION_CACHE_DIR itself; without it the cache lives
# at one fixed path inside the checkout (listed in .gitignore), so every
# process of the checkout, test workers included, shares it.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache",
        ),
    )
_jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

from c_orb_slam_tpu.config import SlamConfig, CameraConfig, OrbConfig  # noqa: F401
