"""Image pyramid + Gaussian blur for ORB extraction.

Reference: src/ORBextractor.cc:1107-1132 ComputePyramid builds 8 levels at
scale 1.2 with cv::resize (bilinear) and a replicated border;
ORBextractor.cc:1086 applies a 7x7 sigma=2 GaussianBlur before computing
descriptors.

Array-program design: levels have static shapes derived from config at trace
time; each level is its own array (a Python list — jit callers close over
the level loop so XLA sees a fixed unrolled program). Images are float32
in [0, 255] with layout (H, W).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def level_shapes(h: int, w: int, n_levels: int, scale_factor: float):
    """Static per-level (h, w), matching round(dim / scale^level)."""
    shapes = []
    for lvl in range(n_levels):
        inv = 1.0 / (scale_factor**lvl)
        shapes.append((int(round(h * inv)), int(round(w * inv))))
    return shapes


def build_pyramid(
    image: jnp.ndarray, n_levels: int, scale_factor: float
) -> list[jnp.ndarray]:
    """Bilinear-downsampled pyramid; level 0 is the input image."""
    h, w = image.shape
    shapes = level_shapes(h, w, n_levels, scale_factor)
    levels = [image]
    for lvl in range(1, n_levels):
        lh, lw = shapes[lvl]
        levels.append(
            jax.image.resize(image, (lh, lw), method="bilinear")
        )
    return levels


@functools.lru_cache(maxsize=8)
def _gaussian_kernel_1d(size: int, sigma: float) -> np.ndarray:
    half = size // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(image: jnp.ndarray, size: int = 7, sigma: float = 2.0) -> jnp.ndarray:
    """Separable Gaussian blur with edge replication (matches the
    cv::GaussianBlur BORDER_REFLECT_101 closely enough for descriptor
    stability; reference: ORBextractor.cc:1086)."""
    k = _gaussian_kernel_1d(size, sigma)
    half = size // 2
    img = jnp.pad(image, ((half, half), (half, half)), mode="edge")
    # Separable pass as STATIC shifted slices + weighted adds: a 1-channel
    # convolution has no channel dimension for a matrix unit to use; the
    # shift-and-add form fuses into one elementwise pass.
    h, w = image.shape
    x = sum(
        float(k[i]) * jax.lax.slice(img, (0, i), (h + 2 * half, i + w))
        for i in range(size)
    )
    out = sum(
        float(k[i]) * jax.lax.slice(x, (i, 0), (i + h, w))
        for i in range(size)
    )
    return out
