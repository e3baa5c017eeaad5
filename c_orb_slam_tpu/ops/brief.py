"""Rotation-steered BRIEF (rBRIEF) 256-bit descriptors, batched.

Reference: src/ORBextractor.cc:108-147 computeOrbDescriptor samples 256
learned point pairs (the bit_pattern_31_ table, ORBextractor.cc:150-408,
derived from OpenCV) rotated by the keypoint angle, one keypoint at a time.

Array-program design: descriptors for all keypoints are produced by one
gather + compare pass over the blurred image. The sampling
pattern here is NOT the OpenCV learned table (we do not copy reference
data): it is a deterministic seeded Gaussian BRIEF pattern (sigma =
patch/5, as in the original BRIEF paper), which is internally consistent
across the whole framework — extractor, matcher, and vocabulary all use
it, so cross-implementation bit compatibility is not needed.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from c_orb_slam_tpu.ops.hamming import pack_bits

N_BITS = 256
# Pattern offsets are clipped to +/-13 like BRIEF, so a rotated sample lies
# within 13*sqrt(2) < 18.4 px of its keypoint: inside the 19 px border
# that detection keeps free (OrbConfig.edge_threshold).
PATTERN_CLIP = 13


@functools.lru_cache(maxsize=4)
def brief_pattern(seed: int = 7) -> np.ndarray:
    """(256, 4) int32 sampling offsets [ay, ax, by, bx], Gaussian with
    sigma = patch/5 = 6.2, clipped to +/-PATTERN_CLIP."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, 6.2, size=(N_BITS, 4))
    return np.clip(np.round(pts), -PATTERN_CLIP, PATTERN_CLIP).astype(np.int32)


def compute_descriptors(
    image_blurred: jnp.ndarray,
    yx: jnp.ndarray,
    angles: jnp.ndarray,
    seed: int = 7,
) -> jnp.ndarray:
    """256-bit descriptors for keypoints at integer coords yx (N, 2).

    image_blurred: the Gaussian-blurred level image (reference blurs before
    describing, ORBextractor.cc:1086). angles: (N,) radians.
    Returns (N, 8) uint32.
    """
    # Rotate the pattern offsets per keypoint (continuous steering, as
    # the reference does) and gather the 2x256 sample points straight
    # from the image.
    pat = jnp.asarray(brief_pattern(seed), dtype=jnp.float32)  # (256, 4)
    h, w = image_blurred.shape
    cos, sin = jnp.cos(angles), jnp.sin(angles)  # (N,)
    ay, ax, by, bx = pat[:, 0], pat[:, 1], pat[:, 2], pat[:, 3]

    def sample(y, x):
        # Reference rotates with row-major (x*cos - y*sin, x*sin + y*cos)
        # (ORBextractor.cc:120-121 GET_VALUE).
        rx = cos[:, None] * x[None, :] - sin[:, None] * y[None, :]
        ry = sin[:, None] * x[None, :] + cos[:, None] * y[None, :]
        iy = jnp.clip(jnp.round(ry).astype(jnp.int32) + yx[:, 0:1], 0, h - 1)
        ix = jnp.clip(jnp.round(rx).astype(jnp.int32) + yx[:, 1:2], 0, w - 1)
        return image_blurred[iy, ix]  # (N, 256)

    bits = (sample(ay, ax) < sample(by, bx)).astype(jnp.uint8)  # (N, 256)
    return pack_bits(bits)
