"""Batched Hamming distance over 256-bit ORB descriptors.

The reference computes descriptor distance one pair at a time with a
hand-unrolled XOR/popcount over 8 int32 words
(reference: src/ORBmatcher.cc:1647-1663 DescriptorDistance) and loops over
candidates. Here the whole candidate set is one batched popcount — a
(N1, N2) distance matrix or masked variant. jax.lax.population_count
lowers to the native popcount.

Descriptors are stored as (N, 8) uint32 (256 bits).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Distance returned for masked-out candidates — larger than the 256 max.
INVALID_DIST = 512


def pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """(..., 256) {0,1} -> (..., 8) uint32, little-endian within words."""
    b = bits.astype(jnp.uint32).reshape(*bits.shape[:-1], 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << shifts, axis=-1, dtype=jnp.uint32)


def unpack_bits(words: jnp.ndarray) -> jnp.ndarray:
    """(..., 8) uint32 -> (..., 256) {0,1}."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (words[..., :, None] >> shifts) & jnp.uint32(1)
    return bits.reshape(*words.shape[:-1], 256).astype(jnp.uint8)


def distance(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Elementwise Hamming distance between (..., 8) uint32 descriptors."""
    x = jnp.bitwise_xor(a, b)
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


def distance_matrix(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(N1, 8) x (N2, 8) -> (N1, N2) int32 Hamming distances.

    Matrix-unit formulation: for binary vectors, d(a, b) = |a| + |b| -
    2 a·b, so the whole matrix is one (N1, 256) x (256, N2) bfloat16
    matmul instead of N1*N2*8 popcounts (the reference's scalar
    XOR/popcount loop is ORBmatcher.cc:1647-1663). Bits are exact in
    bfloat16 and the f32 accumulation is exact (sums <= 256 << 2^24).
    """
    pop_a = jnp.sum(jax.lax.population_count(a), axis=-1).astype(jnp.int32)
    pop_b = jnp.sum(jax.lax.population_count(b), axis=-1).astype(jnp.int32)
    bits_a = unpack_bits(a).astype(jnp.bfloat16)
    bits_b = unpack_bits(b).astype(jnp.bfloat16)
    cross = jnp.dot(
        bits_a, bits_b.T, preferred_element_type=jnp.float32
    ).astype(jnp.int32)
    return pop_a[:, None] + pop_b[None, :] - 2 * cross


def masked_distance_matrix(
    a: jnp.ndarray,
    b: jnp.ndarray,
    valid_a: jnp.ndarray | None = None,
    valid_b: jnp.ndarray | None = None,
    pair_mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Distance matrix with INVALID_DIST where masked out.

    pair_mask: optional (N1, N2) bool — e.g. search-window gating for
    projection-guided matching (replaces the reference's per-candidate
    GetFeaturesInArea loops, ORBmatcher.cc:75-110).
    """
    d = distance_matrix(a, b)
    if valid_a is not None:
        d = jnp.where(valid_a[:, None], d, INVALID_DIST)
    if valid_b is not None:
        d = jnp.where(valid_b[None, :], d, INVALID_DIST)
    if pair_mask is not None:
        d = jnp.where(pair_mask, d, INVALID_DIST)
    return d


def best_two(d: jnp.ndarray, axis: int = -1):
    """Top-2 smallest along axis: (best_dist, best_idx, second_dist).

    Implements the NN-ratio machinery every reference matcher repeats
    (e.g. ORBmatcher.cc:212-233 bestDist1/bestDist2).
    """
    best_idx = jnp.argmin(d, axis=axis).astype(jnp.int32)
    best = jnp.min(d, axis=axis)
    d2 = jnp.where(
        jax.nn.one_hot(best_idx, d.shape[axis], axis=axis, dtype=bool),
        INVALID_DIST,
        d,
    )
    second = jnp.min(d2, axis=axis)
    return best, best_idx, second


def mutual_best(d: jnp.ndarray):
    """Mutual nearest-neighbor test: returns (best_idx_rows (N1,), mutual
    (N1,) bool)."""
    row_best = jnp.argmin(d, axis=1).astype(jnp.int32)
    col_best = jnp.argmin(d, axis=0).astype(jnp.int32)
    mutual = col_best[row_best] == jnp.arange(d.shape[0], dtype=jnp.int32)
    return row_best, mutual
