"""Temporal binary descriptor transform.

Re-implements the reference descriptor transforms *bit-identically*:

* ``transform_limited`` — reference ``descriptor_transform.hpp:32-73``
* ``transform_full``    — reference ``descriptor_transform.hpp:76-123``

Design notes:

The reference walks each pixel's temporal series with a scalar bit-appender
(``bitfield.hpp:35-58``). Here every comparison is a whole-image vectorized
``jnp`` op over the ``(H, W)`` plane; the bit *order* (LSB-first append order)
is reproduced exactly, so packing the boolean planes into little-endian uint32
lanes yields the same words the reference stores in its 32/64/128/256-bit
descriptors. All elementwise work, fully fused by XLA.

Exactness argument for the float mean comparison (``a < av``): the running
float sum of n <= 65 uint16 samples is an integer < 2^24, hence exact in
float32 regardless of summation order; the division by n then rounds
identically to the reference's ``av /= n``.

Outputs:
* ``descriptor_bits``  -> (H, W, B) bool — the readable form, pinned
  against the oracle in tests.
* ``descriptor_words`` -> (H, W, n_words) uint32 little-endian lanes, built
  without the boolean tensor — the form the pipeline uses.
* ``pack_bits``        -> packs bit planes into the same lanes.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp

from .config import TransformMode, actual_bits


def _limited_bits(s32, sf, av) -> List:
    """Bit planes for the LIMITED transform, in reference append order
    (``descriptor_transform.hpp:32-73``)."""
    n = s32.shape[0]
    bits = []
    pairsums = {}
    for t in range(n - 2):
        a, b, c = s32[t], s32[t + 1], s32[t + 2]
        bits.append(a < b)
        bits.append(a < c)
        bits.append(sf[t] < av)
        cur = a + b
        # prev_pair_sums[t % 2] holds the pairsum from t-2 (initialized to -1,
        # so no bit is emitted for t in {0, 1}).
        if t >= 2:
            bits.append(pairsums[t - 2] < cur)
        pairsums[t] = cur
    a, b = s32[n - 2], s32[n - 1]
    bits.append(a < b)
    bits.append(sf[n - 2] < av)
    bits.append(sf[n - 1] < av)
    if n >= 4:
        bits.append(pairsums[n - 4] < (a + b))
    else:
        # prev_pair_sums slot is still -1: (-1 < a+b) is always true since
        # pixel sums are non-negative (descriptor_transform.hpp:55,68).
        bits.append(jnp.ones(s32.shape[1:], dtype=bool))
    return bits


def _full_bits(s32, sf, av) -> List:
    """Bit planes for the FULL transform, in reference append order
    (``descriptor_transform.hpp:76-123``)."""
    n = s32.shape[0]
    bits = []
    pairsums = {}
    for t in range(n - 2):
        a, b, c = s32[t], s32[t + 1], s32[t + 2]
        bits.append(a < b)
        bits.append(a < c)
        bits.append(sf[t] < av)
        pairsums[t] = s32[t] + s32[t + 1]
    pairsums[n - 2] = s32[n - 2] + s32[n - 1]
    a, b = s32[n - 2], s32[n - 1]
    bits.append(a < b)
    bits.append(sf[n - 2] < av)
    bits.append(sf[n - 1] < av)
    for t in range(n - 1):
        for i in range(n - 1):
            if i == t or i == t - 1 or i == t + 1:
                continue
            bits.append(pairsums[t] < pairsums[i])
    return bits


def descriptor_bits(stack, mode: TransformMode):
    """Transform an image stack into binary descriptor bit planes.

    Args:
      stack: ``(n, H, W)`` uint8 or uint16 image stack.
      mode: LIMITED or FULL.

    Returns:
      ``(H, W, B)`` bool array; bit ``k`` along the last axis is the k-th bit
      the reference's ``Bitfield::set`` would append (LSB-first).
    """
    n = stack.shape[0]
    if n < 2:
        raise ValueError("need at least two images")
    s32 = stack.astype(jnp.int32)
    sf = stack.astype(jnp.float32)
    # Barrier: XLA may strength-reduce /n into a reciprocal multiply
    # (1 ulp off a correctly rounded divide); flat series sit exactly
    # on the a < av tie boundary, so that ulp flips mean-comparison
    # bits vs the reference (same guard as agree._stats).
    av = jnp.sum(sf, axis=0) / jax.lax.optimization_barrier(
        jnp.float32(n))
    if mode == TransformMode.FULL:
        bits = _full_bits(s32, sf, av)
    else:
        bits = _limited_bits(s32, sf, av)
    assert len(bits) == actual_bits(n, mode), (len(bits), n, mode)
    return jnp.stack(bits, axis=-1)


def descriptor_words(stack, mode: TransformMode):
    """Transform an image stack directly into packed uint32 descriptor words.

    Same bit semantics as :func:`descriptor_bits` + :func:`pack_bits`, but
    the bit planes are OR-ed into their words as they are produced, so no
    ``(H, W, B)`` boolean tensor (nor the pack's ``(H, W, nw, 32)`` blow-up)
    is ever materialized — at 33x2200x3300 this is the difference between
    ~5 GB of intermediates and a single pass over the stack. This is the
    production path used by the pipeline; ``descriptor_bits`` remains the
    readable form pinned against the oracle in tests.

    Returns ``(H, W, ceil(B/32)) uint32``.
    """
    n = stack.shape[0]
    if n < 2:
        raise ValueError("need at least two images")
    s32 = stack.astype(jnp.int32)
    sf = stack.astype(jnp.float32)
    # Barrier: XLA may strength-reduce /n into a reciprocal multiply
    # (1 ulp off a correctly rounded divide); flat series sit exactly
    # on the a < av tie boundary, so that ulp flips mean-comparison
    # bits vs the reference (same guard as agree._stats).
    av = jnp.sum(sf, axis=0) / jax.lax.optimization_barrier(
        jnp.float32(n))
    if mode == TransformMode.FULL:
        bits = _full_bits(s32, sf, av)
    else:
        bits = _limited_bits(s32, sf, av)
    nbits = actual_bits(n, mode)
    assert len(bits) == nbits, (len(bits), n, mode)
    h, w = stack.shape[1], stack.shape[2]
    words = []
    for wi in range(n_words_for(nbits)):
        acc = jnp.zeros((h, w), jnp.uint32)
        for pos in range(32):
            k = wi * 32 + pos
            if k >= nbits:
                break
            acc = acc | (bits[k].astype(jnp.uint32) << pos)
        words.append(acc)
    return jnp.stack(words, axis=-1)


def n_words_for(num_bits: int) -> int:
    return (num_bits + 31) // 32


def pack_bits(bits):
    """Pack ``(H, W, B)`` bool bit planes into ``(H, W, ceil(B/32))`` uint32
    little-endian words (bit k -> word k//32, position k%32).

    This matches the reference's descriptor storage for every width: uint32,
    uint64 (= word0 | word1<<32), __uint128_t and std::bitset<256> all use
    LSB-first global bit order, so Hamming distances computed on these lanes
    are identical.
    """
    h, w, b = bits.shape
    nw = n_words_for(b)
    pad = nw * 32 - b
    u = bits.astype(jnp.uint32)
    if pad:
        u = jnp.pad(u, ((0, 0), (0, 0), (0, pad)))
    u = u.reshape(h, w, nw, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(u << shifts, axis=-1, dtype=jnp.uint32)


def unpack_words(words, num_bits: int):
    """Inverse of :func:`pack_bits` -> ``(H, W, num_bits)`` bool."""
    h, w, nw = words.shape
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (words[..., None] >> shifts) & jnp.uint32(1)
    return bits.reshape(h, w, nw * 32)[..., :num_bits].astype(bool)
