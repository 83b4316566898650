"""Descriptor transform: bit-exact parity with the per-pixel oracle."""

import numpy as np
import pytest

from libbicos_jax import TransformMode
from libbicos_jax import _oracle as oracle
from libbicos_jax import descriptor
from libbicos_jax.config import actual_bits, required_bits


@pytest.mark.parametrize("n", [2, 3, 4, 5, 10, 33, 65])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_limited_bit_exact(rng, n, dtype):
    stack = rng.integers(0, np.iinfo(dtype).max + 1, size=(n, 6, 9)).astype(dtype)
    got = np.asarray(descriptor.descriptor_bits(stack, TransformMode.LIMITED))
    want = oracle.descriptor_bits(stack, TransformMode.LIMITED)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 10, 16])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_full_bit_exact(rng, n, dtype):
    stack = rng.integers(0, np.iinfo(dtype).max + 1, size=(n, 5, 7)).astype(dtype)
    got = np.asarray(descriptor.descriptor_bits(stack, TransformMode.FULL))
    want = oracle.descriptor_bits(stack, TransformMode.FULL)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_mean_comparison_edge(rng):
    # Constant series: a < av is false everywhere; pairsum ties are false.
    stack = np.full((5, 3, 4), 7, dtype=np.uint8)
    got = np.asarray(descriptor.descriptor_bits(stack, TransformMode.LIMITED))
    want = oracle.descriptor_bits(stack, TransformMode.LIMITED)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [4, 10, 33])
def test_pack_roundtrip(rng, n):
    stack = rng.integers(0, 256, size=(n, 4, 6)).astype(np.uint8)
    bits = descriptor.descriptor_bits(stack, TransformMode.LIMITED)
    words = descriptor.pack_bits(bits)
    back = descriptor.unpack_words(words, bits.shape[-1])
    np.testing.assert_array_equal(np.asarray(back), np.asarray(bits))


def test_packed_words_match_reference_layout(rng):
    """Bit k of the oracle's append order must land at word k//32, bit k%32 —
    the little-endian layout shared by the reference's uint32/64/128/bitset
    descriptors (bitfield.hpp:49-56)."""
    stack = rng.integers(0, 256, size=(10, 3, 4)).astype(np.uint8)
    bits = oracle.descriptor_bits(stack, TransformMode.LIMITED)
    words = np.asarray(
        descriptor.pack_bits(
            descriptor.descriptor_bits(stack, TransformMode.LIMITED)
        )
    )
    b = bits.shape[-1]
    expect = np.zeros(words.shape, dtype=np.uint64)
    for k in range(b):
        expect[:, :, k // 32] |= bits[:, :, k].astype(np.uint64) << (k % 32)
    np.testing.assert_array_equal(words, expect.astype(np.uint32))


def test_required_vs_actual_bits():
    # The reference's 4n-7 undercount never crosses a word boundary.
    for n in range(2, 66):
        req = required_bits(n, TransformMode.LIMITED)
        act = actual_bits(n, TransformMode.LIMITED)
        assert act <= max(32, -(-req // 32) * 32)
    for n in range(2, 17):
        assert required_bits(n, TransformMode.FULL) == actual_bits(
            n, TransformMode.FULL
        )


def test_descriptor_words_equals_packed_bits(rng):
    """The fused word path must match pack_bits(descriptor_bits(...))."""
    import numpy as np
    from libbicos_jax import TransformMode, descriptor

    for n, mode in [(2, TransformMode.LIMITED), (5, TransformMode.LIMITED),
                    (33, TransformMode.LIMITED), (6, TransformMode.FULL),
                    (16, TransformMode.FULL)]:
        s = rng.integers(0, 256, (n, 3, 7), dtype=np.uint8)
        want = descriptor.pack_bits(descriptor.descriptor_bits(s, mode))
        got = descriptor.descriptor_words(s, mode)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
