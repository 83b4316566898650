"""Correspondence search: exact parity with the per-pixel oracle scan."""

import numpy as np
import pytest

from libbicos_jax import Consistency, NoDuplicates, TransformMode
from libbicos_jax import _oracle as oracle
from libbicos_jax import descriptor, search

VARIANTS = [
    NoDuplicates(),
    Consistency(max_lr_diff=1, no_dupes=False),
    Consistency(max_lr_diff=0, no_dupes=False),
    Consistency(max_lr_diff=2, no_dupes=True),
]


def _bits_pair(rng, n, h, w, dtype=np.uint8, mode=TransformMode.LIMITED):
    from conftest import make_stack_pair

    s0, s1, _ = make_stack_pair(rng, n, h, w, dtype)
    b0 = descriptor.descriptor_bits(s0, mode)
    b1 = descriptor.descriptor_bits(s1, mode)
    ob0 = oracle.descriptor_bits(s0, mode)
    ob1 = oracle.descriptor_bits(s1, mode)
    return b0, b1, ob0, ob1


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n,mode", [
    (5, TransformMode.LIMITED),
    (10, TransformMode.LIMITED),
    (6, TransformMode.FULL),
])
def test_search_matches_oracle(rng, variant, n, mode):
    b0, b1, ob0, ob1 = _bits_pair(rng, n, 5, 18, mode=mode)
    got = np.asarray(search.search(b0, b1, variant, backend="xla"))
    want = oracle.bicos(ob0, ob1, variant)
    np.testing.assert_array_equal(got, want)


def test_search_duplicate_invalidation(rng):
    """Force ties: identical descriptors across a row must invalidate under
    NoDuplicates (bicos.hpp:71-73)."""
    # Constant stack -> every pixel has the same descriptor -> all ties.
    s = np.full((5, 3, 9), 13, dtype=np.uint8)
    b = descriptor.descriptor_bits(s, TransformMode.LIMITED)
    got = np.asarray(search.search(b, b, NoDuplicates(), backend="xla"))
    assert (got == -32768).all()
    # Consistency without no_dupes keeps the first-argmin match (col1 = 0).
    got2 = np.asarray(
        search.search(b, b, Consistency(max_lr_diff=0, no_dupes=False),
                      backend="xla")
    )
    want2 = oracle.bicos(
        oracle.descriptor_bits(s, TransformMode.LIMITED),
        oracle.descriptor_bits(s, TransformMode.LIMITED),
        Consistency(max_lr_diff=0, no_dupes=False),
    )
    np.testing.assert_array_equal(got2, want2)


def test_search_recovers_known_shift(rng):
    from conftest import make_stack_pair

    s0, s1, d = make_stack_pair(rng, 10, 6, 32, np.uint8)
    b0 = descriptor.descriptor_bits(s0, TransformMode.LIMITED)
    b1 = descriptor.descriptor_bits(s1, TransformMode.LIMITED)
    got = np.asarray(search.search(b0, b1, NoDuplicates(), backend="xla"))
    interior = got[:, d:]
    valid = interior != -32768
    # Random patterns: nearly every in-bounds pixel should recover the shift.
    assert valid.mean() > 0.9
    np.testing.assert_array_equal(interior[valid], d)


def test_row_minima_decode(rng):
    """cost/first/last decode must equal brute force."""
    b0, b1, ob0, ob1 = _bits_pair(rng, 8, 4, 15)
    cost, first, last = search.row_minima_xla(b0, b1, need_last=True)
    cost, first, last = map(np.asarray, (cost, first, last))
    ob0 = ob0.astype(bool)
    ob1 = ob1.astype(bool)
    h, w, _ = ob0.shape
    for r in range(h):
        for c in range(w):
            costs = np.count_nonzero(ob0[r, c][None, :] ^ ob1[r], axis=1)
            m = costs.min()
            idxs = np.nonzero(costs == m)[0]
            assert cost[r, c] == m
            assert first[r, c] == idxs[0]
            assert last[r, c] == idxs[-1]


def test_ultrawide_row_falls_back_to_xla(rng):
    """A wide row (8200 columns, 65 right tiles) through the GPU scan kernel
    in interpret mode equals the XLA scan, from stacks and from words."""
    from libbicos_jax import descriptor as D

    n, mode = 4, TransformMode.LIMITED
    from conftest import make_stack_pair

    s0, s1, _ = make_stack_pair(rng, n, 1, 8200, max_disp=16)
    want = np.asarray(search.search_stack(s0, s1, mode, NoDuplicates(),
                                          backend="xla"))
    got = np.asarray(search.search_stack(s0, s1, mode, NoDuplicates(),
                                         backend="triton_interpret"))
    np.testing.assert_array_equal(got, want)
    w0 = D.descriptor_words(s0, mode)
    w1 = D.descriptor_words(s1, mode)
    got_w = np.asarray(search.search_words(w0, w1, NoDuplicates(),
                                           backend="triton_interpret"))
    np.testing.assert_array_equal(got_w, want)
