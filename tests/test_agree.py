"""NXCORR agree / subpixel: parity with the per-pixel oracle."""

import numpy as np
import pytest

from libbicos_jax import Config, NoDuplicates, TransformMode
from libbicos_jax import _oracle as oracle
from libbicos_jax import agree, descriptor, search
from conftest import make_stack_pair


def _raw_disp(rng, n, h, w, dtype=np.uint8):
    s0, s1, _ = make_stack_pair(rng, n, h, w, dtype)
    b0 = descriptor.descriptor_bits(s0, TransformMode.LIMITED)
    b1 = descriptor.descriptor_bits(s1, TransformMode.LIMITED)
    disp = np.asarray(search.search(b0, b1, NoDuplicates(), backend="xla"))
    return s0, s1, disp


@pytest.mark.parametrize("minvar", [None, 20.0])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_agree_integer_matches_oracle(rng, minvar, dtype):
    s0, s1, disp = _raw_disp(rng, 7, 5, 16, dtype)
    thr = 0.6
    got_d, got_c = agree.agree_integer(disp, s0, s1, thr, minvar)
    want_d, want_c = oracle.agree(disp.copy(), s0, s1, thr, minvar)
    np.testing.assert_array_equal(np.asarray(got_d), want_d)
    np.testing.assert_allclose(
        np.asarray(got_c), want_c, rtol=2e-5, atol=2e-5, equal_nan=True
    )


@pytest.mark.parametrize("step", [0.5, 0.25, 0.1])
def test_agree_subpixel_matches_oracle(rng, step):
    s0, s1, disp = _raw_disp(rng, 7, 4, 14)
    thr = 0.5
    got_d, got_c = agree.agree_subpixel(disp, s0, s1, thr, step, None)
    want_d, want_c = oracle.agree_subpixel(
        disp.copy(), s0, s1, thr, step, None, np.uint8
    )
    got_d, got_c = np.asarray(got_d), np.asarray(got_c)
    np.testing.assert_allclose(got_c, want_c, rtol=3e-5, atol=3e-5,
                               equal_nan=True)
    # best_x can differ only when two x values have near-identical nxcorr;
    # allow a tiny fraction of such flips but demand exactness elsewhere.
    both = ~(np.isnan(got_d) | np.isnan(want_d))
    mismatch_mask = np.isnan(got_d) != np.isnan(want_d)
    close = np.allclose(got_d[both], want_d[both], atol=float(step) + 1e-6)
    assert close
    exact = np.mean(got_d[both] == want_d[both]) if both.any() else 1.0
    assert exact > 0.95
    assert mismatch_mask.mean() < 0.05


def test_subpixel_xgrid_matches_reference_accumulation():
    # float accumulation drift: with step=0.1 the grid ends at ~0.99998,
    # so x=1.0 IS included only if accumulation lands <= 1.0f.
    for step in [0.1, 0.2, 0.25, 0.15, 0.05]:
        ours = agree.subpixel_xgrid(step)
        theirs = [float(x) for x in oracle.subpixel_xgrid(step)]
        assert ours == theirs


def test_agree_out_of_bounds_invalidates(rng):
    s0 = rng.integers(0, 256, (5, 2, 8)).astype(np.uint8)
    s1 = rng.integers(0, 256, (5, 2, 8)).astype(np.uint8)
    disp = np.full((2, 8), 100, dtype=np.int16)  # all matches out of bounds
    got_d, got_c = agree.agree_integer(disp, s0, s1, -1.0, None)
    assert (np.asarray(got_d) == -32768).all()
    assert np.isnan(np.asarray(got_c)).all()


def test_agree_zero_variance_nan_kept(rng):
    """NaN nxcorr (zero variance, no min_variance) keeps the pixel — the
    reference's `nxc < threshold` is false for NaN."""
    s0 = np.full((5, 2, 8), 9, dtype=np.uint8)
    s1 = np.full((5, 2, 8), 9, dtype=np.uint8)
    disp = np.zeros((2, 8), dtype=np.int16)
    got_d, got_c = agree.agree_integer(disp, s0, s1, 0.9, None)
    assert (np.asarray(got_d) == 0).all()
    assert np.isnan(np.asarray(got_c)).all()
    # with min_variance, nxc = -1 -> all invalidated
    got_d2, _ = agree.agree_integer(disp, s0, s1, 0.9, 5.0)
    assert (np.asarray(got_d2) == -32768).all()
