"""Tests that need the card (marked ``gpu``; skipped elsewhere by the
``gpu`` fixture). On the card:

    BICOS_TEST_PLATFORM=gpu python -m pytest tests/test_gpu.py -m gpu

They compile the Triton-route kernels for the GPU and hold them to the same
references as the interpret-mode tests: the scan to the XLA scan on the
same card, the NXCORR kernel and the whole kernel pipeline to the per-pixel
oracle, bit for bit."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import libbicos_jax as bicos
from libbicos_jax import _oracle as oracle
from libbicos_jax import agree, descriptor, search
from libbicos_jax.config import TransformMode
from libbicos_jax.io import synthetic_stack_pair

pytestmark = pytest.mark.gpu
L, F = TransformMode.LIMITED, TransformMode.FULL


def test_auto_backend_is_triton(gpu):
    assert search.resolve_backend("auto") == "triton"


@pytest.mark.parametrize("n, mode, drange", [
    (4, L, None),        # one descriptor word
    (33, L, None),       # the headline's four words
    (65, L, None),       # eight words
    (16, F, None),
    (33, L, (0, 511)),
    (12, L, (-40, 40)),
])
def test_scan_kernel_matches_xla(gpu, n, mode, drange):
    s0, s1, _ = synthetic_stack_pair(n, 4, 3300, seed=n)
    w0 = descriptor.descriptor_words(s0, mode)
    w1 = descriptor.descriptor_words(s1, mode)
    want = search.row_minima_xla_words(w0, w1, True, drange=drange)
    got = search.row_minima_triton_words(w0, w1, True, drange)
    for g, x in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(x))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("step", [None, 0.5, 0.1])
def test_nxcorr_kernel_matches_oracle(gpu, step, dtype):
    """The .rn PTX arithmetic reproduces the reference's f32 rounding."""
    s0, s1, _ = synthetic_stack_pair(33, 3, 200, dtype=dtype, seed=5)
    disp = np.array(search.search_stack(s0, s1, L, bicos.NoDuplicates()))
    got = agree.agree_kernel(jnp.asarray(disp), jnp.asarray(s0),
                             jnp.asarray(s1), 0.5, step, 66.0)
    if step is None:
        want = oracle.agree(disp.copy(), s0, s1, 0.5, 66.0)
    else:
        want = oracle.agree_subpixel(disp.copy(), s0, s1, 0.5, step, 66.0,
                                     s0.dtype.type)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), x)


@pytest.mark.parametrize("cfg", [
    bicos.Config(nxcorr_threshold=None, mode=F),
    bicos.Config(nxcorr_threshold=0.5, min_variance=1.0),
    bicos.Config(nxcorr_threshold=0.96, subpixel_step=0.1,
                 min_variance=2.0),
    bicos.Config(nxcorr_threshold=0.5, subpixel_step=0.5, min_variance=2.0,
                 variant=bicos.Consistency(max_lr_diff=2, no_dupes=True)),
])
def test_match_kernels_equal_oracle(gpu, cfg):
    n = 6 if cfg.mode == F else 9
    s0, s1, _ = synthetic_stack_pair(n, 4, 300, seed=n)
    want_d, want_c = oracle.match(s0, s1, cfg)
    if cfg.nxcorr_threshold is None:
        np.testing.assert_array_equal(np.asarray(bicos.match(s0, s1, cfg)),
                                      want_d)
        return
    got_d, got_c = bicos.match(s0, s1, cfg, corrmap=True)
    np.testing.assert_array_equal(np.asarray(got_d), want_d)
    np.testing.assert_array_equal(np.asarray(got_c), want_c)


@pytest.mark.parametrize("n", [2, 4, 6])
def test_xla_single_word_descriptors(gpu, n):
    """Descriptors of one uint32 word compile on the card's XLA path and
    equal the CPU's integer result."""
    s0, s1, _ = synthetic_stack_pair(n, 8, 500, seed=n)
    cfg = bicos.Config(nxcorr_threshold=None)
    got = np.asarray(bicos.match(s0, s1, cfg, backend="xla"))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        want = np.asarray(bicos.match(jax.device_put(s0, cpu),
                                      jax.device_put(s1, cpu), cfg,
                                      backend="xla"))
    np.testing.assert_array_equal(got, want)
