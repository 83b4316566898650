"""The GPU kernels (Pallas, Triton route) in interpret mode on the CPU:
the Hamming scan (kernels/scan.py) against the XLA scan, and the NXCORR
kernel (kernels/nxcorr.py) against the per-pixel oracle, bit for bit."""

import numpy as np
import jax.numpy as jnp
import pytest

import libbicos_jax as bicos
from libbicos_jax import _oracle as oracle
from libbicos_jax import agree, descriptor, search
from libbicos_jax.config import TransformMode
from libbicos_jax.io import synthetic_stack_pair
from libbicos_jax.kernels import nxcorr, scan

L, F = TransformMode.LIMITED, TransformMode.FULL


def _words(rng, n, h, w, mode, dtype=np.uint8):
    hi = np.iinfo(dtype).max
    s0 = rng.integers(0, hi + 1, (n, h, w)).astype(dtype)
    s1 = rng.integers(0, hi + 1, (n, h, w)).astype(dtype)
    return (descriptor.descriptor_words(s0, mode),
            descriptor.descriptor_words(s1, mode))


def _assert_minima_equal(w0, w1, need_last, drange=None):
    want = search.row_minima_xla_words(w0, w1, need_last, drange=drange)
    got = search.row_minima_triton_words(w0, w1, need_last, drange,
                                         interpret=True)
    cw, fw, cg, fg = map(np.asarray, (want[0], want[1], got[0], got[1]))
    np.testing.assert_array_equal(fg, fw)
    if need_last:
        np.testing.assert_array_equal(np.asarray(got[2]),
                                      np.asarray(want[2]))
    m = fw >= 0  # costs compare where a candidate exists
    np.testing.assert_array_equal(cg[m], cw[m])


@pytest.mark.parametrize("n, mode", [
    (2, L), (3, L), (4, L), (5, L), (8, L), (12, L), (17, L), (33, L),
    (50, L), (65, L), (2, F), (3, F), (6, F), (10, F), (16, F),
])
def test_scan_matches_xla(rng, n, mode):
    """Every descriptor width (1..8 words, including constant bits at
    LIMITED n<4), first and last argmin."""
    w0, w1 = _words(rng, n, 3, 70, mode)
    _assert_minima_equal(w0, w1, True)
    _assert_minima_equal(w0, w1, False)


@pytest.mark.parametrize("w", [1, 17, 63, 64, 65, 127, 129, 200])
def test_scan_widths_off_tile(rng, w):
    """Widths that are not tile multiples: padded columns never win."""
    w0, w1 = _words(rng, 6, 2, w, L)
    _assert_minima_equal(w0, w1, True)


@pytest.mark.parametrize("w", [1408, 2048, 3300])
def test_scan_production_width(rng, w):
    """Production widths (many right tiles per program) at H = 1."""
    w0, w1 = _words(rng, 33, 1, w, L)
    _assert_minima_equal(w0, w1, True)


@pytest.mark.parametrize("drange", [
    (0, 0), (0, 10), (-5, 5), (3, 40), (-40, -3), (200, 300), (-300, 300),
])
def test_scan_ranges(rng, drange):
    """Bounded disparity ranges: only the reachable tiles are visited, the
    epilogue masks the rest, and pixels with no candidate get -1/-2."""
    w0, w1 = _words(rng, 8, 3, 260, L)
    _assert_minima_equal(w0, w1, True, drange)


def test_scan_duplicate_minima(rng):
    """Exact ties: first and last argmin differ (NoDuplicates invalidates)."""
    w0, w1 = _words(rng, 8, 2, 150, L)
    w1 = w1.at[:, 140].set(w1[:, 3])  # same descriptor in two tiles
    _assert_minima_equal(w0, w1, True)


@pytest.mark.parametrize("shift", [16, 22])
def test_scan_wide_packing(rng, shift):
    """Packing constants of ultra-wide rows (K up to 2^22 with 256-bit
    descriptors, where 2K*a.b wraps int32) decode exactly."""
    w0, w1 = _words(rng, 65, 2, 90, L)
    tile = scan.TILE_W
    p0, q0 = scan.planes_from_words(w0, 90 + (-90) % tile)
    p1, q1 = scan.planes_from_words(w1, 90 + (-90) % tile)
    k = 1 << shift
    mf, ml = scan.packed_minima(p0, p1, q0, q1, w1=90, pack_k=k,
                                need_last=True, interpret=True)
    got = search.decode_minima(mf[:, :90], ml[:, :90], 90, True, k, None)
    want = search.row_minima_xla_words(w0, w1, True)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(x))


@pytest.mark.parametrize("nw", [1, 4, 8])
def test_planes_from_words(rng, nw):
    """Bit k of word k//32 lands on plane k; padded columns are zero."""
    words = rng.integers(0, 2**32, (2, 5, nw), dtype=np.uint64).astype(
        np.uint32)
    planes, pop = scan.planes_from_words(jnp.asarray(words), 128)
    planes, pop = np.asarray(planes), np.asarray(pop)
    assert planes.shape == (2, 128, 32 * nw) and planes.dtype == np.int8
    bits = np.asarray(descriptor.unpack_words(jnp.asarray(words), 32 * nw))
    np.testing.assert_array_equal(planes[:, :5], bits.astype(np.int8))
    assert not planes[:, 5:].any() and not pop[:, 5:].any()
    np.testing.assert_array_equal(pop[:, :5], bits.sum(-1))


def _oracle_agree(disp, s0, s1, thr, step, minvar):
    d = np.asarray(disp).copy()
    if step is None:
        return oracle.agree(d, s0, s1, thr, minvar)
    return oracle.agree_subpixel(d, s0, s1, thr, step, minvar,
                                 s0.dtype.type)


def _assert_agree_exact(s0, s1, disp, thr, step, minvar):
    got = agree.agree_kernel(jnp.asarray(disp), jnp.asarray(s0),
                             jnp.asarray(s1), thr, step, minvar,
                             interpret=True)
    want = _oracle_agree(disp, s0, s1, thr, step, minvar)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), x)


def _disp(s0, s1):
    return np.array(search.search_stack(s0, s1, L, bicos.NoDuplicates(),
                                        backend="xla"))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("n", [2, 3, 5, 8, 16, 33, 65])
def test_nxcorr_integer_matches_oracle(n, dtype):
    s0, s1, _ = synthetic_stack_pair(n, 3, 40, dtype=dtype, seed=n)
    _assert_agree_exact(s0, s1, _disp(s0, s1), 0.4, None, None)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("step", [0.5, 0.25, 0.2, 0.1])
def test_nxcorr_subpixel_matches_oracle(step, dtype):
    """The f32-accumulated x grid, roundeven, the modular cast to the input
    dtype and the strict-max update, for exact and inexact grids."""
    s0, s1, _ = synthetic_stack_pair(12, 3, 50, dtype=dtype, seed=3)
    _assert_agree_exact(s0, s1, _disp(s0, s1), 0.3, step, None)


@pytest.mark.parametrize("step", [None, 0.25])
def test_nxcorr_minvar(step):
    """Variance prefilter: -1 correlation below min_variance * n."""
    s0, s1, _ = synthetic_stack_pair(6, 4, 40, seed=6)
    s0[:, 1, :20] = s0[:, 1, :20] // 64  # low-variance left series
    _assert_agree_exact(s0, s1, _disp(s0, s1), 0.3, step, 6 * 40.0)


@pytest.mark.parametrize("step", [None, 0.5])
def test_nxcorr_nan_kept(step):
    """Zero-variance series give NaN NXCORR. Integer agree: NaN < threshold
    is false, so the pixel is kept; the sweep never takes a NaN, so the
    subpixel corrmap stays at its -1 start — both as in the reference."""
    s0, s1, _ = synthetic_stack_pair(5, 3, 40, seed=4)
    s0[:, 0, :] = 7  # flat left rows
    disp = _disp(s0, s1)
    disp[0, :] = 3
    _assert_agree_exact(s0, s1, disp, 0.5, step, None)
    got = agree.agree_kernel(jnp.asarray(disp), jnp.asarray(s0),
                             jnp.asarray(s1), 0.5, step, None,
                             interpret=True)
    # col 3 matches col1 = 0, a border pixel: the integer check there.
    corr, out = np.asarray(got[1])[0, 4:], np.asarray(got[0])[0, 4:]
    if step is None:
        assert np.isnan(corr).all() and (out != -32768).all()
    else:
        assert (corr == -1).all() and np.isnan(out).all()


@pytest.mark.parametrize("step", [None, 0.5])
def test_nxcorr_borders_and_invalid(step):
    """Matches at the row borders fall back to the integer check; invalid
    and out-of-row disparities leave the corrmap NaN."""
    s0, s1, _ = synthetic_stack_pair(7, 3, 30, seed=8)
    disp = np.zeros((3, 30), np.int16)
    disp[0] = np.arange(30)            # col1 = 0: left border
    disp[1] = np.arange(30) - 29       # col1 = 29: right border
    disp[2, :10] = -32768              # invalid input
    disp[2, 10:] = 40                  # col1 < 0: out of the row
    _assert_agree_exact(s0, s1, disp, 0.2, step, None)


@pytest.mark.parametrize("step", [None, 0.1])
def test_nxcorr_production_width(step):
    s0, s1, _ = synthetic_stack_pair(33, 1, 1408, seed=33)
    _assert_agree_exact(s0, s1, _disp(s0, s1), 0.9, step, 66.0)


def test_nxcorr_series_block_padding():
    """Pixel counts that are not a block multiple: the wrapper pads and the
    padding never leaks into real pixels."""
    s0, s1, _ = synthetic_stack_pair(6, 3, 45, seed=2)  # 135 pixels
    assert (3 * 45) % nxcorr.BLOCK
    _assert_agree_exact(s0, s1, _disp(s0, s1), 0.3, 0.25, None)


@pytest.mark.parametrize("cfg", [
    bicos.Config(nxcorr_threshold=0.5),
    bicos.Config(nxcorr_threshold=0.5, min_variance=1.0),
    bicos.Config(nxcorr_threshold=0.4, subpixel_step=0.25),
    bicos.Config(nxcorr_threshold=None, mode=F),
    bicos.Config(nxcorr_threshold=0.5,
                 variant=bicos.Consistency(max_lr_diff=1, no_dupes=False)),
    bicos.Config(nxcorr_threshold=0.5, subpixel_step=0.5, min_variance=2.0,
                 variant=bicos.Consistency(max_lr_diff=2, no_dupes=True)),
    bicos.Config(nxcorr_threshold=0.96, subpixel_step=0.1,
                 min_variance=2.0),
])
def test_match_kernels_equal_oracle(cfg):
    """match() on the kernel backend equals the oracle exactly: integer
    disparity, subpixel disparity and corrmap."""
    n = 6 if cfg.mode == F else 9
    s0, s1, _ = synthetic_stack_pair(n, 4, 36, seed=n)
    want_d, want_c = oracle.match(s0, s1, cfg)
    if cfg.nxcorr_threshold is None:
        got = bicos.match(s0, s1, cfg, backend="triton_interpret")
        np.testing.assert_array_equal(np.asarray(got), want_d)
        return
    got_d, got_c = bicos.match(s0, s1, cfg, corrmap=True,
                               backend="triton_interpret")
    np.testing.assert_array_equal(np.asarray(got_d), want_d)
    np.testing.assert_array_equal(np.asarray(got_c), want_c)
