"""``Config.disparity_range`` — the bounded-range matching extension.

The reference always scans the full row (``bicos.hpp:54``); the range mode
is an extension (standard production-stereo contract) whose
semantics are: argmin restricted to candidates with ``dmin <= col0 - col1
<= dmax`` (both searches of the Consistency variant), no-candidate pixels
invalid, everything downstream (ties, NXCORR, subpixel) unchanged. The
ground truth here is a direct numpy transcription of that definition; the
masked XLA scan and the GPU scan kernel (interpret mode), whose block loop
visits only the right tiles the range can reach, must both agree with it
exactly.
"""

import numpy as np
import pytest
import jax.numpy as jnp

import libbicos_jax as bicos
from libbicos_jax import _oracle
from libbicos_jax.config import Config, Consistency
from libbicos_jax.io import synthetic_stack_pair


def _np_range_nodupes(s0, s1, mode, dmin, dmax):
    b0 = np.asarray(_oracle.descriptor_bits(np.asarray(s0), mode))
    b1 = np.asarray(_oracle.descriptor_bits(np.asarray(s1), mode))
    h, w, _ = b0.shape
    disp = np.full((h, w), -32768, np.int16)
    for r in range(h):
        ham = (b0[r][:, None, :] != b1[r][None, :, :]).sum(-1)
        for c in range(w):
            lo, hi = max(0, c - dmax), min(w - 1, c - dmin)
            if lo > hi:
                continue
            costs = ham[c, lo:hi + 1]
            idxs = np.nonzero(costs == costs.min())[0]
            if len(idxs) == 1:
                disp[r, c] = c - (lo + idxs[0])
    return disp


@pytest.mark.parametrize("dr", [(0, 31), (-5, 20), (10, 40)])
def test_range_search_matches_numpy_reference(rng, dr):
    s0, s1, _ = synthetic_stack_pair(8, 10, 80, dtype=np.uint8, seed=5)
    cfg = Config(nxcorr_threshold=None, disparity_range=dr)
    want = _np_range_nodupes(s0, s1, cfg.mode, *dr)
    got_x = np.asarray(bicos.match(s0, s1, cfg, backend="xla"))
    np.testing.assert_array_equal(got_x, want)
    # The GPU scan kernel, whose block loop skips out-of-range tiles.
    got_p = np.asarray(bicos.match(s0, s1, cfg, backend="triton_interpret"))
    np.testing.assert_array_equal(got_p, want)


def test_range_restricts_and_validity(rng):
    """In-range disparities only; pixels whose window leaves the row are
    invalid; the unrestricted scan is reproduced by a full-width range."""
    s0, s1, d = synthetic_stack_pair(8, 8, 64, dtype=np.uint8, seed=7)
    full = np.asarray(bicos.match(
        s0, s1, Config(nxcorr_threshold=None), backend="xla"))
    wide = np.asarray(bicos.match(
        s0, s1, Config(nxcorr_threshold=None, disparity_range=(-63, 63)),
        backend="xla"))
    np.testing.assert_array_equal(full, wide)

    got = np.asarray(bicos.match(
        s0, s1, Config(nxcorr_threshold=None, disparity_range=(0, 15)),
        backend="xla"))
    v = got != -32768
    assert v.any()
    assert ((got[v] >= 0) & (got[v] <= 15)).all()


@pytest.mark.parametrize("step", [None, 0.25])
@pytest.mark.parametrize("variant", [
    None,  # NoDuplicates
    Consistency(max_lr_diff=3, no_dupes=True),  # widened agree windows
])
def test_range_full_pipeline_kernel_vs_xla(rng, step, variant):
    """Threshold+minvar (+subpixel) with range: the kernel pipeline (ranged
    scan + NXCORR kernel) must match the XLA path bit-for-bit, including
    Consistency disparities that sit ceil(max_lr_diff/2) outside the
    range."""
    s0, s1, _ = synthetic_stack_pair(12, 12, 700, dtype=np.uint8, seed=9)
    kw = {} if variant is None else {"variant": variant}
    cfg = Config(nxcorr_threshold=0.5, subpixel_step=step, min_variance=1.0,
                 disparity_range=(0, 63), **kw)
    gx = np.asarray(bicos.match(s0, s1, cfg, backend="xla"))
    gp = np.asarray(bicos.match(s0, s1, cfg, backend="triton_interpret"))
    if gx.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(gx), np.isnan(gp))
        m = ~np.isnan(gx)
        np.testing.assert_array_equal(gx[m], gp[m])
    else:
        np.testing.assert_array_equal(gx, gp)


@pytest.mark.parametrize("step", [None, 0.25])
def test_range_u16_mxu_gather_kernel_vs_xla(rng, step):
    """u16 + range: the kernel pipeline reads u16 series (modular u16
    rounding in the sweep) and must match XLA bit-for-bit for both the
    integer and subpixel variants."""
    s0, s1, _ = synthetic_stack_pair(12, 12, 700, dtype=np.uint16, seed=13)
    cfg = Config(nxcorr_threshold=0.5, subpixel_step=step, min_variance=1.0,
                 disparity_range=(0, 63))
    gx = np.asarray(bicos.match(s0, s1, cfg, backend="xla"))
    gp = np.asarray(bicos.match(s0, s1, cfg, backend="triton_interpret"))
    if gx.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(gx), np.isnan(gp))
        m = ~np.isnan(gx)
        np.testing.assert_array_equal(gx[m], gp[m])
    else:
        np.testing.assert_array_equal(gx, gp)


@pytest.mark.parametrize("no_dupes", [True, False])
@pytest.mark.parametrize("mld", [1, 3])
def test_range_consistency_variant(rng, no_dupes, mld):
    """Consistency (+no_dupes) with range: the ranged scan kernel, run
    forward and reverse (reflected range), must match the masked XLA scan
    bit-for-bit; the averaged consistency disparity can sit
    ceil(max_lr_diff/2) outside the search range."""
    s0, s1, _ = synthetic_stack_pair(8, 8, 64, dtype=np.uint8, seed=11)
    cfg = Config(nxcorr_threshold=0.5, min_variance=1.0,
                 variant=Consistency(max_lr_diff=mld, no_dupes=no_dupes),
                 disparity_range=(0, 31))
    gx = np.asarray(bicos.match(s0, s1, cfg, backend="xla"))
    gp = np.asarray(bicos.match(s0, s1, cfg, backend="triton_interpret"))
    np.testing.assert_array_equal(gx, gp)
    v = gx != -32768
    m2 = (mld + 1) // 2
    assert ((gx[v] >= -m2) & (gx[v] <= 31 + m2)).all()


def test_range_config_validation():
    with pytest.raises(ValueError):
        Config(disparity_range=(5, 1))
    with pytest.raises(ValueError):
        Config(disparity_range=(1.5, 3))
    assert Config(disparity_range=(0, 64)).disparity_range == (0, 64)


def test_range_wband_matches_single_chip(rng):
    """Ranged W-banding must equal the single-device ranged scan — the
    full equality matrix (both agree engines, u8/u16, negative ranges)
    lives in tests/test_sharding.py."""
    from libbicos_jax.sharding import make_mesh, match_sharded_w

    s0, s1, _ = synthetic_stack_pair(5, 8, 32, dtype=np.uint8, seed=1)
    cfg = Config(nxcorr_threshold=0.5, disparity_range=(0, 8))
    ref = np.asarray(bicos.match(s0, s1, cfg, backend="xla"))
    got = np.asarray(match_sharded_w(
        s0, s1, cfg, mesh=make_mesh(2), backend="xla"))
    np.testing.assert_array_equal(got, ref)


def test_range_hband_matches_single_chip(rng):
    from libbicos_jax.sharding import make_mesh, match_sharded

    s0, s1, _ = synthetic_stack_pair(6, 16, 48, dtype=np.uint8, seed=2)
    cfg = Config(nxcorr_threshold=0.5, disparity_range=(0, 15))
    ref = np.asarray(bicos.match(s0, s1, cfg, backend="xla"))
    got = np.asarray(match_sharded(
        s0, s1, cfg, mesh=make_mesh(4), backend="xla"))
    np.testing.assert_array_equal(got, ref)
