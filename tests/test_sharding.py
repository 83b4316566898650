"""Multi-device sharding on the 8-device virtual CPU mesh (conftest sets
XLA_FLAGS=--xla_force_host_platform_device_count=8)."""

import numpy as np
import pytest

import libbicos_jax as bicos
from libbicos_jax import Config, Consistency, NoDuplicates, TransformMode
from libbicos_jax import descriptor, search
from libbicos_jax.sharding import (
    make_mesh, match_sharded, match_sharded_w, row_minima_wband,
)


@pytest.fixture(scope="module")
def mesh():
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 devices")
    return make_mesh(4)


CFGS = [
    Config(nxcorr_threshold=None),
    Config(nxcorr_threshold=0.5, min_variance=1.0),
    Config(nxcorr_threshold=0.7, subpixel_step=0.25,
           variant=Consistency(max_lr_diff=1, no_dupes=True)),
]


@pytest.mark.parametrize("cfg", CFGS)
def test_match_sharded_equals_single(rng, mesh, cfg):
    from conftest import make_stack_pair

    s0, s1, _ = make_stack_pair(rng, 5, 10, 24)  # H=10: uneven over 4 devices
    want = np.asarray(bicos.match(s0, s1, cfg, backend="xla"))
    got = np.asarray(
        match_sharded(s0, s1, cfg, mesh=mesh, backend="xla")
    )
    np.testing.assert_array_equal(got, want)


def test_match_sharded_corrmap(rng, mesh):
    from conftest import make_stack_pair

    cfg = Config(nxcorr_threshold=0.5)
    s0, s1, _ = make_stack_pair(rng, 5, 8, 24)
    wd, wc = bicos.match(s0, s1, cfg, corrmap=True, backend="xla")
    gd, gc = match_sharded(s0, s1, cfg, mesh=mesh, corrmap=True,
                           backend="xla")
    np.testing.assert_array_equal(np.asarray(gd), np.asarray(wd))
    np.testing.assert_array_equal(np.asarray(gc), np.asarray(wc))


def test_match_batched_sharded_equals_batched(rng, mesh):
    from conftest import make_stack_pair

    from libbicos_jax.sharding import match_batched_sharded

    cfg = Config(nxcorr_threshold=0.5, min_variance=1.0)
    pairs = [make_stack_pair(rng, 4, 6, 24) for _ in range(3)]
    b0 = np.stack([p[0] for p in pairs])  # (3, 4, 6, 24): 18 rows over 4 dev
    b1 = np.stack([p[1] for p in pairs])
    want = np.asarray(bicos.match_batched(b0, b1, cfg, backend="xla"))
    gd, gc = match_batched_sharded(
        b0, b1, cfg, mesh=mesh, corrmap=True, backend="xla"
    )
    assert np.asarray(gd).shape == want.shape == (3, 6, 24)
    np.testing.assert_array_equal(np.asarray(gd), want)
    _, wc = bicos.match_batched(b0, b1, cfg, corrmap=True, backend="xla")
    np.testing.assert_array_equal(np.asarray(gc), np.asarray(wc))


def _single_minima(backend, bits0, bits1, need_last, drange=None):
    """Single-device minima from either scan engine (the ring's reference)."""
    w0, w1 = descriptor.pack_bits(bits0), descriptor.pack_bits(bits1)
    if backend == "xla":
        return search.row_minima_xla_words(w0, w1, need_last, drange=drange)
    return search.row_minima_triton_words(w0, w1, need_last, drange,
                                          interpret=True)


@pytest.mark.parametrize("backend", ["xla", "triton_interpret"])
@pytest.mark.parametrize("need_last", [True, False])
def test_wband_ring_equals_single(rng, mesh, need_last, backend):
    from conftest import make_stack_pair

    s0, s1, _ = make_stack_pair(rng, 6, 3, 42)  # W=42: uneven over 4 devices
    b0 = descriptor.descriptor_bits(s0, TransformMode.LIMITED)
    b1 = descriptor.descriptor_bits(s1, TransformMode.LIMITED)
    cw, fw, lw = row_minima_wband(b0, b1, need_last, mesh=mesh)
    c1, f1, l1 = _single_minima(backend, b0, b1, need_last)
    np.testing.assert_array_equal(np.asarray(cw), np.asarray(c1))
    np.testing.assert_array_equal(np.asarray(fw), np.asarray(f1))
    if need_last:
        np.testing.assert_array_equal(np.asarray(lw), np.asarray(l1))


@pytest.mark.parametrize("dup", [35, 12])
def test_wband_duplicate_ties_across_bands(rng, mesh, dup):
    """A duplicate minimum split across two column bands must still be seen
    as a tie (first != last) after the ring reduction."""
    b = rng.random((1, 40, 30)) < 0.5
    b1 = b.copy()
    b1[:, dup] = b1[:, 2]  # duplicate far apart -> lives on another band
    bits0 = b[:, 2:3, :]  # single query equal to the duplicated descriptor
    cw, fw, lw = row_minima_wband(bits0, b1, True, mesh=mesh)
    assert int(cw[0, 0]) == 0
    assert int(fw[0, 0]) == 2
    assert int(lw[0, 0]) == dup


def test_match_sharded_w_kernel_agree(rng, mesh):
    """Full W-banded pipeline with the NXCORR kernel (interpret mode)
    validating each column band."""
    from conftest import make_stack_pair

    s0, s1, _ = make_stack_pair(rng, 5, 6, 41)
    for cfg in (Config(nxcorr_threshold=0.5, min_variance=1.0),
                Config(nxcorr_threshold=0.7, subpixel_step=0.25,
                       variant=Consistency(max_lr_diff=1, no_dupes=True))):
        ref = np.asarray(bicos.match(s0, s1, cfg, backend="xla"))
        got = np.asarray(match_sharded_w(
            s0, s1, cfg, mesh=mesh, backend="triton_interpret"))
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("cfg", [
    Config(nxcorr_threshold=None),
    Config(nxcorr_threshold=0.5, min_variance=1.0),
    Config(nxcorr_threshold=0.6, subpixel_step=0.5),
    # step 0.1: the x grid is NOT exactly representable in f32, so the
    # banded agree must apply its column offset inside the exact integer
    # disparity (agree_subpixel col_offset) — adding it to the float
    # output rounds twice and lands 1 ulp off single-device (regression:
    # found by tools/fuzz_soak.py; steps 0.5/0.25 are exact grids and
    # cannot catch it).
    Config(nxcorr_threshold=0.6, subpixel_step=0.1),
    Config(nxcorr_threshold=None,
           variant=Consistency(max_lr_diff=1, no_dupes=True)),
    Config(nxcorr_threshold=None,
           variant=Consistency(max_lr_diff=2, no_dupes=False)),
])
def test_match_sharded_w_equals_single(rng, mesh, cfg):
    """W-banded match (ring search + gathered-agree) must equal the
    single-device pipeline exactly."""
    from libbicos_jax.sharding import match_sharded_w
    from conftest import make_stack_pair

    s0, s1, _ = make_stack_pair(rng, 5, 4, 42)  # W=42: uneven over 4 devices
    want = bicos.match(s0, s1, cfg, backend="xla")
    got = match_sharded_w(s0, s1, cfg, mesh=mesh)
    want = np.asarray(want)
    got = np.asarray(got)
    if want.dtype == np.int16:
        np.testing.assert_array_equal(got, want)
    else:
        assert (np.isnan(got) == np.isnan(want)).all()
        m = ~np.isnan(want)
        np.testing.assert_array_equal(got[m], want[m])


def test_wband_ring_visits_prunes_exactly():
    """wband_ring_visits must keep exactly the visits where SOME (device,
    col0, col1) pair is in range — brute-forced over real column indices."""
    from libbicos_jax.sharding import wband_ring_visits

    for ndev in (2, 3, 4):
        for band in (4, 7):
            for drange in [(0, 3), (2, 9), (-5, -1), (0, 0),
                           (-2, 2), (5, 100), (-100, 100)]:
                dmin, dmax = drange
                want = []
                for i in range(ndev):
                    hit = False
                    for idx in range(ndev):
                        src = (idx + i) % ndev
                        for c0 in range(idx * band, (idx + 1) * band):
                            for c1 in range(src * band, (src + 1) * band):
                                if dmin <= c0 - c1 <= dmax:
                                    hit = True
                    if hit:
                        want.append(i)
                got = wband_ring_visits(ndev, band, drange)
                assert got == want, (ndev, band, drange, got, want)
                # Sanity: tight ranges actually prune (the feature's
                # point); at ndev=2 every visit is adjacent, nothing to cut.
                if drange == (0, 3) and band == 7 and ndev >= 3:
                    assert len(got) < ndev
    assert wband_ring_visits(4, 8, None) == [0, 1, 2, 3]


@pytest.mark.parametrize("backend", ["xla", "triton_interpret"])
@pytest.mark.parametrize("drange", [(0, 15), (3, 20), (-6, 6)])
def test_wband_ring_ranged_equals_masked_scan(rng, mesh, backend, drange):
    """Ranged W-band ring minima == the single-device ranged scan of either
    engine, including the -1/-2 no-candidate sentinels."""
    from conftest import make_stack_pair

    s0, s1, _ = make_stack_pair(rng, 6, 3, 42)
    b0 = descriptor.descriptor_bits(s0, TransformMode.LIMITED)
    b1 = descriptor.descriptor_bits(s1, TransformMode.LIMITED)
    cw, fw, lw = row_minima_wband(b0, b1, True, mesh=mesh, drange=drange)
    c1, f1, l1 = _single_minima(backend, b0, b1, True, drange)
    fw, lw = np.asarray(fw), np.asarray(lw)
    np.testing.assert_array_equal(fw, np.asarray(f1))
    np.testing.assert_array_equal(lw, np.asarray(l1))
    # Costs only comparable where a candidate exists (the sentinel branch
    # leaves engine-specific penalty values in the cost field).
    m = fw >= 0
    np.testing.assert_array_equal(np.asarray(cw)[m], np.asarray(c1)[m])
    if drange[0] > 0:
        # cols < dmin have no in-range candidate -> sentinel coverage.
        assert (~m).any(), "range should create no-candidate pixels"


@pytest.mark.parametrize("backend", ["xla", "triton_interpret"])
@pytest.mark.parametrize("cfg", [
    Config(nxcorr_threshold=0.5, min_variance=1.0,
           disparity_range=(0, 15)),
    Config(nxcorr_threshold=0.6, subpixel_step=0.1,
           disparity_range=(2, 17)),
    Config(nxcorr_threshold=None,
           variant=Consistency(max_lr_diff=1, no_dupes=True),
           disparity_range=(0, 12)),
    Config(nxcorr_threshold=0.5,
           variant=Consistency(max_lr_diff=2, no_dupes=False),
           disparity_range=(-6, 9)),
])
def test_match_sharded_w_ranged_equals_single(rng, mesh, backend, cfg):
    """disparity_range composes with W-banding: the ranged ring (with
    static visit pruning) must equal the single-device ranged pipeline
    exactly, with either agree engine."""
    from conftest import make_stack_pair

    s0, s1, _ = make_stack_pair(rng, 5, 4, 42)
    want = np.asarray(bicos.match(s0, s1, cfg, backend="xla"))
    got = np.asarray(match_sharded_w(s0, s1, cfg, mesh=mesh,
                                     backend=backend))
    if want.dtype == np.int16:
        np.testing.assert_array_equal(got, want)
    else:
        assert (np.isnan(got) == np.isnan(want)).all()
        m = ~np.isnan(want)
        np.testing.assert_array_equal(got[m], want[m])


def test_match_sharded_w_ranged_u16(rng, mesh):
    """u16 input through the ranged ring and the NXCORR kernel."""
    from conftest import make_stack_pair

    cfg = Config(nxcorr_threshold=0.5, disparity_range=(0, 15))
    s0, s1, _ = make_stack_pair(rng, 5, 3, 42, dtype=np.uint16)
    want = np.asarray(bicos.match(s0, s1, cfg, backend="xla"))
    got = np.asarray(match_sharded_w(s0, s1, cfg, mesh=mesh,
                                     backend="triton_interpret"))
    np.testing.assert_array_equal(got, want)


def test_sharded_surfaces_validate_like_match(rng, mesh):
    """The sharded entry points must reject bad inputs with the same errors
    match() raises (reference guards cpu.cpp:110-114), not crash inside
    shard_map."""
    from libbicos_jax.sharding import match_sharded_w
    from conftest import make_stack_pair

    s0, s1, _ = make_stack_pair(rng, 5, 8, 24)
    one = s0[:1]  # n=1: too few images
    bad = s0.astype(np.float32)
    for fn in (match_sharded, match_sharded_w):
        with pytest.raises(ValueError, match="at least two"):
            fn(one, s1[:1], Config(nxcorr_threshold=None), mesh=mesh)
        with pytest.raises(ValueError, match="depths"):
            fn(bad, bad, Config(nxcorr_threshold=None), mesh=mesh)
        with pytest.raises(ValueError, match="corrmap"):
            fn(s0, s1, Config(nxcorr_threshold=None), mesh=mesh,
               corrmap=True)


@pytest.mark.parametrize("w, col", [(8300, 8260), (16500, 16450)])
def test_wband_ring_wide_rows(rng, mesh, w, col):
    """Rows far wider than a band still decode global columns exactly
    (planted zero-cost match; 32 bits make spurious ties ~2^-32)."""
    bits1 = rng.random((1, w, 32)) < 0.5
    bits0 = bits1[:, col:col + 1, :].copy()
    cw, fw, lw = row_minima_wband(bits0, bits1, True, mesh=mesh)
    assert int(cw[0, 0]) == 0
    assert int(fw[0, 0]) == col


def test_match_batched_sharded_rejects_shape_mismatch(rng, mesh):
    """(2,n,6,W) vs (4,n,3,W) have the same batch*H product; folding must
    reject the mismatch instead of silently pairing rows across images."""
    from libbicos_jax.sharding import match_batched_sharded

    a = rng.integers(0, 256, (2, 4, 6, 24)).astype(np.uint8)
    c = rng.integers(0, 256, (4, 4, 3, 24)).astype(np.uint8)
    with pytest.raises(ValueError, match="identical shapes"):
        match_batched_sharded(a, c, Config(nxcorr_threshold=None), mesh=mesh)
    with pytest.raises(ValueError, match="identical shapes"):
        bicos.match_batched(a, c, Config(nxcorr_threshold=None))


def test_sharded_w_rejects_ultrawide(mesh):
    """match_sharded_w packs cost * PACK_K + col; wider images would alias
    into the cost field, so the guard must fire before any compute."""
    from libbicos_jax.sharding import match_sharded_w
    from libbicos_jax.search import PACK_K

    s = np.zeros((2, 1, PACK_K + 8), np.uint8)
    with pytest.raises(ValueError, match="width"):
        match_sharded_w(s, s, Config(nxcorr_threshold=None), mesh=mesh)


def test_match_sharded_double_precision(rng, mesh):
    """Precision.DOUBLE on the sharded surface must match the single-device
    DOUBLE result — the x64 scope has to wrap the shard_map tracing too,
    or NXCORR silently degrades to f32."""
    from libbicos_jax import Precision
    from conftest import make_stack_pair

    s0, s1, _ = make_stack_pair(rng, 5, 8, 24)
    cfg = Config(nxcorr_threshold=0.5, precision=Precision.DOUBLE)
    wd, wc = bicos.match(s0, s1, cfg, corrmap=True, backend="xla")
    gd, gc = match_sharded(s0, s1, cfg, mesh=mesh, corrmap=True,
                           backend="xla")
    np.testing.assert_array_equal(np.asarray(gd), np.asarray(wd))
    np.testing.assert_array_equal(np.asarray(gc), np.asarray(wc))


def test_match_sharded_reuses_jit_cache(rng):
    """The sharded entry points must NOT rebuild jax.jit per call — a fresh
    wrapper keys the trace cache on a new function identity and recompiles
    the whole pipeline every invocation, defeating
    serve.Engine's warm-pipeline contract."""
    from conftest import make_stack_pair
    from libbicos_jax.sharding import _hband_run, make_mesh, match_sharded

    mesh = make_mesh(2)
    cfg = Config(nxcorr_threshold=0.5)
    s0, s1, _ = make_stack_pair(rng, 4, 8, 24)
    _hband_run.cache_clear()
    a = match_sharded(s0, s1, cfg, mesh=mesh, backend="xla")
    b = match_sharded(s0, s1, cfg, mesh=mesh, backend="xla")
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    info = _hband_run.cache_info()
    assert info.misses == 1 and info.hits >= 1
    run = _hband_run(mesh, "rows", cfg, False, "xla")
    size = getattr(run, "_cache_size", lambda: None)()
    if size is not None:  # one shape specialization, reused across calls
        assert size == 1
