"""Differential CI gate: the JAX engine vs the REAL compiled reference.

Everything else in the suite pins the engine against ``_oracle.py`` — a
*transcription* of the reference templates — so a shared mis-reading of the
C++ would pass silently. This module closes that loop: it builds the
reference CPU backend + ``pybicos_c`` C ABI from ``/root/reference`` (cached
in /tmp across sessions; skips cleanly when cmake/OpenCV are absent), loads
it through a CORRECTED ctypes struct (CPU builds omit the ``precision``
field — ``pybicos_c.cpp:34-37`` vs the shipped ``pybicos/__init__.py:41-51``,
see PARITY.md row 18), and fuzzes randomized config x shape x dtype trials
engine-vs-compiled-C++.

Ground truth: ``/root/reference/src/impl/cpu.cpp:36-159`` as compiled.

Comparison policy (same classes as tools/fuzz_soak.py): disparity bit-equal
except where the NXCORR value sits within ulps of the threshold (fma/serial
summation-order rounding can flip validity there); corrmap allclose 3e-5;
subpixel sweep winners may flip at near-ties (bounded corr delta + moved
disparity).
"""

from __future__ import annotations

import numpy as np
import pytest

import libbicos_jax as bicos
from libbicos_jax.config import Config, Consistency, NoDuplicates, TransformMode

import _reference_binding as rb

pytestmark = pytest.mark.skipif(
    not rb.available(),
    reason="reference toolchain (cmake/OpenCV/g++) unavailable",
)

# The engine backend under test. The suite's conftest runs everything on the
# CPU platform with strict f32; 'xla' is the production lowering there.
BACKEND = "xla"


def _draw_cfg(fz):
    mode = TransformMode.FULL if fz.integers(2) else TransformMode.LIMITED
    n_hi = 10 if mode == TransformMode.FULL else 20
    n = int(fz.integers(3, n_hi))
    # The C ABI cannot express "no threshold" (a negative sentinel keeps the
    # C++ default 0.5f, common.hpp:74 + pybicos_c.cpp:56-62), so every trial
    # draws a real threshold; the sentinel semantics themselves are pinned in
    # test_negative_threshold_sentinel_keeps_default below.
    threshold = float(fz.uniform(0.1, 0.95))
    step = (float(fz.choice([0.5, 0.25, 0.2, 0.1]))
            if fz.integers(2) else None)
    minvar = float(fz.uniform(0.0, 3.0)) if fz.integers(2) else None
    if fz.integers(2):
        variant = Consistency(max_lr_diff=int(fz.integers(1, 4)),
                              no_dupes=bool(fz.integers(2)))
    else:
        variant = NoDuplicates()
    return Config(nxcorr_threshold=threshold, subpixel_step=step,
                  min_variance=minvar, mode=mode, variant=variant), n


def _make_pair(fz, n, h, w, dtype):
    hi = int(np.iinfo(dtype).max) + 1
    if fz.integers(3):
        from libbicos_jax.io import synthetic_stack_pair
        s0, s1, _ = synthetic_stack_pair(
            n, h, w, dtype=dtype, seed=int(fz.integers(2**31)))
        return s0, s1
    s0 = fz.integers(0, hi, size=(n, h, w), dtype=dtype)
    s1 = fz.integers(0, hi, size=(n, h, w), dtype=dtype)
    return s0, s1


def _compare(ref_d, ref_c, got_d, got_c, cfg, ctx):
    """Reference (compiled C++, CPU conventions) vs engine (CUDA output
    conventions): ref disparity is float32 whenever a threshold is set
    (cpu.cpp:88-94); the engine returns int16 unless subpixel."""
    got_d = np.asarray(got_d).astype(np.float32)
    got_c = np.asarray(got_c)
    assert ref_d.dtype == np.float32, ctx
    assert ref_d.shape == got_d.shape, ctx

    step = cfg.subpixel_step
    cerr = np.abs(np.nan_to_num(ref_c, nan=-9.0)
                  - np.nan_to_num(got_c, nan=-9.0))
    if step is None:
        # Integer path: ref invalid = -32768.0 (convertTo cast), engine
        # invalid = -32768 int16. Validity may flip only within ulps of the
        # threshold; valid values must be bit-equal.
        np.testing.assert_allclose(ref_c, got_c, rtol=3e-5, atol=3e-5,
                                   equal_nan=True, err_msg=ctx)
        inv_r = ref_d == -32768.0
        inv_g = got_d == -32768.0
        near = np.abs(np.nan_to_num(ref_c, nan=-9.0)
                      - cfg.nxcorr_threshold) < 3e-5
        bad = (inv_r != inv_g) & ~near
        assert not bad.any(), ctx + " validity flip away from threshold"
        both = ~inv_r & ~inv_g
        np.testing.assert_array_equal(ref_d[both], got_d[both], ctx)
    else:
        # Subpixel cross-arithmetic policy: the engine reproduces the CUDA
        # backend's fma-chained NXCORR (agree.cuh:35-97) while this
        # differential runs against the CPU backend's serial float math —
        # at a rounding boundary the roundeven(interpolated sample) cast
        # (agree.hpp:170) can flip a sample by one quantization step at the
        # SAME sweep x, moving the corr by ~1e-3 with an unchanged
        # disparity, and near-tie sweep winners can flip outright. Bound
        # the per-pixel delta and the fraction of beyond-ulp pixels; the
        # disparity checks below stay strict.
        assert (cerr < 2e-2).all(), ctx + (
            f" corr mismatch beyond policy (max {cerr[cerr >= 2e-2].max():.3g})")
        assert (cerr > 3e-5).mean() < 0.02, ctx + (
            f" too many beyond-ulp corr pixels ({(cerr > 3e-5).mean():.1%})")
        assert (np.isnan(ref_d) == np.isnan(got_d)).mean() > 0.97, ctx
        both = ~(np.isnan(ref_d) | np.isnan(got_d))
        np.testing.assert_allclose(ref_d[both], got_d[both],
                                   atol=step + 1e-6, err_msg=ctx)


@pytest.mark.parametrize("burst", range(5))
def test_fuzz_engine_vs_compiled_reference(burst):
    """>= 50 randomized trials against the real compiled C++. Split into
    bursts so a failure localizes and the suite can parallelize."""
    fz = np.random.default_rng(0xB1C05 + burst)
    for t in range(12):
        cfg, n = _draw_cfg(fz)
        dtype = np.uint16 if fz.integers(4) == 0 else np.uint8
        h = int(fz.integers(3, 13))
        w = int(fz.integers(10, 42))
        s0, s1 = _make_pair(fz, n, h, w, dtype)
        ctx = f"burst={burst} t={t} cfg={cfg} n={n} {h}x{w} {dtype.__name__}"
        ref_d, ref_c = rb.ref_match(s0, s1, cfg)
        got_d, got_c = bicos.match(s0, s1, cfg, corrmap=True, backend=BACKEND)
        _compare(ref_d, ref_c, got_d, got_c, cfg, ctx)


def test_fuzz_compat_vs_compiled_reference():
    """The drop-in ``pybicos_compat`` surface must match the compiled
    CPU-build binding byte-for-byte: float32 disparity whenever the (always
    effective) threshold applies, identical corrmap contract."""
    import libbicos_jax.pybicos_compat as pybicos

    fz = np.random.default_rng(0xC0FFEE)
    for t in range(8):
        cfg, n = _draw_cfg(fz)
        dtype = np.uint16 if fz.integers(4) == 0 else np.uint8
        h = int(fz.integers(3, 10))
        w = int(fz.integers(10, 32))
        s0, s1 = _make_pair(fz, n, h, w, dtype)
        ctx = f"t={t} cfg={cfg} n={n} {h}x{w} {dtype.__name__}"

        pcfg = pybicos.Config()
        pcfg.nxcorr_threshold = cfg.nxcorr_threshold
        pcfg.subpixel_step = cfg.subpixel_step
        pcfg.min_variance = cfg.min_variance
        pcfg.mode = pybicos.TransformMode(
            1 if cfg.mode == TransformMode.FULL else 0)
        if isinstance(cfg.variant, Consistency):
            pcfg.set_consistency(cfg.variant.max_lr_diff,
                                 cfg.variant.no_dupes)
        ref_d, ref_c = rb.ref_match(s0, s1, cfg)
        got_d, got_c = pybicos.match(list(s0), list(s1), pcfg)
        assert got_d.dtype == ref_d.dtype == np.float32, ctx
        _compare(ref_d, ref_c, got_d, got_c, cfg, ctx)


def test_negative_threshold_sentinel_keeps_default():
    """C-ABI sentinel semantics, measured against the compiled binary:
    a negative ``nxcorr_threshold`` does NOT disable NXCORR — convertConfig
    only assigns when >= 0 (pybicos_c.cpp:56-62) and the C++ default is
    0.5f (common.hpp:74). pybicos therefore cannot reach the library's
    nullopt-threshold path; pybicos_compat mirrors this."""
    import libbicos_jax.pybicos_compat as pybicos

    rng = np.random.default_rng(7)
    s0 = rng.integers(0, 256, size=(5, 6, 24), dtype=np.uint8)
    s1 = rng.integers(0, 256, size=(5, 6, 24), dtype=np.uint8)

    ref_d, ref_c = rb.ref_match(s0, s1, Config(nxcorr_threshold=None))
    assert ref_d.dtype == np.float32
    want_d, want_c = rb.ref_match(s0, s1, Config(nxcorr_threshold=0.5))
    np.testing.assert_array_equal(ref_d, want_d)
    np.testing.assert_array_equal(ref_c, want_c)

    pcfg = pybicos.Config()
    pcfg.nxcorr_threshold = -1.0
    got_d, got_c = pybicos.match(list(s0), list(s1), pcfg)
    _compare(ref_d, ref_c, got_d, got_c, Config(nxcorr_threshold=0.5),
             "compat negative-threshold sentinel")


def test_float_output_dtype_contract():
    """CPU-build output dtype (cpu.cpp:88-94): float32 whenever a threshold
    is in effect, with invalid pixels staying -32768.0 on the integer path
    (plain convertTo cast, NOT NaN)."""
    rng = np.random.default_rng(11)
    s0 = rng.integers(0, 256, size=(6, 5, 20), dtype=np.uint8)
    s1 = rng.integers(0, 256, size=(6, 5, 20), dtype=np.uint8)
    ref_d, _ = rb.ref_match(s0, s1, Config(nxcorr_threshold=0.9))
    assert ref_d.dtype == np.float32
    assert (ref_d == -32768.0).any()  # high threshold rejects plenty
    assert not np.isnan(ref_d).any()

    import libbicos_jax.pybicos_compat as pybicos
    pcfg = pybicos.Config()
    pcfg.nxcorr_threshold = 0.9
    got_d, _ = pybicos.match(list(s0), list(s1), pcfg)
    assert got_d.dtype == np.float32
    assert not np.isnan(got_d).any()
    np.testing.assert_array_equal(ref_d, got_d)


def test_headline_config_large_stack_agreement():
    """Production-class gate: the README headline
    configuration (threshold .96, step .1, variance 2, LIMITED) on a
    33-image synthetic stack at a larger-than-fuzz size must agree with
    the COMPILED reference exactly under the standard near-tie policy.
    (The real downloadable dataset is network-restricted; the synthetic
    projected-pattern stack exercises the same statistics minus sensor
    noise.)"""
    from libbicos_jax.io import synthetic_stack_pair

    s0, s1, _ = synthetic_stack_pair(33, 96, 768, dtype=np.uint8, seed=99)
    cfg = Config(nxcorr_threshold=0.96, subpixel_step=0.1, min_variance=2.0,
                 mode=TransformMode.LIMITED)
    ref_d, ref_c = rb.ref_match(s0, s1, cfg)
    got_d, got_c = bicos.match(s0, s1, cfg, corrmap=True, backend=BACKEND)
    _compare(ref_d, ref_c, got_d, got_c, cfg, "headline large stack")
    # Sanity on the workload itself: mostly valid, BASELINE-style >=99%
    # exact agreement (measured 100% on this fixture).
    assert np.isfinite(ref_d).mean() > 0.9
    eq = (np.nan_to_num(ref_d, nan=-1e9)
          == np.nan_to_num(np.asarray(got_d), nan=-1e9)).mean()
    assert eq > 0.99, f"agreement {eq:.4f}"
