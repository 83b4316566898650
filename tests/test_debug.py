"""BICOS_DEBUG invariant checks (libbicos_jax/debug.py) — the analogue of
the reference's debug-build traps (bitfield.hpp:40-48, bitfield.cuh:56-58)."""

import numpy as np
import pytest
from conftest import make_stack_pair

import libbicos_jax as bicos
from libbicos_jax import debug as dbg
from libbicos_jax.config import TransformMode, actual_bits


def test_enabled_reads_env_at_call_time(monkeypatch):
    monkeypatch.delenv("BICOS_DEBUG", raising=False)
    assert not dbg.enabled()
    monkeypatch.setenv("BICOS_DEBUG", "0")
    assert not dbg.enabled()
    monkeypatch.setenv("BICOS_DEBUG", "1")
    assert dbg.enabled()


def test_match_passes_under_debug(rng, monkeypatch):
    """A healthy pipeline run must clear every invariant (both output
    dtypes; corrmap on)."""
    monkeypatch.setenv("BICOS_DEBUG", "1")
    s0, s1, _ = make_stack_pair(rng, 7, 6, 40)
    for cfg in (
        bicos.Config(nxcorr_threshold=0.5, min_variance=1.0),
        bicos.Config(nxcorr_threshold=0.5, subpixel_step=0.25),
    ):
        bicos.match(s0, s1, cfg, corrmap=True, backend="xla")


def test_descriptor_overflow_detected(rng):
    """Set bits at/beyond the declared width must raise (the bitfield
    overflow trap)."""
    s0, _, _ = make_stack_pair(rng, 6, 4, 40)
    from libbicos_jax import descriptor

    words = np.asarray(descriptor.descriptor_words(s0, TransformMode.LIMITED))
    nbits = actual_bits(6, TransformMode.LIMITED)
    dbg.check_descriptor_words(words, nbits)  # healthy words pass
    bad = words.copy()
    bad[0, 0, -1] |= np.uint32(1 << 31)  # a bit far past nbits
    with pytest.raises(dbg.BicosDebugError, match="overflow"):
        dbg.check_descriptor_words(bad, nbits)
    # A bit exactly AT nbits (first invalid lane) must also trip.
    bad2 = words.copy()
    bad2[0, 0, nbits // 32] |= np.uint32(1 << (nbits % 32))
    with pytest.raises(dbg.BicosDebugError, match="overflow"):
        dbg.check_descriptor_words(bad2, nbits)


def test_disparity_range_violations_detected():
    w = 40
    good = np.full((4, w), -32768, np.int16)
    good[0, 5] = 3
    dbg.check_match_output(good, None, w, subpixel=False)
    bad = good.copy()
    bad[1, 1] = w + 5  # beyond the geometric range
    with pytest.raises(dbg.BicosDebugError, match="disparity"):
        dbg.check_match_output(bad, None, w, subpixel=False)
    # float output: the subpixel margin is honored, but not more.
    goodf = np.full((4, w), np.nan, np.float32)
    goodf[0, 0] = (w - 1) + 0.9
    dbg.check_match_output(goodf, None, w, subpixel=True)
    with pytest.raises(dbg.BicosDebugError, match="disparity"):
        dbg.check_match_output(goodf, None, w, subpixel=False)


def test_corr_range_violation_detected():
    w = 16
    d = np.full((2, w), -32768, np.int16)
    corr = np.full((2, w), np.nan, np.float32)
    corr[0, 0] = -1.0  # the variance prefilter sentinel is legal
    dbg.check_match_output(d, corr, w, subpixel=False)
    corr[0, 1] = 1.5
    with pytest.raises(dbg.BicosDebugError, match="NXCORR"):
        dbg.check_match_output(d, corr, w, subpixel=False)
