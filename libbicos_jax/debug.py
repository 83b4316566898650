"""``BICOS_DEBUG`` runtime invariant checks.

Analogue of the reference's debug-build traps and sanitizer
strategy (SURVEY.md section 5): the reference guards bitfield overflow with
a throw on CPU (``bitfield.hpp:40-48``) / ``__trap()`` on CUDA
(``bitfield.cuh:56-58,73-76``), guards register-array indexing in the
transform kernel (``descriptor_transform.cuh:110-113``), and upstream ran
the bench suite under ASAN/MSAN/UBSAN (``bench/baselines/cuda-rtx4090.txt:4``).

Under jit, purity removes data races and wild pointers by construction, so
the residual failure surface is *logic* invariants. With ``BICOS_DEBUG=1``
(or any non-empty, non-"0" value) the pipeline validates, on every
``match()``:

* packed descriptor words carry no bits at or beyond the declared
  descriptor width (the bitfield-overflow analogue; checked where the
  packed-words path runs),
* disparities are either the INVALID sentinel or inside the geometric range
  ``(-W, W)`` (plus the subpixel half-open ``+-1`` refinement margin),
* correlation values are NaN (not computed) or inside ``[-1, 1]`` up to
  fma rounding slack (the variance prefilter's ``-1`` sentinel included).

Violations raise :class:`BicosDebugError` with offending statistics. The
checks fetch results to the host and cost milliseconds — a debug/CI tool
(like the reference's Debug builds), not a production-path feature. For NaN
provenance hunts, JAX's own ``jax.config.update("jax_debug_nans", True)``
composes with this.
"""

from __future__ import annotations

import os

import numpy as np

# Tolerance for |NXCORR| <= 1: the kernels accumulate with fused
# multiply-adds (the reference CUDA backend's own arithmetic), so values may
# exceed 1 by rounding noise on near-constant series.
CORR_SLACK = 1e-3


class BicosDebugError(AssertionError):
    """A BICOS_DEBUG invariant was violated."""


def enabled() -> bool:
    """Read the switch at call time (not import time) so tests and REPL
    sessions can toggle it."""
    return os.environ.get("BICOS_DEBUG", "") not in ("", "0")


def check_descriptor_words(words, nbits: int) -> None:
    """Bitfield-overflow analogue: lanes at or beyond ``nbits`` must be zero
    in the packed uint32 words (``descriptor.pack_bits`` LSB-first order)."""
    w = np.asarray(words)
    nw = w.shape[-1]
    if nbits > 32 * nw:
        raise BicosDebugError(
            f"descriptor width {nbits} exceeds packed capacity {32 * nw}")
    full, rem = divmod(nbits, 32)
    bad = 0
    if full < nw and rem:
        bad += int((w[..., full] >> np.uint32(rem)).astype(bool).sum())
    if full + 1 < nw or (full < nw and not rem):
        start = full + (1 if rem else 0)
        bad += int(w[..., start:].astype(bool).sum())
    if bad:
        raise BicosDebugError(
            f"{bad} packed descriptor word(s) carry bits >= the declared "
            f"width {nbits} (bitfield overflow)")


def check_match_output(disp, corr, w: int, subpixel: bool) -> None:
    """Validate a ``match()`` result against the geometric/numeric ranges."""
    d = np.asarray(disp)
    if d.dtype == np.int16:
        invalid = d == np.int16(-32768)
        vals = d[~invalid].astype(np.int64)
        lo, hi = -(w - 1), w - 1
    else:
        invalid = np.isnan(d)
        vals = d[~invalid]
        margin = 1.0 if subpixel else 0.0
        lo, hi = -(w - 1) - margin, (w - 1) + margin
    if vals.size and (vals.min() < lo or vals.max() > hi):
        raise BicosDebugError(
            f"disparity out of range [{lo}, {hi}]: "
            f"min={vals.min()} max={vals.max()}")
    if corr is not None:
        c = np.asarray(corr)
        cv = c[~np.isnan(c)]
        if cv.size and (cv.min() < -1.0 - CORR_SLACK
                        or cv.max() > 1.0 + CORR_SLACK):
            raise BicosDebugError(
                f"NXCORR out of [-1, 1] (+/-{CORR_SLACK}): "
                f"min={cv.min()} max={cv.max()}")
