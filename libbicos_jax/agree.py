"""NXCORR validation ("agree"), variance prefilter, and subpixel refinement.

Reference semantics:

* ``nxcorr``          — ``agree.hpp:28-51`` (f32 means/variances/covariance;
  with ``min_variance``: return -1 when either variance is below it).
* integer ``agree``   — ``agree.hpp:53-93``: recompute NXCORR at the matched
  column ``col1 = col - d``; invalidate below threshold; out-of-bounds
  matches are invalidated *without* touching the corrmap.
* ``agree_subpixel``  — ``agree.hpp:95-191``: per-shot parabola through the
  three right-stack samples around ``col1``, swept over a float-accumulated
  x grid in [-1, 1]; interpolated samples are rounded half-even back to the
  integer input type (modular, matching C-style int->unsigned conversion)
  before NXCORR; border columns fall back to the integer check.

Quirks preserved on purpose:
* a zero-variance series without ``min_variance`` yields NaN NXCORR, and
  ``NaN < threshold`` is false, so the pixel is *kept* — same as the C++.
* ``min_variance`` arrives here already scaled by n (``cpu.cpp:127``).
* the x sweep's float accumulation drift (``for (x=-1; x<=1; x+=step)``) is
  replicated exactly by accumulating in float32 at trace time.

All ops are vectorized over the (H, W) plane (elementwise work under XLA
fusion); the only gathers are ``take_along_axis`` of the right stack at
``col1 +/- 1``. :func:`agree_kernel` runs the same arithmetic per pixel in
one GPU kernel (``kernels/nxcorr.py``).
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import Precision

INVALID_I16 = jnp.int16(-32768)


def subpixel_xgrid(step: float) -> List[float]:
    """Replicates the reference's f32-accumulated sweep (agree.hpp:168)."""
    xs = []
    x = np.float32(-1.0)
    while x <= np.float32(1.0):
        xs.append(float(x))
        x = np.float32(x + np.float32(step))
    return xs


def _stats(series_f, dtype):
    """Mean/diff/variance of a temporal series (n, H, W) -> ((H,W), (n,H,W), (H,W)).

    Optimization barriers keep XLA from (a) strength-reducing the division
    by n into a reciprocal multiply and (b) contracting the squared-diff
    product into the reduction as an fma — both shift results by 1 ulp vs
    the reference arithmetic.
    """

    n = series_f.shape[0]
    mean = jnp.sum(series_f, axis=0) / jax.lax.optimization_barrier(dtype(n))
    diff = series_f - mean[None]
    var = jnp.sum(jax.lax.optimization_barrier(diff * diff), axis=0)
    return mean, diff, var


def _nxcorr_from(diff0, var0, series1_f, minvar, dtype):
    """NXCORR of cached left stats against a right series (agree.hpp:28-51)."""
    _, diff1, var1 = _stats(series1_f, dtype)
    covar = jnp.sum(jax.lax.optimization_barrier(diff0 * diff1), axis=0)
    # Barrier: XLA may rewrite x/sqrt(y) into x*rsqrt(y)+refinement under
    # --xla_allow_excess_precision, off by 1 ulp (v/sqrt(v*v) != 1).
    nxc = covar / jax.lax.optimization_barrier(jnp.sqrt(var0 * var1))
    if minvar is not None:
        bad = (var0 < dtype(minvar)) | (var1 < dtype(minvar))
        nxc = jnp.where(bad, dtype(-1.0), nxc)
    return nxc


def _compute_dtype(precision: Precision):
    return jnp.float64 if precision == Precision.DOUBLE else jnp.float32


def _match_columns(disp, w: int, w1: int):
    """Matched right column ``col1 = col - d`` of every pixel: ``(d, keep,
    col1 clipped into the row)``. Invalid and out-of-bounds matches are not
    kept (agree.hpp:61-70)."""
    d = disp.astype(jnp.int32)
    col1 = jnp.arange(w, dtype=jnp.int32)[None, :] - d
    keep = (disp != INVALID_I16) & (col1 >= 0) & (col1 < w1)
    return d, keep, jnp.clip(col1, 0, w1 - 1)


def _gather(stack1, col1c, shift: int = 0):
    """Right-stack series at ``col1c + shift`` (clamped), input dtype."""
    w1 = stack1.shape[2]
    idx = jnp.clip(col1c + shift, 0, w1 - 1) if shift else col1c
    return jnp.take_along_axis(stack1, idx[None], axis=2)


def _finish_integer(d, keep, nxc, threshold: float, dt):
    corr = jnp.where(keep, nxc, jnp.nan).astype(jnp.float32)
    # NaN nxc is NOT below threshold (reference keeps such pixels).
    final = keep & ~(nxc < dt(threshold))
    out = jnp.where(final, d, jnp.int32(INVALID_I16)).astype(jnp.int16)
    return out, corr


def _finish_subpixel(d, keep, border, nxc_border, best_nxc, best_x,
                     threshold: float, dt, col_offset=0):
    corr_val = jnp.where(border, nxc_border, best_nxc)
    corr = jnp.where(keep, corr_val, jnp.nan).astype(jnp.float32)
    final = keep & ~(corr_val < dt(threshold))
    dg = (d + jnp.int32(col_offset)).astype(jnp.float32)  # exact int add
    ret = jnp.where(border, dg, dg - best_x)
    out = jnp.where(final, ret, jnp.nan).astype(jnp.float32)
    return out, corr


def agree_integer(
    disp,
    stack0,
    stack1,
    threshold: float,
    minvar: Optional[float],
    precision: Precision = Precision.SINGLE,
):
    """Integer-disparity NXCORR validation.

    Args:
      disp: (H, W) int16 raw disparity (INVALID = -32768).
      stack0/stack1: (n, H, W) uint8/uint16. ``stack1`` may be wider than
        ``stack0`` (one column band of the left image under W-banded
        sharding).

    Returns (disp int16, corrmap f32 with NaN where not computed).
    """
    dt = _compute_dtype(precision)
    d, keep, col1c = _match_columns(disp, stack0.shape[2], stack1.shape[2])
    _, diff0, var0 = _stats(stack0.astype(dt), dt)
    nxc = _nxcorr_from(diff0, var0, _gather(stack1, col1c).astype(dt),
                       minvar, dt)
    return _finish_integer(d, keep, nxc, threshold, dt)


def agree_subpixel(
    disp,
    stack0,
    stack1,
    threshold: float,
    step: float,
    minvar: Optional[float],
    precision: Precision = Precision.SINGLE,
    col_offset=0,
):
    """Subpixel parabola-sweep NXCORR validation.

    ``col_offset``: global column offset of ``disp``'s band (W-banded
    sharding). The refined output is ``float32(d + col_offset) - best_x``
    computed with the offset applied in EXACT integer arithmetic before the
    single float rounding — adding the offset to the float output after the
    fact rounds twice and lands 1 ulp off the single-device value whenever
    the x grid is not exactly representable (step 0.1; caught by the
    differential fuzz soak, tools/fuzz_soak.py).

    Returns (disp f32 with NaN invalid, corrmap f32).
    """
    dt = _compute_dtype(precision)
    in_dtype = stack0.dtype
    _, h, w = stack0.shape
    w1 = stack1.shape[2]
    d, keep, col1c = _match_columns(disp, w, w1)
    border = (col1c == 0) | (col1c == w1 - 1)

    # Gather the three neighbouring right-stack series (kept in the input
    # dtype; coefficient math is fused per x step to avoid materializing
    # (n, H, W) float intermediates).
    y1u = _gather(stack1, col1c)
    y0 = _gather(stack1, col1c, -1).astype(jnp.float32)
    y2 = _gather(stack1, col1c, 1).astype(jnp.float32)
    y1 = y1u.astype(jnp.float32)

    _, diff0, var0 = _stats(stack0.astype(dt), dt)
    pa = jnp.float32(0.5) * (y0 - jnp.float32(2.0) * y1 + y2)
    pb = jnp.float32(0.5) * (y2 - y0)

    # The x sweep runs as a lax.scan so XLA compiles ONE loop body instead of
    # unrolling ~2/step copies of (n, H, W) temporaries (compile time and
    # peak-memory win; the reference iterates serially per pixel,
    # agree.hpp:168-178).
    xs = jnp.asarray(subpixel_xgrid(step), dtype=jnp.float32)

    # Products are rounded on their own by adding a zero XLA cannot fold
    # (x * 0 is not folded for floats): LLVM contracts ``a * b + c`` into an
    # FMA on the CPU and the GPU, and one ulp there moves the roundeven
    # below onto another integer. ``fma(a, b, 0)`` is the rounded product.
    zero = y1 * jnp.float32(0.0)

    def sweep(carry, xf):
        best_nxc, best_x = carry
        # roundeven + modular cast to the input dtype (agree.hpp:170);
        # left-to-right evaluation order (a*x)*x like the reference.
        ax = pa * xf + zero
        interp_f = jnp.round(((ax * xf + zero) + (pb * xf + zero)) + y1)
        interp = interp_f.astype(jnp.int32).astype(in_dtype)
        nxc = _nxcorr_from(diff0, var0, interp.astype(dt), minvar, dt)
        upd = best_nxc < nxc  # strict: earliest x of the max wins
        best_nxc = jnp.where(upd, nxc, best_nxc)
        best_x = jnp.where(upd, xf, best_x)
        return (best_nxc, best_x), None

    init = (jnp.full((h, w), -1.0, dtype=dt), jnp.zeros((h, w), jnp.float32))
    (best_nxc, best_x), _ = jax.lax.scan(sweep, init, xs)

    nxc_border = _nxcorr_from(diff0, var0, y1u.astype(dt), minvar, dt)
    return _finish_subpixel(d, keep, border, nxc_border, best_nxc, best_x,
                            threshold, dt, col_offset)


def agree_kernel(
    disp,
    stack0,
    stack1,
    threshold: float,
    step: Optional[float],
    minvar: Optional[float],
    *,
    col_offset=0,
    interpret: bool = False,
):
    """f32 NXCORR validation through the GPU kernel (``kernels.nxcorr``):
    the same outputs as :func:`agree_integer` (``step`` None) or
    :func:`agree_subpixel` (``col_offset`` as there). XLA gathers the
    matched series; the kernel reads each stack once."""
    from .kernels import nxcorr

    n, h, w = stack0.shape
    w1 = stack1.shape[2]
    d, keep, col1c = _match_columns(disp, w, w1)
    p = h * w
    pad = (-p) % nxcorr.BLOCK

    def flat(series):
        return jnp.pad(series.reshape(n, p), ((0, 0), (0, pad)))

    s0 = flat(stack0)
    y1 = flat(_gather(stack1, col1c))
    if step is None:
        (nxc,) = nxcorr.nxcorr_series(s0, y1, minvar=minvar,
                                      interpret=interpret)
        return _finish_integer(d, keep, nxc[:p].reshape(h, w), threshold,
                               jnp.float32)
    xs = subpixel_xgrid(step)
    xgrid = (xs[0], float(np.float32(step)), len(xs))
    nxc, best, bestx = nxcorr.nxcorr_series(
        s0, y1, flat(_gather(stack1, col1c, -1)),
        flat(_gather(stack1, col1c, 1)), minvar=minvar, xgrid=xgrid,
        interpret=interpret)
    border = (col1c == 0) | (col1c == w1 - 1)
    return _finish_subpixel(
        d, keep, border, *(v[:p].reshape(h, w) for v in (nxc, best, bestx)),
        threshold, jnp.float32, col_offset)


def validate(disp, stack0, stack1, threshold: float, step: Optional[float],
             minvar: Optional[float], precision: Precision, backend: str,
             col_offset=0):
    """The agree stage on the engine ``backend`` names (already resolved):
    the GPU kernel for f32 on the kernel backends, XLA otherwise. Integer
    check when ``step`` is None, else the subpixel sweep."""
    if (backend in ("triton", "triton_interpret")
            and precision == Precision.SINGLE):
        return agree_kernel(disp, stack0, stack1, threshold, step, minvar,
                            col_offset=col_offset,
                            interpret=backend == "triton_interpret")
    if step is None:
        return agree_integer(disp, stack0, stack1, threshold, minvar,
                             precision)
    return agree_subpixel(disp, stack0, stack1, threshold, step, minvar,
                          precision, col_offset=col_offset)
