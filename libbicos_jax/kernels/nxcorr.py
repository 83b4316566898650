"""NXCORR validation and the subpixel sweep as a Pallas kernel for the GPU
(Triton route).

One program owns ``BLOCK`` pixels of the flattened ``(H*W)`` plane and reads
their left series and the gathered right series (``y1`` at the matched
column, ``y0``/``y2`` beside it for the sweep) in the input dtype, once from
device memory and then from cache. Per pixel it computes, in the reference's
order (``_oracle.nxcorr``: sequential sums over t, every product and sum
rounded to f32 on its own):

* ``nxc``  — NXCORR of the left series against ``y1`` (the integer check,
  and the border fallback of the sweep);
* with a subpixel step, ``best_nxc`` and ``best_x`` of the parabola sweep:
  for each x of the f32-accumulated grid, ``roundeven(((a*x)*x + b*x) + c)``
  is cast modularly to the input dtype and correlated; a strictly larger
  NXCORR moves the best x.

The masks, the threshold and the output dtype are XLA's, in
``agree._finish_integer`` / ``agree._finish_subpixel``.

Compiled, the reference-rounded f32 operations are PTX instructions with an
explicit ``.rn`` rounding mode, which ptxas never contracts into an FMA and
which round division and square root correctly. Interpret mode (tests on the
CPU) runs the same arithmetic as plain JAX operations, guarded so that XLA
neither contracts a product into an FMA nor strength-reduces a division.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BLOCK = 128
NUM_WARPS = 4


class _F32:
    """f32 arithmetic rounded like the reference, compiled or interpreted."""

    def __init__(self, interpret: bool, zero):
        self.interpret = interpret
        # Interpreted, a product is rounded on its own by adding a zero that
        # XLA cannot fold (x * 0.0 is not folded for floats): LLVM on the CPU
        # contracts ``a * b + c`` into an FMA even across an optimization
        # barrier, but ``fma(a, b, 0)`` is exactly the rounded product.
        self.zero = zero

    def _asm(self, op: str, *args):
        regs = ", ".join(f"${i + 1}" for i in range(len(args)))
        return plgpu.elementwise_inline_asm(
            f"{op} $0, {regs};",
            args=list(args),
            constraints="=f," + ",".join("f" * len(args)),
            pack=1,
            result_shape_dtypes=[
                jax.ShapeDtypeStruct(args[0].shape, jnp.float32)],
        )[0]

    def add(self, a, b):
        return a + b if self.interpret else self._asm("add.rn.f32", a, b)

    def sub(self, a, b):
        return a - b if self.interpret else self._asm("sub.rn.f32", a, b)

    def mul(self, a, b):
        if self.interpret:
            return a * b + self.zero
        return self._asm("mul.rn.f32", a, b)

    def div(self, a, b):
        if self.interpret:
            return a / jax.lax.optimization_barrier(b)
        return self._asm("div.rn.f32", a, b)

    def sqrt(self, a):
        if self.interpret:
            return jax.lax.optimization_barrier(jnp.sqrt(a))
        return self._asm("sqrt.rn.f32", a)

    def roundeven(self, a):
        return (jnp.round(a) if self.interpret
                else self._asm("cvt.rni.f32.f32", a))


def _nxcorr_kernel(s0_ref, y1_ref, *refs, n: int, mask: int, minvar,
                   xgrid, interpret: bool):
    if xgrid is None:
        (nxc_ref,) = refs
    else:
        y0_ref, y2_ref, nxc_ref, best_ref, bestx_ref = refs
    px = pl.ds(pl.program_id(0) * BLOCK, BLOCK)
    zero = jnp.zeros((BLOCK,), jnp.float32)
    nf = jnp.full((BLOCK,), n, jnp.float32)

    def load(ref, t):
        return ref[t, px].astype(jnp.int32).astype(jnp.float32)

    f = _F32(interpret, load(s0_ref, 0) * 0.0)

    def mean(series):
        total = jax.lax.fori_loop(
            0, n, lambda t, acc: f.add(acc, series(t)), zero)
        return f.div(total, nf)

    def left(t):
        return load(s0_ref, t)

    mean0 = mean(left)

    def correlate(series, var0=None):
        """agree.hpp:28-51 against the left series; var0 once known."""
        mean1 = mean(series)

        def body(t, acc):
            covar, v0, v1 = acc
            d0 = f.sub(left(t), mean0)
            d1 = f.sub(series(t), mean1)
            covar = f.add(f.mul(d0, d1), covar)
            if var0 is None:
                v0 = f.add(f.mul(d0, d0), v0)
            v1 = f.add(f.mul(d1, d1), v1)
            return covar, v0, v1

        covar, v0, v1 = jax.lax.fori_loop(0, n, body, (zero, zero, zero))
        v0 = v0 if var0 is None else var0
        nxc = f.div(covar, f.sqrt(f.mul(v0, v1)))
        if minvar is not None:
            nxc = jnp.where((v0 < minvar) | (v1 < minvar),
                            jnp.float32(-1.0), nxc)
        return nxc, v0

    nxc, var0 = correlate(lambda t: load(y1_ref, t))
    nxc_ref[px] = nxc
    if xgrid is None:
        return

    def coeffs(t):
        y0, y1, y2 = load(y0_ref, t), load(y1_ref, t), load(y2_ref, t)
        # Exact in f32 (sums of small integers times powers of two).
        return 0.5 * (y0 - 2.0 * y1 + y2), 0.5 * (y2 - y0), y1

    def sweep(k, carry):
        best, bestx, x = carry

        def interp(t):
            pa, pb, c = coeffs(t)
            v = f.add(f.add(f.mul(f.mul(pa, x), x), f.mul(pb, x)), c)
            r = f.roundeven(v).astype(jnp.int32) & mask
            return r.astype(jnp.float32)

        cur, _ = correlate(interp, var0)
        upd = best < cur  # strict: the earliest x of the maximum wins
        best = jnp.where(upd, cur, best)
        bestx = jnp.where(upd, x, bestx)
        return best, bestx, f.add(x, jnp.full((BLOCK,), xgrid[1],
                                              jnp.float32))

    x0 = jnp.full((BLOCK,), xgrid[0], jnp.float32)
    best, bestx, _ = jax.lax.fori_loop(
        0, xgrid[2], sweep, (jnp.full((BLOCK,), -1.0, jnp.float32), zero,
                             x0))
    best_ref[px] = best
    bestx_ref[px] = bestx


@functools.partial(
    jax.jit, static_argnames=("minvar", "xgrid", "interpret"))
def nxcorr_series(s0, y1, y0=None, y2=None, *, minvar=None, xgrid=None,
                  interpret: bool = False):
    """Per-pixel NXCORR of ``(n, P)`` left series against gathered right
    series, ``P`` a multiple of ``BLOCK``.

    ``xgrid = (x0, step, count)`` (f32 values) runs the subpixel sweep over
    ``y0``/``y1``/``y2``. Returns ``nxc`` ``(P,)`` f32, and with a sweep also
    ``(best_nxc, best_x)``."""
    n, p = s0.shape
    mask = jnp.iinfo(s0.dtype).max
    kernel = functools.partial(
        _nxcorr_kernel, n=n, mask=int(mask),
        minvar=None if minvar is None else float(minvar), xgrid=xgrid,
        interpret=interpret)
    out = jax.ShapeDtypeStruct((p,), jnp.float32)
    args = (s0, y1) if xgrid is None else (s0, y1, y0, y2)
    return pl.pallas_call(
        kernel,
        out_shape=(out,) if xgrid is None else (out, out, out),
        grid=(p // BLOCK,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="bicos_nxcorr",
    )(*args)
