"""Hamming row scan as a Pallas kernel for the GPU (Triton route).

For 0/1 bit planes ``ham(a, b) = pop(a) + pop(b) - 2 a.b``, so the W x W cost
matrix of one image row is an int8 matrix product that the tensor cores take
exactly (int32 accumulation). One program owns one row and ``TILE_I`` left
pixels; it walks the right row in ``TILE_J`` blocks and keeps the two packed
minima of the XLA scan (``search._row_chunk_minima``) in registers:

* ``cost * K + col``           -> minimum cost and its FIRST column,
* ``cost * K + (W1 - 1 - col)`` -> the LAST column (NoDuplicates test),

with ``K = search.pack_width(W1)``. The ``W x W`` cost matrix never reaches
device memory. Since ``pop(a)`` is constant along a row's reduction, the
epilogue reduces ``(pop(b) * K + col) - 2K * a.b`` and adds ``pop(a) * K``
once at the end. Padded right columns have all-zero planes (``a.b = 0``), so
a ``BIG`` column term alone keeps them from winning.

With a disparity range ``(dmin, dmax)`` the block loop covers only the right
tiles that meet ``[col0 - dmax, col0 - dmin]`` for the program's columns, and
the epilogue masks candidates outside the range. A pixel without an in-range
candidate keeps ``BIG``, which the shared decode turns into the sentinels.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Left pixels per program (the product's M; 64 rows is one warpgroup MMA)
# and right pixels per loop step (N). Widths are padded to TILE_W.
TILE_I = 64
TILE_J = 128
TILE_W = max(TILE_I, TILE_J)
NUM_WARPS = 4
NUM_STAGES = 3

# Above every real packing at every pack width (decoded cost > 256).
BIG = 0x7F000000


def planes_from_words(words, wp: int):
    """``(H, W, nw)`` uint32 words -> ``(H, wp, 32*nw)`` int8 0/1 planes
    (bit k of the descriptor on plane k), columns zero-padded to ``wp``,
    plus the per-pixel popcount ``(H, wp)`` int32."""
    h, w, nw = words.shape
    words = jnp.pad(words, ((0, 0), (0, wp - w), (0, 0)))
    shifts = jnp.arange(32, dtype=jnp.uint32)
    planes = ((words[..., None] >> shifts) & jnp.uint32(1)).astype(jnp.int8)
    pop = jnp.sum(jax.lax.population_count(words).astype(jnp.int32),
                  axis=-1, dtype=jnp.int32)
    return planes.reshape(h, wp, nw * 32), pop


def _scan_kernel(a_ref, b_ref, popa_ref, popb_ref, *out_refs,
                 w1: int, shift: int, need_last: bool, drange, n_steps: int,
                 n_tiles: int):
    row = pl.program_id(0)
    i0 = pl.program_id(1) * TILE_I
    a = a_ref[row, pl.ds(i0, TILE_I), :]
    col0 = i0 + jnp.arange(TILE_I, dtype=jnp.int32)
    if drange is None:
        j_first = 0
    else:
        j_first = jnp.maximum(i0 - drange[1], 0) // TILE_J

    def step(k, carry):
        mf, ml = carry
        j0 = jnp.minimum(j_first + k, n_tiles - 1) * TILE_J
        b = b_ref[row, pl.ds(j0, TILE_J), :]
        popb = popb_ref[row, pl.ds(j0, TILE_J)]
        dot = jax.lax.dot_general(
            a, b, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32)
        # 2K * a.b can wrap int32 at K = 2^22 (256-bit descriptors wider
        # than 2^21 columns); every sum below lands back inside int32, so
        # two's-complement wrap-around leaves the packed values exact.
        dot2k = dot << (shift + 1)
        col = j0 + jnp.arange(TILE_J, dtype=jnp.int32)
        real = col < w1
        hi = popb << shift
        vf = jnp.where(real, hi + col, BIG)[None, :] - dot2k
        if drange is not None:
            d = col0[:, None] - col[None, :]
            ok = (d >= drange[0]) & (d <= drange[1])
            vf = jnp.where(ok, vf, BIG)
        mf = jnp.minimum(mf, jnp.min(vf, axis=1))
        if need_last:
            vl = jnp.where(real, hi + (w1 - 1 - col), BIG)[None, :] - dot2k
            if drange is not None:
                vl = jnp.where(ok, vl, BIG)
            ml = jnp.minimum(ml, jnp.min(vl, axis=1))
        return mf, ml

    init = jnp.full((TILE_I,), BIG, jnp.int32)
    # int32 bounds keep the loop index int32 under jax.enable_x64.
    mf, ml = jax.lax.fori_loop(jnp.int32(0), jnp.int32(n_steps), step,
                               (init, init))
    popak = popa_ref[row, pl.ds(i0, TILE_I)] << shift
    for ref, m in zip(out_refs, (mf, ml)):
        ref[row, pl.ds(i0, TILE_I)] = jnp.where(m >= BIG, BIG, m + popak)


@functools.partial(
    jax.jit, static_argnames=("w1", "pack_k", "need_last", "drange",
                              "interpret"))
def packed_minima(planes0, planes1, pop0, pop1, *, w1: int, pack_k: int,
                  need_last: bool, drange=None, interpret: bool = False):
    """Packed first/last minima of every left pixel against its right row.

    ``planes*``/``pop*`` come from :func:`planes_from_words` (widths padded
    to a multiple of ``TILE_W``); ``w1`` is the real right width. Returns
    ``(mf, ml)`` ``(H, Wp0)`` int32 in the packing of
    ``search._row_chunk_minima`` (``ml`` is ``mf`` when ``need_last`` is
    False)."""
    h, wp0, kp = planes0.shape
    n_tiles = planes1.shape[1] // TILE_J
    if drange is None:
        n_steps = n_tiles
    else:
        span = TILE_I + drange[1] - drange[0]
        n_steps = min(n_tiles, -(-span // TILE_J) + 1)
    kernel = functools.partial(
        _scan_kernel, w1=w1, shift=pack_k.bit_length() - 1,
        need_last=need_last, drange=drange, n_steps=n_steps,
        n_tiles=n_tiles)
    out = jax.ShapeDtypeStruct((h, wp0), jnp.int32)
    res = pl.pallas_call(
        kernel,
        out_shape=(out, out) if need_last else (out,),
        grid=(h, wp0 // TILE_I),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES),
        interpret=interpret,
        name="bicos_hamming_scan",
    )(planes0, planes1, pop0, pop1)
    return res[0], res[-1]
