"""Binary correspondence search: per-row Hamming-distance argmin.

Reference semantics (``bicos.hpp:50-113``): for every pixel of the left image,
scan the *entire* right epipolar row, take the argmin of the Hamming distance
between descriptors (first occurrence), then

* NoDuplicates: invalidate if the minimum is not unique (``bicos.hpp:63-73``);
* Consistency: re-search from the best right column back into the left row and
  accept iff ``|col0 - reverse_col0| <= max_lr_diff``; disparity becomes
  ``(col0 + reverse_col0) // 2 - best_col1`` (``bicos.hpp:99-107``).

Design
------
The serial scan becomes a *reduction over a cost matrix*:

* **Packed argmin**: reduce ``K*cost + col1`` with a plain ``min`` to get
  (min cost, first argmin) in one pass, and ``K*cost + (W-1-col1)`` to get the
  last argmin. The min is unique iff first == last — this replaces the
  reference's duplicate counter with two cheap min-reductions that tile and
  shard trivially. ``K`` (:func:`pack_width`) is the power of two at or above
  the row width, at least 32768, so every packed value is an exact int32.
* Two engines compute the minima: the XLA XOR+popcount scan here (every
  platform), and on the GPU the Hamming-as-matmul kernel
  (``kernels/scan.py``): for 0/1 bit planes ``ham(a, b) = pop(a) + pop(b) -
  2 a.b``, so the W x W cost matrix of a row is an int8 product on the
  tensor cores with the packed minima in its epilogue.

The consistency variant's reverse search is the transpose of the same cost
matrix; we evaluate it as a second pass with the operands swapped, which —
unlike the reference, which re-scans per pixel (``bicos.hpp:100-101``) —
computes each reverse argmin exactly once per column, and look it up at the
forward argmin with an XLA gather.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .config import Consistency, NoDuplicates, SearchVariant
from .descriptor import pack_bits

INVALID_I16 = jnp.int16(-32768)

# Smallest packing constant: packed = K * cost + col with cost <= 256 and
# col < K. Rows wider than K widen it (pack_width).
PACK_K = 32768

BACKENDS = ("auto", "xla", "triton", "triton_interpret")


def pack_width(w1: int) -> int:
    """Packing constant for a right row of ``w1`` columns: the power of two
    at or above ``w1``, at least :data:`PACK_K`. ``cost * K + col`` stays
    exact in int32 up to ``K = 2^22`` (cost <= 256 bits)."""
    pack_k = max(PACK_K, 1 << (w1 - 1).bit_length())
    if pack_k > 1 << 22:
        raise ValueError(
            f"image width {w1} > {1 << 22} overflows the int32 cost-packing")
    return pack_k


def _row_chunk_minima(w0, w1, need_last: bool, pack_k: int = PACK_K,
                      drange=None):
    """Minima for one chunk of rows via direct XOR+popcount (int32 exact).

    w0: (R, W0, nw) uint32, w1: (R, W1, nw) uint32.
    Returns (mf, ml): packed minima (R, W0) int32; ml is None-like zeros if
    ``need_last`` is False. ``drange=(dmin, dmax)`` penalizes candidates
    whose disparity ``col0 - col1`` falls outside the inclusive range
    (the ``Config.disparity_range`` extension) — a pixel with no in-range
    candidate keeps the penalty in its packing, which the decode turns
    into the invalid sentinel.
    """
    r, wid0, nw = w0.shape
    wid1 = w1.shape[1]
    cost = None
    for k in range(nw):
        x = w0[:, :, None, k] ^ w1[:, None, :, k]
        p = jax.lax.population_count(x).astype(jnp.int32)
        cost = p if cost is None else cost + p
    col = jnp.arange(wid1, dtype=jnp.int32)
    pf = cost * pack_k + col[None, None, :]
    if need_last:
        pl_ = cost * pack_k + (wid1 - 1 - col)[None, None, :]
    if drange is not None:
        dmin, dmax = drange
        dm = (jnp.arange(wid0, dtype=jnp.int32)[None, :, None]
              - col[None, None, :])
        # where-replace (not add): the decoded cost of an all-penalized
        # pixel must exceed any true cost (<= 256) for EVERY pack width
        # up to the 2^22 ultra-wide packing.
        bad = (dm < dmin) | (dm > dmax)
        big = jnp.int32(0x7F000000)
        pf = jnp.where(bad, big, pf)
        if need_last:
            pl_ = jnp.where(bad, big, pl_)
    mf = jnp.min(pf, axis=2)
    if need_last:
        ml = jnp.min(pl_, axis=2)
    else:
        ml = jnp.zeros_like(mf)
    return mf, ml


# Column-chunk width for very wide rows: bounds the materialized cost slab
# to (row_chunk, W0, COL_CHUNK) int32 regardless of the image width.
COL_CHUNK = 8192


def _row_chunk_minima_cols(w0, w1, need_last: bool, pack_k: int,
                           drange=None):
    """Column-chunked :func:`_row_chunk_minima` for unbounded image widths.

    The reference's CPU scan walks any width with O(1) state
    (bicos.hpp:54); this is its XLA equivalent — a ``lax.scan`` over
    COL_CHUNK column slabs folding a running packed minimum, so memory
    stays O(R * W0 * COL_CHUNK) while the packing widens to the next power
    of two >= W1 (exact in int32 for widths up to 2^22 at 256 bits).
    """
    r, wid0, nw = w0.shape
    wid1 = w1.shape[1]
    ncc = -(-wid1 // COL_CHUNK)
    padc = ncc * COL_CHUNK - wid1
    w1p = jnp.pad(w1, ((0, 0), (0, padc), (0, 0)))
    w1cc = jnp.moveaxis(w1p.reshape(r, ncc, COL_CHUNK, nw), 1, 0)
    # > any real packing at every pack width (decoded cost > 256); only
    # decoded when a range leaves a pixel without candidates.
    big = jnp.int32(0x7F000000)

    def step(carry, args):
        w1c, base = args
        cost = None
        for k in range(nw):
            x = w0[:, :, None, k] ^ w1c[:, None, :, k]
            p = jax.lax.population_count(x).astype(jnp.int32)
            cost = p if cost is None else cost + p
        col = base + jnp.arange(COL_CHUNK, dtype=jnp.int32)
        ok = (col < wid1)[None, None, :]
        if drange is not None:
            dmin, dmax = drange
            dm = (jnp.arange(wid0, dtype=jnp.int32)[None, :, None]
                  - col[None, None, :])
            ok = ok & (dm >= dmin) & (dm <= dmax)
        pf = jnp.where(ok, cost * pack_k + col[None, None, :], big)
        mf = jnp.minimum(carry[0], jnp.min(pf, axis=2))
        if need_last:
            pl_ = jnp.where(
                ok, cost * pack_k + (wid1 - 1 - col)[None, None, :], big)
            ml = jnp.minimum(carry[1], jnp.min(pl_, axis=2))
        else:
            ml = carry[1]
        return (mf, ml), None

    init = (jnp.full((r, wid0), big, jnp.int32),
            jnp.full((r, wid0), big, jnp.int32))
    bases = jnp.arange(ncc, dtype=jnp.int32) * COL_CHUNK
    (mf, ml), _ = jax.lax.scan(step, init, (w1cc, bases))
    if not need_last:
        ml = jnp.zeros_like(mf)
    return mf, ml


def row_minima_xla(
    bits0, bits1, need_last: bool, row_chunk: int = 8, drange=None
) -> Tuple[jnp.ndarray, jnp.ndarray, Optional[jnp.ndarray]]:
    """Bit-plane wrapper over :func:`row_minima_xla_words` (tests/oracle
    surface; the pipeline passes packed words directly)."""
    return row_minima_xla_words(
        pack_bits(bits0), pack_bits(bits1), need_last, row_chunk,
        drange=drange,
    )


def row_minima_xla_words(
    words0, words1, need_last: bool, row_chunk: int = 8, drange=None
) -> Tuple[jnp.ndarray, jnp.ndarray, Optional[jnp.ndarray]]:
    """Forward search minima of every left pixel against its full right row.

    Args:
      words0: (H, W0, nw) uint32 packed descriptors (left/query side).
      words1: (H, W1, nw) uint32 (right/database side).
      need_last: also compute the last-occurrence argmin (for NoDuplicates).
      drange: optional inclusive (dmin, dmax) disparity-range restriction
        (``Config.disparity_range``); pixels without an in-range candidate
        decode to ``first = -1, last = -2`` (never equal, never a column).

    Returns:
      cost  (H, W0) int32 — minimum Hamming cost,
      first (H, W0) int32 — first column attaining it,
      last  (H, W0) int32 or None — last column attaining it.
    """
    h, w0, _ = words0.shape
    w1 = words1.shape[1]
    pack_k = pack_width(w1)
    col_chunked = w1 > 2 * COL_CHUNK
    if col_chunked:
        # Bound the (row_chunk, W0, COL_CHUNK) int32 cost slab to ~1 GiB.
        row_chunk = max(
            1, min(row_chunk, (1 << 28) // max(1, w0 * COL_CHUNK)))
    pad = (-h) % row_chunk
    if pad:
        words0 = jnp.pad(words0, ((0, pad), (0, 0), (0, 0)))
        words1 = jnp.pad(words1, ((0, pad), (0, 0), (0, 0)))
    nchunk = words0.shape[0] // row_chunk
    w0c = words0.reshape(nchunk, row_chunk, w0, words0.shape[-1])
    w1c = words1.reshape(nchunk, row_chunk, w1, words1.shape[-1])
    fn = _row_chunk_minima_cols if col_chunked else _row_chunk_minima
    mf, ml = jax.lax.map(
        lambda args: fn(args[0], args[1], need_last, pack_k, drange),
        (w0c, w1c),
    )
    return decode_minima(mf.reshape(-1, w0)[:h], ml.reshape(-1, w0)[:h],
                         w1, need_last, pack_k, drange)


def decode_minima(mf, ml, w1: int, need_last: bool, pack_k: int, drange):
    """Decode the packings ``mf = cost*pack_k + col`` and ``ml =
    cost*pack_k + (w1-1-col)`` into ``(cost, first, last-or-None)``.

    Shared by both scan engines and the W-band ring so the encode and
    decode rules cannot drift apart. With a disparity range, a pixel
    without an in-range candidate kept the penalty in its packing and
    decodes to ``first = -1, last = -2`` (never equal, never a column, so
    every variant decode invalidates it)."""
    cost = mf // pack_k
    first = mf - cost * pack_k
    last = ((w1 - 1) - (ml - (ml // pack_k) * pack_k)) if need_last else None
    if drange is not None:
        none = cost > 256
        first = jnp.where(none, jnp.int32(-1), first)
        if need_last:
            last = jnp.where(none, jnp.int32(-2), last)
    return cost, first, last


def row_minima_triton_words(words0, words1, need_last: bool, drange=None,
                            interpret: bool = False):
    """:func:`row_minima_xla_words` through the GPU scan kernel
    (``kernels/scan.py``); identical outputs."""
    from .kernels import scan

    h, w0, _ = words0.shape
    w1 = words1.shape[1]
    pack_k = pack_width(w1)
    tile = scan.TILE_W
    planes0, pop0 = scan.planes_from_words(words0, w0 + (-w0) % tile)
    planes1, pop1 = scan.planes_from_words(words1, w1 + (-w1) % tile)
    mf, ml = scan.packed_minima(
        planes0, planes1, pop0, pop1, w1=w1, pack_k=pack_k,
        need_last=need_last, drange=drange, interpret=interpret)
    return decode_minima(mf[:, :w0], ml[:, :w0], w1, need_last, pack_k,
                         drange)


def _row_minima_w(words0, words1, need_last: bool, backend: str,
                  drange=None):
    if backend in ("triton", "triton_interpret"):
        return row_minima_triton_words(
            words0, words1, need_last, drange,
            interpret=backend == "triton_interpret")
    return row_minima_xla_words(words0, words1, need_last, drange=drange)


def resolve_backend(backend: str) -> str:
    """Map a backend name to the engine that runs.

    ``auto`` is ``triton`` (the Pallas-Triton GPU kernels) on a GPU and
    ``xla`` elsewhere. ``triton`` needs a GPU; ``triton_interpret`` runs the
    same kernels in interpret mode on any device (tests) and is used only
    when asked for by name."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {BACKENDS}")
    platform = jax.devices()[0].platform
    if backend == "auto":
        return "triton" if platform == "gpu" else "xla"
    if backend == "triton" and platform != "gpu":
        raise ValueError(
            f"backend 'triton' compiles GPU kernels, but the default device "
            f"is {platform!r}; use 'xla', or 'triton_interpret' to run the "
            "kernels in interpret mode")
    return backend


def search(bits0, bits1, variant: SearchVariant, backend: str = "auto"):
    """Full correspondence search -> (H, W0) int16 disparity.

    Bit-exact to the reference's integer disparity output (``bicos.hpp:78-113``
    with INVALID = -32768). Bit-plane surface; the pipeline calls
    :func:`search_words` with packed descriptors directly.
    """
    return search_words(pack_bits(bits0), pack_bits(bits1), variant, backend)


def _finish_nodupes(first, last, w0: int):
    col0 = jnp.arange(w0, dtype=jnp.int32)[None, :]
    # first >= 0 guards the disparity-range no-candidate sentinel (-1/-2);
    # always true for the unrestricted scan.
    valid = (first == last) & (first >= 0)
    disp = col0 - first
    return jnp.where(valid, disp, jnp.int32(INVALID_I16)).astype(jnp.int16)


def _finish_consistency(first0, last0, first1, last1, w0: int,
                        variant: Consistency):
    """Decode from per-right-column reverse minima, looked up at the forward
    argmin with XLA gathers."""
    bc1 = jnp.clip(first0, 0, first1.shape[1] - 1)
    rc0 = jnp.take_along_axis(first1, bc1, axis=1)
    col0 = jnp.arange(w0, dtype=jnp.int32)[None, :]
    # >= 0 guards the disparity-range no-candidate sentinels (forward and
    # reverse); always true for the unrestricted scan.
    valid = ((first0 >= 0) & (rc0 >= 0)
             & (jnp.abs(col0 - rc0) <= jnp.int32(variant.max_lr_diff)))
    if variant.no_dupes:
        rok = jnp.take_along_axis(first1 == last1, bc1, axis=1)
        valid = valid & (first0 == last0) & rok
    disp = (col0 + rc0) // 2 - first0
    return jnp.where(valid, disp, jnp.int32(INVALID_I16)).astype(jnp.int16)


def search_words(
    words0, words1, variant: SearchVariant, backend: str = "auto",
    drange=None,
):
    """Correspondence search on packed uint32 descriptor words.

    ``drange``: optional inclusive (dmin, dmax) disparity-range
    restriction (``Config.disparity_range``)."""
    backend = resolve_backend(backend)
    w0 = words0.shape[1]
    if isinstance(variant, NoDuplicates):
        _, first, last = _row_minima_w(words0, words1, True, backend, drange)
        return _finish_nodupes(first, last, w0)
    assert isinstance(variant, Consistency)
    nodupes = variant.no_dupes
    _, first0, last0 = _row_minima_w(
        words0, words1, nodupes, backend, drange)
    # Reverse search: query and candidate roles swap, so the range
    # reflects to (-dmax, -dmin).
    drange_rev = None if drange is None else (-drange[1], -drange[0])
    _, first1, last1 = _row_minima_w(
        words1, words0, nodupes, backend, drange_rev)
    return _finish_consistency(first0, last0, first1, last1, w0, variant)


def search_stack(stack0, stack1, mode, variant: SearchVariant,
                 backend: str = "auto", drange=None):
    """Correspondence search straight from raw ``(n, H, W)`` image stacks:
    the descriptor transform (``descriptor.descriptor_words``, XLA) and
    :func:`search_words`."""
    from .descriptor import descriptor_words

    return search_words(
        descriptor_words(stack0, mode), descriptor_words(stack1, mode),
        variant, backend, drange=drange)
