"""Multi-chip scale-out for the BICOS pipeline.

The reference is strictly single-GPU (SURVEY.md section 2: no NCCL/MPI — its
only parallelism is row-sliced ``cv::parallel_for_`` and a thread-per-pixel
CUDA grid). Here the pipeline scales over a 1-D ``jax.sharding.Mesh`` of
devices (on one host the GPUs are joined all to all, so the mesh follows the
algorithm alone):

* **H-banding** (:func:`match_sharded`) — every stage of BICOS is
  row-independent (epipolar geometry), so sharding the row axis across chips
  is a pure map: XLA inserts *zero* collectives. This is the default and
  moves data between devices only for the initial scatter and final gather
  of results.

* **W-banding** (:func:`row_minima_wband`) — for very wide images the O(W^2)
  Hamming scan can additionally be split along columns: each chip holds a
  column band of left descriptors and ring-passes right-descriptor bands with
  ``jax.lax.ppermute``, folding each visiting band into running packed
  (min-cost, argmin) accumulators — the collective analogue of the
  reference kernel's shared-memory row cache (and of ring attention). The packed-min trick makes the
  cross-chip reduction a plain elementwise ``min``, so NoDuplicates ties and
  first-occurrence semantics survive sharding exactly.

Multi-host: build the mesh from ``jax.devices()`` after
``jax.distributed.initialize``; per-host sharded image loading lives in
:mod:`.io` (``load_multihost_stack`` / ``distribute_stack``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from . import descriptor as _descriptor
from . import search as _search
from .config import Config
from .pipeline import _match_impl
from .search import PACK_K


def make_mesh(
    n_devices: Optional[int] = None, axis_name: str = "rows"
) -> Mesh:
    """1-D device mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        # Silently truncating would attribute scaling numbers to a device
        # count that was never used.
        raise ValueError(
            f"requested {n_devices} devices but only {len(devs)} available")
    return Mesh(np.array(devs[:n_devices]), (axis_name,))


def _pad_rows(x, rows_axis: int, mult: int):
    pad = (-x.shape[rows_axis]) % mult
    if pad == 0:
        return x, 0
    widths = [(0, 0)] * x.ndim
    widths[rows_axis] = (0, pad)
    return jnp.pad(x, widths), pad


def _validate_match_args(stack0, stack1, cfg: Config, corrmap: bool):
    """Same guards match() applies (pipeline.py) — the sharded surfaces
    must fail identically, not crash downstream."""
    from .config import validate_stack
    from .pipeline import _validate_inputs

    _validate_inputs(stack0, stack1)
    validate_stack(stack0.shape[0], cfg.mode)
    if corrmap and cfg.nxcorr_threshold is None:
        raise ValueError("corrmap requires cfg.nxcorr_threshold")


def _precision_scope(cfg: Config):
    """Precision.DOUBLE needs x64 enabled around tracing, exactly as
    pipeline.match does — without it the f64 NXCORR silently degrades to
    f32 on the sharded paths."""
    from .config import Precision

    if cfg.precision == Precision.DOUBLE:
        return jax.enable_x64(True)
    import contextlib

    return contextlib.nullcontext()


@functools.lru_cache(maxsize=None)
def _hband_run(mesh: Mesh, axis_name: str, cfg: Config, corrmap: bool,
               backend: str):
    """Jitted H-band pipeline, cached per (mesh, cfg, corrmap, backend).

    The jit wrapper must be a long-lived object: a fresh ``jax.jit`` per
    call would key its trace cache on a new function identity every time
    and re-trace + recompile the whole sharded pipeline on every invocation
    — defeating serve.Engine's warm-pipeline contract.
    Shape specialization still happens inside this one wrapper's cache."""
    fn = jax.shard_map(
        lambda a, b: _match_impl(a, b, cfg, corrmap, backend),
        mesh=mesh,
        in_specs=(P(None, axis_name, None), P(None, axis_name, None)),
        out_specs=(P(axis_name, None),
                   P(axis_name, None) if corrmap else P()),
        check_vma=False,
    )
    return jax.jit(fn)


def match_sharded(
    stack0,
    stack1,
    cfg: Config = Config(),
    *,
    mesh: Optional[Mesh] = None,
    corrmap: bool = False,
    backend: str = "auto",
):
    """H-banded multi-chip ``match``: rows scattered over the mesh, no
    communication inside the pipeline (SURVEY.md section 5 plan).

    Accepts the same arguments as :func:`libbicos_jax.match` plus ``mesh``
    (defaults to all local devices on one axis).
    """
    if mesh is None:
        mesh = make_mesh()
    (axis_name,) = mesh.axis_names
    ndev = mesh.devices.size

    stack0 = jnp.asarray(stack0)
    stack1 = jnp.asarray(stack1)
    _validate_match_args(stack0, stack1, cfg, corrmap)
    stack0, pad = _pad_rows(stack0, 1, ndev)
    stack1, _ = _pad_rows(stack1, 1, ndev)
    h = stack0.shape[1]

    backend = _search.resolve_backend(backend)
    run = _hband_run(mesh, axis_name, cfg, corrmap, backend)
    sharding = NamedSharding(mesh, P(None, axis_name, None))
    s0 = jax.device_put(stack0, sharding)
    s1 = jax.device_put(stack1, sharding)
    with _precision_scope(cfg):
        disp, corr = run(s0, s1)
    if pad:
        disp = disp[: h - pad]
        corr = corr[: h - pad] if corrmap else corr
    if corrmap:
        return disp, corr
    return disp


def match_batched_sharded(
    stacks0,
    stacks1,
    cfg: Config = Config(),
    *,
    mesh: Optional[Mesh] = None,
    corrmap: bool = False,
    backend: str = "auto",
):
    """Throughput / serving layout: ``(batch, n, H, W)`` stereo-pair batches
    with the batch folded into the row axis (:func:`pipeline.match_batched`)
    and the combined ``batch * H`` rows H-banded over the mesh
    (:func:`match_sharded`, zero collectives) — one launch covers the whole
    batch across every chip. Rows of one pair may land on different chips;
    that is sound because every pipeline stage is row-independent
    (epipolar geometry)."""
    from .pipeline import _fold_batch

    flat0, flat1, (b, h, w) = _fold_batch(stacks0, stacks1)
    out = match_sharded(
        flat0, flat1, cfg, mesh=mesh, corrmap=corrmap, backend=backend
    )
    if corrmap:
        disp, corr = out
        return disp.reshape(b, h, w), corr.reshape(b, h, w)
    return out.reshape(b, h, w)


def match_sharded_w(
    stack0,
    stack1,
    cfg: Config = Config(),
    *,
    mesh: Optional[Mesh] = None,
    corrmap: bool = False,
    backend: str = "auto",
):
    """W-banded multi-chip ``match`` for very wide images: the O(W^2)
    Hamming scan — the dominant cost and memory term — stays fully sharded
    along columns (each chip ring-reduces visiting right-descriptor bands,
    see :func:`row_minima_wband`); the NXCORR stage then all-gathers the
    right stack so each chip validates its own column band (the series
    gather at ``col - d`` is unbounded, exactly the reference's full-width
    semantics, ``bicos.hpp:54``).

    Functional parity path for the SURVEY section 5 "long-context" plan;
    H-banding (:func:`match_sharded`) remains the zero-communication default.
    """
    backend = _search.resolve_backend(backend)
    if mesh is None:
        mesh = make_mesh()
    (axis_name,) = mesh.axis_names
    ndev = mesh.devices.size

    stack0 = jnp.asarray(stack0)
    stack1 = jnp.asarray(stack1)
    _validate_match_args(stack0, stack1, cfg, corrmap)
    n, h, w = stack0.shape
    if w >= PACK_K:
        # The ring reduction packs cost * PACK_K + col, so wider rows would
        # alias columns into the cost field; w == PACK_K exactly is also
        # rejected because _agree_banded's int16 local-disparity shift can
        # then collide with the -32768 invalid sentinel on a valid pixel.
        raise ValueError(f"image width >= {PACK_K} not supported")
    s0p, padw = _pad_rows(stack0, 2, ndev)
    s1p, _ = _pad_rows(stack1, 2, ndev)
    wp = s0p.shape[2]
    band = wp // ndev

    run = _wband_run(mesh, axis_name, cfg, backend, band, w, n)
    sharding = NamedSharding(mesh, P(None, None, axis_name))
    s0d = jax.device_put(s0p, sharding)
    s1d = jax.device_put(s1p, sharding)
    with _precision_scope(cfg):
        out, corr = run(s0d, s1d)
    out = out[:, :w]
    corr = corr[:, :w]
    if corrmap:
        return out, corr
    return out


@functools.lru_cache(maxsize=None)
def _wband_run(mesh: Mesh, axis_name: str, cfg: Config, backend: str,
               band: int, w: int, n: int):
    """Jitted W-band pipeline, cached like :func:`_hband_run` (``band``,
    ``w`` and ``n`` are baked into the traced closure, so they are part of
    the cache key). The ring search is XLA's on every backend; ``backend``
    chooses the agree engine."""
    from .config import NoDuplicates, Consistency

    ndev = mesh.devices.size
    variant = cfg.variant
    nodupes = isinstance(variant, NoDuplicates) or (
        isinstance(variant, Consistency) and variant.no_dupes
    )

    drange = cfg.disparity_range
    # Reverse search swaps query/candidate roles, so the range reflects —
    # same rule as the single-device decode (search.search_words).
    drange_rev = None if drange is None else (-drange[1], -drange[0])

    def shard_fn(s0_local, s1_local):
        idx = jax.lax.axis_index(axis_name)
        col0 = idx * band + jnp.arange(band, dtype=jnp.int32)[None, :]
        bits0 = _descriptor.descriptor_bits(s0_local, cfg.mode)
        bits1 = _descriptor.descriptor_bits(s1_local, cfg.mode)
        # padded left cols produce garbage rows; masked out at the end.
        _, first0, last0 = _ring_minima(
            bits0, bits1, nodupes, axis_name, ndev, band, w, drange=drange)
        if isinstance(variant, NoDuplicates):
            # first >= 0 guards the ranged no-candidate sentinel, exactly
            # as search._finish_nodupes (always true unrestricted).
            valid = (first0 == last0) & (first0 >= 0)
            disp = col0 - first0
        else:
            _, first1, last1 = _ring_minima(
                bits1, bits0, nodupes, axis_name, ndev, band, w,
                drange=drange_rev)
            # Reverse results live on the band owning each right column;
            # gather them globally for the cross-band lookup at best_col1.
            f1g = jax.lax.all_gather(
                first1, axis_name, axis=1, tiled=True)[:, :w]
            valid = jnp.ones_like(first0, dtype=bool)
            if nodupes:
                valid = first0 == last0
                l1g = jax.lax.all_gather(
                    last1, axis_name, axis=1, tiled=True)[:, :w]
                rvalid = f1g == l1g
            else:
                rvalid = jnp.ones_like(f1g, dtype=bool)
            bc1 = jnp.clip(first0, 0, w - 1)
            rc0 = jnp.take_along_axis(f1g, bc1, axis=1)
            rok = jnp.take_along_axis(rvalid, bc1, axis=1)
            # >= 0 guards the ranged no-candidate sentinels (forward and
            # reverse), exactly as search._finish_consistency_gathered.
            valid = valid & rok & (first0 >= 0) & (rc0 >= 0) & (
                jnp.abs(col0 - rc0) <= jnp.int32(variant.max_lr_diff))
            disp = (col0 + rc0) // 2 - first0
        disp = jnp.where(valid, disp, jnp.int32(-32768)).astype(jnp.int16)

        if cfg.nxcorr_threshold is None:
            return disp, jnp.full(disp.shape, jnp.nan, jnp.float32)

        # NXCORR: the right stack is gathered once; the left band plus its
        # global column offset drive the local validation.
        s1_full = jax.lax.all_gather(
            s1_local, axis_name, axis=2, tiled=True)[:, :, :w]
        minvar = None if cfg.min_variance is None else cfg.min_variance * n
        out, corr = _agree_banded(
            disp, s0_local, s1_full, col0, cfg, minvar, backend)
        return out, corr

    return jax.jit(jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(None, None, axis_name), P(None, None, axis_name)),
        out_specs=(P(None, axis_name), P(None, axis_name)),
        check_vma=False,
    ))


def wband_ring_visits(ndev: int, band: int, drange) -> list:
    """Contributing ring-visit indices under a static disparity range.

    Visit ``i`` brings chip ``idx`` the right band of ``src = (idx + i) %
    ndev``, i.e. a relative column offset ``rel = (src - idx) * band`` that
    is ``i * band`` for non-wrapping chips and ``(i - ndev) * band`` for
    wrapping ones. With ``d = col0 - col1`` restricted to ``[dmin, dmax]``
    a visit can contribute only when ``[-rel - (band-1), -rel + band-1]``
    overlaps the range; visits empty for EVERY chip are provably dead and
    the ring skips them entirely (the payload jumps them with one composed
    ``ppermute``). Typical production ranges keep 2 of ``ndev`` visits:
    the reference's structural analogue is the smem row cache
    (``bicos.cuh:77-140``) which always scans the full row."""
    if drange is None:
        return list(range(ndev))
    dmin, dmax = int(drange[0]), int(drange[1])

    def overlap(rel):
        return -rel - (band - 1) <= dmax and -rel + band - 1 >= dmin

    visits = []
    for i in range(ndev):
        rels = [i * band] if i == 0 else [i * band, (i - ndev) * band]
        if any(overlap(r) for r in rels):
            visits.append(i)
    return visits


def _ring_fold(ndev, axis_name, visits, init, fold_visit, payload):
    """Shared ring driver: visit every index in ``visits`` (ascending),
    jumping skipped rotations with one composed ``ppermute`` per gap.

    ``fold_visit(i, carry, cur)`` folds visit ``i``'s kernel result into
    the carry. With the full visit list this is the plain unrolled ring;
    with a range-pruned list the payload takes ``len(visits)`` collectives
    instead of ``ndev``."""
    pos = 0
    carry = init
    cur = payload
    for i in visits:
        if i > pos:
            k = i - pos
            cur = jax.lax.ppermute(
                cur, axis_name,
                perm=[((d + k) % ndev, d) for d in range(ndev)])
            pos = i
        carry = fold_visit(i, carry, cur)
    return carry


def _ring_minima_packed(bits0, bits1, need_last, axis_name, ndev, band, w,
                        drange=None, band0=None):
    """Packed-min ring reduction over right-descriptor bands, callable
    inside ``shard_map``. Returns ``(mf, ml)`` int32 in the ``cost * PACK_K
    + col`` packing (``ml`` packs ``cost * PACK_K + (w-1-col)``; zeros when
    ``need_last`` is False). Each visit is one XLA band cost matrix
    (:func:`_band_cost`) folded into the running packed minima."""
    h = bits0.shape[0]
    w0b = bits0.shape[1]
    band0 = w0b if band0 is None else band0
    idx = jax.lax.axis_index(axis_name)
    perm = [((d + 1) % ndev, d) for d in range(ndev)]

    def visit(i, carry, cur):
        mf, ml = carry
        src = jax.lax.rem(idx + i, ndev)
        cost = _band_cost(bits0, cur)
        col = src * band + jnp.arange(band, dtype=jnp.int32)[None, None]
        colg = jnp.broadcast_to(col, cost.shape)
        pen = jnp.where(colg >= w, jnp.int32(1 << 26), jnp.int32(0))
        if drange is not None:
            col0g = (idx * band0
                     + jnp.arange(w0b, dtype=jnp.int32))[None, :, None]
            d = col0g - colg
            pen = pen + jnp.where(
                (d < jnp.int32(drange[0])) | (d > jnp.int32(drange[1])),
                jnp.int32(1 << 26), jnp.int32(0))
        pf = cost * PACK_K + colg + pen
        mf = jnp.minimum(mf, jnp.min(pf, axis=2))
        if need_last:
            pl_ = cost * PACK_K + (w - 1 - colg) + pen
            ml = jnp.minimum(ml, jnp.min(pl_, axis=2))
        return mf, ml

    big = jnp.full((h, w0b), jnp.int32(1 << 30))
    if drange is None:
        def step(i, carry):
            mf, ml, cur = carry
            mf, ml = visit(i, (mf, ml), cur)
            return mf, ml, jax.lax.ppermute(cur, axis_name, perm=perm)

        mf, ml, _ = jax.lax.fori_loop(0, ndev, step, (big, big, bits1))
    else:
        mf, ml = _ring_fold(ndev, axis_name,
                            wband_ring_visits(ndev, band, drange),
                            (big, big), visit, bits1)
    return mf, (ml if need_last else jnp.zeros_like(mf))


def _ring_minima(bits0, bits1, need_last, axis_name, ndev, band, w,
                 drange=None, band0=None):
    """Decoded (cost, first, last) ring minima (see
    :func:`_ring_minima_packed`), with the single-device decode and
    disparity-range sentinels (``search.decode_minima``)."""
    mf, ml = _ring_minima_packed(
        bits0, bits1, need_last, axis_name, ndev, band, w,
        drange=drange, band0=band0)
    return _search.decode_minima(mf, ml, w, need_last, PACK_K, drange)


def _agree_banded(disp, stack0_local, stack1_full, col0, cfg: Config, minvar,
                  backend: str):
    """Column-band NXCORR: reuses the library agree with the local disparity
    translated into the global-column convention. agree computes
    ``col1 = col - d`` with ``col`` the LOCAL index; substituting
    ``d_local = d - offset`` makes ``col_local - d_local = col_global - d``,
    and agree's bounds/border checks run against the gathered full-width
    right stack (its ``w1``), on the ``backend``'s agree engine."""
    from . import agree as _agree

    offset = col0[0, 0]  # idx * band
    invalid = disp == jnp.int16(-32768)
    d_shift = jnp.where(
        invalid, jnp.int32(-32768), disp.astype(jnp.int32) - offset
    ).astype(jnp.int16)
    # col_offset applies the global offset inside agree's EXACT integer
    # disparity before the single float rounding of ``d - best_x``; adding
    # it to the float output here instead rounds twice — 1 ulp off the
    # single-device pipeline for non-representable x grids (step 0.1),
    # breaking the W-band exactness contract.
    out, corr = _agree.validate(
        d_shift, stack0_local, stack1_full, cfg.nxcorr_threshold,
        cfg.subpixel_step, minvar, cfg.precision, backend, col_offset=offset)
    if cfg.subpixel_step is None:
        out = jnp.where(out == jnp.int16(-32768), out,
                        (out.astype(jnp.int32) + offset).astype(jnp.int16))
    return out, corr


def row_minima_wband(
    bits0,
    bits1,
    need_last: bool,
    *,
    mesh: Mesh,
    drange=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, Optional[jnp.ndarray]]:
    """W-banded Hamming-scan minima via a ``ppermute`` ring.

    Each device owns a column band of the left descriptors and starts with
    its band of the right descriptors; right bands rotate around the ring,
    and each visit folds into the packed running minima. After ``ndev``
    steps every device holds exact global (cost, first, last) for its band.

    Inputs/outputs match :func:`..search.row_minima_xla`, but execution is
    sharded on the column axis of ``bits0``. ``drange``: inclusive
    (dmin, dmax) restriction on ``d = col0 - col1`` — visits that cannot
    contribute for any device are statically skipped (wband_ring_visits)
    and no-candidate pixels decode to the -1/-2 sentinels like the
    single-device ranged scan.
    """
    (axis_name,) = mesh.axis_names
    ndev = mesh.devices.size
    _, w0, _ = bits0.shape
    w1 = bits1.shape[1]
    if max(w0, w1) > PACK_K:
        raise ValueError(f"image width > {PACK_K} not supported")

    padded0, _ = _pad_rows(bits0, 1, ndev)
    padded1, _ = _pad_rows(bits1, 1, ndev)
    band0 = padded0.shape[1] // ndev
    band1 = padded1.shape[1] // ndev

    def shard_fn(b0, b1):
        # b0: (H, w0/ndev, B) local left band; b1: (H, band1, B) right band.
        return _ring_minima_packed(
            b0, b1, need_last, axis_name, ndev, band1, w1,
            drange=drange, band0=band0)

    mf, ml = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(None, axis_name, None), P(None, axis_name, None)),
        out_specs=(P(None, axis_name), P(None, axis_name)),
        check_vma=False,
    )(padded0, padded1)
    return _search.decode_minima(mf[:, :w0], ml[:, :w0], w1, need_last,
                                 PACK_K, drange)


def _band_cost(bits0, bits1):
    """(H, W0b, B) x (H, W1b, B) -> (H, W0b, W1b) int32 Hamming cost.

    0/1 operands in bf16 with f32 accumulation: every product and sum is
    an exact small integer."""
    a = bits0.astype(jnp.bfloat16)
    bm = bits1.astype(jnp.bfloat16)
    dot = jnp.einsum(
        "hib,hjb->hij", a, bm, preferred_element_type=jnp.float32
    )
    pop0 = jnp.sum(bits0, axis=-1, dtype=jnp.int32)[:, :, None]
    pop1 = jnp.sum(bits1, axis=-1, dtype=jnp.int32)[:, None, :]
    return pop0 + pop1 - 2 * dot.astype(jnp.int32)
