"""End-to-end BICOS matching pipeline under one ``jax.jit``.

Equivalent of the reference's backend orchestrators (``cpu.cpp:36-159``,
``cuda.cu:56-524``) — but instead of runtime template dispatch over
{u8,u16} x {u32,u64,u128,bitset256}, each (shape, dtype, Config) combination
is a separate XLA specialization; descriptor width is just the static trace
constant B. The CUDA backend's stream choreography (two substreams for the
two transforms, ``cuda.cu:85-161``) is unnecessary: both transforms live in
one jitted program and XLA schedules them.

Output dtype convention follows the CUDA backend (``cuda.cu:457-458``):
int16 disparity unless subpixel refinement is enabled (then float32 with NaN
invalid). (The reference CPU backend instead converts to float32 whenever a
threshold is set, ``cpu.cpp:88-94`` — a documented backend divergence; see
``pybicos_compat.float_disparity`` for the CPU-flavoured surface.)

``min_variance`` is scaled by the stack size before use, preserving the
reference quirk (``cpu.cpp:127``, ``cuda.cu:455``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import agree as _agree
from . import descriptor as _descriptor
from . import search as _search
from .config import Config, Precision, validate_stack


def _validate_inputs(stack0, stack1):
    if stack0.ndim != 3 or stack1.ndim != 3:
        raise ValueError("stacks must have shape (n, H, W)")
    if stack0.shape != stack1.shape:
        raise ValueError(
            f"stack shapes differ: {stack0.shape} vs {stack1.shape}"
        )
    if stack0.dtype != stack1.dtype:
        raise ValueError("stack dtypes differ")
    if stack0.dtype not in (jnp.uint8, jnp.uint16):
        raise ValueError(
            "bad input depths, only uint8 and uint16 are supported"
        )


def _match_impl(stack0, stack1, cfg: Config, want_corrmap: bool, backend: str):
    n = stack0.shape[0]
    # Packed-words path: descriptors are OR-ed into uint32 lanes as the
    # comparisons are computed — no (H, W, B) boolean tensors.
    words0 = _descriptor.descriptor_words(stack0, cfg.mode)
    words1 = _descriptor.descriptor_words(stack1, cfg.mode)
    disp = _search.search_words(
        words0, words1, cfg.variant, backend=backend,
        drange=cfg.disparity_range,
    )

    if cfg.nxcorr_threshold is None:
        return disp, None

    minvar = None if cfg.min_variance is None else cfg.min_variance * n
    out, corr = _agree.validate(
        disp, stack0, stack1, cfg.nxcorr_threshold, cfg.subpixel_step, minvar,
        cfg.precision, backend)
    return out, (corr if want_corrmap else None)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _match_jit(stack0, stack1, cfg: Config, want_corrmap: bool, backend: str):
    return _match_impl(stack0, stack1, cfg, want_corrmap, backend)


def match(
    stack0,
    stack1,
    cfg: Config = Config(),
    *,
    corrmap: bool = False,
    backend: str = "auto",
):
    """Match two multishot stereo stacks (the ``BICOS::match`` equivalent,
    ``match.hpp:31-41``).

    Args:
      stack0/stack1: ``(n, H, W)`` uint8 or uint16 rectified image stacks
        (left, right).
      cfg: matching configuration (library defaults; see :class:`Config`).
      corrmap: also return the NXCORR correlation map (float32, NaN where not
        computed). Requires ``cfg.nxcorr_threshold``.
      backend: 'auto' | 'xla' | 'triton' | 'triton_interpret' (see
        :func:`search.resolve_backend`).

    Returns:
      ``disparity`` — (H, W) int16 (INVALID = -32768), or float32 with NaN
      invalid when ``cfg.subpixel_step`` is set. If ``corrmap`` is True,
      returns ``(disparity, corrmap)``.
    """
    stack0 = jnp.asarray(stack0)
    stack1 = jnp.asarray(stack1)
    _validate_inputs(stack0, stack1)
    validate_stack(stack0.shape[0], cfg.mode)
    if corrmap and cfg.nxcorr_threshold is None:
        raise ValueError("corrmap requires cfg.nxcorr_threshold")
    backend = _search.resolve_backend(backend)
    if cfg.precision == Precision.DOUBLE:
        # f64 NXCORR (common.hpp:60) runs on the XLA agree path.
        with jax.enable_x64(True):
            disp, corr = _match_jit(stack0, stack1, cfg, corrmap, backend)
    else:
        disp, corr = _match_jit(stack0, stack1, cfg, corrmap, backend)
    from . import debug as _debug

    if _debug.enabled():
        # BICOS_DEBUG invariant checks (the reference's debug-build traps;
        # see debug.py). Fetches results to the host — debug/CI only.
        _debug.check_match_output(
            disp, corr, stack0.shape[2],
            subpixel=cfg.subpixel_step is not None,
        )
    if corrmap:
        return disp, corr
    return disp


def match_batched(
    stacks0,
    stacks1,
    cfg: Config = Config(),
    *,
    corrmap: bool = False,
    backend: str = "auto",
):
    """Batched matching over ``(batch, n, H, W)`` stacks.

    Capability the reference lacks (its only batching is the caller's loop,
    SURVEY.md section 2). Because every pipeline stage is row-independent
    (epipolar geometry), the batch is folded into the row axis — one
    program over ``batch * H`` rows instead of ``vmap``.
    """
    flat0, flat1, (b, h, w) = _fold_batch(stacks0, stacks1)
    return match_batched_folded(
        flat0, flat1, b, cfg, corrmap=corrmap, backend=backend)


def match_batched_folded(
    flat0,
    flat1,
    batch: int,
    cfg: Config = Config(),
    *,
    corrmap: bool = False,
    backend: str = "auto",
):
    """Batched matching on PRE-FOLDED ``(n, batch*H, W)`` stacks.

    The fold (batch into the row axis) is a real transpose when it runs on
    device: at batch=8 x 33 x 2200 x 3300 the transposed copies alone are
    ~3.8 GB of device memory. Callers that control staging (the serving
    daemon, the bench) can upload rows already folded — appending a pair's
    rows is plain concatenation — and skip that copy entirely; this entry
    trusts the layout and only reshapes the output back to per-pair maps.
    """
    flat0 = jnp.asarray(flat0)
    flat1 = jnp.asarray(flat1)
    if flat0.ndim != 3 or flat0.shape != flat1.shape:
        raise ValueError("folded stacks must share one (n, batch*H, W) shape")
    if batch < 1 or flat0.shape[1] % batch:
        raise ValueError(
            f"row count {flat0.shape[1]} is not a multiple of batch {batch}")
    h = flat0.shape[1] // batch
    w = flat0.shape[2]
    out = match(flat0, flat1, cfg, corrmap=corrmap, backend=backend)
    if corrmap:
        disp, corr = out
        return disp.reshape(batch, h, w), corr.reshape(batch, h, w)
    return out.reshape(batch, h, w)


def _fold_batch(stacks0, stacks1):
    """Fold ``(batch, n, H, W)`` stereo-pair batches into the row axis
    (rows are independent, so one ``(n, batch*H, W)`` launch covers the
    batch). Shapes must match exactly — a coincidental ``batch*H`` product
    match would silently pair rows of different images."""
    stacks0 = jnp.asarray(stacks0)
    stacks1 = jnp.asarray(stacks1)
    if stacks0.ndim != 4 or stacks1.ndim != 4:
        raise ValueError("batched stacks must have shape (batch, n, H, W)")
    if stacks0.shape != stacks1.shape:
        raise ValueError(
            f"batched stacks must have identical shapes, got "
            f"{stacks0.shape} vs {stacks1.shape}")
    b, n, h, w = stacks0.shape
    flat0 = jnp.moveaxis(stacks0, 0, 1).reshape(n, b * h, w)
    flat1 = jnp.moveaxis(stacks1, 0, 1).reshape(n, b * h, w)
    return flat0, flat1, (b, h, w)
