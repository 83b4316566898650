"""Tracing, metrics and observability.

The reference's only observability is wall-clock prints in the CLI
(``cli.cpp:43,177-216``) and Google-Benchmark microbenches. Equivalents
here:

* :func:`trace` — context manager around ``jax.profiler`` trace capture
  (view in TensorBoard / xprof).
* :func:`stage_timings` — per-stage wall times of the pipeline (transform /
  search / agree), each fenced with ``block_until_ready`` for honest numbers;
  used by the CLI's verbose mode and the bench harness.
* :func:`metrics` — JSON-able throughput/quality metrics (MP/s, stacks/s,
  valid-pixel fraction) the reference never reports.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, Optional

import numpy as np


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace of the enclosed block."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def stage_timings(stack0, stack1, cfg=None, *, backend: str = "auto") -> Dict:
    """Time each pipeline stage separately on the host clock, each ending in
    ``block_until_ready``; every stage runs once untimed first, so
    compilation is excluded.

    Returns {"transform_ms", "search_ms", "agree_ms", "total_ms"}.
    """
    import jax
    import jax.numpy as jnp

    from . import agree as _agree
    from . import descriptor as _descriptor
    from . import search as _search
    from .config import Config
    from .pipeline import match

    cfg = cfg or Config()
    s0 = jnp.asarray(stack0)
    s1 = jnp.asarray(stack1)
    backend = _search.resolve_backend(backend)

    def timed(fn, *args):
        out = jax.block_until_ready(fn(*args))
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        return (time.perf_counter() - t0) * 1e3, out

    transform = jax.jit(lambda a, b: (
        _descriptor.descriptor_words(a, cfg.mode),
        _descriptor.descriptor_words(b, cfg.mode)))
    t_transform, (w0, w1) = timed(transform, s0, s1)
    search = jax.jit(lambda a, b: _search.search_words(
        a, b, cfg.variant, backend=backend, drange=cfg.disparity_range))
    t_search, disp = timed(search, w0, w1)

    t_agree = 0.0
    if cfg.nxcorr_threshold is not None:
        minvar = (None if cfg.min_variance is None
                  else cfg.min_variance * s0.shape[0])
        agree = jax.jit(lambda d, a, b: _agree.validate(
            d, a, b, cfg.nxcorr_threshold, cfg.subpixel_step, minvar,
            cfg.precision, backend))
        t_agree, _ = timed(agree, disp, s0, s1)

    t_total, _ = timed(lambda a, b: match(a, b, cfg, backend=backend), s0, s1)
    return {
        "transform_ms": round(t_transform, 3),
        "search_ms": round(t_search, 3),
        "agree_ms": round(t_agree, 3),
        "total_ms": round(t_total, 3),
    }


def metrics(disparity, elapsed_ms: Optional[float] = None) -> Dict:
    """Quality/throughput metrics for a disparity result."""
    disp = np.asarray(disparity)
    h, w = disp.shape[-2:]
    if np.issubdtype(disp.dtype, np.floating):
        valid = np.isfinite(disp)
    else:
        valid = disp != np.int16(-32768)
    out = {
        "height": int(h),
        "width": int(w),
        "megapixels": round(h * w / 1e6, 3),
        "valid_fraction": round(float(valid.mean()), 4),
    }
    if elapsed_ms is not None:
        out["latency_ms"] = round(elapsed_ms, 3)
        out["mp_per_s"] = round(h * w / 1e6 / (elapsed_ms / 1e3), 2)
    return out


def device_memory(device=None) -> Dict:
    """On-device memory stats (bytes). The reference headline quotes
    ~1.6 GB VRAM (README.md:90); this is the device-memory equivalent.
    Returns {} on backends without allocator stats (e.g. CPU)."""
    import jax

    if device is None:
        device = jax.devices()[0]
    try:
        stats = device.memory_stats() or {}
    except (NotImplementedError, RuntimeError, AttributeError):
        return {}
    out = {}
    for key in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"):
        if key in stats:
            out[key] = int(stats[key])
    return out


def emit(d: Dict) -> str:
    """One-line JSON for log scraping."""
    s = json.dumps(d)
    print(s)
    return s
