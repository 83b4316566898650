#!/usr/bin/env python
"""End-to-end benchmark of the BICOS engine on one GPU.

Prints ONE JSON line on stdout:
    {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...,
     "platform": ..., "device_kind": ..., "device_count": ..., "card": ...}

``card`` is ``nvidia-smi --query-gpu=name,power.limit`` of the card: a card
set below its full power limit runs slower under load, so every number
carries it. The run refuses any platform but a GPU: a CPU time is never
printed under a device metric.

Primary metric (mode ``headline``): end-to-end ``match`` latency for the
reference README's headline configuration (README.md:90 — two 33-image
stacks, LIMITED mode, ``--threshold 0.96 --variance 2.0 --step 0.1``) at the
reference *bench* suite's synthetic resolution 3300x2200 (bench/cuda.cu:44;
the real dataset is not vendored, data/.MISSING_LARGE_BLOBS). Baseline: ~44
ms on an RTX 4090. ``vs_baseline`` > 1 means faster than the reference.
Times are host-clock medians around work that ends in
``block_until_ready``; compilation is reported on stderr as set-up time.

Modes (``BICOS_BENCH_MODE``): ``headline``, ``search`` (transform + Hamming
scan, MP/s against the reference's 770 MP/s u32 smem kernel) and ``batched``
(stacks/s over ``BICOS_BENCH_BATCH`` pre-folded pairs). Sizes:
``BICOS_BENCH_N``, ``BICOS_BENCH_H``, ``BICOS_BENCH_W``,
``BICOS_BENCH_REPS``; engine: ``BICOS_BENCH_BACKEND``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

BASELINE_E2E_MS = 44.0  # README.md:90 (RTX 4090)
BASELINE_SEARCH_MP_S = 770.0  # u32 bicos_kernel_smem, BASELINE.md
BASELINE_STACKS_PER_S = 23.0  # ~1 / 44 ms, RTX 4090


def card_info() -> str:
    """``name, power.limit`` of the first card as nvidia-smi reports them,
    or "not available"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "not available"
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else "not available"


def result_record(metric, value, unit, vs_baseline, devices, card):
    """The one stdout line: the number plus the device it was taken on."""
    return {
        "metric": metric,
        "value": value,
        "unit": unit,
        "vs_baseline": vs_baseline,
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "card": card,
    }


def host_times(fn, reps):
    """Host-clock ms of ``reps`` calls of ``fn``, each ending in
    ``block_until_ready``, after one untimed call."""
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def main():
    n = int(os.environ.get("BICOS_BENCH_N", "33"))
    h = int(os.environ.get("BICOS_BENCH_H", "2200"))
    w = int(os.environ.get("BICOS_BENCH_W", "3300"))
    reps = int(os.environ.get("BICOS_BENCH_REPS", "5"))
    backend = os.environ.get("BICOS_BENCH_BACKEND", "auto")
    mode = os.environ.get("BICOS_BENCH_MODE", "headline")

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"bench: needs a GPU, found platform {devices[0].platform!r}",
              file=sys.stderr)
        return 2

    import jax.numpy as jnp

    import libbicos_jax as bicos
    from libbicos_jax.compile_cache import enable_compile_cache
    from libbicos_jax.io import synthetic_stack_pair
    from libbicos_jax.profiling import device_memory

    enable_compile_cache()
    card = card_info()
    print(f"device: {devices[0].device_kind} x{len(devices)} ({card})",
          file=sys.stderr)
    s0, s1, _ = synthetic_stack_pair(n, h, w, dtype=np.uint8)
    d0, d1 = jax.block_until_ready((jnp.asarray(s0), jnp.asarray(s1)))

    if mode == "search":
        from libbicos_jax import search as S

        bk = S.resolve_backend(backend)
        fn = jax.jit(lambda a, b: S.search_stack(
            a, b, bicos.TransformMode.LIMITED, bicos.NoDuplicates(),
            backend=bk))
        call = lambda: fn(d0, d1)  # noqa: E731
        metric, unit = f"bicos_search_n{n}_{w}x{h}_mps", "MP/s"
        scale = lambda ms: h * w / 1e6 / (ms / 1e3)  # noqa: E731
        baseline = BASELINE_SEARCH_MP_S
    elif mode == "batched":
        batch = int(os.environ.get("BICOS_BENCH_BATCH", "8"))
        cfg = bicos.Config(nxcorr_threshold=0.9, min_variance=2.0,
                           mode=bicos.TransformMode.LIMITED)
        # Pre-folded (n, batch*H, W) rows: the serving layout.
        b0 = jnp.asarray(np.concatenate([s0] * batch, axis=1))
        b1 = jnp.asarray(np.concatenate([s1] * batch, axis=1))
        call = lambda: bicos.match_batched_folded(  # noqa: E731
            b0, b1, batch, cfg, backend=backend)
        metric = f"batched{batch}_match_n{n}_{w}x{h}_stacks_per_s"
        unit = "stacks/s"
        scale = lambda ms: batch / (ms / 1e3)  # noqa: E731
        baseline = BASELINE_STACKS_PER_S
    else:
        cfg = bicos.Config(nxcorr_threshold=0.96, subpixel_step=0.1,
                           min_variance=2.0, mode=bicos.TransformMode.LIMITED)
        call = lambda: bicos.match(d0, d1, cfg, backend=backend)  # noqa
        metric, unit = f"e2e_match_n{n}_{w}x{h}_ms", "ms"
        scale = lambda ms: ms  # noqa: E731
        baseline = None

    t0 = time.perf_counter()
    jax.block_until_ready(call())
    print(f"set-up (compile + first call): "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    times = host_times(call, reps)
    med = float(np.median(times))
    print(f"host-clock ms: {times} ({card})", file=sys.stderr)
    mem = device_memory(devices[0])
    if mem:
        print(f"device memory: {mem} ({card})", file=sys.stderr)
    value = scale(med)
    vs = (BASELINE_E2E_MS / value if baseline is None else value / baseline)
    print(json.dumps(result_record(metric, value, unit, vs, devices, card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
