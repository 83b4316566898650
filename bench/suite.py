#!/usr/bin/env python
"""Per-stage + integration benchmark suite.

Mirrors the reference's Google-Benchmark suite (``/root/reference/bench/
cuda.cu``): descriptor-transform, Hamming-scan and agree microbenches at the
synthetic 3300x2200 resolution (bench/cuda.cu:44), plus ``bench_integration``
over n in {6, 8, 12, 16} x subpixel step in {0, .25, .20, .15, .10}
(bench/cuda.cu:297-323,397-401) on synthetic projected-pattern stacks (the
real dataset is not vendored upstream). Seed 0x600DF00D preserved
(bench/cuda.cu:39).

Measurement protocol: min over reps of the host clock around a call that
ends in ``block_until_ready``, after an untimed compile call. Every row
names its device. It refuses any platform but a GPU unless ``--quick``
(tiny shapes on the CPU: a smoke run, not a measurement).

Output: one JSON object per line on stdout. Run everything:
    python bench/suite.py [--quick]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, ".")  # repo root


def timeit(fn, args, reps):
    """min-of-reps host-clock ms, each call ending in block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))  # compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return min(ts)


ONLY = None  # --only substring filter


def want(name: str) -> bool:
    return ONLY is None or ONLY in name


DEVICE = {}


def emit(name, ms, extra=None):
    rec = {"bench": name, "ms": ms, **DEVICE}
    if extra:
        rec.update(extra)
    print(json.dumps(rec), flush=True)


def bench(name, fn, args, reps, mp):
    """Gate on --only, then time and emit one row."""
    if not want(name):
        return
    ms = timeit(fn, args, reps)
    emit(name, ms, {"mp_per_s": mp / (ms / 1e3)})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="small shapes on the CPU (CI smoke, no timing "
                    "claims)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--only", default=None,
                    help="Run only benches whose name contains this "
                    "substring (resume/focus filter).")
    args = ap.parse_args()
    global ONLY
    ONLY = args.only

    import jax

    if args.quick:
        jax.config.update("jax_platforms", "cpu")
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.quick:
        sys.exit(f"suite: needs a GPU, found platform {dev.platform!r} "
                 "(--quick runs tiny shapes on the CPU)")
    import jax.numpy as jnp

    import libbicos_jax as bicos
    from libbicos_jax import agree as A
    from libbicos_jax import descriptor as D
    from libbicos_jax import search as S
    from libbicos_jax.compile_cache import enable_compile_cache
    from libbicos_jax.config import Precision, TransformMode
    from libbicos_jax.io import synthetic_stack_pair

    enable_compile_cache()
    DEVICE.update(platform=dev.platform, device_kind=dev.device_kind,
                  device_count=len(jax.devices()))
    if dev.platform == "gpu":
        DEVICE["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]

    h = args.height or (128 if args.quick else 2200)
    w = args.width or (256 if args.quick else 3300)
    reps = args.reps
    backend = S.resolve_backend("auto")
    print(f"# device={jax.devices()[0]} backend={backend} {w}x{h}",
          file=sys.stderr)

    mp = h * w / 1e6

    # --- descriptor transform (bench/cuda.cu:258-295 analogue) ----------
    for n, mode in [(10, TransformMode.LIMITED), (33, TransformMode.LIMITED),
                    (10, TransformMode.FULL)]:
        s0, _, _ = synthetic_stack_pair(n, h, w)
        tf = jax.jit(lambda s, m=mode: D.descriptor_words(s, m))
        bench(f"transform_{mode.name.lower()}_n{n}", tf, (jnp.asarray(s0),),
              reps, mp)

    # --- Hamming scan (bench/cuda.cu:192-256 analogue) -------------------
    # Transform + search from raw stacks, comparable to the reference's
    # transform + bicos kernel pair.
    from libbicos_jax.config import actual_bits

    for n, mode in [(10, TransformMode.LIMITED), (33, TransformMode.LIMITED),
                    (16, TransformMode.FULL)]:
        s0, s1, _ = synthetic_stack_pair(n, h, w)
        pair = (jnp.asarray(s0), jnp.asarray(s1))
        nbits = actual_bits(n, mode)
        nd = jax.jit(lambda a, b, m=mode: S.search_stack(
            a, b, m, bicos.NoDuplicates(), backend=backend))
        bench(f"search_nodupes_{mode.name.lower()}_n{n}_b{nbits}", nd,
              pair, reps, mp)
        cons = jax.jit(lambda a, b, m=mode: S.search_stack(
            a, b, m, bicos.Consistency(max_lr_diff=1, no_dupes=False),
            backend=backend))
        bench(f"search_consistency_{mode.name.lower()}_n{n}_b{nbits}",
              cons, pair, reps, mp)

    # --- agree (bench/cuda.cu:99-180 analogue; TInput in {u8, u16}) ------
    n = 10

    def agree_fn(step):
        return jax.jit(lambda d, a, b: A.validate(
            d, a, b, 0.9, step, 2.0 * n, Precision.SINGLE, backend))

    for dtype, tag in ((np.uint8, ""), (np.uint16, "_u16")):
        s0, s1, _ = synthetic_stack_pair(n, h, w, dtype=dtype)
        d0, d1 = jnp.asarray(s0), jnp.asarray(s1)
        disp = jax.block_until_ready(jax.jit(lambda a, b: S.search_stack(
            a, b, TransformMode.LIMITED, bicos.NoDuplicates(),
            backend=backend))(d0, d1))
        bench(f"agree_integer{tag}_n{n}", agree_fn(None), (disp, d0, d1),
              reps, mp)
        bench(f"agree_subpixel{tag}_n{n}_step0.25", agree_fn(0.25),
              (disp, d0, d1), reps, mp)

    # --- nxcorr subroutine (bench/cuda.cu:46-77 analogue) -----------------
    # The reference times a single nxcorr evaluation over an n=50 series in
    # f32/f64 x {PLAIN, MINVAR}; here the equivalent is the vectorized XLA
    # nxcorr over a full image of series (per-element cost is what matters).
    from libbicos_jax.agree import _compute_dtype, _nxcorr_from, _stats

    def nxcorr_image(a, b, minvar, precision):
        dt = _compute_dtype(precision)
        af = a.astype(dt)
        _, diff0, var0 = _stats(af, dt)
        return _nxcorr_from(diff0, var0, b.astype(dt), minvar, dt)

    nn = 50
    sa = jnp.asarray(
        np.random.default_rng(0x600DF00D).integers(
            0, 256, size=(nn, h, w), dtype=np.uint8))
    sb = jnp.asarray(
        np.random.default_rng(0xBADC0DE).integers(
            0, 256, size=(nn, h, w), dtype=np.uint8))
    import contextlib

    for prec, tag in ((Precision.SINGLE, "f32"), (Precision.DOUBLE, "f64")):
        for minvar, vtag in ((None, "plain"), (2.0 * nn, "minvar")):
            ctx = (jax.enable_x64(True) if prec == Precision.DOUBLE
                   else contextlib.nullcontext())
            with ctx:
                fnx = jax.jit(lambda a, b, mv=minvar, p=prec: nxcorr_image(
                    a, b, mv, p))
                bench(f"nxcorr_{tag}_{vtag}_n{nn}", fnx, (sa, sb), reps, mp)

    # --- integration (bench/cuda.cu:297-323 analogue) --------------------
    steps = [0] if args.quick else [0, 0.25, 0.10]
    for n in ([6] if args.quick else [6, 8, 12, 16]):
        s0, s1, _ = synthetic_stack_pair(n, h, w)
        pair = (jnp.asarray(s0), jnp.asarray(s1))
        for step in steps:
            cfg = bicos.Config(
                nxcorr_threshold=0.9,
                subpixel_step=step or None,
                mode=TransformMode.FULL,
            )
            fn = lambda a, b, c=cfg: bicos.match(a, b, c, backend=backend)
            bench(f"integration_n{n}_step{step}", fn, pair, reps, mp)

    # --- u16 integration (reference microbenches cover u16,
    # bench/cuda.cu:99-180): headline LIMITED n=33 and a FULL n=12 row.
    for n, mode, step in ([(6, TransformMode.FULL, 0)] if args.quick else
                          [(33, TransformMode.LIMITED, 0.1),
                           (33, TransformMode.LIMITED, 0),
                           (12, TransformMode.FULL, 0)]):
        name = (f"integration_u16_n{n}_"
                f"{'limited' if mode == TransformMode.LIMITED else 'full'}"
                f"_step{step}")
        if not want(name):
            continue
        s0, s1, _ = synthetic_stack_pair(n, h, w, dtype=np.uint16)
        cfg = bicos.Config(
            nxcorr_threshold=0.96 if n == 33 else 0.9,
            subpixel_step=step or None,
            min_variance=2.0 if n == 33 else None,
            mode=mode,
        )
        fn = lambda a, b, c=cfg: bicos.match(a, b, c, backend=backend)
        bench(name, fn, (jnp.asarray(s0), jnp.asarray(s1)), reps, mp)

if __name__ == "__main__":
    main()
