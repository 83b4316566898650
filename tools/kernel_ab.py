#!/usr/bin/env python
"""A/B of the GPU kernels against the plain XLA program, end to end.

Times ``descriptor_words -> search_words -> agree`` at the headline
configuration (n=33 LIMITED u8, 3300x2200, threshold 0.96, min variance
2.0, step 0.1) with each of the four engine pairs

    search: XLA scan | kernels/scan.py,  agree: XLA sweep | kernels/nxcorr.py

in interleaved rounds (each round runs the pairs in one order and then in
the reverse order), on the host clock around ``block_until_ready``; then
the per-stage times of ``profiling.stage_timings`` for both backends.
Needs a GPU. One JSON object per line on stdout, also written to
``chiprun_out/kernel_ab.jsonl``.

    python tools/kernel_ab.py [--rounds 5]
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit("kernel_ab: needs a GPU")
    import libbicos_jax as bicos
    from libbicos_jax import agree, descriptor, profiling, search
    from libbicos_jax.compile_cache import enable_compile_cache
    from libbicos_jax.io import synthetic_stack_pair

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cfg = bicos.Config(nxcorr_threshold=0.96, subpixel_step=0.1,
                       min_variance=2.0, mode=bicos.TransformMode.LIMITED)
    minvar = cfg.min_variance * 33
    s0, s1, _ = synthetic_stack_pair(33, 2200, 3300, seed=7)
    d0, d1 = jax.block_until_ready((jax.device_put(s0), jax.device_put(s1)))
    os.makedirs("chiprun_out", exist_ok=True)
    sink = open(os.path.join("chiprun_out", "kernel_ab.jsonl"), "w")

    def emit(rec):
        rec["card"] = card
        line = json.dumps(rec)
        print(line, flush=True)
        sink.write(line + "\n")

    def build(search_engine, agree_engine):
        def run(a, b):
            words0 = descriptor.descriptor_words(a, cfg.mode)
            words1 = descriptor.descriptor_words(b, cfg.mode)
            disp = search.search_words(words0, words1, cfg.variant,
                                       backend=search_engine)
            return agree.validate(disp, a, b, cfg.nxcorr_threshold,
                                  cfg.subpixel_step, minvar, cfg.precision,
                                  agree_engine)
        return jax.jit(run)

    pairs = [(s, a) for s in ("xla", "triton") for a in ("xla", "triton")]
    fns, outs = {}, {}
    for p in pairs:
        fns[p] = build(*p)
        t0 = time.perf_counter()
        outs[p] = jax.block_until_ready(fns[p](d0, d1))
        emit({"pair": p, "setup_s": time.perf_counter() - t0})
    ref = [np.asarray(x) for x in outs[("triton", "triton")]]
    for p in pairs:
        same = [np.array_equal(np.asarray(x), r, equal_nan=True)
                for x, r in zip(outs[p], ref)]
        emit({"pair": p, "equal_to_kernels": same})

    times = {p: [] for p in pairs}
    for r in range(args.rounds):
        order = pairs if r % 2 == 0 else pairs[::-1]
        for p in order:
            t0 = time.perf_counter()
            jax.block_until_ready(fns[p](d0, d1))
            times[p].append((time.perf_counter() - t0) * 1e3)
    for p in pairs:
        emit({"pair": p, "e2e_ms": times[p],
              "median_ms": float(np.median(times[p]))})
    for backend in ("xla", "triton"):
        emit({"stages": backend,
              **profiling.stage_timings(d0, d1, cfg, backend=backend)})
    emit({"peak_bytes_in_use":
          jax.devices()[0].memory_stats().get("peak_bytes_in_use")})


if __name__ == "__main__":
    main()
