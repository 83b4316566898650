#!/usr/bin/env python
"""Smoke test of the matcher on NVIDIA GPUs, through the user entry points.

    python chip_smoke.py          # one card: phases 1-8 below
    python chip_smoke.py --four   # four cards: H-band and W-band sharding

One card, at the headline configuration (n=33 LIMITED u8 stacks,
3300x2200, threshold 0.96, min variance 2.0, subpixel step 0.1; the
reference README's benchmark at its bench resolution):

1. the card: platform, ``nvidia-smi`` name and power limit, JAX version, and
   the engines ``backend="auto"`` chose;
2. ``match(..., corrmap=True)``: compile (set-up) time, three warm calls on
   the host clock, peak device memory and the compiled memory analysis;
3. the same inputs through ``backend="xla"`` on the card;
4. an 8-row full-width band on the CPU in this process, and 64 seeded
   pixels of that band against the per-pixel oracle (``_oracle``);
5. steps 2-4 for Consistency + no_dupes (integer), a 0:511 disparity range
   (step 0.1), u16 n=12 FULL (integer) and Precision.DOUBLE;
6. the ``serve`` daemon on a thread, driven by ``client.BicosClient``: two
   single pairs and one batch of two (``match_batched_folded``);
7. the gpu-marked tests (``tests/test_gpu.py``) in this process;
8. the last line: ``{"ok": true, "device": {...}}``.

Comparisons: integer disparities must be bit-exact everywhere. The kernel
path must equal the oracle exactly at every checked pixel. Where an XLA
path takes part, subpixel disparity and corrmap may differ within
``TOLERANCE`` (see PERF.md for why); the count of differing pixels and the
largest difference in ulps are printed either way. Any failure raises, and
the script exits non-zero without a result line. It refuses to run without
a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np

SEED = 7
HEADLINE = (33, 2200, 3300)
BAND_ROWS = (1096, 1104)  # the 8-row CPU band
ORACLE_PIXELS = 64
# Where an XLA path is compared. XLA sums over t in its own order (on the
# GPU, a tree), so its NXCORR differs from the reference-ordered kernel by
# a few ulps at many pixels; the discrete steps after it (argmax over x,
# the min-variance and threshold tests, roundeven of the parabola) can turn
# such a difference into another disparity or corrmap value at a few
# pixels. So: corrmap values within CORR_ABS everywhere but a
# ``pixel_share`` of pixels, and disparity (validity or value) equal
# everywhere but a ``pixel_share`` of pixels.
TOLERANCE = {"pixel_share": 0.01, "corr_abs": 2e-6}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return "; ".join(ln.strip() for ln in out.strip().splitlines())


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _ordered(x):
    """f32 -> int64 keys whose difference counts ulps."""
    i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def _as_f32_pair(a, b):
    return np.asarray(a, np.float32), np.asarray(b, np.float32)


def compare(name, got, want, *, exact: bool) -> None:
    """Compare ``(disparity, corrmap)`` pairs; print and enforce the rule."""
    gd, wd = np.asarray(got[0]), np.asarray(want[0])
    check(gd.shape == wd.shape and gd.dtype == wd.dtype,
          f"{name}: shape/dtype {gd.shape} {gd.dtype} vs {wd.shape} {wd.dtype}")
    npx = gd.size
    if gd.dtype == np.int16:
        gv, wv = gd != -32768, wd != -32768
        both = gv & wv
        val_diff = int((gd[both] != wd[both]).sum())
        flips = int((gv != wv).sum())
        check(val_diff == 0, f"{name}: {val_diff} integer disparities differ")
        d_ulps = 0
    else:
        gv, wv = ~np.isnan(gd), ~np.isnan(wd)
        both = gv & wv
        flips = int((gv != wv).sum())
        dd = np.abs(_ordered(gd[both]) - _ordered(wd[both]))
        val_diff = int((dd > 0).sum())
        d_ulps = int(dd.max()) if dd.size else 0
    msg = (f"{name}: disparity {flips + val_diff}/{npx} px differ "
           f"({flips} validity, {val_diff} value, max {d_ulps} ulp)")
    if got[1] is not None:
        gc, wc = _as_f32_pair(got[1], want[1])
        cboth = ~np.isnan(gc) & ~np.isnan(wc)
        cflips = int((np.isnan(gc) != np.isnan(wc)).sum())
        cd = np.abs(_ordered(gc[cboth]) - _ordered(wc[cboth]))
        c_diff = int((cd > 0).sum())
        c_ulps = int(cd.max()) if cd.size else 0
        cabs = np.abs(gc[cboth] - wc[cboth])
        c_far = int((cabs > TOLERANCE["corr_abs"]).sum())
        msg += (f"; corrmap {c_diff + cflips}/{npx} px differ "
                f"(max {c_ulps} ulp = {cabs.max() if cabs.size else 0:.3g}, "
                f"{c_far} beyond {TOLERANCE['corr_abs']:g}, "
                f"{cflips} NaN pattern)")
    else:
        c_diff = cflips = c_far = 0
    log(msg)
    if exact:
        check(flips + val_diff + c_diff + cflips == 0,
              f"{name}: not bit-exact")
        return
    share = TOLERANCE["pixel_share"] * npx
    check(flips + val_diff <= share, f"{name}: disparity beyond tolerance")
    check(c_far + cflips <= share, f"{name}: corrmap beyond tolerance")


def oracle_pixels(s0, s1, cfg, pixels):
    """Per-pixel reference results (disparity, corrmap) from ``_oracle``,
    with the disparity-range restriction applied to both searches."""
    from libbicos_jax import _oracle
    from libbicos_jax.config import Consistency

    n = s0.shape[0]
    w = s0.shape[2]
    variant = cfg.variant
    cons = isinstance(variant, Consistency)
    nodupes = variant.no_dupes if cons else True
    dr = cfg.disparity_range
    rows = {}

    def bits(r):
        if r not in rows:
            rows[r] = (_oracle.descriptor_bits(s0[:, r:r + 1], cfg.mode)[0],
                       _oracle.descriptor_bits(s1[:, r:r + 1], cfg.mode)[0])
        return rows[r]

    def scan(query, row, lo, hi):
        if lo > hi:
            return -1
        best = _oracle.bicos_search(query, row[lo:hi + 1], nodupes)
        return best if best < 0 else best + lo

    out = []
    for r, c in pixels:
        b0, b1 = bits(r)
        lo, hi = (0, w - 1) if dr is None else (
            max(0, c - dr[1]), min(w - 1, c - dr[0]))
        best = scan(b0[c], b1, lo, hi)
        d = -32768
        if best >= 0 and cons:
            rlo, rhi = (0, w - 1) if dr is None else (
                max(0, best + dr[0]), min(w - 1, best + dr[1]))
            rev = scan(b1[best], b0, rlo, rhi)
            if rev >= 0 and abs(c - rev) <= variant.max_lr_diff:
                d = (c + rev) // 2 - best
        elif best >= 0:
            d = c - best
        row_disp = np.full((1, w), -32768, np.int16)
        row_disp[0, c] = d
        if cfg.nxcorr_threshold is None:
            out.append((row_disp[0, c], np.nan))
            continue
        minvar = None if cfg.min_variance is None else cfg.min_variance * n
        sl = (slice(None), slice(r, r + 1))
        if cfg.subpixel_step is None:
            od, oc = _oracle.agree(row_disp, s0[sl], s1[sl],
                                   cfg.nxcorr_threshold, minvar)
        else:
            od, oc = _oracle.agree_subpixel(
                row_disp, s0[sl], s1[sl], cfg.nxcorr_threshold,
                cfg.subpixel_step, minvar, s0.dtype.type)
        out.append((od[0, c], oc[0, c]))
    return out


def run_config(name, cfg, s0, s1, *, backend="auto", timed=False):
    """Steps 2-4 for one configuration; returns the card's result."""
    import jax

    import libbicos_jax as bicos
    from libbicos_jax import pipeline, search
    from libbicos_jax.config import Precision

    card = card_line()
    dev = jax.devices()[0]
    d0, d1 = jax.device_put(s0, dev), jax.device_put(s1, dev)
    route = search.resolve_backend(backend)
    log(f"[{name}] backend={route}")
    t0 = time.perf_counter()
    if timed and cfg.precision == Precision.SINGLE:
        compiled = pipeline._match_jit.lower(d0, d1, cfg, True, route) \
            .compile()
        log(f"[{name}] compile (set-up): "
            f"{time.perf_counter() - t0:.3f} s ({card})")
        ma = compiled.memory_analysis()
        if ma is not None:
            log(f"[{name}] memory_analysis: argument "
                f"{ma.argument_size_in_bytes} B, output "
                f"{ma.output_size_in_bytes} B, temp "
                f"{ma.temp_size_in_bytes} B, generated code "
                f"{ma.generated_code_size_in_bytes} B ({card})")
    out = jax.block_until_ready(bicos.match(d0, d1, cfg, corrmap=True,
                                            backend=backend))
    log(f"[{name}] first call (incl. any compile): "
        f"{time.perf_counter() - t0:.3f} s ({card})")
    if timed:
        times = []
        for _ in range(3):
            t1 = time.perf_counter()
            jax.block_until_ready(bicos.match(d0, d1, cfg, corrmap=True,
                                              backend=backend))
            times.append((time.perf_counter() - t1) * 1e3)
        log(f"[{name}] warm calls (host clock, ms): {times} ({card})")
        stats = dev.memory_stats() or {}
        log(f"[{name}] peak_bytes_in_use: "
            f"{stats.get('peak_bytes_in_use')} ({card})")
    return tuple(None if x is None else np.asarray(x) for x in out)


def cpu_band(name, cfg, s0, s1):
    import jax

    import libbicos_jax as bicos

    cpu = jax.devices("cpu")[0]
    r0, r1 = BAND_ROWS
    b0 = jax.device_put(np.ascontiguousarray(s0[:, r0:r1]), cpu)
    b1 = jax.device_put(np.ascontiguousarray(s1[:, r0:r1]), cpu)
    t0 = time.perf_counter()
    with jax.default_device(cpu):
        out = bicos.match(b0, b1, cfg, corrmap=True, backend="xla")
        out = tuple(np.asarray(x) for x in out)
    log(f"[{name}] CPU band rows {r0}:{r1}: "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def check_config(name, cfg, s0, s1, *, timed=False, oracle=True):
    from libbicos_jax.config import Precision

    kern = run_config(name, cfg, s0, s1, timed=timed)
    xla = run_config(f"{name}/xla", cfg, s0, s1, backend="xla",
                     timed=timed)
    kernel_exact = cfg.precision == Precision.SINGLE
    compare(f"[{name}] card kernels vs card XLA", kern, xla, exact=False)
    r0, r1 = BAND_ROWS
    band = cpu_band(name, cfg, s0, s1)
    compare(f"[{name}] card vs CPU band", tuple(x[r0:r1] for x in kern),
            band, exact=False)
    if oracle:
        rng = np.random.default_rng(SEED)
        px = list(zip(rng.integers(r0, r1, ORACLE_PIXELS),
                      rng.integers(0, s0.shape[2], ORACLE_PIXELS)))
        want = oracle_pixels(s0, s1, cfg, px)
        got = tuple(np.array([x[r, c] for r, c in px]) for x in kern)
        ref = (np.array([v[0] for v in want], kern[0].dtype),
               np.array([v[1] for v in want], np.float32))
        compare(f"[{name}] card vs oracle ({ORACLE_PIXELS} px)", got, ref,
                exact=kernel_exact)
    return kern


def served_path(cfg, s0, s1, want):
    from libbicos_jax.client import BicosClient
    from libbicos_jax.serve import Engine, serve

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ready = threading.Event()
    engine = Engine(cfg)
    threading.Thread(
        target=serve, args=(engine, "127.0.0.1", port),
        kwargs={"ready_event": ready}, daemon=True).start()
    check(ready.wait(120), "serve daemon did not start")
    client = BicosClient(f"http://127.0.0.1:{port}", timeout=1800)
    for i in range(2):
        t0 = time.perf_counter()
        got = client.match(s0, s1, corrmap=True)
        log(f"[served] pair {i}: {(time.perf_counter() - t0) * 1e3:.1f} ms "
            "client-side")
        compare(f"[served] pair {i} vs match", got, want, exact=True)
    t0 = time.perf_counter()
    bd, bc = client.match(np.stack([s0, s0]), np.stack([s1, s1]),
                          corrmap=True)
    log(f"[served] batch of 2: {(time.perf_counter() - t0) * 1e3:.1f} ms "
        "client-side")
    for i in range(2):
        compare(f"[served] batch[{i}] vs match", (bd[i], bc[i]), want,
                exact=True)


def headline_data(dtype=np.uint8, n=HEADLINE[0]):
    from libbicos_jax.io import synthetic_stack_pair

    _, h, w = HEADLINE
    s0, s1, _ = synthetic_stack_pair(n, h, w, dtype=dtype, seed=SEED)
    return s0, s1


def one_card():
    import jax

    import libbicos_jax as bicos
    from libbicos_jax.config import Consistency, Precision, TransformMode

    log(f"route: search="
        f"{'kernels/scan.py (Pallas, Triton route)' if AUTO == 'triton' else 'XLA'}"
        f", agree="
        f"{'kernels/nxcorr.py (Pallas, Triton route)' if AUTO == 'triton' else 'XLA'}"
        f" (Precision.DOUBLE: XLA)")
    headline = bicos.Config(nxcorr_threshold=0.96, subpixel_step=0.1,
                            min_variance=2.0, mode=TransformMode.LIMITED)
    s0, s1 = headline_data()
    want = check_config("headline", headline, s0, s1, timed=True)
    check(np.isfinite(want[0]).mean() > 0.5, "headline: too few valid px")

    variants = [
        ("consistency", bicos.Config(
            nxcorr_threshold=0.96, min_variance=2.0,
            mode=TransformMode.LIMITED,
            variant=Consistency(max_lr_diff=1, no_dupes=True)), None),
        ("range0:511", bicos.Config(
            nxcorr_threshold=0.96, subpixel_step=0.1, min_variance=2.0,
            mode=TransformMode.LIMITED, disparity_range=(0, 511)), None),
        ("u16-n12-full", bicos.Config(
            nxcorr_threshold=0.9, mode=TransformMode.FULL), (np.uint16, 12)),
        ("double", bicos.Config(
            nxcorr_threshold=0.96, subpixel_step=0.1, min_variance=2.0,
            mode=TransformMode.LIMITED, precision=Precision.DOUBLE), None),
    ]
    for name, cfg, data in variants:
        v0, v1 = (s0, s1) if data is None else headline_data(*data)
        check_config(name, cfg, v0, v1, oracle=cfg.precision ==
                     Precision.SINGLE)
        jax.clear_caches()

    served_path(headline, s0, s1, want)

    import pytest

    os.environ["BICOS_TEST_PLATFORM"] = "gpu"
    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                      os.path.join(here, "tests", "test_gpu.py")])
    check(rc == 0, f"gpu-marked tests failed (pytest rc {rc})")


def four_cards():
    import jax

    import libbicos_jax as bicos
    from libbicos_jax.config import TransformMode
    from libbicos_jax.sharding import make_mesh, match_sharded, \
        match_sharded_w

    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 GPUs, found {len(devs)}")
    cfg = bicos.Config(nxcorr_threshold=0.96, subpixel_step=0.1,
                       min_variance=2.0, mode=TransformMode.LIMITED)
    s0, s1 = headline_data()
    card = card_line()
    t0 = time.perf_counter()
    ref = tuple(np.asarray(x) for x in bicos.match(
        jax.device_put(s0, devs[0]), jax.device_put(s1, devs[0]), cfg,
        corrmap=True))
    log(f"[four] single-card match on {devs[0]}: "
        f"{time.perf_counter() - t0:.1f} s incl. compile ({card})")
    mesh = make_mesh(4)
    for name, fn in (("H-band match_sharded", match_sharded),
                     ("W-band match_sharded_w", match_sharded_w)):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(s0, s1, cfg, mesh=mesh, corrmap=True))
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(fn(s0, s1, cfg, mesh=mesh, corrmap=True))
        warm = (time.perf_counter() - t0) * 1e3
        used = {s.device for s in out[0].addressable_shards}
        log(f"[four] {name}: first call {first:.1f} s, warm call "
            f"{warm:.1f} ms incl. host transfer; output shards on "
            f"{sorted(str(d) for d in used)} ({card})")
        check(len(used) == 4, f"{name}: output not spread over 4 devices")
        compare(f"[four] {name} vs single-card match",
                tuple(np.asarray(x) for x in out), ref, exact=True)


AUTO = None


def main(argv=None) -> int:
    global AUTO
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card H-band and W-band paths "
                    "against single-card match")
    args = ap.parse_args(argv)

    if os.environ.get("JAX_PLATFORMS") and \
            "cpu" not in os.environ["JAX_PLATFORMS"]:
        # The CPU band (phase 4) needs the CPU backend beside the card.
        os.environ["JAX_PLATFORMS"] += ",cpu"
    # The CPU band runs strict f32 like the test suite (tests/conftest.py):
    # XLA's CPU backend may otherwise keep fused f32 values in wider
    # registers. f32 programs on the card are not affected.
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_allow_excess_precision" not in flags:
        os.environ["XLA_FLAGS"] = \
            (flags + " --xla_allow_excess_precision=false").strip()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    from libbicos_jax import search
    from libbicos_jax.compile_cache import enable_compile_cache

    log(f"card: {card_line()}")
    log(f"device_kind: {dev.device_kind}, devices: {len(jax.devices())}, "
        f"jax {jax.__version__}")
    log(f"compile cache: {enable_compile_cache()}")
    AUTO = search.resolve_backend("auto")
    (four_cards if args.four else one_card)()
    devices = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
