"""Persistent matching service: keep compiled pipelines warm, serve requests.

Why this exists: a BICOS pipeline program takes tens of seconds to compile
per (shape, dtype, config) specialization, which makes process-per-match
deployment (how the reference CLI is used, ``cli.cpp:55-253``) costly for
production. The reference has no serving story at all — its C-ABI binding
(``pybicos_c.cpp``) still pays full startup per process. Here one
long-lived engine process owns the device, precompiles the configured
specializations once, and serves ``match`` requests over HTTP with zero
per-request compilation.

Design:

* **Engine** — thread-safe wrapper around :func:`libbicos_jax.match` /
  :func:`sharding.match_sharded` with a jit-specialization registry keyed by
  ``(shape, dtype, config, corrmap)``. A lock serializes device work (one
  pipeline program fills the device); compilation of NEW shapes happens
  inside the lock so concurrent first requests don't double-compile.
* **Wire format** — ``.npz`` (one POST body) in, ``.npz`` out. No external
  dependencies; works from any language with an npz writer.
* **Warmup** — shapes listed at startup are compiled before the server
  accepts traffic, so the first real request is fast.

Usage::

    python -m libbicos_jax.serve --port 8344 \
        --warmup 33x2200x3300:u8 --threshold 0.96 --step 0.1 --variance 2.0

    # client
    import io, urllib.request, numpy as np
    buf = io.BytesIO()
    np.savez(buf, stack0=s0, stack1=s1)
    req = urllib.request.Request("http://localhost:8344/match",
                                 data=buf.getvalue(),
                                 headers={"Content-Type": "application/npz"})
    with urllib.request.urlopen(req) as resp:
        out = np.load(io.BytesIO(resp.read()))
    disp = out["disparity"]

Endpoints:

* ``POST /match`` — body: npz with ``stack0``, ``stack1`` ``(n, H, W)``
  arrays — or ``(batch, n, H, W)`` for the batched throughput layout
  (``match_batched_folded`` / ``match_batched_sharded``: batch folded on
  the host at staging time into the
  row axis, one launch per request); optional query params override the
  engine's default config (``threshold``, ``step``, ``variance``,
  ``limited``, ``lr_maxdiff``, ``no_dupes``, ``corrmap``,
  ``disp_range=MIN:MAX`` — the bounded-range extension). Response: npz
  with ``disparity`` (and ``corrmap`` if requested), batch-shaped when the
  input was batched.
* ``GET /healthz`` — liveness + compiled-specialization count, JSON.
* ``POST /warmup?shape=NxHxW&dtype=u8`` — precompile a specialization;
  accepts the same config-override params as ``/match`` (including
  ``corrmap``, which is its own jit specialization).
"""

from __future__ import annotations

import argparse
import io
import json
import threading
from dataclasses import replace
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from .config import Config, Consistency, NoDuplicates, TransformMode
from .search import BACKENDS


def _cfg_key(cfg: Config) -> tuple:
    v = cfg.variant
    vkey = (
        ("consistency", v.max_lr_diff, v.no_dupes)
        if isinstance(v, Consistency)
        else ("nodupes",)
    )
    return (
        cfg.nxcorr_threshold,
        cfg.subpixel_step,
        cfg.min_variance,
        cfg.mode,
        cfg.precision,
        vkey,
        cfg.disparity_range,
    )


class Engine:
    """Thread-safe warm-pipeline registry over one device (or mesh)."""

    def __init__(self, cfg: Config = Config(), *, backend: str = "auto",
                 mesh=None, max_specializations: int = 64):
        self.cfg = cfg
        self.backend = backend
        self.mesh = mesh
        # Every distinct (shape, dtype, config, corrmap) is a separate
        # compile; config OVERRIDE params (threshold,
        # disp_range, ...) have effectively unbounded value spaces, so an
        # unconstrained client could force endless compiles while holding
        # the device lock. New specializations beyond this cap are
        # rejected (HTTP 400) instead.
        self.max_specializations = max_specializations
        self._lock = threading.Lock()
        self._compiled: Dict[tuple, bool] = {}

    @staticmethod
    def _fold(s: np.ndarray):
        # Fold on the HOST at staging time: the device-side transpose of
        # (batch, n, H, W) is GBs of HBM at production batch sizes
        # (pipeline.match_batched_folded). At batch=8 the two folds are
        # GB-scale strided copies — comparable to the device run itself —
        # so staging runs OUTSIDE the device lock (see ``match``).
        b, n, h, w = s.shape
        return np.ascontiguousarray(
            np.moveaxis(np.asarray(s), 0, 1)).reshape(n, b * h, w)

    def _run(self, s0, s1, cfg: Config, corrmap: bool, batch: int):
        from . import match, match_batched_folded
        from .sharding import match_batched_sharded, match_sharded

        if self.mesh is not None:
            fn = match_batched_sharded if batch else match_sharded
            return fn(
                s0, s1, cfg, mesh=self.mesh, corrmap=corrmap,
                backend=self.backend,
            )
        if batch:
            return match_batched_folded(
                s0, s1, batch, cfg, corrmap=corrmap, backend=self.backend)
        return match(s0, s1, cfg, corrmap=corrmap, backend=self.backend)

    def match(self, s0: np.ndarray, s1: np.ndarray,
              cfg: Optional[Config] = None, *, corrmap: bool = False):
        """Run a match; first call per specialization compiles (serialized
        under the engine lock), later calls reuse jit caches.

        Batched (4-d) requests are folded into the row axis on the host
        BEFORE taking the device lock, so while one request runs on the
        device, concurrent request threads overlap their own staging with
        it instead of queueing the whole fold+run behind the lock."""
        import jax

        cfg = self.cfg if cfg is None else cfg
        key = (s0.shape, str(s0.dtype), _cfg_key(cfg), corrmap)
        if s0.ndim == 4 or s1.ndim == 4:
            # Validate the 4-d pair BEFORE folding — and detect batching
            # from EITHER operand: a 3-d stack0 with a 4-d stack1 must be
            # rejected here, not left to downstream shape checks. After the
            # fold a coincidental batch*H product match (e.g. (2,n,8,W) vs
            # (4,n,4,W)) would pass match_batched_folded's flat checks and
            # silently pair rows of different images (_fold_batch's
            # contract, pipeline.py).
            if s0.ndim != 4 or s1.ndim != 4 or s0.shape != s1.shape:
                raise ValueError(
                    f"batched stacks must have identical (batch, n, H, W) "
                    f"shapes, got {s0.shape} vs {s1.shape}")
            batch = s0.shape[0]
        else:
            batch = 0
        if batch and self.mesh is None:
            s0, s1 = self._fold(s0), self._fold(s1)
        with self._lock:
            # Cap check under the lock: concurrent first-time requests must
            # not race past the limit and each trigger a
            # compile beyond it.
            if (key not in self._compiled
                    and len(self._compiled) >= self.max_specializations):
                raise ValueError(
                    f"specialization limit reached "
                    f"({self.max_specializations}): refusing to compile a "
                    "new (shape, config) combination — raise "
                    "--max-specializations or reuse warmed configs")
            out = self._run(s0, s1, cfg, corrmap, batch)
            out = jax.block_until_ready(out)
            self._compiled[key] = True
        if corrmap:
            return np.asarray(out[0]), np.asarray(out[1])
        return np.asarray(out)

    def warmup(self, shape: Tuple[int, int, int], dtype: str = "uint8",
               cfg: Optional[Config] = None, *, corrmap: bool = False):
        """Precompile the specialization for ``shape``/``dtype`` using a
        synthetic pair (compilation is shape/dtype-keyed, values don't
        matter)."""
        rng = np.random.default_rng(0)
        hi = np.iinfo(dtype).max
        s0 = rng.integers(0, hi + 1, shape).astype(dtype)
        s1 = rng.integers(0, hi + 1, shape).astype(dtype)
        self.match(s0, s1, cfg, corrmap=corrmap)

    @property
    def compiled_count(self) -> int:
        return len(self._compiled)


def _bool_param(s: str) -> bool:
    """Boolean query-param parsing that also understands Python/JSON
    spellings: a hand-rolled client sending ``?limited=False`` (str(False))
    must not silently flip the flag ON."""
    return s.strip().lower() not in ("0", "false", "no", "off", "")


def _cfg_from_params(base: Config, params: Dict[str, list],
                     want_corrmap: bool = False) -> Config:
    """Apply CLI-style query-param overrides to ``base`` (same semantics as
    the reference CLI flags, cli.cpp:137-166, including the 'corrmap forces
    threshold -1' rule, cli.cpp:146-149 — without it a corrmap request with
    thresholding disabled would be unservable)."""

    def one(name, cast):
        vals = params.get(name)
        return cast(vals[0]) if vals else None

    cfg = base
    thr = one("threshold", float)
    if thr is not None:
        cfg = replace(cfg, nxcorr_threshold=None if thr <= 0 else thr)
    step = one("step", float)
    if step is not None:
        cfg = replace(cfg, subpixel_step=step)
    var = one("variance", float)
    if var is not None:
        cfg = replace(cfg, min_variance=var)
    lim = one("limited", _bool_param)
    if lim is not None:
        cfg = replace(
            cfg, mode=TransformMode.LIMITED if lim else TransformMode.FULL
        )
    lr = one("lr_maxdiff", int)
    nd = one("no_dupes", _bool_param)
    if lr is not None:
        cfg = replace(cfg, variant=Consistency(lr, bool(nd)))
    elif nd:
        cfg = replace(cfg, variant=NoDuplicates())
    dr = one("disp_range", str)
    if dr is not None:
        if dr == "":
            cfg = replace(cfg, disparity_range=None)
        else:
            lo, _, hi = dr.partition(":")
            try:
                cfg = replace(cfg, disparity_range=(int(lo), int(hi)))
            except ValueError:
                raise ValueError(
                    f"disp_range expects MIN:MAX integers, got {dr!r}")
    if want_corrmap and cfg.nxcorr_threshold is None:
        cfg = replace(cfg, nxcorr_threshold=-1.0)
    return cfg


# Default request-body cap: a production batched request (batch=8 x 33
# images x 2200x3300 u8, two stacks) is ~3.8 GB of npz payload, so the
# default is deliberately generous; tighten with --max-body-mb for
# smaller deployments. The daemon has NO authentication — it is designed
# for a trusted rack network (see --help / docs/DEPLOYMENT.md).
DEFAULT_MAX_BODY = 8 << 30
# Socket read timeout (seconds) between received chunks; a stalled or
# slow-loris client frees its handler thread after this. Device-side
# compile/run time is NOT under this clock (it runs after the body is
# fully read).
DEFAULT_READ_TIMEOUT = 120.0


def make_handler(engine: Engine, *, max_body_bytes: int = DEFAULT_MAX_BODY,
                 read_timeout: float = DEFAULT_READ_TIMEOUT):
    class Handler(BaseHTTPRequestHandler):
        # one engine instance shared by all request threads
        timeout = read_timeout  # socket read timeout (BaseRequestHandler)

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "compiled": engine.compiled_count,
                })
                return
            self._json(404, {"error": f"unknown path {url.path}"})

        def do_POST(self):
            url = urlparse(self.path)
            params = parse_qs(url.query)
            try:
                if url.path == "/warmup":
                    shape = tuple(
                        int(x) for x in params["shape"][0].split("x")
                    )
                    dtype_s = params.get("dtype", ["u8"])[0]
                    if dtype_s not in _DTYPES:
                        raise ValueError(f"unknown dtype {dtype_s!r}")
                    dtype = _DTYPES[dtype_s]
                    # corrmap is a separate jit specialization
                    # (pipeline._match_jit statics) — warmup must honor it
                    # or the first corrmap match stalls on a full compile.
                    want_corr = _bool_param(
                        params.get("corrmap", ["0"])[0])
                    cfg = _cfg_from_params(engine.cfg, params, want_corr)
                    engine.warmup(shape, dtype, cfg, corrmap=want_corr)
                    self._json(200, {"compiled": engine.compiled_count})
                    return
                if url.path != "/match":
                    self._json(404, {"error": f"unknown path {url.path}"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", ""))
                except ValueError:
                    self._json(411, {"error": "Content-Length required"})
                    return
                if length > max_body_bytes:
                    # Reject before reading: protects host memory from a
                    # single oversized request (the npz is buffered whole).
                    self._json(413, {
                        "error": f"body {length} bytes exceeds limit "
                                 f"{max_body_bytes}"})
                    return
                data = np.load(io.BytesIO(self.rfile.read(length)))
                s0, s1 = data["stack0"], data["stack1"]
                want_corr = _bool_param(params.get("corrmap", ["0"])[0])
                cfg = _cfg_from_params(engine.cfg, params, want_corr)
                out = engine.match(s0, s1, cfg, corrmap=want_corr)
                buf = io.BytesIO()
                if want_corr:
                    np.savez(buf, disparity=out[0], corrmap=out[1])
                else:
                    np.savez(buf, disparity=out)
                self._send(200, buf.getvalue(), "application/npz")
            except (KeyError, ValueError) as e:
                self._json(400, {"error": str(e)})
            except Exception as e:  # engine errors -> 500, keep serving
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(engine: Engine, host: str = "127.0.0.1", port: int = 8344,
          *, warmup_shapes=(), ready_event: Optional[threading.Event] = None,
          max_body_bytes: int = DEFAULT_MAX_BODY,
          read_timeout: float = DEFAULT_READ_TIMEOUT):
    """Blocking server loop; compiles ``warmup_shapes`` before serving."""
    for shape, dtype in warmup_shapes:
        engine.warmup(shape, dtype)
    httpd = ThreadingHTTPServer((host, port), make_handler(
        engine, max_body_bytes=max_body_bytes, read_timeout=read_timeout))
    if ready_event is not None:
        ready_event.set()
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


_DTYPES = {"u8": "uint8", "uint8": "uint8", "u16": "uint16",
           "uint16": "uint16"}


def _parse_warmup(spec: str):
    shape_s, _, dtype_s = spec.partition(":")
    shape = tuple(int(x) for x in shape_s.split("x"))
    if len(shape) not in (3, 4):
        raise ValueError(
            f"warmup shape must be NxHxW or BxNxHxW, got {spec!r}")
    dtype = _DTYPES.get(dtype_s or "u8")
    if dtype is None:
        raise ValueError(
            f"warmup dtype must be one of {sorted(_DTYPES)}, got {spec!r}")
    return shape, dtype


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m libbicos_jax.serve",
        description="Persistent BICOS matching service (warm compiled "
                    "pipelines, npz-over-HTTP). TRUSTED-NETWORK ONLY: the "
                    "daemon has no authentication or TLS — bind it to "
                    "localhost or a private rack network and front it with "
                    "a real proxy if wider exposure is needed.")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8344)
    p.add_argument("-t", "--threshold", type=float, default=0.5)
    p.add_argument("-s", "--step", type=float, default=None)
    p.add_argument("-v", "--variance", type=float, default=None)
    p.add_argument("--limited", action="store_true")
    p.add_argument("-m", "--lr-maxdiff", type=int, default=None)
    p.add_argument("--no-dupes", action="store_true")
    p.add_argument("--disp-range", default=None, metavar="MIN:MAX",
                   help="default disparity range for served matches "
                        "(Config.disparity_range extension; per-request "
                        "disp_range param overrides)")
    p.add_argument("--backend", default="auto", choices=list(BACKENDS),
                   help="compute path (see search.resolve_backend)")
    p.add_argument("--max-body-mb", type=int,
                   default=DEFAULT_MAX_BODY >> 20,
                   help="reject request bodies larger than this with 413 "
                        "(default %(default)s MiB — sized for batched "
                        "production stacks)")
    p.add_argument("--read-timeout", type=float,
                   default=DEFAULT_READ_TIMEOUT,
                   help="per-connection socket read timeout in seconds "
                        "(default %(default)s)")
    p.add_argument("--max-specializations", type=int, default=64,
                   help="reject requests that would compile more than this "
                        "many distinct (shape, config) pipeline "
                        "specializations (each is a separate compile; "
                        "default %(default)s)")
    p.add_argument("--devices", type=int, default=1,
                   help="H-band the pipeline over this many devices")
    p.add_argument("--warmup", action="append", default=[],
                   metavar="[Bx]NxHxW[:u8|u16]",
                   help="precompile these stack shapes before serving "
                        "(repeatable; 4-component shapes warm the batched "
                        "throughput layout)")
    args = p.parse_args(argv)

    variant = (Consistency(args.lr_maxdiff, args.no_dupes)
               if args.lr_maxdiff is not None
               else NoDuplicates())
    drange = None
    if args.disp_range:
        try:
            lo, _, hi = args.disp_range.partition(":")
            drange = (int(lo), int(hi))
        except ValueError:
            p.error(f"--disp-range expects MIN:MAX integers, "
                    f"got {args.disp_range!r}")
    cfg = Config(
        nxcorr_threshold=None if args.threshold <= 0 else args.threshold,
        subpixel_step=args.step,
        min_variance=args.variance,
        mode=(TransformMode.LIMITED if args.limited else TransformMode.FULL),
        variant=variant,
        disparity_range=drange,
    )
    from .compile_cache import enable_compile_cache

    enable_compile_cache()
    mesh = None
    if args.devices > 1:
        from .sharding import make_mesh

        mesh = make_mesh(args.devices)
    engine = Engine(cfg, backend=args.backend, mesh=mesh,
                    max_specializations=args.max_specializations)
    shapes = [_parse_warmup(s) for s in args.warmup]
    print(f"serving on http://{args.host}:{args.port} "
          f"(warmup: {len(shapes)} shapes)", flush=True)
    serve(engine, args.host, args.port, warmup_shapes=shapes,
          max_body_bytes=args.max_body_mb << 20,
          read_timeout=args.read_timeout)


if __name__ == "__main__":
    main()
