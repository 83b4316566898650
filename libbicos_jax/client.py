"""Zero-dependency client for the :mod:`libbicos_jax.serve` daemon.

Usage::

    from libbicos_jax.client import BicosClient

    c = BicosClient("http://localhost:8344")
    c.warmup((33, 2200, 3300))              # precompile once
    disp = c.match(stack0, stack1)          # numpy in, numpy out
    disp, corr = c.match(stack0, stack1, corrmap=True, threshold=0.96,
                         step=0.1, variance=2.0, limited=True)

Only stdlib + numpy; the wire format is npz-over-HTTP (see serve.py).
"""

from __future__ import annotations

import io
import json
import urllib.error
import urllib.parse
import urllib.request

import numpy as np


class ServerError(RuntimeError):
    """Raised when the daemon reports an error (HTTP 4xx/5xx)."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class BicosClient:
    def __init__(self, base_url: str = "http://127.0.0.1:8344",
                 timeout: float = 600.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _request(self, path: str, data: bytes | None = None,
                 params: dict | None = None) -> bytes:
        url = self.base_url + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        req = urllib.request.Request(
            url, data=data,
            headers={"Content-Type": "application/npz"} if data else {},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            body = e.read()
            try:
                msg = json.loads(body).get("error", body.decode())
            except Exception:
                msg = body.decode(errors="replace")
            raise ServerError(e.code, msg) from None

    def healthz(self) -> dict:
        return json.loads(self._request("/healthz"))

    def warmup(self, shape, dtype: str = "u8", **overrides) -> int:
        """Precompile a (shape, dtype[, config-override]) specialization;
        returns the daemon's compiled-specialization count."""
        params = {"shape": "x".join(str(int(x)) for x in shape),
                  "dtype": dtype, **_clean(overrides)}
        return json.loads(self._request("/warmup", b"", params))["compiled"]

    def match(self, stack0: np.ndarray, stack1: np.ndarray, *,
              corrmap: bool = False, **overrides):
        """Run a match on the daemon. ``overrides`` take the CLI-style
        names: threshold, step, variance, limited, lr_maxdiff, no_dupes."""
        buf = io.BytesIO()
        np.savez(buf, stack0=stack0, stack1=stack1)
        params = _clean(overrides)
        if corrmap:
            params["corrmap"] = 1
        body = self._request("/match", buf.getvalue(), params)
        out = np.load(io.BytesIO(body))
        if corrmap:
            return out["disparity"], out["corrmap"]
        return out["disparity"]


def _clean(overrides: dict) -> dict:
    out = {}
    for k, v in overrides.items():
        if v is None:
            continue
        out[k] = int(v) if isinstance(v, bool) else v
    return out
