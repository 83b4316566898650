"""Native (C++) I/O runtime: threaded PNG stack decode + fast .xyz export.

Built lazily with g++ on first use (``ensure_built()``); all callers fall
back to the pure-Python/cv2 paths in :mod:`libbicos_jax.io` when a compiler
or libpng is unavailable, so the native layer is an accelerator, never a
hard dependency.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "fastio.cpp"
_SO = _DIR / "_fastio.so"

_lock = threading.Lock()
_lib = None
_tried = False


def build(force: bool = False) -> Optional[Path]:
    """Compile the native library. Returns the .so path or None."""
    if _SO.exists() and not force:
        if _SO.stat().st_mtime >= _SRC.stat().st_mtime:
            return _SO
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
        str(_SRC), "-lpng", "-o", str(_SO),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except Exception:
        return None
    return _SO


def get() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("BICOS_NO_NATIVE"):
            return None
        so = build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.bicos_png_probe.restype = ctypes.c_int
        lib.bicos_png_probe.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.bicos_decode_stack.restype = ctypes.c_int
        lib.bicos_decode_stack.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int,
        ]
        lib.bicos_write_xyz.restype = ctypes.c_long
        lib.bicos_write_xyz.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_long, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def decode_stack(paths: Sequence[str], n_threads: int = 0):
    """Decode grayscale PNGs into one contiguous (n, H, W) array, or None
    if the native path can't handle them (caller falls back)."""
    lib = get()
    if lib is None or not paths:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    depth = ctypes.c_int()
    if lib.bicos_png_probe(str(paths[0]).encode(), ctypes.byref(w),
                           ctypes.byref(h), ctypes.byref(depth)) != 0:
        return None
    out_depth = 16 if depth.value == 16 else 8
    dtype = np.uint16 if out_depth == 16 else np.uint8
    n = len(paths)
    out = np.empty((n, h.value, w.value), dtype=dtype)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    rc = lib.bicos_decode_stack(
        arr, n, w.value, h.value, out_depth,
        out.ctypes.data_as(ctypes.c_void_p), n_threads,
    )
    if rc != 0:
        return None
    return out


def write_xyz(path, points: np.ndarray, disp: np.ndarray,
              allow_negative_z: bool) -> Optional[int]:
    """Fast .xyz export; returns point count or None (caller falls back)."""
    lib = get()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points.reshape(-1, 3), dtype=np.float32)
    d = np.ascontiguousarray(disp.reshape(-1), dtype=np.float32)
    n = lib.bicos_write_xyz(
        str(path).encode(),
        pts.ctypes.data_as(ctypes.c_void_p),
        d.ctypes.data_as(ctypes.c_void_p),
        pts.shape[0], 1 if allow_negative_z else 0,
    )
    return None if n < 0 else int(n)
