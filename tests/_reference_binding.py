"""Build + load the REAL compiled reference (CPU backend) for differential
testing.

The reference's own ctypes package cannot be used as-is: on CPU builds the
C-ABI config struct omits the ``precision`` field
(``/root/reference/src/pybicos_c.cpp:34-37`` — it is guarded by
``#ifdef BICOS_CUDA``) while the shipped ctypes struct always includes it
(``/root/reference/pybicos/__init__.py:41-51``). Every field after ``mode``
is therefore shifted by 4 bytes for CPU-build users: asking for Consistency
silently configures NoDuplicates with ``no_dupes`` read from ``max_lr_diff``.
This module defines the CORRECTED struct (see PARITY.md row 18) so the
differential compares against what the compiled C++ actually does, not
against the upstream binding bug.

Build artifacts are cached in ``/tmp/bicos_ref_build_ci`` across test
sessions (the reference tree is read-only and immutable). If cmake, OpenCV,
or a compiler is unavailable the loader degrades to ``None`` and callers
skip.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

REF_SRC = os.environ.get("BICOS_REF_SRC", "/root/reference")
BUILD_DIR = os.environ.get("BICOS_REF_BUILD", "/tmp/bicos_ref_build_ci")

# OpenCV single-channel type codes (opencv2/core/hal/interface.h).
_CV_8UC1 = 0
_CV_16UC1 = 2
_CV_16SC1 = 3
_CV_32FC1 = 5

_NP_FROM_CV = {
    _CV_8UC1: np.uint8,
    _CV_16UC1: np.uint16,
    _CV_16SC1: np.int16,
    _CV_32FC1: np.float32,
}
_CV_FROM_NP = {np.dtype(np.uint8): _CV_8UC1, np.dtype(np.uint16): _CV_16UC1}


class BicosConfigCPU(ctypes.Structure):
    """C-ABI config struct AS COMPILED for CPU builds (pybicos_c.cpp:29-41):
    no ``precision`` field — that member only exists under BICOS_CUDA."""

    _fields_ = [
        ("nxcorr_threshold", ctypes.c_float),
        ("subpixel_step", ctypes.c_float),
        ("min_variance", ctypes.c_float),
        ("mode", ctypes.c_int),
        ("variant_type", ctypes.c_int),
        ("max_lr_diff", ctypes.c_int),
        ("no_dupes", ctypes.c_int),
    ]


class BicosResult(ctypes.Structure):
    _fields_ = [
        ("disparity_data", ctypes.c_void_p),
        ("disparity_rows", ctypes.c_int),
        ("disparity_cols", ctypes.c_int),
        ("disparity_type", ctypes.c_int),
        ("corrmap_data", ctypes.c_void_p),
        ("corrmap_rows", ctypes.c_int),
        ("corrmap_cols", ctypes.c_int),
        ("corrmap_type", ctypes.c_int),
    ]


def _build() -> Optional[str]:
    """Configure + build the reference CPU ``pybicos_c`` once; return the
    shared-library path or None when the toolchain/deps are missing."""
    so = os.path.join(BUILD_DIR, "pybicos_c.so")
    if os.path.exists(so):
        return so
    if not os.path.isdir(REF_SRC) or shutil.which("cmake") is None:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    gen = ["-G", "Ninja"] if shutil.which("ninja") else []
    log = os.path.join(BUILD_DIR, "ci_build.log")
    with open(log, "a") as f:
        cfg = subprocess.run(
            ["cmake", "-S", REF_SRC, "-B", BUILD_DIR,
             "-DBICOS_IMPLEMENTATION=CPU", "-DCMAKE_BUILD_TYPE=Release",
             *gen],
            stdout=f, stderr=subprocess.STDOUT, timeout=300,
        )
        if cfg.returncode != 0:
            return None
        bld = subprocess.run(
            ["cmake", "--build", BUILD_DIR, "--target", "pybicos_c"],
            stdout=f, stderr=subprocess.STDOUT, timeout=600,
        )
        if bld.returncode != 0:
            return None
    return so if os.path.exists(so) else None


_LIB = None
_LOAD_TRIED = False


def load() -> Optional[ctypes.CDLL]:
    global _LIB, _LOAD_TRIED
    if _LOAD_TRIED:
        return _LIB
    _LOAD_TRIED = True
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.BICOS_Match.restype = ctypes.POINTER(BicosResult)
    lib.BICOS_Match.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
        ctypes.POINTER(BicosConfigCPU),
    ]
    lib.BICOS_FreeResult.restype = None
    lib.BICOS_FreeResult.argtypes = [ctypes.POINTER(BicosResult)]
    lib.BICOS_InvalidDisparityFloat.restype = ctypes.c_float
    lib.BICOS_InvalidDisparityInt16.restype = ctypes.c_int16
    _LIB = lib
    return _LIB


def available() -> bool:
    return load() is not None


def _marshal_stack(stack: np.ndarray):
    n = stack.shape[0]
    imgs = [np.ascontiguousarray(stack[i]) for i in range(n)]
    data = (ctypes.c_void_p * n)()
    rows = (ctypes.c_int * n)()
    cols = (ctypes.c_int * n)()
    types = (ctypes.c_int * n)()
    for i, img in enumerate(imgs):
        data[i] = img.ctypes.data_as(ctypes.c_void_p)
        rows[i] = img.shape[0]
        cols[i] = img.shape[1]
        types[i] = _CV_FROM_NP[img.dtype]
    return imgs, data, rows, cols, types


def _copy_out(ptr: int, rows: int, cols: int, cvtype: int) -> np.ndarray:
    dtype = _NP_FROM_CV.get(cvtype, np.uint8)
    if rows <= 0 or cols <= 0 or not ptr:
        return np.empty((max(rows, 0), max(cols, 0)), dtype=dtype)
    nbytes = rows * cols * np.dtype(dtype).itemsize
    buf = (ctypes.c_byte * nbytes).from_address(ptr)
    return np.frombuffer(buf, dtype=dtype).reshape(rows, cols).copy()


def ref_match(stack0: np.ndarray, stack1: np.ndarray, cfg
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Run the COMPILED reference CPU backend through its C ABI.

    ``cfg`` is a ``libbicos_jax.Config``. Returns ``(disparity, corrmap)``
    exactly as the reference ctypes package would have (modulo the corrected
    struct). NOTE the measured C-ABI sentinel semantics (verified against
    the compiled binary, 2026-08-20): ``convertConfig`` only ASSIGNS config
    fields when the sentinel is ``>= 0`` (``pybicos_c.cpp:56-70``), and the
    C++ ``Config`` initializes ``nxcorr_threshold = 0.5f``
    (``common.hpp:74``) — so a negative/None threshold does NOT disable
    NXCORR through this ABI; the library runs with the 0.5 default and
    returns float32 disparity + a real corrmap. The library-level
    nullopt-threshold path (raw int16 search output, untouched corrmap;
    ``cpu.cpp:77-95``) is UNREACHABLE from pybicos. ``subpixel_step`` and
    ``min_variance`` default to nullopt, so their -1 sentinels behave as
    expected.
    """
    from libbicos_jax.config import Consistency, TransformMode

    lib = load()
    assert lib is not None, "reference binding unavailable"
    c = BicosConfigCPU()
    c.nxcorr_threshold = (-1.0 if cfg.nxcorr_threshold is None
                          else float(cfg.nxcorr_threshold))
    c.subpixel_step = (-1.0 if cfg.subpixel_step is None
                       else float(cfg.subpixel_step))
    c.min_variance = (-1.0 if cfg.min_variance is None
                      else float(cfg.min_variance))
    c.mode = 1 if cfg.mode == TransformMode.FULL else 0
    if isinstance(cfg.variant, Consistency):
        c.variant_type = 1
        c.max_lr_diff = int(cfg.variant.max_lr_diff)
        c.no_dupes = 1 if cfg.variant.no_dupes else 0
    else:
        c.variant_type = 0
        c.max_lr_diff = 1
        c.no_dupes = 0

    s0 = np.asarray(stack0)
    s1 = np.asarray(stack1)
    k0, d0, r0, c0, t0 = _marshal_stack(s0)
    k1, d1, r1, c1, t1 = _marshal_stack(s1)
    res = lib.BICOS_Match(d0, r0, c0, t0, len(k0),
                          d1, r1, c1, t1, len(k1),
                          ctypes.byref(c))
    if not res:
        raise RuntimeError("reference BICOS_Match failed")
    try:
        disp = _copy_out(res.contents.disparity_data,
                         res.contents.disparity_rows,
                         res.contents.disparity_cols,
                         res.contents.disparity_type)
        corr = _copy_out(res.contents.corrmap_data,
                         res.contents.corrmap_rows,
                         res.contents.corrmap_cols,
                         res.contents.corrmap_type)
    finally:
        lib.BICOS_FreeResult(res)
    return disp, corr
