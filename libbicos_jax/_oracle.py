"""Per-pixel NumPy oracle of the reference BICOS semantics.

A deliberately *literal*, loop-based transcription of the reference C++
templates, used as the independent correctness oracle for the vectorized
JAX implementation (SURVEY.md section 4 mandates golden-file descriptor tests
and disparity-agreement tests). Slow by construction — only run on tiny
images in tests.

Transcribed behaviors (reference file:line):
* transform_limited / transform_full  — descriptor_transform.hpp:32-123
* Bitfield::set append order          — bitfield.hpp:35-58
* bicos_search / bicos                — bicos.hpp:50-113
* nxcorr (+ min_variance)             — agree.hpp:28-51
* agree / agree_subpixel              — agree.hpp:53-191
* dispatch quirks (min_variance * n)  — cpu.cpp:127
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from .config import Config, Consistency, NoDuplicates, TransformMode

INVALID_I16 = -32768


def transform_limited(pix: np.ndarray) -> list:
    """pix: (n,) ints. Returns list of bits (bools) in append order."""
    n = len(pix)
    pix = [int(v) for v in pix]
    av = np.float32(0.0)
    for t in range(n):
        av = np.float32(av + np.float32(pix[t]))
    av = np.float32(av / np.float32(n))
    bits = []
    prev_pair_sums = [-1, -1]
    for t in range(n - 2):
        a, b, c = pix[t], pix[t + 1], pix[t + 2]
        bits.append(a < b)
        bits.append(a < c)
        bits.append(np.float32(a) < av)
        cur = a + b
        if prev_pair_sums[t % 2] != -1:
            bits.append(prev_pair_sums[t % 2] < cur)
        prev_pair_sums[t % 2] = cur
    a, b = pix[n - 2], pix[n - 1]
    bits.append(a < b)
    bits.append(np.float32(a) < av)
    bits.append(np.float32(b) < av)
    bits.append(prev_pair_sums[(n - 2) % 2] < (a + b))
    return bits


def transform_full(pix: np.ndarray) -> list:
    n = len(pix)
    pix = [int(v) for v in pix]
    av = np.float32(0.0)
    for t in range(n):
        av = np.float32(av + np.float32(pix[t]))
    av = np.float32(av / np.float32(n))
    bits = []
    pairsums = [0] * (n - 1)
    for t in range(n - 2):
        a, b, c = pix[t], pix[t + 1], pix[t + 2]
        bits.append(a < b)
        bits.append(a < c)
        bits.append(np.float32(a) < av)
        pairsums[t] = pix[t] + pix[t + 1]
    pairsums[n - 2] = pix[n - 2] + pix[n - 1]
    a, b = pix[n - 2], pix[n - 1]
    bits.append(a < b)
    bits.append(np.float32(a) < av)
    bits.append(np.float32(b) < av)
    for t in range(n - 1):
        for i in range(n - 1):
            if i == t or i == t - 1 or i == t + 1:
                continue
            bits.append(pairsums[t] < pairsums[i])
    return bits


def descriptor_bits(stack: np.ndarray, mode: TransformMode) -> np.ndarray:
    """stack: (n, H, W) -> (H, W, B) bool, in Bitfield append order."""
    n, h, w = stack.shape
    fn = transform_full if mode == TransformMode.FULL else transform_limited
    first = fn(stack[:, 0, 0])
    out = np.zeros((h, w, len(first)), dtype=bool)
    for r in range(h):
        for c in range(w):
            out[r, c, :] = fn(stack[:, r, c])
    return out


def bicos_search(d0_bits: np.ndarray, row1_bits: np.ndarray, nodupes: bool) -> int:
    """Linear scan over the full opposite row (bicos.hpp:50-76).

    d0_bits: (B,) bool; row1_bits: (W, B) bool. Returns best col1 or -1."""
    best_col1 = -1
    min_cost = 1 << 30
    dup = 0
    for col1 in range(row1_bits.shape[0]):
        cost = int(np.count_nonzero(d0_bits ^ row1_bits[col1]))
        if cost < min_cost:
            min_cost = cost
            best_col1 = col1
            dup = 0
        elif nodupes and cost == min_cost:
            dup += 1
    if nodupes and dup > 0:
        return -1
    return best_col1


def bicos(desc0: np.ndarray, desc1: np.ndarray, variant) -> np.ndarray:
    """Full correspondence search (bicos.hpp:78-113) -> (H, W) int16."""
    h, w, _ = desc0.shape
    out = np.full((h, w), INVALID_I16, dtype=np.int16)
    if isinstance(variant, Consistency):
        nodupes = variant.no_dupes
        consistency = True
        max_lr = variant.max_lr_diff
    else:
        nodupes = True
        consistency = False
        max_lr = -1
    for row in range(h):
        r0, r1 = desc0[row], desc1[row]
        for col0 in range(w):
            best_col1 = bicos_search(r0[col0], r1, nodupes)
            if best_col1 < 0:
                continue
            if consistency:
                reverse_col0 = bicos_search(r1[best_col1], r0, nodupes)
                if reverse_col0 < 0 or abs(col0 - reverse_col0) > max_lr:
                    continue
                out[row, col0] = (col0 + reverse_col0) // 2 - best_col1
            else:
                out[row, col0] = col0 - best_col1
    return out


def nxcorr(pix0, pix1, minvar: Optional[float]) -> np.float32:
    """agree.hpp:28-51 (float32 math, fma-chained accumulation)."""
    n = len(pix0)
    mean0 = np.float32(0)
    mean1 = np.float32(0)
    for i in range(n):
        mean0 = np.float32(mean0 + np.float32(pix0[i]))
        mean1 = np.float32(mean1 + np.float32(pix1[i]))
    mean0 = np.float32(mean0 / np.float32(n))
    mean1 = np.float32(mean1 / np.float32(n))
    covar = np.float32(0)
    var0 = np.float32(0)
    var1 = np.float32(0)
    for i in range(n):
        d0 = np.float32(np.float32(pix0[i]) - mean0)
        d1 = np.float32(np.float32(pix1[i]) - mean1)
        covar = np.float32(d0 * d1 + covar)
        var0 = np.float32(d0 * d0 + var0)
        var1 = np.float32(d1 * d1 + var1)
    if minvar is not None and (var0 < minvar or var1 < minvar):
        return np.float32(-1.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.float32(covar / np.float32(math.sqrt(var0 * var1)))


def agree(
    raw_disp: np.ndarray,
    stack0: np.ndarray,
    stack1: np.ndarray,
    threshold: float,
    minvar: Optional[float],
):
    """Integer NXCORR validation (agree.hpp:53-93), in place on raw_disp.

    Returns (disp int16, corrmap float32)."""
    h, w = raw_disp.shape
    corr = np.full((h, w), np.nan, dtype=np.float32)
    for row in range(h):
        for col in range(w):
            d = int(raw_disp[row, col])
            if d == INVALID_I16:
                continue
            idx1 = col - d
            if idx1 < 0 or w <= idx1:
                raw_disp[row, col] = INVALID_I16
                continue
            nxc = nxcorr(stack0[:, row, col], stack1[:, row, idx1], minvar)
            corr[row, col] = nxc
            if nxc < threshold:
                raw_disp[row, col] = INVALID_I16
    return raw_disp, corr


def subpixel_xgrid(step: float) -> list:
    """The reference's float-accumulated x sweep (agree.hpp:168)."""
    xs = []
    x = np.float32(-1.0)
    while x <= np.float32(1.0):
        xs.append(np.float32(x))
        x = np.float32(x + np.float32(step))
    return xs


def agree_subpixel(
    raw_disp: np.ndarray,
    stack0: np.ndarray,
    stack1: np.ndarray,
    threshold: float,
    step: float,
    minvar: Optional[float],
    input_dtype,
):
    """Subpixel parabola sweep (agree.hpp:95-191).

    Returns (disp float32 w/ NaN invalid, corrmap float32)."""
    n, h, w = stack0.shape
    ret = np.full((h, w), np.nan, dtype=np.float32)
    corr = np.full((h, w), np.nan, dtype=np.float32)
    xs = subpixel_xgrid(step)
    mod = np.iinfo(input_dtype).max + 1
    for row in range(h):
        for col in range(w):
            d = int(raw_disp[row, col])
            if d == INVALID_I16:
                continue
            col1 = col - d
            if col1 < 0 or w <= col1:
                continue
            if col1 == 0 or col1 == w - 1:
                nxc = nxcorr(stack0[:, row, col], stack1[:, row, col1], minvar)
                corr[row, col] = nxc
                if nxc < threshold:
                    continue
                ret[row, col] = np.float32(d)
            else:
                y0 = stack1[:, row, col1 - 1].astype(np.float32)
                y1 = stack1[:, row, col1].astype(np.float32)
                y2 = stack1[:, row, col1 + 1].astype(np.float32)
                a = np.float32(0.5) * (y0 - np.float32(2.0) * y1 + y2)
                b = np.float32(0.5) * (-y0 + y2)
                c = y1
                best_x = np.float32(0.0)
                best_nxc = np.float32(-1.0)
                for x in xs:
                    # roundeven then C-style int conversion (modular for
                    # unsigned targets) — agree.hpp:170, agree.cuh:235.
                    interp = np.asarray(
                        np.round(a * x * x + b * x + c), dtype=np.int64
                    ) % mod
                    interp = interp.astype(input_dtype)
                    nxc = nxcorr(stack0[:, row, col], interp, minvar)
                    if best_nxc < nxc:
                        best_x = x
                        best_nxc = nxc
                corr[row, col] = best_nxc
                if best_nxc < threshold:
                    continue
                ret[row, col] = np.float32(np.float32(d) - best_x)
    return ret, corr


def match(stack0: np.ndarray, stack1: np.ndarray, cfg: Config):
    """End-to-end oracle pipeline mirroring cpu.cpp:36-98 (but with the CUDA
    backend's output-dtype convention: int16 unless subpixel).

    Returns (disparity, corrmap or None)."""
    n = stack0.shape[0]
    mode = cfg.mode
    bits0 = descriptor_bits(stack0, mode)
    bits1 = descriptor_bits(stack1, mode)
    disp = bicos(bits0, bits1, cfg.variant)
    if cfg.nxcorr_threshold is None:
        return disp, None
    minvar = None if cfg.min_variance is None else cfg.min_variance * n
    if cfg.subpixel_step is not None:
        return agree_subpixel(
            disp, stack0, stack1, cfg.nxcorr_threshold, cfg.subpixel_step,
            minvar, stack0.dtype.type,
        )
    return agree(disp, stack0, stack1, cfg.nxcorr_threshold, minvar)
