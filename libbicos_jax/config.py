"""Configuration types for the BICOS engine.

Mirrors the reference library's public configuration surface
(``/root/reference/include/common.hpp:58-82``) as frozen Python dataclasses so
they can be used as static arguments under ``jax.jit``:

* ``TransformMode`` — LIMITED / FULL   (common.hpp:58)
* ``Precision``     — SINGLE / DOUBLE  (common.hpp:60; DOUBLE runs the NXCORR
  math in float64 on the XLA agree path)
* ``Variant.NoDuplicates`` / ``Variant.Consistency`` (common.hpp:63-71)
* ``Config`` with the same defaults as the reference *library*
  (common.hpp:73-82): nxcorr_threshold=0.5, mode=LIMITED, NoDuplicates.
  Note the reference *CLI* uses different defaults (threshold 0.75, FULL;
  cli.cpp:63,137-140) — our CLI mirrors those separately.

Invalid-disparity sentinels preserve the reference bit-compatible values
(common.hpp:34-37): NaN for floating point, -32768 for int16.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Union

import numpy as np


class TransformMode(enum.Enum):
    LIMITED = 0
    FULL = 1


class Precision(enum.Enum):
    SINGLE = 0
    DOUBLE = 1


@dataclasses.dataclass(frozen=True)
class NoDuplicates:
    """Invalidate a pixel whose minimum Hamming cost is not unique in its row.

    Reference: ``bicos.hpp:50-76`` (BICOSFLAGS_NODUPES path).
    """


@dataclasses.dataclass(frozen=True)
class Consistency:
    """Left/right consistency check (reference ``bicos.hpp:99-107``).

    A forward match ``col0 -> best_col1`` is kept only if the reverse search
    from ``best_col1`` lands within ``max_lr_diff`` of ``col0``; the stored
    disparity is ``(col0 + reverse_col0) // 2 - best_col1``.
    ``no_dupes`` additionally applies the NoDuplicates rule to both searches.
    """

    max_lr_diff: int = 1
    no_dupes: bool = False


SearchVariant = Union[NoDuplicates, Consistency]


@dataclasses.dataclass(frozen=True)
class Config:
    """Matching configuration; defaults equal the reference library defaults
    (``common.hpp:73-82``).

    ``disparity_range`` is an EXTENSION the reference lacks
    (its scan is always full-width, ``bicos.hpp:54``): an inclusive
    ``(dmin, dmax)`` bound on the disparity ``d = col0 - col1``. The
    search argmin (and the Consistency reverse search) is restricted to
    in-range candidates; a pixel with no in-range candidate is invalid.
    This is the standard production-stereo contract (rectified rigs have
    a known depth bracket); the GPU scan kernel then visits only the right
    columns the range can reach. ``None`` (default) keeps exact reference
    semantics.
    """

    nxcorr_threshold: Optional[float] = 0.5
    subpixel_step: Optional[float] = None
    min_variance: Optional[float] = None
    mode: TransformMode = TransformMode.LIMITED
    precision: Precision = Precision.SINGLE
    variant: SearchVariant = NoDuplicates()
    disparity_range: Optional[tuple] = None

    def __post_init__(self):
        if self.subpixel_step is not None and self.subpixel_step <= 0:
            raise ValueError("subpixel_step must be positive")
        if self.disparity_range is not None:
            import operator

            dr = self.disparity_range
            try:
                if len(dr) != 2 or any(isinstance(v, bool) for v in dr):
                    raise TypeError
                # operator.index accepts any integral type (numpy ints,
                # array scalars from arr.min()/max()) and rejects floats.
                dr = (operator.index(dr[0]), operator.index(dr[1]))
            except TypeError:
                raise ValueError(
                    "disparity_range must be an integer (dmin, dmax) pair, "
                    f"got {self.disparity_range!r}") from None
            if dr[0] > dr[1]:
                raise ValueError(
                    f"disparity_range needs dmin <= dmax, got {dr!r}")
            # Normalize to a plain int tuple so Config stays hashable/static.
            object.__setattr__(self, "disparity_range", dr)


# Invalid disparity sentinels (common.hpp:34-37).
INVALID_DISP_INT16 = np.int16(-32768)
INVALID_DISP_FLOAT = float("nan")


def invalid_disparity(dtype) -> float:
    """Reference parity: NaN for float dtypes, lowest() for int16
    (``common.hpp:34-37``, ``pybicos/__init__.py:246-252``)."""
    dt = np.dtype(dtype)
    if np.issubdtype(dt, np.floating):
        return float("nan")
    if dt == np.int16:
        return int(INVALID_DISP_INT16)
    raise ValueError(f"unsupported disparity dtype: {dtype}")


def is_invalid(disparity):
    """Elementwise invalid mask, dtype-dispatched like ``common.hpp:39-48``."""
    import jax.numpy as jnp

    arr = jnp.asarray(disparity)
    if jnp.issubdtype(arr.dtype, jnp.floating):
        return jnp.isnan(arr)
    return arr == INVALID_DISP_INT16


def required_bits(n: int, mode: TransformMode) -> int:
    """Descriptor width formula used by the reference's dtype dispatch
    (``cpu.cpp:122-124``): FULL -> n^2-2n+3, LIMITED -> 4n-7.

    NOTE: the LIMITED transform actually emits 4n-6 bits (the reference
    undercounts by one), but because 4n-7 == 1 (mod 4) the undercount never
    crosses a 32/64/128/256-bit storage boundary, so the reference dispatch is
    still safe; we size storage by the *actual* bit count.
    """
    if mode == TransformMode.FULL:
        return n * n - 2 * n + 3
    return 4 * n - 7


def actual_bits(n: int, mode: TransformMode) -> int:
    """Exact number of descriptor bits emitted by the transform."""
    if mode == TransformMode.FULL:
        # 3(n-2) temporal bits + 3 tail bits + all-pairs pairsum comparisons
        # excluding i in {t-1, t, t+1}:  (n-1)^2 - (3n-5)  = n^2 - 5n + 6.
        return n * n - 2 * n + 3
    # LIMITED: 3 bits per t in [0, n-2), a lagged pairsum bit for t >= 2,
    # and 4 tail bits. For n in {2, 3} the lagged tail bit degenerates to a
    # constant-true bit (prev_pair_sum stays -1) but is still emitted.
    if n == 2:
        return 4
    return 3 * (n - 2) + max(0, n - 4) + 4


MAX_BITS = 256


def validate_stack(n: int, mode: TransformMode) -> int:
    """Validate stack size like the reference (``cpu.cpp:110-114,129-156``)
    and return the actual descriptor bit count."""
    if n < 2:
        raise ValueError("need at least two images")
    req = required_bits(n, mode)
    if req > MAX_BITS:
        raise ValueError(
            f"input stacks too large, would require {req} bits (max {MAX_BITS})"
        )
    bits = actual_bits(n, mode)
    assert bits <= MAX_BITS
    return bits


def max_stacksize(mode: TransformMode, bits: int = MAX_BITS) -> int:
    """Largest n whose required_bits fit in ``bits``
    (reference ``impl/common.hpp:61-76``)."""
    if mode == TransformMode.LIMITED:
        return (bits + 7) // 4
    return int((2 + math.isqrt(4 - 4 * (3 - bits))) // 2)
