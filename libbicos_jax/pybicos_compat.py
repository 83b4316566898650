"""Drop-in ``pybicos``-compatible API surface.

Users of the reference's ctypes package (``/root/reference/pybicos/__init__.py``)
can ``import libbicos_jax.pybicos_compat as pybicos`` and keep their code:

* mutable :class:`Config` with the same property names, None <-> -1 sentinel
  semantics (pybicos/__init__.py:110-196) and the C-ABI default values
  (pybicos_c.cpp:92-108: threshold 0.5, LIMITED, NoDuplicates),
* :func:`match` taking *lists of 2-D arrays* and returning
  ``(disparity, corrmap)``,
* :func:`invalid_disparity` (pybicos/__init__.py:246-252).

The observable contract is pinned against the COMPILED reference CPU-build
binding by ``tests/test_reference_differential.py`` (randomized engine-vs-
real-C++ trials). Two measured C-ABI behaviors this module reproduces:

1. **NXCORR cannot be disabled.** ``convertConfig`` only assigns config
   fields when the sentinel is ``>= 0`` (pybicos_c.cpp:56-62), and the C++
   ``Config`` default is ``nxcorr_threshold = 0.5f`` (common.hpp:74) — so a
   None/negative threshold silently runs the 0.5 default. (``subpixel_step``
   and ``min_variance`` default to nullopt, so their sentinels behave as
   documented.)
2. **float32 disparity, always.** Because a threshold is always in effect,
   the CPU backend always converts the disparity to float32
   (cpu.cpp:88-94); on the integer (non-subpixel) path that is a plain
   ``convertTo`` cast, so invalid pixels stay ``-32768.0f`` — NOT NaN.
   The corrmap is always real (NaN-initialized, written at searched pixels).

KNOWN UPSTREAM BUG (not reproduced): the reference's own ctypes struct
always includes a ``precision`` field (pybicos/__init__.py:41-51) while CPU
builds compile the C struct WITHOUT it (pybicos_c.cpp:34-37), shifting every
field after ``mode`` by 4 bytes — a stock CPU-build pybicos user asking for
Consistency silently gets NoDuplicates with ``no_dupes`` read from
``max_lr_diff``. This module implements the *corrected* (intended) layout;
see PARITY.md row 18. ``precision`` exists here for CUDA-build interface
compatibility and is honored by the engine (a capability superset: the CPU
build has no precision concept at all).

Everything runs through the JAX engine — there is no C ABI because the
compute already lives behind XLA; the ctypes marshalling layer's job
(zero-copy ndarray views in, owned copies out) is what ``jnp.asarray`` /
``np.asarray`` do natively.
"""

from __future__ import annotations

from enum import Enum
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import config as _config
from . import pipeline as _pipeline


class TransformMode(Enum):
    LIMITED = 0
    FULL = 1


class Precision(Enum):
    SINGLE = 0
    DOUBLE = 1


class VariantType(Enum):
    NO_DUPLICATES = 0
    CONSISTENCY = 1


class Config:
    """Mutable config mirroring the ctypes wrapper's surface."""

    def __init__(self):
        # Defaults per BICOS_CreateDefaultConfig (pybicos_c.cpp:92-108).
        self.nxcorr_threshold = 0.5
        self._subpixel_step = -1.0
        self._min_variance = -1.0
        self._mode = TransformMode.LIMITED.value
        self._precision = Precision.SINGLE.value
        self._variant_type = VariantType.NO_DUPLICATES.value
        self._max_lr_diff = 1
        self._no_dupes = 0

    @property
    def subpixel_step(self) -> Optional[float]:
        return None if self._subpixel_step < 0 else self._subpixel_step

    @subpixel_step.setter
    def subpixel_step(self, value):
        self._subpixel_step = -1.0 if value is None else float(value)

    @property
    def min_variance(self) -> Optional[float]:
        return None if self._min_variance < 0 else self._min_variance

    @min_variance.setter
    def min_variance(self, value):
        self._min_variance = -1.0 if value is None else float(value)

    @property
    def mode(self) -> TransformMode:
        return TransformMode(self._mode)

    @mode.setter
    def mode(self, value):
        self._mode = value.value if isinstance(value, TransformMode) else value

    @property
    def precision(self) -> Precision:
        return Precision(self._precision)

    @precision.setter
    def precision(self, value):
        self._precision = (
            value.value if isinstance(value, Precision) else value
        )

    @property
    def variant(self):
        if self._variant_type == VariantType.NO_DUPLICATES.value:
            return "NoDuplicates"
        return {
            "type": "Consistency",
            "max_lr_diff": self._max_lr_diff,
            "no_dupes": bool(self._no_dupes),
        }

    def set_no_duplicates(self):
        self._variant_type = VariantType.NO_DUPLICATES.value

    def set_consistency(self, max_lr_diff: int = 1, no_dupes: bool = False):
        self._variant_type = VariantType.CONSISTENCY.value
        self._max_lr_diff = max_lr_diff
        self._no_dupes = 1 if no_dupes else 0

    def __repr__(self):
        return "\n".join([
            "Config(",
            f"  nxcorr_threshold={self.nxcorr_threshold}",
            f"  subpixel_step={self.subpixel_step}",
            f"  min_variance={self.min_variance}",
            f"  mode={self.mode.name}",
            f"  precision={self.precision.name}",
            f"  variant={self.variant}",
            ")",
        ])

    def _to_native(self) -> _config.Config:
        """Translate to the engine Config with the C ABI's sentinel rules.

        Measured semantics (tests/test_reference_differential.py): a
        None/negative threshold keeps the C++ default 0.5f — convertConfig
        only assigns when the sentinel is >= 0 (pybicos_c.cpp:56-62,
        common.hpp:74) — so NXCORR is always on through this surface."""
        thr = self.nxcorr_threshold
        if thr is None or thr < 0:
            thr = 0.5
        if self._variant_type == VariantType.CONSISTENCY.value:
            variant = _config.Consistency(
                max_lr_diff=self._max_lr_diff, no_dupes=bool(self._no_dupes)
            )
        else:
            variant = _config.NoDuplicates()
        return _config.Config(
            nxcorr_threshold=thr,
            subpixel_step=self.subpixel_step,
            min_variance=self.min_variance,
            mode=_config.TransformMode(self._mode),
            precision=_config.Precision(self._precision),
            variant=variant,
        )


def match(
    stack0: Sequence[np.ndarray],
    stack1: Sequence[np.ndarray],
    cfg: Optional[Config] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """pybicos-compatible match: lists of 2-D images in, owned numpy arrays
    (disparity, corrmap) out.

    Matches the compiled CPU-build binding byte-for-byte (see the module
    docstring): a threshold is always in effect (the C ABI cannot clear the
    0.5 default), so the disparity is always float32 — a plain cast of the
    int16 map on the integer path (invalid stays -32768.0, cpu.cpp:88-94)
    or the subpixel float map (invalid NaN) — and the corrmap is always a
    real (H, W) float32 NXCORR map."""
    if (isinstance(stack0, (list, tuple)) and not stack0) or (
        isinstance(stack1, (list, tuple)) and not stack1
    ):
        raise ValueError("Empty image stacks")
    if cfg is None:
        cfg = Config()
    native = cfg._to_native()
    s0 = np.stack([np.ascontiguousarray(im) for im in stack0])
    s1 = np.stack([np.ascontiguousarray(im) for im in stack1])
    disp, corr = _pipeline.match(s0, s1, native, corrmap=True)
    return float_disparity(disp), np.asarray(corr)


def invalid_disparity(dtype):
    if dtype == np.float32:
        return float("nan")
    if dtype == np.int16:
        return np.int16(-32768)
    raise ValueError(f"Unsupported dtype for invalid_disparity: {dtype}")


def float_disparity(disparity) -> np.ndarray:
    """Reference-CPU-backend output convention (``cpu.cpp:88-94``).

    When a threshold is set without subpixel refinement, the reference CPU
    backend converts the int16 disparity to float32 via ``convertTo(CV_32F)``
    — a plain cast, so invalid pixels stay ``-32768.0f`` rather than becoming
    NaN (the float-invalid convention elsewhere). That sharp edge is the
    reference's own; :func:`match` above applies it by default (pinned
    against the compiled binding in tests/test_reference_differential.py).
    This helper remains for callers converting engine-native int16 output
    (``pipeline.match`` follows the CUDA backend, ``cuda.cu:457-458``) to
    the CPU-build convention. Float inputs (subpixel outputs) pass through
    unchanged.
    """
    d = np.asarray(disparity)
    if d.dtype == np.float32:
        return d
    return d.astype(np.float32)
