"""libbicos_jax — a JAX BInary COrrespondence Search engine.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of libBICOS
(multishot stereo correspondence search; reference implementation surveyed in
SURVEY.md). The compute path is jitted JAX; on a GPU, Pallas kernels
(Triton route) take the Hamming-argmin scan and the NXCORR sweep; scale-out
uses ``jax.sharding`` meshes.

Public surface::

    import libbicos_jax as bicos
    disp = bicos.match(stack0, stack1, bicos.Config(...))
    disp, corr = bicos.match(stack0, stack1, cfg, corrmap=True)
"""

from .config import (
    Config,
    Consistency,
    INVALID_DISP_FLOAT,
    INVALID_DISP_INT16,
    MAX_BITS,
    NoDuplicates,
    Precision,
    TransformMode,
    invalid_disparity,
    is_invalid,
    max_stacksize,
    required_bits,
)
from .pipeline import match, match_batched, match_batched_folded

__version__ = "0.1.0"

__all__ = [
    "Config",
    "Consistency",
    "INVALID_DISP_FLOAT",
    "INVALID_DISP_INT16",
    "MAX_BITS",
    "NoDuplicates",
    "Precision",
    "TransformMode",
    "invalid_disparity",
    "is_invalid",
    "match",
    "match_batched",
    "match_batched_folded",
    "max_stacksize",
    "required_bits",
    "__version__",
]
