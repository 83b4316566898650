"""Regression tests for the driver contract in ``__graft_entry__.py``.

``entry()`` is compile-checked on one device and ``dryrun_multichip(N)``
runs on a virtual N-device CPU mesh; a refactor that breaks either is
otherwise easy to miss. These tests exercise both under the suite's own
8-device CPU mesh (conftest.py).
"""

import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import __graft_entry__ as graft  # noqa: E402


def test_entry_compiles_and_runs():
    fn, args = graft.entry()
    compiled = jax.jit(fn).lower(*args).compile()
    disp, corr = compiled(*args)
    n, h, w = args[0].shape
    assert disp.shape == (h, w) and corr.shape == (h, w)
    assert disp.dtype == np.int16
    # Random-noise pair: some pixels survive, and the corrmap is finite at
    # least wherever the disparity is valid (NaN elsewhere by design).
    disp, corr = np.asarray(disp), np.asarray(corr)
    valid = disp != np.int16(-32768)
    assert valid.any()
    assert bool(np.isfinite(corr[valid]).all())


@pytest.mark.skipif(
    os.environ.get("BICOS_TEST_PLATFORM", "cpu") != "cpu",
    reason="dryrun_multichip pins jax_platforms='cpu' process-globally, which "
    "conflicts with running the suite on a real platform (BICOS_TEST_PLATFORM)",
)
def test_dryrun_multichip_8():
    # Includes internal exact-equality asserts: W-band ring vs single-device
    # minima, H-/W-banded and batched pipelines vs the unsharded match.
    graft.dryrun_multichip(8)
