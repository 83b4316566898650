"""Test configuration: force CPU with an 8-device virtual mesh so sharding
tests run anywhere (SURVEY.md section 4's multi-host simulation strategy).

Tests marked ``gpu`` need the card and take the ``gpu`` fixture, which
skips them elsewhere; on the card they run with
``BICOS_TEST_PLATFORM=gpu python -m pytest tests/test_gpu.py -m gpu`` (also
phase 7 of
``chip_smoke.py``)."""

import os

# Must be set before jax is imported anywhere. Force CPU even when the
# environment preselects another platform: the suite needs the 8-device
# virtual mesh. Set BICOS_TEST_PLATFORM=gpu to run the gpu-marked tests on
# the card.
if os.environ.get("BICOS_TEST_PLATFORM", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
# Otherwise JAX picks its platforms itself: the card first, and the CPU
# beside it for the gpu tests' comparisons.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
# Strict f32 on the CPU backend: with excess precision enabled (XLA's
# default), XLA CPU evaluates fused f32 regions in wider registers, so
# NXCORR values drift ulps away from the reference arithmetic.
import re as _re

# Strip ANY prior spelling (bare flag, =1, =true) — the exact-string
# replace this used to do let a bare `--xla_allow_excess_precision`
# survive and then suppressed the =false append.
flags = _re.sub(r"--xla_allow_excess_precision(=\S*)?", "", flags)
flags = (flags + " --xla_allow_excess_precision=false").strip()
os.environ["XLA_FLAGS"] = flags

import jax

if os.environ.get("JAX_PLATFORMS") == "cpu":
    # Pin the config directly too; must run before the backend initializes.
    jax.config.update("jax_platforms", "cpu")
    try:
        jax.config.update("jax_num_cpu_devices", 8)
    except Exception:  # pragma: no cover - older jax without the option
        pass

import numpy as np
import pytest


@pytest.fixture
def gpu():
    """The card, for tests marked ``gpu``; decided here (never at import)
    so that every xdist worker collects the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run BICOS_TEST_PLATFORM=gpu "
                    "python -m pytest tests/ -m gpu on the card")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(0x600DF00D)  # reference bench seed


def make_stack_pair(rng, n, h, w, dtype=np.uint8, max_disp=None):
    """Synthetic rectified projected-pattern stack pair with known disparity.

    The right stack is a column-shift of the left by a per-test disparity, so
    ground truth is known where the shift stays in-bounds.
    """
    if max_disp is None:
        max_disp = max(2, w // 8)
    hi = np.iinfo(dtype).max
    wide = w + max_disp
    pattern = rng.integers(0, hi + 1, size=(n, h, wide)).astype(dtype)
    disp = int(rng.integers(1, max_disp + 1))
    # Left sees pattern columns [disp, disp+w), right sees [0, w): a pixel at
    # left col c matches right col c+disp... i.e. disparity col0-col1 = -disp?
    # BICOS convention: d = col0 - col1, and left content at col0 equals
    # right content at col1 = col0 + disp here; flip so disparity is positive:
    left = pattern[:, :, disp : disp + w]
    right = pattern[:, :, 0:w]
    # left[c] == right[c + disp] -> col1 = col0 + disp -> d = -disp.
    # Swap to make d = +disp (left content shifted the other way):
    return np.ascontiguousarray(right), np.ascontiguousarray(left), disp


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Bound compile-cache memory across the suite.

    Every fresh (shape, config) jit is a new CPU executable; by the last
    modules the accumulated LLVM/XLA state reached the point where one
    more big compile SEGFAULTED the process (observed twice at the same
    suite position, 2026-08-21 — test_sharding passes in isolation). The
    open-ended fuzz soak clears caches every 50 trials for the same
    reason (tools/fuzz_soak.py); do it per test module here.
    """
    yield
    import jax

    jax.clear_caches()
