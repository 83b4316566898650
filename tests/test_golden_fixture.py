"""Committed-fixture regression gate.

The reference's integration benches run on its downloadable `data/` stacks
(bench/cuda.cu:297-323) with a >=99%-agreement acceptance gate
(BASELINE.md); that dataset cannot be vendored here, so this pins the same
kind of end-to-end contract on a committed fixture instead: a fixed
projected-pattern stack pair (PNGs, bit-exact forever) with GOLDEN outputs
produced by the oracle transcription at fixture-creation time. Unlike the
oracle-parity tests (which recompute the oracle and would drift along with
it), this catches any behavior change in EITHER the pipeline or the oracle
since the goldens were frozen.
"""

from pathlib import Path

import numpy as np
import pytest

import libbicos_jax as bicos

FIX = Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def stack():
    cv2 = pytest.importorskip("cv2")
    s0, s1 = [], []
    for i in range(9):
        s0.append(cv2.imread(str(FIX / "stack" / f"{i}_left.png"),
                             cv2.IMREAD_GRAYSCALE))
        s1.append(cv2.imread(str(FIX / "stack" / f"{i}_right.png"),
                             cv2.IMREAD_GRAYSCALE))
    return np.stack(s0), np.stack(s1)


def test_golden_subpixel(stack):
    s0, s1 = stack
    g = np.load(FIX / "golden.npz")
    cfg = bicos.Config(nxcorr_threshold=0.7, subpixel_step=0.25,
                       min_variance=1.0, mode=bicos.TransformMode.LIMITED)
    for backend in ("xla", "triton_interpret"):
        d, c = bicos.match(s0, s1, cfg, corrmap=True, backend=backend)
        d = np.asarray(d)
        want = g["d_sub"]
        assert (np.isnan(d) == np.isnan(want)).all()
        m = ~np.isnan(want)
        np.testing.assert_array_equal(d[m], want[m])
        c = np.asarray(c)
        wc = g["c_sub"]
        assert (np.isnan(c) == np.isnan(wc)).all()
        np.testing.assert_allclose(c[~np.isnan(wc)], wc[~np.isnan(wc)],
                                   rtol=4e-6, atol=4e-6)


def test_golden_integer_consistency(stack):
    s0, s1 = stack
    g = np.load(FIX / "golden.npz")
    cfg = bicos.Config(
        nxcorr_threshold=0.5,
        variant=bicos.Consistency(max_lr_diff=1, no_dupes=True))
    for backend in ("xla", "triton_interpret"):
        d = np.asarray(bicos.match(s0, s1, cfg, backend=backend))
        np.testing.assert_array_equal(d, g["d_int"])


def test_golden_ground_truth_agreement(stack):
    """>=99% agreement with the scene's true disparity on valid pixels
    (the BASELINE.md acceptance gate, on the committed fixture)."""
    s0, s1 = stack
    true_d = np.load(FIX / "true_disp.npy")
    cfg = bicos.Config(nxcorr_threshold=0.5,
                       mode=bicos.TransformMode.LIMITED)
    d = np.asarray(bicos.match(s0, s1, cfg, backend="xla"))
    valid = d != -32768
    interior = valid.copy()
    interior[:, : int(true_d.max())] = False  # shift-out-of-frame band
    agree = (d[interior] == true_d[interior]).mean()
    assert agree >= 0.99, f"ground-truth agreement {agree:.4f} < 0.99"
