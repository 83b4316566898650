"""End-to-end pipeline parity with the oracle + property tests."""

import numpy as np
import pytest

import libbicos_jax as bicos
from libbicos_jax import _oracle as oracle
from conftest import make_stack_pair

CONFIGS = [
    bicos.Config(nxcorr_threshold=None),
    bicos.Config(nxcorr_threshold=0.5),
    bicos.Config(nxcorr_threshold=0.5, min_variance=1.0),
    bicos.Config(nxcorr_threshold=0.4, subpixel_step=0.25),
    bicos.Config(nxcorr_threshold=None, mode=bicos.TransformMode.FULL),
    bicos.Config(
        nxcorr_threshold=0.5,
        variant=bicos.Consistency(max_lr_diff=1, no_dupes=False),
    ),
    bicos.Config(
        nxcorr_threshold=0.5,
        subpixel_step=0.5,
        min_variance=2.0,
        variant=bicos.Consistency(max_lr_diff=2, no_dupes=True),
    ),
]


@pytest.mark.parametrize("cfg", CONFIGS)
def test_match_against_oracle(rng, cfg):
    n = 6 if cfg.mode == bicos.TransformMode.FULL else 8
    s0, s1, _ = make_stack_pair(rng, n, 4, 14)
    want_d, want_c = oracle.match(s0, s1, cfg)
    if cfg.nxcorr_threshold is None:
        got_d = bicos.match(s0, s1, cfg, backend="xla")
        np.testing.assert_array_equal(np.asarray(got_d), want_d)
        return
    got_d, got_c = bicos.match(s0, s1, cfg, corrmap=True, backend="xla")
    got_d, got_c = np.asarray(got_d), np.asarray(got_c)
    np.testing.assert_allclose(got_c, want_c, rtol=3e-5, atol=3e-5,
                               equal_nan=True)
    if cfg.subpixel_step is None:
        np.testing.assert_array_equal(got_d, want_d)
    else:
        both = ~(np.isnan(got_d) | np.isnan(want_d))
        assert (np.isnan(got_d) == np.isnan(want_d)).mean() > 0.97
        np.testing.assert_allclose(
            got_d[both], want_d[both], atol=cfg.subpixel_step + 1e-6
        )


def test_shift_invariance(rng):
    """Matching a stack against a column-shifted copy recovers the shift."""
    s0, s1, d = make_stack_pair(rng, 10, 6, 40)
    disp = np.asarray(bicos.match(s0, s1, bicos.Config(), backend="xla"))
    interior = disp[:, d:]
    valid = interior != -32768
    assert valid.mean() > 0.9
    np.testing.assert_array_equal(interior[valid], d)


def test_match_batched(rng):
    s0a, s1a, _ = make_stack_pair(rng, 6, 4, 12)
    s0b, s1b, _ = make_stack_pair(rng, 6, 4, 12)
    cfg = bicos.Config()
    batched = np.asarray(
        bicos.match_batched(
            np.stack([s0a, s0b]), np.stack([s1a, s1b]), cfg, backend="xla"
        )
    )
    single_a = np.asarray(bicos.match(s0a, s1a, cfg, backend="xla"))
    single_b = np.asarray(bicos.match(s0b, s1b, cfg, backend="xla"))
    np.testing.assert_array_equal(batched[0], single_a)
    np.testing.assert_array_equal(batched[1], single_b)


def test_match_batched_folded(rng):
    """Pre-folded (n, batch*H, W) staging (the serving/bench layout) must
    equal the (batch, n, H, W) entry and per-pair matches; bad row counts
    and odd-H pair boundaries mid-row-batch stay exact."""
    s0a, s1a, _ = make_stack_pair(rng, 6, 5, 12)  # H=5: boundaries mid-8
    s0b, s1b, _ = make_stack_pair(rng, 6, 5, 12)
    cfg = bicos.Config(nxcorr_threshold=0.5)
    flat0 = np.concatenate([s0a, s0b], axis=1)
    flat1 = np.concatenate([s1a, s1b], axis=1)
    folded = np.asarray(bicos.match_batched_folded(
        flat0, flat1, 2, cfg, backend="xla"))
    single_a = np.asarray(bicos.match(s0a, s1a, cfg, backend="xla"))
    single_b = np.asarray(bicos.match(s0b, s1b, cfg, backend="xla"))
    np.testing.assert_array_equal(folded[0], single_a)
    np.testing.assert_array_equal(folded[1], single_b)
    with pytest.raises(ValueError):
        bicos.match_batched_folded(flat0, flat1, 3, cfg, backend="xla")


def test_uint16_inputs(rng):
    s0, s1, _ = make_stack_pair(rng, 8, 4, 12, np.uint16)
    cfg = bicos.Config(nxcorr_threshold=0.5)
    want_d, _ = oracle.match(s0, s1, cfg)
    got_d = np.asarray(bicos.match(s0, s1, cfg, backend="xla"))
    np.testing.assert_array_equal(got_d, want_d)


def test_validation_errors(rng):
    s0, s1, _ = make_stack_pair(rng, 4, 4, 8)
    with pytest.raises(ValueError, match="at least two"):
        bicos.match(s0[:1], s1[:1], bicos.Config())
    with pytest.raises(ValueError, match="too large"):
        bicos.match(
            np.zeros((20, 4, 8), np.uint8),
            np.zeros((20, 4, 8), np.uint8),
            bicos.Config(mode=bicos.TransformMode.FULL),
        )
    with pytest.raises(ValueError, match="depths"):
        bicos.match(s0.astype(np.int16), s1.astype(np.int16), bicos.Config())
    with pytest.raises(ValueError, match="differ"):
        bicos.match(s0, s1[:, :, :4], bicos.Config())


def test_invalid_disparity_helpers():
    assert bicos.invalid_disparity(np.int16) == -32768
    assert np.isnan(bicos.invalid_disparity(np.float32))
    assert bicos.max_stacksize(bicos.TransformMode.LIMITED) == 65
    assert bicos.max_stacksize(bicos.TransformMode.FULL) == 16


def test_match_double_precision(rng):
    """Precision.DOUBLE runs NXCORR in f64 (common.hpp:60); the validity
    decisions must be at least as consistent as f32 and the corrmap must be
    finite where f32's is."""
    import numpy as np
    from conftest import make_stack_pair

    import libbicos_jax as bicos
    from libbicos_jax import Precision

    s0, s1, _ = make_stack_pair(rng, 5, 4, 20)
    d32, c32 = bicos.match(
        s0, s1, bicos.Config(nxcorr_threshold=0.5), corrmap=True,
        backend="xla")
    d64, c64 = bicos.match(
        s0, s1,
        bicos.Config(nxcorr_threshold=0.5, precision=Precision.DOUBLE),
        corrmap=True, backend="xla")
    c64 = np.asarray(c64)
    assert c64.dtype == np.float32  # corrmap surface stays f32
    # f64 and f32 NXCORR agree closely; validity identical on random data.
    m = ~np.isnan(np.asarray(c32))
    np.testing.assert_allclose(c64[m], np.asarray(c32)[m], atol=1e-5)
    np.testing.assert_array_equal(np.asarray(d64), np.asarray(d32))


def test_match_extreme_stack_sizes(rng):
    """n=2 (minimum, 4-bit descriptors) and n=65 (LIMITED maximum, 254 bits
    -> the 8-word lane path) through both backends."""
    import numpy as np
    from conftest import make_stack_pair

    import libbicos_jax as bicos
    from libbicos_jax.config import TransformMode, actual_bits, max_stacksize

    assert max_stacksize(TransformMode.LIMITED) == 65
    assert actual_bits(65, TransformMode.LIMITED) == 254
    for n in (2, 65):
        s0, s1, _ = make_stack_pair(rng, n, 3, 24)
        want = np.asarray(
            bicos.match(s0, s1, bicos.Config(nxcorr_threshold=None),
                        backend="xla"))
        got = np.asarray(
            bicos.match(s0, s1, bicos.Config(nxcorr_threshold=None),
                        backend="triton_interpret"))
        np.testing.assert_array_equal(got, want)


def test_match_rejects_oversized_stack(rng):
    import numpy as np
    import pytest as _pytest

    import libbicos_jax as bicos
    from libbicos_jax.config import TransformMode

    s = rng.integers(0, 255, (66, 3, 8), dtype=np.uint8)
    with _pytest.raises(ValueError, match="too large"):
        bicos.match(s, s, bicos.Config(mode=TransformMode.LIMITED))
    s17 = rng.integers(0, 255, (17, 3, 8), dtype=np.uint8)
    with _pytest.raises(ValueError, match="too large"):
        bicos.match(s17, s17, bicos.Config(mode=TransformMode.FULL))


def test_fuzz_random_configs():
    """Randomized config x shape x dtype draws vs the oracle (seeded).

    Broadens the fixed CONFIGS matrix: every field combination the
    reference accepts (common.hpp:73-82) should agree with the per-pixel
    oracle transcription, not just the hand-picked rows above.
    """
    fuzz = np.random.default_rng(0x600DF00D)
    for trial in range(10):
        mode = (bicos.TransformMode.FULL if fuzz.integers(2)
                else bicos.TransformMode.LIMITED)
        n = int(fuzz.integers(3, 8 if mode == bicos.TransformMode.FULL
                              else 10))
        h = int(fuzz.integers(3, 7))
        w = int(fuzz.integers(10, 19))
        dtype = np.uint16 if fuzz.integers(4) == 0 else np.uint8
        threshold = (None if fuzz.integers(3) == 0
                     else float(fuzz.uniform(0.2, 0.9)))
        step = (float(fuzz.choice([0.5, 0.25, 0.2]))
                if threshold is not None and fuzz.integers(2) else None)
        minvar = (float(fuzz.uniform(0.0, 3.0))
                  if threshold is not None and fuzz.integers(2) else None)
        if fuzz.integers(2):
            variant = bicos.Consistency(
                max_lr_diff=int(fuzz.integers(1, 4)),
                no_dupes=bool(fuzz.integers(2)),
            )
        else:
            variant = bicos.NoDuplicates()
        cfg = bicos.Config(
            nxcorr_threshold=threshold, subpixel_step=step,
            min_variance=minvar, mode=mode, variant=variant,
        )
        s0, s1, _ = make_stack_pair(fuzz, n, h, w, dtype)
        ctx = f"trial={trial} cfg={cfg} n={n} {h}x{w} {dtype.__name__}"
        want_d, want_c = oracle.match(s0, s1, cfg)
        if threshold is None:
            got_d = bicos.match(s0, s1, cfg, backend="xla")
            np.testing.assert_array_equal(np.asarray(got_d), want_d, ctx)
            continue
        got_d, got_c = bicos.match(s0, s1, cfg, corrmap=True, backend="xla")
        got_d, got_c = np.asarray(got_d), np.asarray(got_c)
        np.testing.assert_allclose(
            got_c, want_c, rtol=3e-5, atol=3e-5, equal_nan=True,
            err_msg=ctx)
        if step is None:
            np.testing.assert_array_equal(got_d, want_d, ctx)
        else:
            assert (np.isnan(got_d) == np.isnan(want_d)).mean() > 0.97, ctx
            both = ~(np.isnan(got_d) | np.isnan(want_d))
            np.testing.assert_allclose(
                got_d[both], want_d[both], atol=step + 1e-6, err_msg=ctx)


def test_fuzz_random_configs_pallas():
    """Same randomized draw protocol through the GPU kernel pipeline
    (interpret mode): the kernel path must agree with the oracle across the
    config matrix, not just on the hand-picked kernel tests."""
    fuzz = np.random.default_rng(0xB1C05)
    for trial in range(4):
        mode = (bicos.TransformMode.FULL if fuzz.integers(2)
                else bicos.TransformMode.LIMITED)
        n = int(fuzz.integers(4, 8 if mode == bicos.TransformMode.FULL
                              else 12))
        h = int(fuzz.integers(3, 6))
        w = int(fuzz.integers(10, 17))
        dtype = np.uint16 if fuzz.integers(4) == 0 else np.uint8
        threshold = (None if fuzz.integers(3) == 0
                     else float(fuzz.uniform(0.2, 0.9)))
        step = (0.25 if threshold is not None and fuzz.integers(2) else None)
        if fuzz.integers(2):
            variant = bicos.Consistency(
                max_lr_diff=int(fuzz.integers(1, 3)),
                no_dupes=bool(fuzz.integers(2)),
            )
        else:
            variant = bicos.NoDuplicates()
        cfg = bicos.Config(
            nxcorr_threshold=threshold, subpixel_step=step,
            min_variance=(1.0 if threshold is not None else None),
            mode=mode, variant=variant,
        )
        s0, s1, _ = make_stack_pair(fuzz, n, h, w, dtype)
        ctx = f"trial={trial} cfg={cfg} n={n} {h}x{w} {dtype.__name__}"
        want_d, want_c = oracle.match(s0, s1, cfg)
        if threshold is None:
            got_d = bicos.match(s0, s1, cfg, backend="triton_interpret")
            np.testing.assert_array_equal(np.asarray(got_d), want_d, ctx)
            continue
        got_d, got_c = bicos.match(
            s0, s1, cfg, corrmap=True, backend="triton_interpret")
        got_d, got_c = np.asarray(got_d), np.asarray(got_c)
        np.testing.assert_allclose(
            got_c, want_c, rtol=3e-5, atol=3e-5, equal_nan=True, err_msg=ctx)
        inv_w = np.isnan(want_d) if want_d.dtype.kind == "f" else (
            want_d == -32768)
        inv_g = np.isnan(got_d) if got_d.dtype.kind == "f" else (
            got_d == -32768)
        np.testing.assert_array_equal(inv_g, inv_w, ctx)
        if want_d.dtype.kind == "f":
            np.testing.assert_allclose(
                got_d[~inv_g], want_d[~inv_w], atol=1e-5, err_msg=ctx)
        else:
            np.testing.assert_array_equal(got_d, want_d, ctx)
