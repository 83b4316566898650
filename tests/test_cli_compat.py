"""CLI flag mapping (reference cli.cpp:137-166 parity) + pybicos_compat."""

import numpy as np
import pytest

from libbicos_jax import Config, Consistency, NoDuplicates, Precision, TransformMode
from libbicos_jax.cli import build_parser, config_from_args


def _cfg(argv):
    args = build_parser().parse_args(["folder"] + argv)
    return config_from_args(args)


def test_cli_defaults_differ_from_library():
    cfg = _cfg([])
    assert cfg.nxcorr_threshold == 0.75  # cli.cpp:63 (library: 0.5)
    assert cfg.mode == TransformMode.FULL  # cli.cpp:139 (library: LIMITED)
    # The reference's default_value("1.0") is never APPLIED unless -v is
    # explicitly passed (cli.cpp:158-160 guards on args.count("variance"),
    # 0 for a cxxopts default) — default runs have no variance prefilter.
    assert cfg.min_variance is None
    assert isinstance(cfg.variant, NoDuplicates)
    lib = Config()
    assert lib.nxcorr_threshold == 0.5
    assert lib.mode == TransformMode.LIMITED


def test_cli_threshold_zero_disables():
    cfg = _cfg(["-t", "0"])
    assert cfg.nxcorr_threshold is None


def test_cli_corrmap_forces_threshold():
    cfg = _cfg(["-t", "0", "--corrmap"])
    assert cfg.nxcorr_threshold == -1.0  # cli.cpp:146-149


def test_cli_lr_maxdiff_selects_consistency():
    cfg = _cfg(["-m", "3"])
    assert cfg.variant == Consistency(max_lr_diff=3, no_dupes=False)
    cfg = _cfg(["-m", "3", "--no-dupes"])
    assert cfg.variant == Consistency(max_lr_diff=3, no_dupes=True)


def test_cli_limited_and_double():
    cfg = _cfg(["--limited", "--double"])
    assert cfg.mode == TransformMode.LIMITED
    assert cfg.precision == Precision.DOUBLE


def test_cli_variance_nonpositive_disables():
    cfg = _cfg(["-v", "0"])
    assert cfg.min_variance is None


def test_cli_end_to_end(tmp_path, rng):
    cv2 = pytest.importorskip("cv2")
    from libbicos_jax.cli import main
    from libbicos_jax.io import synthetic_stack_pair

    s0, s1, _ = synthetic_stack_pair(5, 8, 24, seed=3)
    d = tmp_path / "imgs"
    d.mkdir()
    for i in range(5):
        cv2.imwrite(str(d / f"{i}_left.png"), s0[i])
        cv2.imwrite(str(d / f"{i}_right.png"), s1[i])
    q = tmp_path / "Q.yaml"
    fs = cv2.FileStorage(str(q), cv2.FILE_STORAGE_WRITE)
    fs.write("Q", np.eye(4))
    fs.release()
    out = tmp_path / "disp.png"
    rc = main([str(d), "-o", str(out), "-t", "0.5", "--limited", "--corrmap",
               "-q", str(q), "--backend", "xla"])
    assert rc == 0
    assert out.exists()
    assert (tmp_path / "disp.tiff").exists()
    assert (tmp_path / "disp-corrmap.png").exists()
    assert (tmp_path / "disp.xyz").exists()


def test_pybicos_compat_match(rng):
    from conftest import make_stack_pair

    import libbicos_jax as bicos
    import libbicos_jax.pybicos_compat as pybicos

    s0, s1, _ = make_stack_pair(rng, 5, 6, 20)
    cfg = pybicos.Config()
    assert cfg.nxcorr_threshold == 0.5
    assert cfg.mode == pybicos.TransformMode.LIMITED
    assert cfg.variant == "NoDuplicates"
    disp, corr = pybicos.match(list(s0), list(s1), cfg)
    assert disp.shape == (6, 20) and corr.shape == (6, 20)
    # CPU-build binding contract: float32 disparity, invalid stays -32768.0
    # (cpu.cpp:88-94 convertTo cast; tests/test_reference_differential.py).
    assert disp.dtype == np.float32
    want_d, want_c = bicos.match(
        s0, s1, bicos.Config(), corrmap=True, backend="xla"
    )
    np.testing.assert_array_equal(disp, np.asarray(want_d).astype(np.float32))
    np.testing.assert_array_equal(corr, np.asarray(want_c))


def test_pybicos_compat_negative_threshold_keeps_default(rng):
    """A negative threshold does NOT disable NXCORR through the C ABI:
    convertConfig only assigns when >= 0 (pybicos_c.cpp:56-62), leaving the
    C++ default 0.5f (common.hpp:74) — measured against the compiled binding
    in tests/test_reference_differential.py."""
    from conftest import make_stack_pair

    import libbicos_jax as bicos
    import libbicos_jax.pybicos_compat as pybicos

    s0, s1, _ = make_stack_pair(rng, 5, 4, 16)
    cfg = pybicos.Config()
    cfg.nxcorr_threshold = -1.0  # sentinel: keeps the 0.5 default
    disp, corr = pybicos.match(list(s0), list(s1), cfg)
    assert corr.shape == disp.shape and disp.dtype == np.float32
    want_d, want_c = bicos.match(
        s0, s1, bicos.Config(nxcorr_threshold=0.5), corrmap=True,
        backend="xla")
    np.testing.assert_array_equal(disp, np.asarray(want_d).astype(np.float32))
    np.testing.assert_array_equal(corr, np.asarray(want_c))


def test_pybicos_compat_consistency(rng):
    from conftest import make_stack_pair

    import libbicos_jax as bicos
    import libbicos_jax.pybicos_compat as pybicos

    s0, s1, _ = make_stack_pair(rng, 5, 4, 16)
    cfg = pybicos.Config()
    cfg.set_consistency(max_lr_diff=2, no_dupes=True)
    disp, _ = pybicos.match(list(s0), list(s1), cfg)
    want, _ = bicos.match(
        s0, s1,
        bicos.Config(variant=bicos.Consistency(max_lr_diff=2, no_dupes=True)),
        corrmap=True, backend="xla",
    )
    np.testing.assert_array_equal(disp, np.asarray(want))


def test_pybicos_invalid_disparity():
    import libbicos_jax.pybicos_compat as pybicos

    assert np.isnan(pybicos.invalid_disparity(np.float32))
    assert pybicos.invalid_disparity(np.int16) == -32768


def test_cli_dump_descriptors(tmp_path, rng):
    """--dump-descriptors writes both stacks' packed words (debug artifact)."""
    import numpy as np
    from conftest import make_stack_pair
    from libbicos_jax import TransformMode, descriptor
    from libbicos_jax.cli import main
    import cv2

    s0, s1, _ = make_stack_pair(rng, 4, 6, 24)
    d = tmp_path / "imgs"
    d.mkdir()
    for i in range(4):
        cv2.imwrite(str(d / f"{i}_left.png"), np.asarray(s0[i]))
        cv2.imwrite(str(d / f"{i}_right.png"), np.asarray(s1[i]))
    npz = tmp_path / "desc.npz"
    rc = main([str(d), "-t", "0.5", "--limited",
               "-o", str(tmp_path / "disp.png"),
               "--dump-descriptors", str(npz)])
    assert rc == 0 and npz.exists()
    data = np.load(npz)
    want = np.asarray(descriptor.descriptor_words(s0, TransformMode.LIMITED))
    np.testing.assert_array_equal(data["words0"], want)


@pytest.mark.parametrize("shard_axis", ["rows", "cols"])
def test_cli_sharded_matches_unsharded(tmp_path, rng, shard_axis):
    """--devices N (both H- and W-banding) must reproduce the single-device
    CLI output exactly (extension flags over the reference surface)."""
    cv2 = pytest.importorskip("cv2")
    from libbicos_jax.cli import main
    from libbicos_jax.io import synthetic_stack_pair

    s0, s1, _ = synthetic_stack_pair(5, 8, 24, seed=7)
    d = tmp_path / "imgs"
    d.mkdir()
    for i in range(5):
        cv2.imwrite(str(d / f"{i}_left.png"), s0[i])
        cv2.imwrite(str(d / f"{i}_right.png"), s1[i])
    base = [str(d), "-t", "0.5", "--limited", "--backend", "xla"]
    ref = tmp_path / "ref.png"
    assert main(base + ["-o", str(ref)]) == 0
    out = tmp_path / "sharded.png"
    assert main(base + ["-o", str(out), "--devices", "2",
                        "--shard-axis", shard_axis]) == 0
    a = cv2.imread(str(tmp_path / "ref.tiff"), cv2.IMREAD_ANYDEPTH)
    b = cv2.imread(str(tmp_path / "sharded.tiff"), cv2.IMREAD_ANYDEPTH)
    np.testing.assert_array_equal(a, b)


def test_cli_prints_license_banner(capsys):
    """The reference CLI always prints its LGPL banner first
    (cli.cpp:49-53,91); ours does the same before touching the inputs."""
    from libbicos_jax.cli import LICENSE_HEADER, main

    with pytest.raises((FileNotFoundError, NotADirectoryError)):
        main(["/nonexistent-bicos-folder"])
    out = capsys.readouterr()
    assert LICENSE_HEADER in out.out
    assert "stable CLI interface" in out.err


def test_pybicos_compat_float_disparity(rng):
    """float_disparity reproduces the reference CPU backend's convertTo
    (cpu.cpp:88-94): plain int16 -> float32 cast, invalid stays -32768.0f
    (NOT NaN — the reference's own quirk); float inputs pass through."""
    from conftest import make_stack_pair

    import libbicos_jax as bicos
    import libbicos_jax.pybicos_compat as pybicos

    s0, s1, _ = make_stack_pair(rng, 5, 4, 16)
    disp = np.asarray(bicos.match(
        s0, s1, bicos.Config(nxcorr_threshold=0.5), backend="xla"))
    assert disp.dtype == np.int16
    f = pybicos.float_disparity(disp)
    assert f.dtype == np.float32
    np.testing.assert_array_equal(f, disp.astype(np.float32))
    assert (f[disp == -32768] == -32768.0).all()
    assert not np.isnan(f).any()
    sub = np.full((2, 2), np.nan, np.float32)
    assert pybicos.float_disparity(sub) is not None
    np.testing.assert_array_equal(
        np.isnan(pybicos.float_disparity(sub)), np.isnan(sub))


def test_cli_variance_explicit_sets():
    cfg = _cfg(["-v", "2.5"])
    assert cfg.min_variance == 2.5


def test_cli_rejects_negative_uint_flags(capsys):
    """-m and -n are uint in the reference (cli.cpp:67,70): cxxopts rejects
    negatives at parse time. Without the guard, -m -1 silently invalidates
    every pixel and -n -2 silently drops trailing images."""
    for argv in (["folder", "-m", "-1"], ["folder", "-n", "-2"]):
        with pytest.raises(SystemExit):
            build_parser().parse_args(argv)
        capsys.readouterr()
