"""Engine choice, packing width, the compile-cache helper and the chip
smoke script's refusal to run without a GPU — all on the CPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import libbicos_jax as bicos
from libbicos_jax import compile_cache, search
from libbicos_jax.cli import build_parser

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name, want", [
    ("auto", "xla"), ("xla", "xla"), ("triton_interpret", "triton_interpret"),
])
def test_resolve_backend_on_cpu(name, want):
    assert search.resolve_backend(name) == want


@pytest.mark.parametrize("name", ["triton", "pallas", "gpu", ""])
def test_resolve_backend_rejects(name):
    """The GPU kernels need a GPU (no silent interpret fallback), and
    unknown names are errors."""
    with pytest.raises(ValueError):
        search.resolve_backend(name)


def test_match_triton_on_cpu_raises():
    s = np.zeros((4, 2, 8), np.uint8)
    with pytest.raises(ValueError, match="triton"):
        bicos.match(s, s, bicos.Config(), backend="triton")


def test_cli_backend_choices():
    p = build_parser()
    assert p.parse_args(["d", "--backend", "triton"]).backend == "triton"
    with pytest.raises(SystemExit):
        p.parse_args(["d", "--backend", "pallas"])


@pytest.mark.parametrize("w, k", [
    (1, 32768), (3300, 32768), (32768, 32768), (32769, 65536),
    (1 << 22, 1 << 22),
])
def test_pack_width(w, k):
    assert search.pack_width(w) == k


def test_pack_width_overflow():
    with pytest.raises(ValueError, match="overflows"):
        search.pack_width((1 << 22) + 1)


@pytest.mark.parametrize("w", [64, 65, 200])
def test_kernel_planes_padding(w):
    """The kernel route pads both rows to the tile width and slices the
    minima back: same shapes and values as the XLA scan."""
    from libbicos_jax import descriptor

    rng = np.random.default_rng(w)
    s = rng.integers(0, 256, (5, 2, w), dtype=np.uint8)
    words = descriptor.descriptor_words(s, bicos.TransformMode.LIMITED)
    got = search.row_minima_triton_words(words, words, True, interpret=True)
    want = search.row_minima_xla_words(words, words, True)
    for g, x in zip(got, want):
        assert g.shape == x.shape == (2, w)
        np.testing.assert_array_equal(np.asarray(g), np.asarray(x))


def test_compile_cache_env_set(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the only cache: the helper
    returns it and sets nothing."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_env_unset(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _run_smoke(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("args", [(), ("--four",)])
def test_chip_smoke_refuses_cpu(args):
    proc = _run_smoke(REPO, *args)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs a GPU" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Without the repository beside it the script cannot pass."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
