"""docs/API.md drift guard: every dotted API path named in the reference
doc must resolve against the installed package, so the doc can't rot as
modules evolve."""

import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

# First components that map into libbicos_jax.<module>; other prefixes
# (np, jax, cv, data paths, reference file citations) are not ours to check.
MODULES = {
    "descriptor", "search", "agree", "io", "sharding", "profiling",
    "kernels", "pipeline", "config", "serve", "client", "native",
    "pybicos_compat", "cli", "compile_cache",
}


def _resolve(path: str) -> bool:
    import libbicos_jax

    obj = libbicos_jax
    for part in path.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            # Submodules aren't imported by the package root; import on
            # demand (e.g. kernels.scan, serve, client).
            import importlib

            try:
                obj = importlib.import_module(
                    "libbicos_jax." + path[: path.index(part) + len(part)]
                )
            except ImportError:
                return False
    return True


def _doc_symbols():
    text = (REPO / "docs" / "API.md").read_text()
    # dotted names inside backticks, optionally with a call suffix
    exts = {"cpp", "cuh", "hpp", "cu", "h", "md", "py", "yaml", "sh", "so"}
    for m in re.finditer(r"`([A-Za-z_][\w.]*\.[A-Za-z_]\w*)\(?", text):
        name = m.group(1)
        if name.split(".")[-1] in exts:  # reference file citation, not API
            continue
        head = name.split(".")[0]
        if head == "bicos":
            yield name.split(".", 1)[1]
        elif head in MODULES:
            yield name


@pytest.mark.parametrize("symbol", sorted(set(_doc_symbols())))
def test_api_doc_symbol_exists(symbol):
    assert _resolve(symbol), f"docs/API.md names {symbol!r} which no longer exists"


def test_env_knobs_documented_exist():
    """Every BICOS_* env knob named in docs must be read somewhere in the
    package (and vice versa the doc should name the real spelling)."""
    text = (REPO / "docs" / "API.md").read_text()
    documented = set(re.findall(r"BICOS_[A-Z_0-9]+", text))
    used = set()
    for p in (REPO / "libbicos_jax").rglob("*.py"):
        used |= set(re.findall(r"environ\.get\(\"(BICOS_[A-Z_0-9]+)\"",
                               p.read_text()))
    missing = documented - used - {"BICOS_BENCH_MODE"}  # bench.py knob
    assert not missing, f"doc names unknown env knobs: {sorted(missing)}"
