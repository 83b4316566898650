"""Contract of bench.py: it measures only on a GPU, and its one stdout line
names the device the number was taken on."""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

REPO = Path(__file__).resolve().parent.parent


def _run_bench(mode):
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "BICOS_BENCH_MODE": mode,
        "BICOS_BENCH_N": "5",
        "BICOS_BENCH_H": "16",
        "BICOS_BENCH_W": "32",
        "BICOS_BENCH_REPS": "2",
        "BICOS_BENCH_BATCH": "2",
    })
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p
    )
    return subprocess.run(
        [sys.executable, str(REPO / "bench.py")],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env,
    )


@pytest.mark.parametrize("mode", ["headline", "search", "batched"])
def test_bench_prints_one_json_line(mode):
    """On the CPU every mode refuses to measure: non-zero exit, no result
    line on stdout, and the platform it found on stderr."""
    proc = _run_bench(mode)
    assert proc.returncode != 0
    assert not proc.stdout.strip(), proc.stdout
    assert "needs a GPU" in proc.stderr and "'cpu'" in proc.stderr


def test_bench_record_carries_device_fields():
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench_main",
                                                  REPO / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)

    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    rec = bench.result_record("m", 1.5, "ms", 2.0, [dev, dev],
                              "NVIDIA H100 80GB HBM3, 700.00 W")
    assert json.loads(json.dumps(rec)) == {
        "metric": "m", "value": 1.5, "unit": "ms", "vs_baseline": 2.0,
        "platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
        "device_count": 2, "card": "NVIDIA H100 80GB HBM3, 700.00 W",
    }
