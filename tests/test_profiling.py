"""Observability helpers: stage timings and metrics."""

import numpy as np

from libbicos_jax import Config, TransformMode
from libbicos_jax import profiling


def test_stage_timings(rng):
    from conftest import make_stack_pair

    s0, s1, _ = make_stack_pair(rng, 5, 6, 20)
    t = profiling.stage_timings(
        s0, s1, Config(nxcorr_threshold=0.5, subpixel_step=0.5),
        backend="xla",
    )
    assert set(t) == {"transform_ms", "search_ms", "agree_ms", "total_ms"}
    assert all(v >= 0 for v in t.values())


def test_metrics_int16():
    disp = np.full((4, 5), -32768, dtype=np.int16)
    disp[0, 0] = 3
    m = profiling.metrics(disp, elapsed_ms=10.0)
    assert m["valid_fraction"] == round(1 / 20, 4)
    assert m["latency_ms"] == 10.0
    assert m["mp_per_s"] >= 0


def test_metrics_float():
    disp = np.full((4, 5), np.nan, dtype=np.float32)
    disp[1, 1] = 2.5
    m = profiling.metrics(disp)
    assert m["valid_fraction"] == round(1 / 20, 4)
    assert "latency_ms" not in m


def test_emit(capsys):
    profiling.emit({"a": 1})
    assert capsys.readouterr().out.strip() == '{"a": 1}'
