"""Serving daemon: warm-engine HTTP service (libbicos_jax/serve.py)."""

import io
import json
import socket
import threading
import urllib.request

import numpy as np
import pytest

import libbicos_jax as bicos
from libbicos_jax.config import Consistency
from libbicos_jax.serve import Engine, serve


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def server():
    port = _free_port()
    engine = Engine(
        bicos.Config(nxcorr_threshold=0.5, min_variance=1.0),
        backend="xla",
    )
    ready = threading.Event()
    t = threading.Thread(
        target=serve,
        args=(engine, "127.0.0.1", port),
        kwargs={"warmup_shapes": [((4, 8, 24), "uint8")],
                "ready_event": ready},
        daemon=True,
    )
    t.start()
    assert ready.wait(120), "server failed to start"
    assert engine.compiled_count == 1  # warmup compiled before serving
    return f"http://127.0.0.1:{port}", engine


def _post(url: str, body: bytes, ctype: str = "application/npz"):
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _stacks(rng, n=4, h=8, w=24):
    s0 = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    s1 = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    return s0, s1


def test_healthz(server):
    base, engine = server
    with urllib.request.urlopen(base + "/healthz") as resp:
        obj = json.loads(resp.read())
    assert obj["status"] == "ok"
    assert obj["compiled"] == engine.compiled_count >= 1


def test_match_roundtrip(server, rng):
    base, _ = server
    s0, s1 = _stacks(rng)
    status, body = _post(base + "/match", _npz(stack0=s0, stack1=s1))
    assert status == 200
    out = np.load(io.BytesIO(body))
    want = np.asarray(bicos.match(
        s0, s1,
        bicos.Config(nxcorr_threshold=0.5, min_variance=1.0),
        backend="xla",
    ))
    np.testing.assert_array_equal(out["disparity"], want)


def test_match_param_overrides(server, rng):
    base, _ = server
    s0, s1 = _stacks(rng)
    status, body = _post(
        base + "/match?threshold=0.4&lr_maxdiff=1&no_dupes=1&corrmap=1",
        _npz(stack0=s0, stack1=s1),
    )
    assert status == 200
    out = np.load(io.BytesIO(body))
    cfg = bicos.Config(
        nxcorr_threshold=0.4, min_variance=1.0,
        variant=Consistency(1, True),
    )
    wd, wc = bicos.match(s0, s1, cfg, corrmap=True, backend="xla")
    np.testing.assert_array_equal(out["disparity"], np.asarray(wd))
    np.testing.assert_array_equal(out["corrmap"], np.asarray(wc))


def test_match_threshold_zero_disables_nxcorr(server, rng):
    base, _ = server
    s0, s1 = _stacks(rng)
    status, body = _post(
        base + "/match?threshold=0", _npz(stack0=s0, stack1=s1))
    assert status == 200
    out = np.load(io.BytesIO(body))
    want = np.asarray(bicos.match(
        s0, s1, bicos.Config(nxcorr_threshold=None, min_variance=1.0),
        backend="xla",
    ))
    np.testing.assert_array_equal(out["disparity"], want)


def test_bad_requests(server, rng):
    base, _ = server
    status, body = _post(base + "/match", _npz(stack0=np.zeros((2, 4, 8))))
    assert status == 400  # missing stack1
    assert b"error" in body
    # invalid stacks (n=1 < minimum) -> clean 400, server keeps serving
    s0 = np.zeros((1, 4, 8), dtype=np.uint8)
    status, _ = _post(base + "/match", _npz(stack0=s0, stack1=s0))
    assert status == 400
    s0, s1 = _stacks(rng)
    status, _ = _post(base + "/match", _npz(stack0=s0, stack1=s1))
    assert status == 200
    status, _ = _post(base + "/nope", b"")
    assert status == 404


def test_batched_shape_mismatch_rejected(server, rng):
    """Mismatched 4-d pairs whose batch*H products coincide must be a 400:
    the host-side fold runs BEFORE match_batched_folded's flat checks,
    which a (2,n,8,W)-vs-(4,n,4,W) pair would pass — silently pairing rows
    of different images (Engine.match validates pre-fold)."""
    base, _ = server
    s0, s1 = _stacks(rng)  # (4, 8, 24)
    b0 = np.stack([s0, s0])                      # (2, 4, 8, 24)
    b1 = np.stack([s1[:, :4], s1[:, 4:],
                   s1[:, :4] ^ 1, s1[:, 4:] ^ 1])  # (4, 4, 4, 24)
    assert b0.size == b1.size
    status, body = _post(base + "/match", _npz(stack0=b0, stack1=b1))
    assert status == 400
    assert b"identical" in body
    # 4-d left with 3-d right is a mismatch too, not a silent broadcast.
    status, _ = _post(base + "/match", _npz(stack0=b0, stack1=s1))
    assert status == 400


def test_warmup_endpoint(server):
    base, engine = server
    before = engine.compiled_count
    status, body = _post(base + "/warmup?shape=4x6x16&dtype=u8", b"")
    assert status == 200
    assert json.loads(body)["compiled"] == before + 1


def test_parse_warmup_validates():
    from libbicos_jax.serve import _parse_warmup

    assert _parse_warmup("4x8x24") == ((4, 8, 24), "uint8")
    assert _parse_warmup("4x8x24:uint16") == ((4, 8, 24), "uint16")
    with pytest.raises(ValueError, match="dtype"):
        _parse_warmup("4x8x24:float32")
    with pytest.raises(ValueError, match="NxHxW"):
        _parse_warmup("4x8")


def test_warmup_endpoint_rejects_bad_dtype(server):
    base, _ = server
    status, body = _post(base + "/warmup?shape=4x6x16&dtype=f32", b"")
    assert status == 400
    assert b"dtype" in body


def test_client_roundtrip(server, rng):
    from libbicos_jax.client import BicosClient, ServerError

    base, engine = server
    c = BicosClient(base, timeout=60)
    assert c.healthz()["status"] == "ok"
    s0, s1 = _stacks(rng)
    disp = c.match(s0, s1)
    want = np.asarray(bicos.match(
        s0, s1, bicos.Config(nxcorr_threshold=0.5, min_variance=1.0),
        backend="xla"))
    np.testing.assert_array_equal(disp, want)
    # overrides + corrmap path
    d2, corr = c.match(s0, s1, corrmap=True, threshold=0.4)
    wd, wc = bicos.match(
        s0, s1, bicos.Config(nxcorr_threshold=0.4, min_variance=1.0),
        corrmap=True, backend="xla")
    np.testing.assert_array_equal(d2, np.asarray(wd))
    np.testing.assert_array_equal(corr, np.asarray(wc))
    # warmup + clean server errors
    before = engine.compiled_count
    assert c.warmup((4, 5, 16)) == before + 1
    with pytest.raises(ServerError, match="dtype"):
        c.warmup((4, 5, 16), dtype="f64")


def test_engine_sharded_mesh(rng):
    """Engine with a mesh dispatches through match_sharded."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 devices")
    from libbicos_jax.sharding import make_mesh

    cfg = bicos.Config(nxcorr_threshold=0.5)
    engine = Engine(cfg, backend="xla", mesh=make_mesh(4))
    s0, s1 = _stacks(rng, 4, 10, 24)
    got = engine.match(s0, s1)
    want = np.asarray(bicos.match(s0, s1, cfg, backend="xla"))
    np.testing.assert_array_equal(got, want)


def test_match_corrmap_without_threshold(server, rng):
    """corrmap with thresholding disabled must serve: the CLI's 'corrmap
    forces threshold -1' rule (cli.cpp:146-149) applies to query params
    too — previously this combination 400'd as unservable."""
    base, _ = server
    s0, s1 = _stacks(rng)
    status, body = _post(
        base + "/match?threshold=0&corrmap=1", _npz(stack0=s0, stack1=s1))
    assert status == 200
    out = np.load(io.BytesIO(body))
    want_d, want_c = bicos.match(
        s0, s1, bicos.Config(nxcorr_threshold=-1.0, min_variance=1.0),
        corrmap=True, backend="xla",
    )
    np.testing.assert_array_equal(out["disparity"], np.asarray(want_d))
    np.testing.assert_array_equal(out["corrmap"], np.asarray(want_c))


def test_bool_params_accept_python_spellings(server, rng):
    """?limited=False (str(False) from a hand-rolled client) must NOT flip
    the flag on; same for no_dupes/corrmap."""
    base, _ = server
    s0, s1 = _stacks(rng)
    status, body = _post(
        base + "/match?limited=False&corrmap=False",
        _npz(stack0=s0, stack1=s1))
    assert status == 200
    out = np.load(io.BytesIO(body))
    assert "corrmap" not in out.files  # corrmap=False honored
    from libbicos_jax.config import TransformMode

    want = np.asarray(bicos.match(
        s0, s1, bicos.Config(nxcorr_threshold=0.5, min_variance=1.0,
                             mode=TransformMode.FULL),
        backend="xla",
    ))  # limited=False forces FULL (engine default here is LIMITED);
    # the old parser read "False" as true and stayed LIMITED
    np.testing.assert_array_equal(out["disparity"], want)


def test_warmup_compiles_corrmap_specialization(server):
    """corrmap is part of the jit-specialization key; /warmup?corrmap=1
    must compile it (previously ignored, so the first corrmap match paid
    the full compile)."""
    base, engine = server
    before = engine.compiled_count
    status, body = _post(base + "/warmup?shape=4x8x24&dtype=u8&corrmap=1",
                         b"")
    assert status == 200
    assert engine.compiled_count == before + 1
    key_corr = [k for k in engine._compiled if k[-1]]
    assert key_corr, "no corrmap=True specialization registered"


def test_match_batched_over_http(server, rng):
    """(batch, n, H, W) bodies route through the batched throughput layout
    and come back batch-shaped, equal per-pair to single matches."""
    base, _ = server
    s0, s1 = _stacks(rng)
    b0 = np.stack([s0, s0 ^ np.uint8(3)])
    b1 = np.stack([s1, s1])
    status, body = _post(base + "/match", _npz(stack0=b0, stack1=b1))
    assert status == 200
    out = np.load(io.BytesIO(body))["disparity"]
    assert out.shape == (2, s0.shape[1], s0.shape[2])
    cfg = bicos.Config(nxcorr_threshold=0.5, min_variance=1.0)
    for k in range(2):
        want = np.asarray(bicos.match(b0[k], b1[k], cfg, backend="xla"))
        np.testing.assert_array_equal(out[k], want)


def test_concurrent_batched_requests(server, rng):
    """Staging now folds OUTSIDE the device lock (serve.Engine.match):
    concurrent batched posts must still produce per-pair-correct,
    batch-shaped results (the lock only serializes the device step)."""
    base, _ = server
    s0, s1 = _stacks(rng)
    cfg = bicos.Config(nxcorr_threshold=0.5, min_variance=1.0)
    results = {}

    def one(k):
        b0 = np.stack([s0 ^ np.uint8(k), s0 ^ np.uint8(k + 16)])
        b1 = np.stack([s1, s1])
        status, body = _post(base + "/match", _npz(stack0=b0, stack1=b1))
        results[k] = (status, np.load(io.BytesIO(body))["disparity"], b0, b1)

    threads = [threading.Thread(target=one, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert sorted(results) == [0, 1, 2]
    for k, (status, out, b0, b1) in results.items():
        assert status == 200
        for j in range(2):
            want = np.asarray(bicos.match(b0[j], b1[j], cfg, backend="xla"))
            np.testing.assert_array_equal(out[j], want)


def test_warmup_batched_shape(server):
    base, engine = server
    before = engine.compiled_count
    status, _ = _post(base + "/warmup?shape=3x4x8x24&dtype=u8", b"")
    assert status == 200
    assert engine.compiled_count == before + 1


def test_mixed_ndim_batch_rejected(server, rng):
    """A 3-d stack0 with a 4-d stack1 (or vice versa) is a clean 400 from
    Engine.match's symmetric pre-fold validation — not a downstream shape
    error from inside the pipeline."""
    base, _ = server
    s0, s1 = _stacks(rng)
    b1 = np.stack([s1, s1])  # (2, 4, 8, 24)
    status, body = _post(base + "/match", _npz(stack0=s0, stack1=b1))
    assert status == 400 and b"batched stacks" in body
    status, body = _post(base + "/match", _npz(stack0=b1, stack1=s0))
    assert status == 400 and b"batched stacks" in body


@pytest.fixture(scope="module")
def capped_server():
    """Server with a 4 KiB body cap for the 413 path."""
    port = _free_port()
    engine = Engine(
        bicos.Config(nxcorr_threshold=0.5, min_variance=1.0),
        backend="xla",
    )
    ready = threading.Event()
    t = threading.Thread(
        target=serve,
        args=(engine, "127.0.0.1", port),
        kwargs={"ready_event": ready, "max_body_bytes": 4096},
        daemon=True,
    )
    t.start()
    assert ready.wait(120), "capped server failed to start"
    return f"http://127.0.0.1:{port}"


def test_oversized_body_413(capped_server, rng):
    """Bodies beyond --max-body-mb are rejected with 413 BEFORE being read
    into memory, and the server keeps serving."""
    big0 = rng.integers(0, 256, (4, 32, 64), dtype=np.uint8)
    status, body = _post(capped_server + "/match",
                         _npz(stack0=big0, stack1=big0))
    assert status == 413
    assert b"exceeds limit" in body
    # A small request still succeeds afterwards.
    s0 = rng.integers(0, 256, (4, 4, 12), dtype=np.uint8)
    s1 = rng.integers(0, 256, (4, 4, 12), dtype=np.uint8)
    status, body = _post(capped_server + "/match", _npz(stack0=s0, stack1=s1))
    assert status == 200
    out = np.load(io.BytesIO(body))
    assert out["disparity"].shape == (4, 12)


def test_disp_range_param(server, rng):
    """?disp_range=MIN:MAX engages Config.disparity_range per request."""
    import libbicos_jax as bicos

    s0, s1 = _stacks(rng)
    status, body = _post(server[0] + "/match?disp_range=0:8",
                         _npz(stack0=s0, stack1=s1))
    assert status == 200
    out = np.load(io.BytesIO(body))["disparity"]
    want = np.asarray(bicos.match(
        s0, s1,
        bicos.Config(nxcorr_threshold=0.5, min_variance=1.0,
                     disparity_range=(0, 8)),
        backend="xla"))
    np.testing.assert_array_equal(out, want)
    # malformed -> clean 400
    status, body = _post(server[0] + "/match?disp_range=zz",
                         _npz(stack0=s0, stack1=s1))
    assert status == 400 and b"disp_range" in body


def test_specialization_cap(rng):
    """New (shape, config) combinations beyond max_specializations are
    rejected (each is a separate compile; config-override params
    like disp_range have unbounded value spaces)."""
    engine = Engine(bicos.Config(nxcorr_threshold=0.5, min_variance=1.0),
                    backend="xla", max_specializations=1)
    s0, s1 = _stacks(rng, n=4, h=4, w=12)
    engine.match(s0, s1)  # first specialization compiles
    engine.match(s0, s1)  # reuse is fine
    with pytest.raises(ValueError, match="specialization limit"):
        engine.match(s0, s1, bicos.Config(nxcorr_threshold=0.7))
