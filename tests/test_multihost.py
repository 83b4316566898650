"""True multi-controller test: two OS processes, one global 8-device mesh.

SURVEY.md section 4 calls for multi-host tests via ``jax.distributed`` on
top of the 8-device single-process simulation the rest of the suite uses;
this spawns two coordinator-connected worker processes (4 virtual CPU
devices each) and runs the H-banded sharded match across the process
boundary — the same code path a real multi-host GPU cluster would take.
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_match_sharded():
    coordinator = f"127.0.0.1:{_free_port()}"
    repo_root = os.path.dirname(os.path.dirname(_WORKER))
    env = dict(os.environ)
    # The workers pin their own platform/devices; scrub inherited XLA_FLAGS
    # so the parent conftest's 8-device forcing doesn't double-apply.
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, coordinator, "2", str(pid)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
            cwd=repo_root,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n" + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"MULTIHOST_OK p{pid}" in out, out
