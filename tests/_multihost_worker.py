"""Worker process for the multi-host (multi-controller) smoke test.

Launched by ``tests/test_multihost.py`` as ``python _multihost_worker.py
<coordinator> <num_processes> <process_id>``. Each process contributes 4
virtual CPU devices to one global mesh, runs the H-banded
:func:`libbicos_jax.sharding.match_sharded` across all processes, and
checks its *addressable* row bands against a locally computed single-device
reference (no result allgather needed — rows are independent, SURVEY.md
section 5).

This is the equivalent of a multi-host deployment: on real hardware the
same code runs with each host's GPUs in one global mesh; here the backend is
the 4-devices-per-process CPU platform.
"""

import sys

LOCAL_DEVICES = 4


def main(coordinator: str, num_processes: int, process_id: int) -> None:
    import jax

    # Platform + device count must be pinned before the backend comes up.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", LOCAL_DEVICES)
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )

    import numpy as np

    import libbicos_jax as bicos
    from libbicos_jax.io import distribute_stack
    from libbicos_jax.sharding import make_mesh, match_sharded

    ndev = num_processes * LOCAL_DEVICES
    assert len(jax.devices()) == ndev, (len(jax.devices()), ndev)
    mesh = make_mesh(ndev)
    (axis_name,) = mesh.axis_names

    n, h, w = 4, 2 * ndev, 32
    rng = np.random.default_rng(7)  # same seed in every process
    s0 = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    s1 = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    cfg = bicos.Config(nxcorr_threshold=0.5, mode=bicos.TransformMode.LIMITED)

    # Every process holds the full (small) arrays; only its addressable row
    # bands are materialized on-device — the io.load_multihost_stack layout.
    g0 = distribute_stack(s0, mesh=mesh)
    g1 = distribute_stack(s1, mesh=mesh)

    disp = match_sharded(g0, g1, cfg, mesh=mesh, backend="xla")
    jax.block_until_ready(disp)

    # Single-process reference on this process's local CPU device.
    ref = np.asarray(bicos.match(s0, s1, cfg, backend="xla"))

    rows_per_dev = h // ndev
    checked = 0
    for shard in disp.addressable_shards:
        (rs, cs) = shard.index
        band = np.asarray(shard.data)
        np.testing.assert_array_equal(band, ref[rs, cs], err_msg=str(rs))
        checked += band.shape[0]
    assert checked == rows_per_dev * LOCAL_DEVICES, checked

    print(f"MULTIHOST_OK p{process_id} rows={checked}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
