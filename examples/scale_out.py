"""Scale-out demo: H-band sharding + batched throughput on a device mesh.

Runs on any JAX platform; without several GPUs, force a virtual 8-device
CPU mesh:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/scale_out.py

On a multi-GPU host the same code uses the physical cards (and
``libbicos_jax.io.load_multihost_stack`` feeds each host its own image
shard). Rows are epipolar-independent, so H-banding is a zero-collective
``shard_map`` — N devices divide the match time by ~N.
"""

import os

import numpy as np

import jax

# Virtual 8-device CPU mesh fallback; must run before the backend
# initializes (a no-op if the backend is already up or not CPU).
try:
    if "cpu" in os.environ.get("JAX_PLATFORMS", "").split(","):
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
except RuntimeError:
    pass

import libbicos_jax as bicos
from libbicos_jax.io import synthetic_stack_pair
from libbicos_jax.sharding import make_mesh, match_sharded

n, h, w = 10, 256, 320
s0, s1, true_disp = synthetic_stack_pair(n, h, w, seed=3)
cfg = bicos.Config(nxcorr_threshold=0.7, min_variance=1.0)

mesh = make_mesh()  # 1-D mesh over all visible devices
print(f"mesh: {mesh.shape} over {len(jax.devices())} devices")

disp = np.asarray(match_sharded(s0, s1, cfg, mesh=mesh))
ref = np.asarray(bicos.match(s0, s1, cfg))
print("sharded == single-device:", (disp == ref).all())

valid = disp != -32768
print(f"valid {valid.mean():.2%}, "
      f"gt agreement {(disp[valid] == true_disp[valid]).mean():.2%}")

# Batched throughput: fold a batch of stereo pairs into one launch.
batch = np.stack([s0, s0 ^ 1, s0 ^ 2, s0 ^ 3])
batch1 = np.stack([s1, s1 ^ 1, s1 ^ 2, s1 ^ 3])
out = np.asarray(bicos.match_batched(batch, batch1, cfg))
print("batched output:", out.shape, "pair0 matches:", (out[0] == ref).all())

# Serving layout: whole batch H-banded over the mesh in one launch
# (batch * H rows scattered, zero collectives).
from libbicos_jax.sharding import match_batched_sharded

outs = np.asarray(match_batched_sharded(batch, batch1, cfg, mesh=mesh))
print("batched+sharded matches batched:", (outs == out).all())
