"""Serving demo: start the warm-engine daemon in-process, hit it with the
client, and show that repeat requests skip compilation.

Run anywhere (forces CPU when requested):

    JAX_PLATFORMS=cpu python examples/serving.py

On a GPU host you would instead run the daemon standalone —

    python -m libbicos_jax.serve --port 8344 --limited -t 0.9 -v 2.0 \
        --warmup 33x2200x3300:u8

— and point ``BicosClient`` at it from any process; the XLA compile
happens once at warmup, every later request skips it.
"""

import os
import threading
import time

import numpy as np

import jax

try:
    if "cpu" in os.environ.get("JAX_PLATFORMS", "").split(","):
        jax.config.update("jax_platforms", "cpu")
except RuntimeError:
    pass

import libbicos_jax as bicos
from libbicos_jax.client import BicosClient
from libbicos_jax.io import synthetic_stack_pair
from libbicos_jax.serve import Engine, serve

PORT = 8377
n, h, w = 10, 128, 160

engine = Engine(bicos.Config(nxcorr_threshold=0.7, min_variance=1.0))
ready = threading.Event()
threading.Thread(
    target=serve,
    args=(engine, "127.0.0.1", PORT),
    kwargs={"warmup_shapes": [((n, h, w), "uint8")], "ready_event": ready},
    daemon=True,
).start()
ready.wait(300)
print(f"daemon ready, {engine.compiled_count} specialization(s) warm")

client = BicosClient(f"http://127.0.0.1:{PORT}")
print("healthz:", client.healthz())

s0, s1, true_disp = synthetic_stack_pair(n, h, w, seed=5)
t0 = time.perf_counter()
disp = client.match(s0, s1)
print(f"warm request: {(time.perf_counter() - t0) * 1e3:.1f} ms "
      f"(shape {disp.shape}, dtype {disp.dtype})")

valid = disp != -32768
agree = (disp[valid] == true_disp[valid]).mean()
print(f"valid {valid.mean():.2%}, ground-truth agreement {agree:.2%}")

# Config overrides per request — a new specialization compiles on demand.
disp_c, corr = client.match(s0, s1, corrmap=True, lr_maxdiff=1, no_dupes=1)
print(f"consistency variant: valid {(disp_c != -32768).mean():.2%}, "
      f"corrmap finite {np.isfinite(corr).mean():.2%}")
print(f"specializations now warm: {client.healthz()['compiled']}")
