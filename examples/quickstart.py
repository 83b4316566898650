"""Minimal end-to-end example: generate a synthetic projected-pattern scene,
match it, and export all the artifacts the reference CLI produces.

Run: python examples/quickstart.py [outdir]
"""

import os
import sys

import numpy as np

import jax

# Honor JAX_PLATFORMS=cpu through jax.config as well; must run before
# backend init.
try:
    if "cpu" in os.environ.get("JAX_PLATFORMS", "").split(","):
        jax.config.update("jax_platforms", "cpu")
except RuntimeError:
    pass

import libbicos_jax as bicos
from libbicos_jax import io as bio
from libbicos_jax import profiling


def main(outdir="/tmp/bicos-quickstart"):
    import os

    os.makedirs(outdir, exist_ok=True)

    # A 9-shot stereo pair with known ground truth.
    stack0, stack1, true_disp = bio.synthetic_stack_pair(9, 120, 160)

    cfg = bicos.Config(
        nxcorr_threshold=0.6,
        subpixel_step=0.25,
        min_variance=1.0,
        mode=bicos.TransformMode.LIMITED,
        variant=bicos.Consistency(max_lr_diff=1, no_dupes=True),
    )
    disp, corr = bicos.match(stack0, stack1, cfg, corrmap=True)
    disp = np.asarray(disp)

    print(profiling.metrics(disp))
    bio.save_image(disp, f"{outdir}/disparity.png")
    bio.save_image(np.asarray(corr), f"{outdir}/corrmap.png")

    q = np.array([[1, 0, 0, -80.0], [0, 1, 0, -60.0],
                  [0, 0, 0, 200.0], [0, 0, 1 / 30.0, 0]])
    points = bio.reproject_image_to_3d(disp, q)
    bio.save_pointcloud(points, disp, f"{outdir}/cloud.xyz")

    valid = np.isfinite(disp)
    cols = np.arange(disp.shape[1])[None, :]
    interior = valid & (cols >= true_disp)
    err = np.abs(disp - true_disp)[interior]
    print(f"valid: {valid.mean():.1%}, max |err| on valid interior: "
          f"{err.max() if err.size else float('nan')}")


if __name__ == "__main__":
    main(*sys.argv[1:])
