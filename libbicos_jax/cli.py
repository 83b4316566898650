"""``bicos`` command line interface.

Mirrors the reference CLI's flags, defaults and behavior
(``/root/reference/src/cli.cpp:55-253``) on the JAX engine:

* positional ``folder0 [folder1]`` (two-folder ``N.png`` layout, or
  single-folder ``N_left.png`` / ``N_right.png``),
* ``-t/--threshold`` default **0.75** and ``--limited`` off (i.e. mode FULL)
  — the CLI defaults intentionally differ from the library defaults
  (cli.cpp:63,137-140 vs common.hpp:74-77),
* ``--threshold <= 0`` disables NXCORR (cli.cpp:141-142); ``--corrmap``
  without a threshold forces threshold -1 (cli.cpp:146-149),
* ``-m/--lr-maxdiff`` selects the Consistency variant, composable with
  ``--no-dupes`` (cli.cpp:161-166),
* ``-q/--qmatrix`` + reprojection to an ascii ``.xyz`` pointcloud; the
  negative-Z filter flag is honored under its *declared* name
  ``--allow-negative-z`` (the reference declares that flag but queries
  ``allow-behind`` — a documented upstream bug we fix, cli.cpp:69,231),
* per-phase latency printout (upload/match/download) like the CUDA CLI
  (cli.cpp:177-216), with ``block_until_ready`` fencing for honest numbers.

Extensions: ``--devices N`` shards rows over a device mesh
(:func:`libbicos_jax.sharding.match_sharded`), ``--backend`` selects the
GPU kernels or the XLA compute path (:func:`search.resolve_backend`),
``--profile DIR`` captures a ``jax.profiler`` trace.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

from . import io as _io
from .config import (
    Config, Consistency, NoDuplicates, Precision, TransformMode,
)
from .search import BACKENDS


def _uint(s: str) -> int:
    """Non-negative int parser: the reference declares -n/-m as
    cxxopts uint, which rejects negatives at argv-parse time (cli.cpp:67,70).
    Without this, -m -1 silently invalidates every pixel and -n -2 silently
    drops trailing images via negative slicing."""
    v = int(s)
    if v < 0:
        raise argparse.ArgumentTypeError(f"must be non-negative, got {s}")
    return v


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bicos",
        description="cli to process images with BICOS (JAX engine)",
    )
    p.add_argument("folder0", help="First folder containing input images "
                   "with numbered names.")
    p.add_argument("folder1", nargs="?", default=None,
                   help="Optional second folder with input images. If "
                   "specified, file names need to be 0.png, 1.png... Else, "
                   "folder0 needs to contain 0_left.png, 0_right.png, "
                   "1_left.png...")
    p.add_argument("-t", "--threshold", type=float, default=0.75,
                   help="Minimum normalized cross correlation for a match "
                   "to be accepted. Set to 0.0 to disable. (default: 0.75)")
    # The reference declares default_value("1.0") but only APPLIES it when
    # the flag is explicitly passed (cli.cpp:158-160 guards on
    # args.count("variance"), which stays 0 for a cxxopts default) — so a
    # default run has NO variance prefilter. None = not passed.
    p.add_argument("-v", "--variance", type=float, default=None,
                   help="Minimum intensity variance. Only active with "
                   "--threshold. (default: 1.0)")
    p.add_argument("-s", "--step", type=float, default=None,
                   help="Stepsize for subpixel interpolation. Only effective "
                   "when threshold is set.")
    p.add_argument("-o", "--out", default="bicosdisp.png",
                   help="Output file for disparity image. "
                   "(default: bicosdisp.png)")
    p.add_argument("-n", "--stacksize", type=_uint, default=None,
                   help="Number of images to process. Defaults to all found "
                   "in the input folders.")
    p.add_argument("-q", "--qmatrix", default=None,
                   help="Path to cv::FileStorage with single matrix \"Q\" "
                   "for reconstructing a pointcloud.")
    p.add_argument("--allow-negative-z", action="store_true",
                   help="Allow for points with negative Z values in the "
                   "pointcloud output. Only effective with a given qmatrix.")
    p.add_argument("-m", "--lr-maxdiff", type=_uint, default=None,
                   help="Maximum disparity difference between left and right "
                   "image. Enabling this disables duplicate filtering.")
    p.add_argument("--double", action="store_true",
                   help="Set double instead of single precision")
    p.add_argument("--limited", action="store_true",
                   help="Limit transformation mode. Allows for more images "
                   "to be used.")
    p.add_argument("--corrmap", action="store_true",
                   help="Output map of normalized cross correlation values.")
    p.add_argument("--no-dupes", action="store_true",
                   help="Default BICOS variant when --lr-maxdiff is not "
                   "specified. Can be set together with --lr-maxdiff to "
                   "activate both.")
    # Extensions over the reference CLI
    p.add_argument("--devices", type=int, default=1,
                   help="Shard over this many devices.")
    p.add_argument("--shard-axis", default="rows", choices=["rows", "cols"],
                   help="Sharding layout with --devices: 'rows' (H-banding, "
                   "zero-collective) or 'cols' (W-banding ring search for "
                   "very wide images).")
    p.add_argument("--backend", default="auto", choices=list(BACKENDS),
                   help="Compute path: 'triton' (GPU kernels, the default "
                   "on a GPU), 'xla' (the default elsewhere), or "
                   "'triton_interpret' (the kernels in interpret mode).")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="Capture a jax.profiler trace into DIR.")
    p.add_argument("--dump-descriptors", default=None, metavar="NPZ",
                   help="Also write both stacks' packed descriptor words "
                        "to NPZ (debug artifact; keys words0/words1).")
    p.add_argument("--disp-range", default=None, metavar="MIN:MAX",
                   help="Restrict matching to disparities in the inclusive "
                        "range MIN:MAX (extension; the reference always "
                        "scans the full row). Pixels without an in-range "
                        "candidate become invalid, and the GPU scan visits "
                        "only the columns the range can reach.")
    return p


def config_from_args(args) -> Config:
    """Replicates the reference CLI -> Config mapping (cli.cpp:137-166)."""
    threshold = args.threshold
    if threshold is not None and threshold <= 0.0:
        threshold = None
    if args.corrmap and threshold is None:
        threshold = -1.0
        print(
            "Computing with nxcorr-threshold of -1.0 because 'corrmap' is "
            "set",
            file=sys.stderr,
        )
    minvar = args.variance if (args.variance and args.variance > 0) else None
    if args.lr_maxdiff is not None:
        variant = Consistency(
            max_lr_diff=args.lr_maxdiff, no_dupes=args.no_dupes
        )
    else:
        variant = NoDuplicates()
        if args.no_dupes:
            print(
                "'no-dupes' is the default when 'lr-maxdiff' is not set.",
                file=sys.stderr,
            )
    drange = None
    if getattr(args, "disp_range", None):
        try:
            lo, _, hi = args.disp_range.partition(":")
            drange = (int(lo), int(hi))
        except ValueError:
            raise SystemExit(
                f"--disp-range expects MIN:MAX integers, got "
                f"{args.disp_range!r}")
        if drange[0] > drange[1]:
            raise SystemExit(
                f"--disp-range expects MIN <= MAX, got {args.disp_range!r}")
    return Config(
        nxcorr_threshold=threshold,
        subpixel_step=args.step,
        min_variance=minvar,
        mode=TransformMode.LIMITED if args.limited else TransformMode.FULL,
        precision=Precision.DOUBLE if args.double else Precision.SINGLE,
        variant=variant,
        disparity_range=drange,
    )


# License banner printed like the reference CLI (cli.cpp:49-53,91); this
# project is an independent JAX implementation, also LGPL (COPYING).
LICENSE_HEADER = (
    "libbicos-jax  Copyright (C) 2026\n"
    "This program is free software, and you are welcome to redistribute\n"
    "it under the conditions of the GNU LGPL-3.0-or-later license.\n"
)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    print(LICENSE_HEADER)
    if not sys.stdout.isatty():
        # Reference parity (cli.cpp:92-93): the CLI output format is not a
        # stable machine interface.
        print("Danger: bicos-cli does not have a stable CLI interface",
              file=sys.stderr)

    import jax
    import jax.numpy as jnp

    from . import match
    from .compile_cache import enable_compile_cache
    from .sharding import make_mesh, match_sharded

    enable_compile_cache()

    lstack, rstack = _io.load_stack_pair(
        args.folder0, args.folder1, args.stacksize
    )
    if lstack.shape[0] != rstack.shape[0]:
        raise SystemExit(
            f"Left stack: {lstack.shape[0]}, right stack: "
            f"{rstack.shape[0]} images"
        )
    bits = lstack.dtype.itemsize * 8
    print(f"Loaded {lstack.shape[0] + rstack.shape[0]} {bits}-bit images "
          "in total")

    cfg = config_from_args(args)

    if args.profile:
        jax.profiler.start_trace(args.profile)

    tick = time.perf_counter()
    l_dev = jnp.asarray(lstack)
    r_dev = jnp.asarray(rstack)
    jax.block_until_ready((l_dev, r_dev))
    t_upload = (time.perf_counter() - tick) * 1e3
    print(f"Latency:\t {t_upload:.2f}ms (upload)\t", end="", flush=True)

    tick = time.perf_counter()
    if args.devices > 1:
        mesh = make_mesh(args.devices)
        if args.shard_axis == "cols":
            from .sharding import match_sharded_w

            out = match_sharded_w(
                l_dev, r_dev, cfg, mesh=mesh, corrmap=args.corrmap,
                backend=args.backend,
            )
        else:
            out = match_sharded(
                l_dev, r_dev, cfg, mesh=mesh, corrmap=args.corrmap,
                backend=args.backend,
            )
    else:
        out = match(
            l_dev, r_dev, cfg, corrmap=args.corrmap, backend=args.backend
        )
    jax.block_until_ready(out)
    t_match = (time.perf_counter() - tick) * 1e3
    print(f"{t_match:.2f}ms (match)\t", end="", flush=True)

    tick = time.perf_counter()
    if args.corrmap:
        disp, corr = out
        disp = np.asarray(disp)
        corr = np.asarray(corr)
    else:
        disp = np.asarray(out)
        corr = None
    t_down = (time.perf_counter() - tick) * 1e3
    print(f"{t_down:.2f}ms (download)")

    if args.profile:
        jax.profiler.stop_trace()
        print(f"Saved profiler trace to {args.profile}")

    outfile = Path(args.out)
    _io.save_image(disp, outfile)
    if corr is not None:
        corr_out = outfile.parent / (outfile.stem + "-corrmap" + outfile.suffix)
        # VIRIDIS for the correlation map, like the reference
        # (cli.cpp:226).
        _io.save_image(corr, corr_out, colormap="viridis")

    if args.qmatrix:
        q = _io.read_q_matrix(args.qmatrix)
        points = _io.reproject_image_to_3d(disp, q)
        _io.save_pointcloud(points, disp, outfile, args.allow_negative_z)

    if args.dump_descriptors:
        # Debug artifact (the stateless pipeline has nothing to
        # checkpoint; descriptor dumps are the inspection surface).
        from . import descriptor as _descriptor

        words0 = np.asarray(_descriptor.descriptor_words(l_dev, cfg.mode))
        words1 = np.asarray(_descriptor.descriptor_words(r_dev, cfg.mode))
        from . import debug as _debug

        if _debug.enabled():
            from .config import actual_bits

            nbits = actual_bits(lstack.shape[0], cfg.mode)
            _debug.check_descriptor_words(words0, nbits)
            _debug.check_descriptor_words(words1, nbits)
        np.savez_compressed(
            args.dump_descriptors, words0=words0, words1=words1,
        )
        print(f"Saved packed descriptors to\t{args.dump_descriptors}")

    return 0


def _entry() -> int:
    """Console entry: surface user errors cleanly, like the reference CLI's
    uncaught-exception abort but without the traceback noise."""
    try:
        return main()
    except (FileNotFoundError, NotADirectoryError, ValueError) as e:
        print(f"bicos: error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(_entry())
