"""Image-stack I/O, result export and pointcloud reprojection.

Equivalent of the reference's I/O utilities
(``/root/reference/src/fileutils.cpp``, ``include/fileutils.hpp``):

* :func:`read_sequence` — numbered two-folder (``0.png``, ``1.png``, ...) or
  single-folder (``0_left.png`` / ``0_right.png``) loading, grayscale +
  any-depth, alpha dropped (fileutils.cpp:60-134).
* :func:`sort_sequence_to_stack` — numeric-index ordering
  (fileutils.cpp:136-154).
* :func:`save_image` — colorized PNG (TURBO, invalid masked black) *and* raw
  float TIFF side by side (fileutils.cpp:30-58).
* :func:`save_pointcloud` — ascii ``.xyz``, skipping invalid / non-finite /
  negative-Z points (fileutils.hpp:43-89).
* :func:`reproject_image_to_3d` — the ``cv::reprojectImageTo3D`` step of the
  CLI (cli.cpp:228-250) as a vectorized NumPy op.
* :func:`load_multihost_stack` / :func:`distribute_stack` — multi-host
  loading: each process materializes only the row bands its devices own
  (no reference analogue; the multi-host scale-out path).

cv2 (OpenCV Python) is used for image codecs exactly where the reference used
OpenCV's imgcodecs; everything else is NumPy.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False

from . import native as _native
from .config import INVALID_DISP_INT16


def _imread_gray_anydepth(path: Path) -> np.ndarray:
    if _HAS_CV2:
        m = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE | cv2.IMREAD_ANYDEPTH)
        if m is None:
            raise IOError(f"could not read image: {path}")
        if m.ndim == 3:
            m = cv2.cvtColor(m, cv2.COLOR_BGR2GRAY)
        return m
    import imageio.v3 as iio  # pragma: no cover

    m = iio.imread(path)  # pragma: no cover
    if m.ndim == 3:  # pragma: no cover
        m = m[..., :3].mean(axis=-1).astype(m.dtype)
    return m  # pragma: no cover


_NUM_RE = re.compile(r"^(\d+)")


def _leading_index(fname: str) -> int:
    m = _NUM_RE.match(fname)
    if not m:
        raise ValueError(
            "Expecting numbered files with names NN.png; e.g 0.png, 1.png..."
        )
    return int(m.group(1))


def _decode_seq(entries: List[Tuple[int, Path]]) -> List[Tuple[int, np.ndarray]]:
    """Decode a list of (index, path): native threaded PNG decoder when
    available (libbicos_jax/native/fastio.cpp), else per-file cv2/imageio."""
    if entries and all(str(p).lower().endswith(".png") for _, p in entries):
        stack = _native.decode_stack([p for _, p in entries])
        if stack is not None:
            return [(idx, stack[i]) for i, (idx, _) in enumerate(entries)]
    return [(idx, _imread_gray_anydepth(p)) for idx, p in entries]


def read_sequence(
    folder0,
    folder1=None,
) -> Tuple[List[Tuple[int, np.ndarray]], List[Tuple[int, np.ndarray]]]:
    """Load (index, image) sequences like the reference
    (fileutils.cpp:60-134). Two-folder layout uses ``N.png`` in each folder;
    single-folder layout uses ``N_left.png`` / ``N_right.png``."""
    folder0 = Path(folder0)
    lpaths: List[Tuple[int, Path]] = []
    rpaths: List[Tuple[int, Path]] = []
    if folder1 is not None:
        for seq, d in ((lpaths, folder0), (rpaths, Path(folder1))):
            for p in sorted(Path(d).iterdir()):
                if not p.is_file():
                    continue
                seq.append((_leading_index(p.name), p))
    else:
        for p in sorted(folder0.iterdir()):
            if not p.is_file():
                continue
            name = p.name
            if "_" not in name:
                raise ValueError(
                    "Expecting numbered files with names NN_{left,right}.png;"
                    " e.g.: 5_left.png, 10_right.png..."
                )
            idx = _leading_index(name)
            (lpaths if "_left" in name else rpaths).append((idx, p))
    if len(lpaths) != len(rpaths):
        raise ValueError(
            f"Unequal number of images; left: {len(lpaths)}, "
            f"right: {len(rpaths)}"
        )
    return _decode_seq(lpaths), _decode_seq(rpaths)


def sort_sequence_to_stack(
    lseq: Sequence[Tuple[int, np.ndarray]],
    rseq: Sequence[Tuple[int, np.ndarray]],
) -> Tuple[np.ndarray, np.ndarray]:
    """Sort by numeric index and stack to (n, H, W) arrays
    (fileutils.cpp:136-154)."""
    ls = [img for _, img in sorted(lseq, key=lambda e: e[0])]
    rs = [img for _, img in sorted(rseq, key=lambda e: e[0])]
    return np.stack(ls), np.stack(rs)


def load_stack_pair(folder0, folder1=None, stacksize: Optional[int] = None):
    """Convenience: read + sort + optional truncation (cli.cpp:117-125)."""
    lseq, rseq = read_sequence(folder0, folder1)
    l, r = sort_sequence_to_stack(lseq, rseq)
    if stacksize is not None and stacksize < l.shape[0]:
        l, r = l[:stacksize], r[:stacksize]
    return l, r


# ---------------------------------------------------------------------------
# Result export


def _invalid_mask(image: np.ndarray) -> np.ndarray:
    if np.issubdtype(image.dtype, np.floating):
        return ~np.isfinite(image)
    return image == INVALID_DISP_INT16


def save_image(image: np.ndarray, outfile, colormap: str = "turbo") -> None:
    """Save a disparity/correlation map as a TURBO-colorized PNG plus the raw
    values as a float32 TIFF (fileutils.cpp:30-58). ``outfile``'s extension
    is replaced per format, exactly like the reference."""
    image = np.asarray(image)
    outfile = Path(outfile)
    mask = _invalid_mask(image)
    vals = image.astype(np.float32)
    finite = vals[~mask]
    if finite.size:
        lo, hi = float(finite.min()), float(finite.max())
    else:
        lo, hi = 0.0, 1.0
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    # NaNs (float INVALID) would trip the uint8 cast; zero them first —
    # they are masked to black below anyway. cv::normalize quantizes with a
    # rounding saturate_cast (cvRound = half-to-even), not a truncation —
    # np.rint matches it so the colorized PNG is byte-identical.
    shifted = np.where(mask, 0.0, (vals - lo) * scale)
    norm = np.clip(np.rint(shifted), 0, 255).astype(np.uint8)
    norm[mask] = 0
    if _HAS_CV2:
        cmap = {"turbo": cv2.COLORMAP_TURBO, "jet": cv2.COLORMAP_JET,
                "viridis": cv2.COLORMAP_VIRIDIS}[colormap]
        colorized = cv2.applyColorMap(norm, cmap)
        colorized[mask] = 0
        png = outfile.with_suffix(".png")
        if cv2.imwrite(str(png), colorized):
            print(f"Saved colorized disparity to\t\t{png}")
        tiff = outfile.with_suffix(".tiff")
        # The reference writes the image's own dtype to TIFF
        # (fileutils.cpp:53): int16 disparity stays int16, floats stay
        # float. (Its stdout label says "floating-point" either way.)
        if cv2.imwrite(str(tiff), image if image.dtype == np.int16 else vals):
            print(f"Saved floating-point disparity to\t{tiff}")
    else:  # pragma: no cover
        import imageio.v3 as iio

        iio.imwrite(outfile.with_suffix(".png"), norm)
        iio.imwrite(outfile.with_suffix(".tiff"), vals)


def read_q_matrix(path) -> np.ndarray:
    """Read the 4x4 reprojection matrix "Q" from a cv::FileStorage YAML
    (cli.cpp:228-233)."""
    if _HAS_CV2:
        fs = cv2.FileStorage(str(path), cv2.FILE_STORAGE_READ)
        try:
            node = fs.getNode("Q")
            q = node.mat()
        finally:
            fs.release()
        if q is None:
            raise ValueError(f"no matrix 'Q' in {path}")
        return np.asarray(q, dtype=np.float64)
    raise RuntimeError("cv2 required for FileStorage YAML")  # pragma: no cover


def reproject_image_to_3d(disparity: np.ndarray, q: np.ndarray) -> np.ndarray:
    """``cv::reprojectImageTo3D`` equivalent: (H, W) disparity + 4x4 Q ->
    (H, W, 3) XYZ. Invalid disparities yield non-finite points."""
    disparity = np.asarray(disparity, dtype=np.float32)
    if _HAS_CV2:
        return cv2.reprojectImageTo3D(disparity, q.astype(np.float64))
    h, w = disparity.shape  # pragma: no cover
    ys, xs = np.mgrid[0:h, 0:w]  # pragma: no cover
    vec = np.stack(
        [xs, ys, disparity, np.ones_like(disparity)], axis=-1
    )  # pragma: no cover
    out = vec @ q.T  # pragma: no cover
    with np.errstate(divide="ignore", invalid="ignore"):  # pragma: no cover
        return (out[..., :3] / out[..., 3:4]).astype(np.float32)


def save_pointcloud(
    points: np.ndarray,
    disparity: np.ndarray,
    outfile,
    allow_negative_z: bool = False,
) -> int:
    """ASCII ``.xyz`` export, skipping invalid / non-finite / negative-Z
    points (z == 0 kept, fileutils.hpp:74). Returns the number of points
    written."""
    points = np.asarray(points).reshape(-1, 3)
    disp = np.asarray(disparity).reshape(-1)
    outfile = Path(outfile).with_suffix(".xyz")
    # Native fast path: fold the int16 sentinel into NaN, let C++ filter+format.
    dispf = disp.astype(np.float32, copy=True)
    dispf[_invalid_mask(disp)] = np.nan
    n = _native.write_xyz(outfile, points, dispf, allow_negative_z)
    valid = ~_invalid_mask(disp)
    finite = np.isfinite(points).all(axis=1)
    if n is None:
        ok = valid & finite
        if not allow_negative_z:
            ok &= points[:, 2] >= 0  # z < 0 skipped; z == 0 kept (reference)
        kept = points[ok]
        with open(outfile, "w") as f:
            for x, y, z in kept:
                f.write(f"{x} {y} {z}\n")
        n = int(kept.shape[0])
    # Reference counters (fileutils.hpp:67-88): invalid-disparity pixels are
    # skipped SILENTLY; only non-finite and negative-Z points among
    # valid-disparity pixels are reported, on separate stderr lines, each
    # only when nonzero — exact wording preserved for log scrapers.
    n_nonfinite = int((valid & ~finite).sum())
    n_negative_z = 0
    if not allow_negative_z:
        n_negative_z = int((valid & finite & (points[:, 2] < 0)).sum())
    print(f"Saved pointcloud in ascii-format to\t{outfile}")
    import sys

    if n_nonfinite:
        print(f"Skipped {n_nonfinite} points with non-finite fp values",
              file=sys.stderr)
    if n_negative_z:
        print(f"Skipped {n_negative_z} points with negative Z values",
              file=sys.stderr)
    return n


# ---------------------------------------------------------------------------
# Synthetic data (CI / bench fallback for the non-vendored dataset,
# data/prepare.sh in the reference)


def synthetic_stack_pair(
    n: int,
    height: int,
    width: int,
    dtype=np.uint8,
    max_disp: Optional[int] = None,
    seed: int = 0x600DF00D,  # the reference bench seed (bench/cuda.cu:39)
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Projected-pattern stereo simulator: a random per-shot pattern warped by
    a smooth disparity field. Returns (stack0, stack1, true_disparity)."""
    rng = np.random.default_rng(seed)
    if max_disp is None:
        max_disp = max(4, width // 16)
    hi = np.iinfo(dtype).max
    wide = width + max_disp
    pattern = rng.integers(0, hi + 1, size=(n, height, wide)).astype(dtype)
    # Smooth disparity field (integer, >= 1) defined on LEFT pixel coords.
    yy = np.linspace(0, np.pi * 2, height)[:, None]
    xx = np.linspace(0, np.pi * 3, width)[None, :]
    field = (np.sin(yy) * np.cos(xx) + 1) / 2  # [0, 1]
    disp = (1 + field * (max_disp - 1)).astype(np.int32)
    cols = np.arange(width)[None, :]
    # right[c] = pattern[c + max_disp];  left[c] = pattern[c + max_disp - d]
    # => left[col0] == right[col0 - d]: BICOS disparity d = col0 - col1 > 0.
    right = pattern[:, :, max_disp : max_disp + width]
    src = cols + max_disp - disp
    left = np.take_along_axis(
        pattern, np.broadcast_to(src, (n, height, width)), axis=2
    )
    return (
        np.ascontiguousarray(left),
        np.ascontiguousarray(right),
        disp.astype(np.int16),
    )


def distribute_stack(stack, *, mesh):
    """Turn a host-local full ``(n, H, W)`` array (identical on every
    process) into a global row-sharded ``jax.Array`` on ``mesh``.

    Uses ``jax.make_array_from_callback`` so each process materializes only
    the row bands its local devices own.  (``make_array_from_process_local_
    data`` is the wrong tool here: it treats its argument as *this
    process's* chunk and would concatenate the full array once per process,
    doubling H on a 2-process mesh.)
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    (axis_name,) = mesh.axis_names
    sharding = NamedSharding(mesh, P(None, axis_name, None))
    return jax.make_array_from_callback(
        stack.shape, sharding, lambda idx: stack[idx]
    )


def load_multihost_stack(folder0, folder1=None, *, mesh, stacksize=None):
    """Per-host sharded stack loading for multi-host meshes: every process
    loads the full files (images are small) but only materializes its
    addressable row bands on-device (see :func:`distribute_stack`)."""
    l, r = load_stack_pair(folder0, folder1, stacksize)
    return distribute_stack(l, mesh=mesh), distribute_stack(r, mesh=mesh)
