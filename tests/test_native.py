"""Native C++ I/O runtime: decode/export parity with the Python paths."""

import numpy as np
import pytest

from libbicos_jax import native

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def lib():
    if native.get() is None:
        pytest.skip("native library unavailable (no g++/libpng)")
    return native


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_decode_stack_exact(tmp_path, rng, lib, dtype):
    hi = np.iinfo(dtype).max
    imgs = [rng.integers(0, hi + 1, (32, 48)).astype(dtype) for _ in range(4)]
    paths = []
    for i, img in enumerate(imgs):
        p = tmp_path / f"{i}.png"
        assert cv2.imwrite(str(p), img)
        paths.append(p)
    stack = lib.decode_stack(paths)
    assert stack is not None and stack.dtype == dtype
    for i, img in enumerate(imgs):
        np.testing.assert_array_equal(stack[i], img)


def test_decode_stack_rgb_to_gray(tmp_path, lib):
    """Color PNGs collapse to luma like cv::IMREAD_GRAYSCALE (BT.601)."""
    img = np.zeros((8, 8, 3), dtype=np.uint8)
    img[..., 0] = 200  # B
    img[..., 1] = 100  # G
    img[..., 2] = 50   # R
    p = tmp_path / "0.png"
    assert cv2.imwrite(str(p), img)
    stack = lib.decode_stack([p])
    want = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
    assert stack is not None
    # BT.601 rounding may differ by 1 count between libpng and cv2.
    assert np.abs(stack[0].astype(int) - want.astype(int)).max() <= 1


def test_write_xyz_filters(tmp_path, lib):
    pts = np.array(
        [[1, 2, 3], [4, 5, -6], [np.nan, 1, 1], [7, 8, 9], [1, 1, np.inf]],
        dtype=np.float32,
    )
    disp = np.array([1.0, 2.0, 3.0, np.nan, 5.0], dtype=np.float32)
    out = tmp_path / "c.xyz"
    n = lib.write_xyz(out, pts, disp, allow_negative_z=False)
    assert n == 1
    assert out.read_text().strip() == "1 2 3"
    n = lib.write_xyz(out, pts, disp, allow_negative_z=True)
    assert n == 2  # negative-z point now kept; NaN/inf still skipped


def test_io_read_sequence_uses_native(tmp_path, rng, lib):
    """The io-layer sequence loader must produce identical stacks whether or
    not the native decoder kicks in."""
    import libbicos_jax.io as bio

    imgs = [rng.integers(0, 256, (16, 24), dtype=np.uint8) for _ in range(3)]
    for i, img in enumerate(imgs):
        cv2.imwrite(str(tmp_path / f"{i}_left.png"), img)
        cv2.imwrite(str(tmp_path / f"{i}_right.png"), img[::-1])
    l1, r1 = bio.load_stack_pair(tmp_path)
    import os

    os.environ["BICOS_NO_NATIVE"] = "1"
    native._lib = None
    native._tried = False
    try:
        l2, r2 = bio.load_stack_pair(tmp_path)
    finally:
        del os.environ["BICOS_NO_NATIVE"]
        native._tried = False
    np.testing.assert_array_equal(l1, l2)
    np.testing.assert_array_equal(r1, r2)
