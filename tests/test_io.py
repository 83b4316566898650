"""I/O parity: sequence loading layouts, dual PNG+TIFF export, pointcloud."""

import numpy as np
import pytest

from libbicos_jax import io as bio

cv2 = pytest.importorskip("cv2")


def _write_pngs(tmpdir, imgs, names):
    for img, name in zip(imgs, names):
        assert cv2.imwrite(str(tmpdir / name), img)


def test_read_sequence_two_folders(tmp_path, rng):
    l = tmp_path / "left"
    r = tmp_path / "right"
    l.mkdir()
    r.mkdir()
    imgs = [rng.integers(0, 255, (6, 8), dtype=np.uint8) for _ in range(3)]
    # Write shuffled names to exercise numeric sorting (10 > 2 numerically).
    _write_pngs(l, imgs, ["10.png", "2.png", "0.png"])
    _write_pngs(r, imgs[::-1], ["10.png", "2.png", "0.png"])
    ls, rs = bio.load_stack_pair(l, r)
    assert ls.shape == (3, 6, 8)
    np.testing.assert_array_equal(ls[0], imgs[2])  # 0.png
    np.testing.assert_array_equal(ls[1], imgs[1])  # 2.png
    np.testing.assert_array_equal(ls[2], imgs[0])  # 10.png
    np.testing.assert_array_equal(rs[0], imgs[0])


def test_read_sequence_single_folder(tmp_path, rng):
    d = tmp_path
    imgs = [rng.integers(0, 255, (4, 5), dtype=np.uint8) for _ in range(4)]
    _write_pngs(d, imgs, ["0_left.png", "0_right.png",
                          "1_left.png", "1_right.png"])
    ls, rs = bio.load_stack_pair(d)
    assert ls.shape == (2, 4, 5)
    np.testing.assert_array_equal(ls[0], imgs[0])
    np.testing.assert_array_equal(rs[0], imgs[1])
    np.testing.assert_array_equal(ls[1], imgs[2])


def test_read_sequence_uint16(tmp_path, rng):
    img = rng.integers(0, 65535, (4, 4), dtype=np.uint16)
    cv2.imwrite(str(tmp_path / "0_left.png"), img)
    cv2.imwrite(str(tmp_path / "0_right.png"), img)
    ls, rs = bio.load_stack_pair(tmp_path)
    assert ls.dtype == np.uint16
    np.testing.assert_array_equal(ls[0], img)


def test_read_sequence_unequal_raises(tmp_path, rng):
    img = rng.integers(0, 255, (4, 4), dtype=np.uint8)
    _write_pngs(tmp_path, [img, img, img],
                ["0_left.png", "0_right.png", "1_left.png"])
    with pytest.raises(ValueError, match="Unequal"):
        bio.read_sequence(tmp_path)


def test_save_image_png_and_tiff(tmp_path):
    disp = np.full((5, 7), np.nan, dtype=np.float32)
    disp[2, 3] = 4.0
    disp[1, 1] = -2.0
    out = tmp_path / "disp.png"
    bio.save_image(disp, out)
    png = cv2.imread(str(tmp_path / "disp.png"))
    assert png.shape == (5, 7, 3)
    assert (png[0, 0] == 0).all()  # invalid -> black
    tiff = cv2.imread(str(tmp_path / "disp.tiff"),
                      cv2.IMREAD_ANYDEPTH | cv2.IMREAD_GRAYSCALE)
    assert tiff.dtype == np.float32
    assert tiff[2, 3] == 4.0
    assert np.isnan(tiff[0, 0])


def test_save_image_int16_sentinel(tmp_path):
    disp = np.full((3, 3), -32768, dtype=np.int16)
    disp[1, 1] = 7
    bio.save_image(disp, tmp_path / "d.png")
    png = cv2.imread(str(tmp_path / "d.png"))
    assert (png[0, 0] == 0).all()
    assert (png[1, 1] != 0).any()
    # The TIFF keeps the disparity's own dtype like the reference
    # (fileutils.cpp:53 writes the raw image): int16 with the -32768
    # sentinel intact.
    tiff = cv2.imread(str(tmp_path / "d.tiff"),
                      cv2.IMREAD_ANYDEPTH | cv2.IMREAD_GRAYSCALE)
    assert tiff.dtype == np.int16
    assert tiff[0, 0] == -32768 and tiff[1, 1] == 7


def test_pointcloud_roundtrip(tmp_path):
    q = np.eye(4, dtype=np.float64)
    disp = np.array([[1.0, np.nan], [2.0, -1.0]], dtype=np.float32)
    pts = bio.reproject_image_to_3d(disp, q)
    assert pts.shape == (2, 2, 3)
    # Z > 0 filter + invalid filter: with identity Q, z = disparity.
    n = bio.save_pointcloud(pts, disp, tmp_path / "cloud.xyz")
    lines = (tmp_path / "cloud.xyz").read_text().strip().splitlines()
    assert len(lines) == n
    assert n == 2  # NaN-disp and negative-Z points skipped
    n2 = bio.save_pointcloud(pts, disp, tmp_path / "cloud2.xyz",
                             allow_negative_z=True)
    assert n2 == 3


def test_q_matrix_yaml(tmp_path):
    q = np.arange(16, dtype=np.float64).reshape(4, 4)
    path = tmp_path / "Q.yaml"
    fs = cv2.FileStorage(str(path), cv2.FILE_STORAGE_WRITE)
    fs.write("Q", q)
    fs.release()
    got = bio.read_q_matrix(path)
    np.testing.assert_array_equal(got, q)


def test_synthetic_stack_pair_recoverable():
    """The synthetic generator's ground truth must be recoverable by the
    matcher (shift-invariance property test, SURVEY.md section 4)."""
    import libbicos_jax as bicos

    s0, s1, disp = bio.synthetic_stack_pair(8, 12, 48, seed=7)
    got = np.asarray(
        bicos.match(s0, s1, bicos.Config(nxcorr_threshold=None),
                    backend="xla")
    )
    valid = got != -32768
    interior = valid & (np.arange(48)[None, :] >= disp)
    agree = (got == disp) & interior
    assert agree.sum() / interior.sum() > 0.95


def test_pointcloud_skip_counters_match_reference(tmp_path, capsys):
    """Reference counters (fileutils.hpp:67-88): invalid-disparity pixels
    skip SILENTLY; only non-finite and negative-Z points among
    valid-disparity pixels print, on separate stderr lines with the
    reference wording, each only when nonzero."""
    q = np.eye(4, dtype=np.float64)
    # row0: valid + z>0 (kept), invalid (silent skip)
    # row1: valid + z<0 (counted), valid but non-finite point (counted)
    disp = np.array([[1.0, np.nan], [-2.0, 3.0]], dtype=np.float32)
    pts = bio.reproject_image_to_3d(disp, q)
    pts[1, 1, 0] = np.inf  # non-finite point at a valid disparity
    n = bio.save_pointcloud(pts, disp, tmp_path / "c.xyz")
    assert n == 1
    err = capsys.readouterr().err
    assert "Skipped 1 points with non-finite fp values" in err
    assert "Skipped 1 points with negative Z values" in err
    # All-clean input: no stderr at all (the invalid pixel stays silent).
    disp2 = np.array([[1.0, np.nan]], dtype=np.float32)
    pts2 = bio.reproject_image_to_3d(disp2, q)
    bio.save_pointcloud(pts2, disp2, tmp_path / "c2.xyz")
    assert capsys.readouterr().err == ""
