"""The port's PNG codec and frame resamplers (`object_nerf_torch/data/
png_io.py`, `data/image_utils.py`) against cv2 and PIL, which the JAX
package's dataset reads frames with."""

import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from object_nerf_torch.data import png_io
from object_nerf_torch.data.image_utils import (
    compute_distance_transform_weights, distance_transform_l2_3x3, resize_lanczos,
    resize_nearest,
)

W, H = 32, 24


def _image(shape, dtype=np.uint8, seed=0):
    """A smooth gradient with noise: every filter type has work to do."""
    rng = np.random.RandomState(seed)
    h, w = shape[:2]
    y, x = np.mgrid[0:h, 0:w]
    base = 0.5 + 0.4 * np.sin(x / 5.0) * np.cos(y / 4.0)
    if len(shape) == 3:
        base = base[..., None] * np.linspace(0.6, 1.0, shape[2])
    top = np.iinfo(dtype).max
    return np.clip((base * 0.85 + 0.15 * rng.rand(*shape)) * top, 0, top).astype(dtype)


def _bgr(img):
    if img.ndim == 2:
        return img
    return img[..., [2, 1, 0]] if img.shape[2] == 3 else img[..., [2, 1, 0, 3]]


CASES = {"grey8": ((H, W), np.uint8), "rgb8": ((H, W, 3), np.uint8),
         "rgba8": ((H, W, 4), np.uint8), "grey16": ((H, W), np.uint16)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("writer", ["cv2", "pil"])
def test_reads_cv2_and_pil_files_bit_equal(tmp_path, case, writer):
    shape, dtype = CASES[case]
    img = _image(shape, dtype)
    path = str(tmp_path / f"{case}.png")
    if writer == "cv2":
        assert cv2.imwrite(path, _bgr(img))
    else:
        Image.fromarray(img).save(path, optimize=True)
    got = png_io.read_png(path)
    assert got.dtype == dtype and got.shape == img.shape
    np.testing.assert_array_equal(got, img)
    if img.ndim == 2:  # the dataset's depth and instance maps: IMREAD_ANYDEPTH
        np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_ANYDEPTH))
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "paeth", [0, 1, 2, 3, 4], [4, 3]])
@pytest.mark.parametrize("case", sorted(CASES))
def test_written_files_read_back_in_cv2_and_pil(tmp_path, filters, case):
    shape, dtype = CASES[case]
    img = _image(shape, dtype, seed=1)
    path = str(tmp_path / "out.png")
    png_io.write_png(path, img, filters=filters)
    np.testing.assert_array_equal(png_io.read_png(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back, _bgr(img))
    # the rows carry the filters asked for, cycled
    raw = _idat_rows(path, img)
    seq = filters if isinstance(filters, list) else [filters]
    seq = [png_io.FILTERS[f] if isinstance(f, str) else f for f in seq]
    np.testing.assert_array_equal(raw[:, 0], np.resize(seq, img.shape[0]))


def _idat_rows(path, img):
    data = open(path, "rb").read()
    idat, pos = b"", 8
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    return np.frombuffer(zlib.decompress(idat), np.uint8).reshape(img.shape[0], -1)


def test_interlaced_palette_and_low_depth_files_raise(tmp_path):
    img = _image((H, W, 3))
    # an Adam7 header (PIL writes no interlaced PNG): IHDR's last byte, new CRC
    data = bytearray(png_io.encode_png(img))
    ihdr = bytes(data[12:29])
    data[28] = 1
    data[29:33] = zlib.crc32(bytes(data[12:29])).to_bytes(4, "big")
    assert ihdr[:4] == b"IHDR"
    inter = tmp_path / "interlaced.png"
    inter.write_bytes(bytes(data))
    with pytest.raises(png_io.PNGError, match=f"{inter}.*interlaced"):
        png_io.read_png(inter)
    pal = tmp_path / "palette.png"
    Image.fromarray(img).convert("P").save(pal)
    with pytest.raises(png_io.PNGError, match=f"{pal}.*palette"):
        png_io.read_png(pal)
    mono = tmp_path / "mono.png"
    Image.fromarray(img[..., 0] > 128).save(mono)
    with pytest.raises(png_io.PNGError, match=f"{mono}.*bit depth 1"):
        png_io.read_png(mono)
    bad = bytearray(png_io.encode_png(img))
    bad[40] ^= 0xFF
    with pytest.raises(png_io.PNGError, match="CRC"):
        png_io.decode_png(bytes(bad), "bad.png")


@pytest.mark.parametrize("src,dst", [((48, 64), (32, 24)), ((29, 41), (32, 24)),
                                     ((24, 32), (64, 48)), ((24, 32), (32, 24))])
@pytest.mark.parametrize("channels", [0, 3])
def test_lanczos_within_one_level_of_pil(src, dst, channels):
    shape = src if channels == 0 else (*src, channels)
    img = _image(shape, seed=2)
    want = np.asarray(Image.fromarray(img).resize(dst, Image.LANCZOS))
    got = resize_lanczos(img, dst)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    if dst == src[::-1]:  # the identity, bit for bit, as PIL
        np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("src,dst", [((48, 64), (32, 24)), ((29, 41), (32, 24)),
                                     ((24, 32), (64, 48)), ((24, 32), (32, 24)),
                                     ((480, 640), (320, 240))])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_nearest_bit_equal_to_cv2(src, dst, dtype):
    img = _image(src, dtype, seed=3)
    np.testing.assert_array_equal(resize_nearest(img, dst),
                                  cv2.resize(img, dst, interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("size", [(H, W), (60, 80)])
def test_distance_transform_matches_cv2(size):
    import object_nerf_tpu.data.image_utils as jax_image_utils

    h, w = size
    y, x = np.mgrid[0:h, 0:w]
    mask = ((x - 0.4 * w) ** 2 + (y - 0.5 * h) ** 2 < (0.3 * min(h, w)) ** 2)
    mask |= np.random.RandomState(0).rand(h, w) > 0.97
    for m in (mask, ~mask, np.ones((h, w), bool), np.zeros((h, w), bool)):
        want = cv2.distanceTransform(m.astype(np.uint8) * 255, cv2.DIST_L2, 3)
        got = distance_transform_l2_3x3(m)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for upd in (15.0, 0.05 * w, 3.0):
        for fg_bg in (False, True):
            np.testing.assert_allclose(
                compute_distance_transform_weights(mask, upd, fg_bg),
                jax_image_utils.compute_distance_transform_weights(mask, upd, fg_bg),
                atol=1e-4, rtol=0)
