"""The port's PNG codec and frame resamplers (`object_nerf_torch/data/
png_io.py`, `data/image_utils.py`) against cv2 and PIL, which the JAX
package's dataset reads frames with."""

import struct
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


# Adam7 passes: (x0, y0, dx, dy) of the pixels each carries (PNG spec, 8.2)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _adam7_png(img):
    """An Adam7-interlaced PNG of `img` (PIL and cv2 write none): each pass's
    rows filtered on their own, the filter types cycling 0-4 over all rows
    of all passes, empty passes left out. Returns (bytes, filters used)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    bpp = c * img.dtype.itemsize
    pix = np.ascontiguousarray(img.astype(">u2") if img.dtype == np.uint16 else img)
    pix = pix.view(np.uint8).reshape(h, w, bpp)
    raw, used, k = [], set(), 0
    for x0, y0, dx, dy in ADAM7:
        sub = pix[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        ph, pw = sub.shape[:2]
        ftypes = (np.arange(k, k + ph) % 5).astype(np.uint8)
        k += ph
        used |= set(ftypes.tolist())
        rows = png_io._filter_rows(sub.reshape(ph, pw * bpp), ftypes, bpp)
        raw.append(np.concatenate([ftypes[:, None], rows], 1).tobytes())

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8 * img.dtype.itemsize, {1: 0, 2: 4, 3: 2, 4: 6}[c],
                       0, 0, 1)
    data = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(raw))) + chunk(b"IEND", b""))
    return data, used


@pytest.mark.parametrize("size", [(H, W), (1, 1), (3, 5), (7, 2), (9, 13)])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_reads_adam7_interlaced_files_bit_equal(tmp_path, size, channels, dtype):
    """Every colour type at 8 and 16 bits, images smaller than 8 x 8 (empty
    passes), every row filter inside the passes: bit-equal to the image,
    to `cv2.imread(..., IMREAD_UNCHANGED)` and (where PIL keeps the depth)
    to `PIL.Image.open` of the same bytes."""
    shape = size if channels == 1 else (*size, channels)
    img = _image(shape, dtype, seed=channels)
    data, used = _adam7_png(img)
    if size == (H, W):
        assert used == {0, 1, 2, 3, 4}
    path = tmp_path / "adam7.png"
    path.write_bytes(data)
    got = png_io.read_png(path)
    assert got.dtype == dtype and got.shape == img.shape
    np.testing.assert_array_equal(got, img)
    ref = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if channels == 2:  # cv2 reads grey + alpha as BGRA
        ref = ref[..., [0, 3]]
    np.testing.assert_array_equal(got, _bgr(ref) if channels > 2 else ref)
    if dtype == np.uint8 or channels == 1:
        with Image.open(path) as pil:
            assert pil.info.get("interlace") == 1
            np.testing.assert_array_equal(got, np.asarray(pil))


def test_interlaced_palette_and_low_depth_files_raise(tmp_path):
    """An interlaced file now decodes (it used to raise); palette and
    low-depth files still raise, naming the file."""
    img = _image((H, W, 3))
    inter = tmp_path / "interlaced.png"
    inter.write_bytes(_adam7_png(img)[0])
    np.testing.assert_array_equal(png_io.read_png(inter), img)
    np.testing.assert_array_equal(png_io.read_png(inter), np.asarray(Image.open(inter)))
    # an Adam7 header over plain scanlines is malformed
    data = bytearray(png_io.encode_png(img))
    assert bytes(data[12:16]) == b"IHDR"
    data[28] = 1
    data[29:33] = zlib.crc32(bytes(data[12:29])).to_bytes(4, "big")
    with pytest.raises(png_io.PNGError, match="image data holds"):
        png_io.decode_png(bytes(data), "forged.png")
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
