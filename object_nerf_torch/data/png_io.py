"""PNG read and write with `zlib` and numpy.

The JAX package reads frames with PIL and cv2 (`data/generic_dataset.py:
45-75`) and its CLIs write them with imageio; none of the three is a
dependency of the port. This module covers what the datasets and the CLIs
meet:

* 8-bit grey, grey + alpha, RGB and RGBA, and the same at 16 bits (samples
  are big-endian in the file, native `uint16` in memory), plain or Adam7
  interlaced (seven passes, each a small image of its own rows, filtered
  on its own; a pass that an image smaller than 8 x 8 leaves empty holds no
  bytes);
* all five row filters on read (None, Sub, Up, Average, Paeth);
* on write, one fixed filter (default Up) or a sequence cycled row by row,
  so every decode path can be exercised.

Palette images and bit depths below 8 raise a `PNGError` naming the file
(PIL opens a palette PNG as its indices, which the JAX package would read as
grey).

Decoding is vectorised. Rows whose filters are None, Sub or Up are undone a
row at a time (Sub as a running sum mod 256 per byte lane). A file with
Average or Paeth rows, whose prediction depends on the reconstructed left
neighbour, is undone along anti-diagonals of pixels: pixel (r, x) needs only
(r, x - 1), (r - 1, x) and (r - 1, x - 1), so every pixel of one
anti-diagonal is computed at once, H + W - 1 steps per image.

`read_png(path)` returns what cv2's `IMREAD_UNCHANGED` and PIL's
`np.asarray(Image.open(path))` return for these files: (H, W) for grey,
(H, W, C) otherwise, RGB channel order.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Iterable, Union

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (palette, type 3, is refused)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}
FILTERS = {"none": 0, "sub": 1, "up": 2, "average": 3, "paeth": 4}
# Adam7 passes: (x0, y0, dx, dy) of the pixels each one carries
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


class PNGError(ValueError):
    """A PNG this codec does not read (or a malformed one)."""


# ---------------------------------------------------------------------------
# Read
# ---------------------------------------------------------------------------


def _chunks(data: bytes, name: str):
    if data[:8] != _SIGNATURE:
        raise PNGError(f"{name}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise PNGError(f"{name}: truncated {ctype!r} chunk")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise PNGError(f"{name}: CRC mismatch in the {ctype!r} chunk")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise PNGError(f"{name}: no IEND chunk")


def _paeth(a, b, c):
    """The Paeth predictor on int32 arrays."""
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(ftypes, filt, bpp):
    """Rows of filters None, Sub and Up only: one row at a time."""
    h, stride = filt.shape
    out = np.empty_like(filt)
    prior = np.zeros(stride, np.uint8)
    for r in range(h):
        row, t = filt[r], ftypes[r]
        if t == 0:
            rec = row
        elif t == 2:
            rec = row + prior  # uint8 arithmetic wraps mod 256
        else:  # Sub: a running sum over each byte lane
            rec = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        out[r] = rec
        prior = rec
    return out


def _unfilter_wavefront(ftypes, filt, bpp):
    """Any filters: along anti-diagonals of pixels. Q[d, r + 1] holds pixel
    (r, d - r); Q[:, 0] is the zero row above the image, and cells left of
    the image stay zero, as PNG's predictors read them."""
    h, stride = filt.shape
    w = stride // bpp
    px = filt.reshape(h, w, bpp).astype(np.int32)
    n_diag = h + w - 1
    q = np.zeros((n_diag + 1, h + 1, bpp), np.int32)  # one zero diagonal at the end
    f = np.zeros((n_diag, h, bpp), np.int32)
    rr, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    f[rr + xx, rr] = px
    t = ftypes.astype(np.int32)[:, None]
    for d in range(n_diag):
        lo, hi = max(0, d - w + 1), min(h, d + 1)
        a = q[d - 1, lo + 1:hi + 1]  # (r, x - 1); q[-1] is the zero diagonal
        b = q[d - 1, lo:hi]  # (r - 1, x)
        c = q[d - 2, lo:hi] if d >= 2 else np.zeros_like(b)  # (r - 1, x - 1)
        tt = t[lo:hi]
        pred = np.where(tt == 1, a, np.where(tt == 2, b, np.where(
            tt == 3, (a + b) >> 1, np.where(tt == 4, _paeth(a, b, c), 0))))
        q[d, lo + 1:hi + 1] = (f[d, lo:hi] + pred) & 0xFF
    return q[rr + xx, rr + 1].astype(np.uint8).reshape(h, stride)


def _unfilter(rows: np.ndarray, bpp: int, name: str) -> np.ndarray:
    """(h, stride + 1) filtered rows, each led by its filter type, -> the
    (h, stride) bytes they encode."""
    ftypes, filt = rows[:, 0], rows[:, 1:]
    if (ftypes > 4).any():
        raise PNGError(f"{name}: unknown row filter {int(ftypes.max())}")
    if (ftypes >= 3).any():
        return _unfilter_wavefront(ftypes, filt, bpp)
    return _unfilter_rows(ftypes, filt, bpp)


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode the bytes of a PNG file (see `read_png`)."""
    header, idat = None, []
    for ctype, body in _chunks(data, name):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"PLTE" and header is not None and header[3] == 3:
            raise PNGError(f"{name}: palette PNGs are not supported")
    if header is None:
        raise PNGError(f"{name}: no IHDR chunk")
    w, h, depth, ctype, compression, filter_method, interlace = header
    if ctype not in _CHANNELS:
        kind = "palette" if ctype == 3 else f"colour type {ctype}"
        raise PNGError(f"{name}: {kind} PNGs are not supported")
    if depth not in (8, 16):
        raise PNGError(f"{name}: bit depth {depth} is not supported (8 or 16)")
    if interlace not in (0, 1):
        raise PNGError(f"{name}: unknown interlace method {interlace}")
    if compression != 0 or filter_method != 0:
        raise PNGError(f"{name}: unknown compression or filter method")
    channels = _CHANNELS[ctype]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    # (x0, y0, dx, dy, pass width, pass height) of each non-empty pass
    passes = [(x0, y0, dx, dy, -(-(w - x0) // dx), -(-(h - y0) // dy))
              for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),))]
    passes = [p for p in passes if p[4] > 0 and p[5] > 0]
    expected = sum(ph * (pw * bpp + 1) for *_, pw, ph in passes)
    if raw.size != expected:
        raise PNGError(f"{name}: image data holds {raw.size} bytes, expected {expected}")
    pix = np.empty((h, w, bpp), np.uint8)
    pos = 0
    for x0, y0, dx, dy, pw, ph in passes:
        rows = raw[pos:pos + ph * (pw * bpp + 1)].reshape(ph, pw * bpp + 1)
        pos += rows.size
        pix[y0::dy, x0::dx] = _unfilter(rows, bpp, name).reshape(ph, pw, bpp)
    if depth == 16:
        pix = np.ascontiguousarray(pix).reshape(-1).view(">u2").astype(np.uint16)
    img = pix.reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img


def read_png(path: Union[str, Path]) -> np.ndarray:
    """Read a PNG: (H, W) for grey, (H, W, C) for grey + alpha (2), RGB (3)
    or RGBA (4); `uint8` or `uint16` by the file's bit depth."""
    return decode_png(Path(path).read_bytes(), str(path))


# ---------------------------------------------------------------------------
# Write
# ---------------------------------------------------------------------------


def _filter_rows(pix: np.ndarray, ftypes: np.ndarray, bpp: int) -> np.ndarray:
    """Filter every row of `pix` (H, stride) uint8 by its type, in bulk: the
    encoder's predictors read the original bytes."""
    x = pix.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    preds = (np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c))
    pred = np.choose(ftypes[:, None].astype(np.int64), preds)
    return ((x - pred) & 0xFF).astype(np.uint8)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def encode_png(img: np.ndarray, filters: Union[int, str, Iterable] = "up") -> bytes:
    """Encode (H, W) or (H, W, C) `uint8` / `uint16` as PNG bytes. `filters`
    is one filter (name or 0-4) for every row, or a sequence cycled row by
    row."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise PNGError(f"PNG samples are uint8 or uint16, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, channels = img.shape
    if channels not in _COLOR_TYPE:
        raise PNGError(f"cannot write {channels} channels (1, 2, 3 or 4)")
    depth = 8 * img.dtype.itemsize
    bpp = channels * img.dtype.itemsize
    pix = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    pix = pix.view(np.uint8).reshape(h, w * bpp)

    if isinstance(filters, (int, np.integer, str)):
        filters = [filters]
    seq = [FILTERS[f.lower()] if isinstance(f, str) else int(f) for f in filters]
    if not seq or any(f not in range(5) for f in seq):
        raise PNGError(f"row filters are 0-4 or their names, got {filters!r}")
    ftypes = np.resize(np.asarray(seq, np.uint8), h)
    raw = np.concatenate([ftypes[:, None], _filter_rows(pix, ftypes, bpp)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[channels], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes())) + _chunk(b"IEND", b""))


def write_png(path: Union[str, Path], img: np.ndarray,
              filters: Union[int, str, Iterable] = "up") -> None:
    """Write `img` as a PNG file (see `encode_png`)."""
    Path(path).write_bytes(encode_png(img, filters))
