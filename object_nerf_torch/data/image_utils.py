"""Image utilities of the dataset: mask weights and the frame resamplers.

Counterpart of `object_nerf_tpu/data/image_utils.py` (reference
datasets/image_utils.py:8-59) and of the PIL / cv2 calls the JAX package's
`GenericDataset` makes (`data/generic_dataset.py:45-75`), in numpy:

* `rebalance_mask`: per-pixel weights that rebalance foreground against
  background. Fixed fg/bg weights when given, otherwise the reference's
  count-ratio rule (fg pixels weighted bg_count/fg_count and vice versa,
  counts clamped to >= 1).
* `compute_distance_transform_weights`: boundary-softened weights from two
  distance transforms (inside and outside the mask), capped at
  `uncertain_pixel_distance`, min-max normalised to [0, 1]. The distance is
  cv2's `distanceTransform(DIST_L2, 3)`, which is a 3x3 chamfer distance
  (steps a = 0.955, b = 1.3693), not the exact Euclidean one, reproduced
  here by its two raster passes, each row's in-row term as a running min.
* `resize_lanczos`: PIL's `Image.resize(size, LANCZOS)` of a uint8 image.
* `resize_nearest`: cv2's `resize(..., interpolation=INTER_NEAREST)`.

Both resamplers return the input unchanged (a copy) when the size is
unchanged, as PIL and cv2 do.
"""

from __future__ import annotations

import numpy as np


def rebalance_mask(
    mask: np.ndarray, fg_weight: float | None = None, bg_weight: float | None = None
) -> np.ndarray:
    """Per-pixel rebalance weights for a boolean fg mask (H, W)."""
    if fg_weight is None and bg_weight is None:
        # reference count-ratio rule (datasets/image_utils.py:10-15)
        fg_cnt = max(int(mask.sum()), 1)
        bg_cnt = max(int((~mask).sum()), 1)
        weight = np.ones(mask.shape, dtype=np.float32)
        weight[mask] = float(bg_cnt) / fg_cnt
        weight[~mask] = float(fg_cnt) / bg_cnt
        return weight
    weight = np.full(mask.shape, bg_weight, dtype=np.float32)
    weight[mask] = fg_weight
    return weight


# ---------------------------------------------------------------------------
# Distance transform (cv2 DIST_L2, mask 3)
# ---------------------------------------------------------------------------

# cv2's 3x3 L2 chamfer steps (float32 constants), and the border's distance
_HV = float(np.float32(0.955))
_DIAG = float(np.float32(1.3693))
_FAR = 1e30


def _row_pass(v: np.ndarray) -> np.ndarray:
    """t[j] = min(v[j], t[j - 1] + a) along a row, t[-1] the far border: a
    running min of v[k] - a*k, then + a*j."""
    steps = _HV * np.arange(len(v))
    return np.minimum.accumulate(v - steps) + steps


def distance_transform_l2_3x3(mask: np.ndarray) -> np.ndarray:
    """cv2.distanceTransform(mask, DIST_L2, 3) of a boolean mask: the 3x3
    chamfer distance of each True pixel to the nearest False one (False
    pixels 0), float32, from cv2's two raster passes. The image border counts
    as infinitely far; a mask with no False pixel is FLT_MAX everywhere, as
    in cv2. cv2 adds its steps in float32 one pixel after the other, this
    sums them in float64 (measured: within 1.5e-6 of the distance)."""
    mask = np.asarray(mask, bool)
    h, w = mask.shape
    if mask.all():
        return np.full((h, w), np.finfo(np.float32).max, np.float32)
    tmp = np.full((h + 2, w + 2), _FAR)
    for i in range(h):  # forward pass: top-left to bottom-right
        up = tmp[i]
        v = np.minimum(np.minimum(up[:-2] + _DIAG, up[1:-1] + _HV), up[2:] + _DIAG)
        tmp[i + 1, 1:-1] = _row_pass(np.where(mask[i], v, 0.0))
    for i in range(h - 1, -1, -1):  # backward pass: bottom-right to top-left
        down = tmp[i + 2]
        v = np.minimum(np.minimum(down[2:] + _DIAG, down[1:-1] + _HV), down[:-2] + _DIAG)
        v = np.minimum(v, tmp[i + 1, 1:-1])
        tmp[i + 1, 1:-1] = _row_pass(v[::-1])[::-1]
    return tmp[1:-1, 1:-1].astype(np.float32)


def _normalize_minmax(x: np.ndarray) -> np.ndarray:
    """cv2.normalize(x, x, 0, 1, NORM_MINMAX) of a float32 array."""
    lo, hi = float(x.min()), float(x.max())
    scale = np.float32(1.0 / (hi - lo) if hi - lo > np.finfo(np.float64).eps else 0.0)
    shift = np.float32(0.0) - np.float32(lo * float(scale))
    return (x * scale + shift).astype(np.float32)


def compute_distance_transform_weights(
    mask: np.ndarray,
    uncertain_pixel_distance: float = 15.0,
    fg_bg_balance_weight: bool = False,
) -> np.ndarray:
    """Down-weight pixels near the mask boundary using distance transforms
    (JAX `data/image_utils.py:48-83`): the distance inside the mask and
    outside it, both capped at `uncertain_pixel_distance`; pixels strictly
    inside the cap band take their distance, all others the cap; min-max
    normalised to [0, 1]. With `fg_bg_balance_weight`, multiplied by the
    count-ratio `rebalance_mask`."""
    mask = np.asarray(mask, bool)
    max_dist = uncertain_pixel_distance
    dist_fg = distance_transform_l2_3x3(mask)
    dist_bg = distance_transform_l2_3x3(~mask)

    dist = np.full_like(dist_fg, max_dist)
    dist_fg = np.minimum(dist_fg, max_dist)
    dist_bg = np.minimum(dist_bg, max_dist)
    fg_band = (dist_fg < max_dist) & (dist_fg > 0)
    dist[fg_band] = dist_fg[fg_band]
    bg_band = (dist_bg < max_dist) & (dist_bg > 0)
    dist[bg_band] = dist_bg[bg_band]

    dist = _normalize_minmax(dist)
    if fg_bg_balance_weight:
        dist *= rebalance_mask(mask)
    return dist


# ---------------------------------------------------------------------------
# Resamplers
# ---------------------------------------------------------------------------

_LANCZOS_SUPPORT = 3.0
_PRECISION_BITS = 32 - 8 - 2  # PIL's fixed point for 8-bit images


def _lanczos(x: np.ndarray) -> np.ndarray:
    """PIL's truncated sinc: sinc(x) sinc(x / 3) on [-3, 3)."""
    return np.where((x >= -3.0) & (x < 3.0), np.sinc(x) * np.sinc(x / 3.0), 0.0)


def _lanczos_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) fixed-point taps of PIL's `precompute_coeffs` and
    `normalize_coeffs_8bpc`, as float64 (whole numbers)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _LANCZOS_SUPPORT * filterscale
    mat = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        x = np.arange(xmin, xmax)
        k = _lanczos((x - center + 0.5) * (1.0 / filterscale))
        ww = k.sum()
        if ww != 0.0:
            k = k / ww
        k = k * (1 << _PRECISION_BITS)
        mat[xx, xmin:xmax] = np.where(k < 0, np.trunc(k - 0.5), np.trunc(k + 0.5))
    return mat


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of PIL's separable resampler along `axis`, rounded to uint8.
    The sums are whole numbers below 2^53, so float64 holds them exactly."""
    mat = _lanczos_matrix(img.shape[axis], out_size)
    moved = np.moveaxis(img.astype(np.float64), axis, -1)
    acc = moved @ mat.T + float(1 << (_PRECISION_BITS - 1))
    out = np.clip(np.floor(acc / (1 << _PRECISION_BITS)), 0, 255).astype(np.uint8)
    return np.moveaxis(out, -1, axis)


def resize_lanczos(img: np.ndarray, size) -> np.ndarray:
    """PIL's `Image.fromarray(img).resize(size, LANCZOS)` of a uint8 (H, W)
    or (H, W, C) image; `size` is (width, height). Horizontal pass first,
    rounded to uint8, then the vertical pass, each only where the size
    changes. (PIL premultiplies an RGBA image's colour by its alpha before
    resampling; this resamples every channel alike.)"""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_lanczos takes uint8 images, not {img.dtype}")
    w, h = int(size[0]), int(size[1])
    out = img.copy()
    if w != img.shape[1]:
        out = _resample_axis(out, w, 1)
    if h != img.shape[0]:
        out = _resample_axis(out, h, 0)
    return out


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """cv2's `resize(img, size, interpolation=INTER_NEAREST)`; `size` is
    (width, height). Source index floor(dst * (1 / (dst_size / src_size))),
    clamped to the last pixel."""
    img = np.asarray(img)
    w, h = int(size[0]), int(size[1])
    src_h, src_w = img.shape[:2]
    if (w, h) == (src_w, src_h):
        return img.copy()
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / src_w))).astype(np.int64), src_w - 1)
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / src_h))).astype(np.int64), src_h - 1)
    return img[ys[:, None], xs[None, :]]


__all__ = ["rebalance_mask", "compute_distance_transform_weights",
           "distance_transform_l2_3x3", "resize_lanczos", "resize_nearest"]
