"""Image quality metrics (masked PSNR, SSIM).

Counterpart of `object_nerf_tpu/train/metrics.py` (reference
utils/metrics.py:5-23): PSNR is -10 log10 of the (optionally masked) MSE;
SSIM is kornia 0.4.1's `ssim(img1, img2, 3, "mean")` (3x3 gaussian window,
sigma 1.5, zero-padded "same" filtering per channel) followed by the
reference's DSSIM clamp and `1 - 2 dssim`.

The 3x3 window is applied as nine shifted, weighted sums in f32, not as a
convolution: on the card a float32 convolution would run through cuDNN in
TF32 by default.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def mse(pred: torch.Tensor, gt: torch.Tensor,
        valid_mask: Optional[torch.Tensor] = None,
        count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared error over the mask's elements; `count` replaces the
    mask's own count as the divisor (a data-parallel step's global count)."""
    err = (pred - gt) ** 2
    if valid_mask is None:
        return err.mean()
    m = valid_mask.to(err.dtype).reshape(err.shape[0], -1).expand(err.shape)
    return (err * m).sum() / (m.sum() if count is None else count).clamp(min=1.0)


def psnr(pred: torch.Tensor, gt: torch.Tensor,
         valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return -10.0 * torch.log10(mse(pred, gt, valid_mask))


def _gaussian_kernel2d(window: int, sigma: float = 1.5) -> torch.Tensor:
    """kornia 0.4.1 get_gaussian_kernel2d: normalised separable gaussian."""
    x = torch.arange(window, dtype=torch.float32) - window // 2
    if window % 2 == 0:
        x = x + 0.5
    g = torch.exp(-(x**2) / (2.0 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g)


def _blur(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Zero-padded 'same' filtering of (H, W, C) by the (win, win) kernel."""
    win = k.shape[0]
    pad = (win - 1) // 2
    h, w = x.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, pad, win - 1 - pad, pad, win - 1 - pad))
    out = torch.zeros_like(x)
    for i in range(win):
        for j in range(win):
            out = out + k[i, j] * xp[i:i + h, j:j + w]
    return out


def ssim_map(pred: torch.Tensor, gt: torch.Tensor, window: int = 3,
             max_val: float = 1.0) -> torch.Tensor:
    """Per-pixel SSIM index map (H, W, 3), kornia 0.4.1 math."""
    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    k = _gaussian_kernel2d(window).to(pred.device, pred.dtype)
    mu_p, mu_g = _blur(pred, k), _blur(gt, k)
    var_p = _blur(pred * pred, k) - mu_p**2
    var_g = _blur(gt * gt, k) - mu_g**2
    cov = _blur(pred * gt, k) - mu_p * mu_g
    return ((2 * mu_p * mu_g + c1) * (2 * cov + c2)) / (
        (mu_p**2 + mu_g**2 + c1) * (var_p + var_g + c2)
    )


def ssim(pred: torch.Tensor, gt: torch.Tensor, window: int = 3,
         max_val: float = 1.0) -> torch.Tensor:
    """SSIM over (H, W, 3) images in [0, 1]; the mean index in [-1, 1]."""
    s = ssim_map(pred, gt, window=window, max_val=max_val)
    dssim = torch.clamp((1.0 - s) / 2.0, 0.0, 1.0)
    return 1.0 - 2.0 * dssim.mean()
