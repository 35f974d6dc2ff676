"""Alpha compositing (volume rendering quadrature).

Counterpart of `object_nerf_tpu/ops/compositing.py:38-116` (reference
models/rendering.py:140-229):

* deltas from consecutive z values; the last delta is 1e10 for the scene
  pass and 0 for the instance pass;
* alpha = 1 - exp(-delta * relu(sigma + noise));
* exclusive transmittance: cumprod of (1 - alpha + 1e-10), shifted by one;
* rgb/depth/opacity maps as weighted sums; optional white background for
  the scene, and the instance rgb is always white-backed;
* instance occlusion suppression (training only): instance alphas beyond
  scene depth + frustum_bound_th are zeroed outside the pass-through mask.

The density noise comes from a `torch.Generator`, or from explicit standard
normal draws `noise` of the densities' shape, which take precedence. As in
the JAX package, `noise_std > 0` adds noise only when one of the two is given.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

T_EPS = 1e-10  # transmittance epsilon (rendering.py:160)
DELTA_INF = 1e10  # "infinite" last delta (rendering.py:144)


class CompositeOut(NamedTuple):
    weights: torch.Tensor  # (N_rays, N_samples)
    opacity: torch.Tensor  # (N_rays,)
    rgb: torch.Tensor  # (N_rays, 3)
    depth: torch.Tensor  # (N_rays,)


def compute_deltas(z_vals: torch.Tensor, last_delta_inf: bool) -> torch.Tensor:
    d = z_vals[:, 1:] - z_vals[:, :-1]
    last = torch.full_like(d[:, :1], DELTA_INF if last_delta_inf else 0.0)
    return torch.cat([d, last], dim=-1)


def alphas_from_sigmas(
    sigmas: torch.Tensor,
    deltas: torch.Tensor,
    noise_std: float = 0.0,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if noise_std > 0.0 and (noise is not None or generator is not None):
        if noise is None:
            noise = torch.randn(sigmas.shape, dtype=sigmas.dtype, device=sigmas.device,
                                generator=generator)
        sigmas = sigmas + noise * noise_std
    return 1.0 - torch.exp(-deltas * torch.relu(sigmas))


class _CumprodPositive(torch.autograd.Function):
    """`torch.cumprod` along the last axis for inputs that are never zero.
    Its backward is the formula PyTorch's own takes when no input is zero,
    `reverse_cumsum(g * out) / x`, without PyTorch's test for zeros, which
    reads a flag back from the device and so stalls the host once per call."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return (g * out).flip(-1).cumsum(-1).flip(-1) / x


def weights_from_alphas(alphas: torch.Tensor) -> torch.Tensor:
    """w_i = a_i * prod_{j<i} (1 - a_j + eps)   (exclusive transmittance).
    alphas <= 1, so every factor is at least eps."""
    trans = _CumprodPositive.apply(1.0 - alphas + T_EPS)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    return alphas * trans


def composite(
    sigmas: torch.Tensor,
    rgbs: torch.Tensor,
    z_vals: torch.Tensor,
    noise_std: float = 0.0,
    last_delta_inf: bool = True,
    white_back: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> CompositeOut:
    """Scene-branch compositing. sigmas (N,S), rgbs (N,S,3), z_vals (N,S)."""
    deltas = compute_deltas(z_vals, last_delta_inf)
    alphas = alphas_from_sigmas(sigmas, deltas, noise_std, generator, noise)
    weights = weights_from_alphas(alphas)
    opacity = weights.sum(dim=-1)
    rgb = (weights[..., None] * rgbs).sum(dim=-2)
    depth = (weights * z_vals).sum(dim=-1)
    if white_back:
        rgb = rgb + (1.0 - opacity[..., None])
    return CompositeOut(weights, opacity, rgb, depth)


def composite_instance(
    inst_sigmas: torch.Tensor,
    inst_rgbs: torch.Tensor,
    z_vals: torch.Tensor,
    scene_depth: torch.Tensor,
    noise_std: float = 0.0,
    frustum_bound_th: float = 0.0,
    pass_through_mask: Optional[torch.Tensor] = None,
    apply_occlusion: bool = True,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> CompositeOut:
    """Instance-branch compositing with occlusion-aware alpha suppression.

    The last delta is always 0 for the instance pass and the instance rgb
    map is always white-backed (rendering.py:146-148, 221-223).
    pass_through_mask: (N_rays,) or (N_rays, 1) bool — rays whose instance
    alphas are never suppressed.
    """
    deltas = compute_deltas(z_vals, last_delta_inf=False)
    alphas = alphas_from_sigmas(inst_sigmas, deltas, noise_std, generator, noise)

    if apply_occlusion and frustum_bound_th > 0:
        occluded = (scene_depth[:, None] + frustum_bound_th) < z_vals
        if pass_through_mask is not None:
            pt = pass_through_mask.reshape(-1, 1).bool()
            occluded = occluded & ~pt
        alphas = torch.where(occluded, torch.zeros_like(alphas), alphas)

    weights = weights_from_alphas(alphas)
    opacity = weights.sum(dim=-1)
    rgb = (weights[..., None] * inst_rgbs).sum(dim=-2)
    depth = (weights * z_vals).sum(dim=-1)
    rgb = rgb + (1.0 - opacity[..., None])  # always white back for objects
    return CompositeOut(weights, opacity, rgb, depth)
