"""Ray sampling: stratified depth sampling + inverse-CDF importance sampling.

Counterpart of `object_nerf_tpu/ops/sampling.py:28-114` (reference
models/rendering.py:11-61, 260-277, 313). Randomness comes from an optional
`torch.Generator`, or from explicit uniform draws `u` in [0, 1), which take
precedence (torch and JAX generators give different numbers from one seed,
so a parity test hands both sides the same draws); the deterministic eval
path needs neither.
"""

from __future__ import annotations

from typing import Optional

import torch


def stratified_sample(
    near: torch.Tensor,
    far: torch.Tensor,
    n_samples: int,
    use_disp: bool = False,
    perturb: float = 0.0,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """near/far (N_rays, 1) -> z_vals (N_rays, n_samples). `u` (N_rays,
    n_samples): the jitter's uniform draws, instead of `generator`'s."""
    z_steps = torch.linspace(0.0, 1.0, n_samples, dtype=near.dtype, device=near.device)
    if not use_disp:
        z_vals = near * (1.0 - z_steps) + far * z_steps
    else:
        z_vals = 1.0 / (1.0 / near * (1.0 - z_steps) + 1.0 / far * z_steps)
    z_vals = z_vals.expand(near.shape[0], n_samples)

    if perturb > 0:
        z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        upper = torch.cat([z_mid, z_vals[:, -1:]], dim=-1)
        lower = torch.cat([z_vals[:, :1], z_mid], dim=-1)
        if u is None:
            u = torch.rand(z_vals.shape, dtype=z_vals.dtype, device=z_vals.device,
                           generator=generator)
        z_vals = lower + (upper - lower) * (perturb * u)
    return z_vals.contiguous()


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_importance: int,
    det: bool = False,
    eps: float = 1e-5,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Draw n_importance samples from the piecewise-constant pdf over bins.

    bins (N_rays, B+1) bin edges; weights (N_rays, B) unnormalised masses
    (detached, as the reference does). Returns (N_rays, n_importance).
    Right-sided search; `u` beyond the last cdf edge (u == 1) clamps to the
    top bin; a bin of (numerically) zero mass gets denominator 1. `u`
    (N_rays, n_importance): the uniform draws when not `det`, instead of
    `generator`'s.
    """
    weights = weights.detach() + eps
    n_rays, n_bins = weights.shape
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # (N, B+1)

    if det:
        u = torch.linspace(0.0, 1.0, n_importance, dtype=cdf.dtype, device=cdf.device)
        u = u.expand(n_rays, n_importance).contiguous()
    elif u is None:
        u = torch.rand((n_rays, n_importance), dtype=cdf.dtype, device=cdf.device,
                       generator=generator)
    else:
        u = u.contiguous()

    inds = torch.searchsorted(cdf, u, right=True)  # >= 1, since cdf[:, 0] == 0 <= u
    below = inds - 1
    beyond = inds > n_bins  # every edge <= u
    above = inds.clamp(max=n_bins)
    cdf_lo = torch.gather(cdf, 1, below)
    bin_lo = torch.gather(bins, 1, below)
    cdf_hi = torch.where(beyond, torch.ones_like(u), torch.gather(cdf, 1, above))
    bin_hi = torch.gather(bins, 1, above)

    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bin_lo + (u - cdf_lo) / denom * (bin_hi - bin_lo)


def merge_z_vals(z_coarse: torch.Tensor, z_fine: torch.Tensor) -> torch.Tensor:
    """Sort-merge coarse and importance z values (rendering.py:313)."""
    return torch.sort(torch.cat([z_coarse, z_fine], dim=-1), dim=-1).values
