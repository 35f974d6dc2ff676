"""Hierarchical volume rendering of the reference (models/rendering.py) and
its losses (models/losses.py), in plain PyTorch.

Per ray: N_samples stratified depths in [near, far] (jittered by the
draws `perturb` in training) -> both branches -> the scene composite (the
last interval 1e10 long, density noise from the draws) and the object
composite (last interval 0, white background, in training its alphas
beyond the scene depth + frustum bound zeroed off the pass-through mask)
-> N_importance depths drawn by inverse CDF from the coarse scene weights
(detached; the draws `pdf` in training, evenly spaced at eval) -> both sets
sorted together -> the fine model over all of them, composited alike. The
eval render runs the coarse model's scene density alone."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..model_spec import Spec
from . import model, voxel

T_EPS = 1e-10
DELTA_INF = 1e10
PDF_EPS = 1e-5


def stratified(near, far, n, u=None):
    t = torch.linspace(0.0, 1.0, n, device=near.device)
    z = (near * (1.0 - t) + far * t).expand(near.shape[0], n)
    if u is None:
        return z.contiguous()
    mid = 0.5 * (z[:, :-1] + z[:, 1:])
    upper = torch.cat([mid, z[:, -1:]], -1)
    lower = torch.cat([z[:, :1], mid], -1)
    return lower + (upper - lower) * u


def inverse_cdf(bins, weights, n, u=None):
    """Samples of the piecewise-constant pdf of `weights` (N, B) over bin
    edges `bins` (N, B+1): u evenly spaced in [0, 1] when None."""
    w = weights.detach() + PDF_EPS
    pdf = w / w.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)
    if u is None:
        u = torch.linspace(0.0, 1.0, n, device=bins.device).expand(bins.shape[0], n)
    u = u.contiguous()
    B = weights.shape[1]
    idx = torch.searchsorted(cdf, u, right=True)
    below = (idx - 1).clamp(min=0)
    above = idx.clamp(max=B)
    c0, c1 = cdf.gather(1, below), cdf.gather(1, above)
    b0, b1 = bins.gather(1, below), bins.gather(1, above)
    denom = c1 - c0
    denom = torch.where(denom < PDF_EPS, torch.ones_like(denom), denom)
    return b0 + (u - c0) / denom * (b1 - b0)


def _weights(alpha):
    keep = torch.cumprod(1.0 - alpha + T_EPS, -1)
    return alpha * torch.cat([torch.ones_like(keep[:, :1]), keep[:, :-1]], -1)


def alphas(sigma, z, noise=None, last=DELTA_INF):
    """1 - exp(-delta relu(sigma + noise)), the last interval `last` long."""
    delta = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], last)], -1)
    if noise is not None:
        sigma = sigma + noise
    return 1.0 - torch.exp(-delta * torch.relu(sigma))


def maps(alpha, rgb, z, white: bool):
    wts = _weights(alpha)
    opacity = wts.sum(-1)
    out_rgb = (wts[..., None] * rgb).sum(-2)
    if white:
        out_rgb = out_rgb + (1.0 - opacity[:, None])
    return wts, out_rgb, (wts * z).sum(-1), opacity


def run_pass(w, net, spec: Spec, grid_ctx, rays, z, dir_pe, codes, rnd, out, typ,
             noise=None, noise_inst=None, occlusion=None):
    """Both branches over rays (N, 8) at depths z (N, S), composited into
    `out` under the reference's keys; returns the scene weights."""
    n, s = z.shape
    xyz = rays[:, None, 0:3] + rays[:, None, 3:6] * z[..., None]
    flat = xyz.reshape(-1, 3)
    raw = None
    if grid_ctx is not None:
        raw = voxel.lookup(grid_ctx[0], grid_ctx[1], flat)
    rep = lambda t: t[:, None, :].expand(n, s, t.shape[-1]).reshape(n * s, -1)  # noqa: E731
    sig, rgb, isig, irgb = model.forward(w, net, spec, flat, raw, rep(dir_pe), rep(codes), rnd)
    sig, isig = sig.reshape(n, s), isig.reshape(n, s)
    rgb, irgb = rgb.reshape(n, s, 3), irgb.reshape(n, s, 3)
    alpha = alphas(sig, z, noise)
    wts, out[f"rgb_{typ}"], out[f"depth_{typ}"], out[f"opacity_{typ}"] = maps(
        alpha, rgb, z, white=False)
    ialpha = alphas(isig, z, noise_inst, last=0.0)
    if occlusion is not None:  # training: (frustum bound, pass-through mask)
        th, pass_through = occlusion
        hidden = ((out[f"depth_{typ}"][:, None] + th) < z) & ~pass_through[:, None]
        ialpha = torch.where(hidden, torch.zeros_like(ialpha), ialpha)
    _, out[f"rgb_instance_{typ}"], out[f"depth_instance_{typ}"], \
        out[f"opacity_instance_{typ}"] = maps(ialpha, irgb, z, white=True)
    return wts


def train_forward(w, spec: Spec, grid_ctx, batch, draws, rnd, frustum_th: float):
    """Both passes of a training batch; `draws` holds the step's perturb,
    noise_coarse, noise_inst_coarse, pdf, noise_fine, noise_inst_fine."""
    rays = batch["rays"]
    dir_pe = model.pe(rays[:, 3:6], spec.N_freq_dir)
    codes = w["code_library.embedding_instance.weight"][batch["instance_ids"]]
    occl = (frustum_th, batch["pass_through_mask"].bool()) if frustum_th > 0 else None
    out: Dict[str, torch.Tensor] = {}
    z = stratified(rays[:, 6:7], rays[:, 7:8], spec.N_samples, draws["perturb"])
    wc = run_pass(w, "nerf_coarse", spec, grid_ctx, rays, z, dir_pe, codes, rnd, out, "coarse",
                  draws["noise_coarse"], draws["noise_inst_coarse"], occl)
    mid = 0.5 * (z[:, :-1] + z[:, 1:])
    zf = inverse_cdf(mid, wc[:, 1:-1], spec.N_importance, draws["pdf"])
    z_all = torch.sort(torch.cat([z, zf], -1), -1).values
    run_pass(w, "nerf_fine", spec, grid_ctx, rays, z_all, dir_pe, codes, rnd, out, "fine",
             draws["noise_fine"], draws["noise_inst_fine"], occl)
    return out


def _mean(err, mask):
    mask = mask.to(err.dtype)
    return (err * mask).sum() / mask.sum().clamp(min=1.0)


def loss(out, batch, weights: dict) -> torch.Tensor:
    """TotalLoss: colour, depth, opacity, object colour and object depth,
    coarse and fine, each a masked mean (0 on an empty mask), weighted."""
    valid = batch["valid_mask"].float()
    inst = batch["instance_mask"].float()
    iw = batch["instance_mask_weight"]
    dmask = valid * (batch["depths"] > 0).float()
    total = 0.0
    for typ in ("coarse", "fine"):
        total = total + weights["color_loss_weight"] * _mean(
            (out[f"rgb_{typ}"] - batch["rgbs"]) ** 2, valid[:, None].expand(-1, 3))
        total = total + weights["depth_loss_weight"] * _mean(
            (out[f"depth_{typ}"] - batch["depths"]) ** 2, dmask)
        total = total + weights["opacity_loss_weight"] * _mean(
            (out[f"opacity_instance_{typ}"].clamp(0.0, 1.0) - inst) ** 2 * iw, valid)
        total = total + weights["instance_color_loss_weight"] * _mean(
            (out[f"rgb_instance_{typ}"] - batch["rgbs"]) ** 2 * iw[:, None],
            (valid * inst)[:, None].expand(-1, 3))
        total = total + weights["instance_depth_loss_weight"] * _mean(
            (out[f"depth_instance_{typ}"] - batch["depths"]) ** 2 * iw, dmask * inst)
    return total


@torch.no_grad()
def eval_rays(w, spec: Spec, grid_ctx, rays, ids, rnd) -> Dict[str, torch.Tensor]:
    """The deterministic render of rays (N, 8) with instance ids (N,): the
    fine pass's six maps."""
    dir_pe = model.pe(rays[:, 3:6], spec.N_freq_dir)
    codes = w["code_library.embedding_instance.weight"][ids]
    n = rays.shape[0]
    z = stratified(rays[:, 6:7], rays[:, 7:8], spec.N_samples)
    xyz = (rays[:, None, 0:3] + rays[:, None, 3:6] * z[..., None]).reshape(-1, 3)
    raw = voxel.lookup(grid_ctx[0], grid_ctx[1], xyz) if grid_ctx is not None else None
    sig = model.forward(w, "nerf_coarse", spec, xyz, raw, None, None, rnd,
                        sigma_only=True)[0].reshape(n, -1)
    wc = _weights(alphas(sig, z))
    mid = 0.5 * (z[:, :-1] + z[:, 1:])
    z_all = torch.sort(torch.cat([z, inverse_cdf(mid, wc[:, 1:-1], spec.N_importance)], -1),
                       -1).values
    out: Dict[str, torch.Tensor] = {}
    run_pass(w, "nerf_fine", spec, grid_ctx, rays, z_all, dir_pe, codes, rnd, out, "fine")
    return out


def grid_context(grid: Optional[voxel.Grid], w) -> Optional[tuple]:
    """(grid, padded dense features) of a voxel model's weights, or None."""
    if grid is None:
        return None
    from ..model_spec import TABLE
    return grid, voxel.dense_features(grid, w[TABLE])
