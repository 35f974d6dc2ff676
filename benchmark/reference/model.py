"""The two-branch Object-NeRF MLP (reference models/nerf_model.py) on a
dict of weights under the reference's state-dict names.

Scene branch: PE inputs -> D layers of width W, LeakyReLU(0.01), the input
concatenated in front of the hidden state before each skip layer -> sigma
head; a linear `final` layer, [final, PE(dir)] -> LeakyReLU layer of W/2 ->
sigmoid rgb. Object branch: the same on [emb_xyz, PE(object voxel
features), code]. emb_xyz is PE(xyz) for the classical model and
[PE(scene voxel features), PE(xyz)] for the voxel model."""

from __future__ import annotations

import torch

from ..model_spec import Spec, branch_layers

FP8_MAX = 448.0  # float8 e4m3


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude to the format's largest), the way fp8 products are fed."""
    s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (q - x).detach()


ROUNDINGS = {"exact": exact, "fp8": fp8}


def pe(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(n-1) x), cos(2^(n-1) x)]."""
    parts = [x]
    for k in range(n_freqs):
        parts += [torch.sin((2.0 ** k) * x), torch.cos((2.0 ** k) * x)]
    return torch.cat(parts, -1)


def _lin(w, name, x, rnd):
    return rnd(x) @ rnd(w[name + ".weight"]).t() + w[name + ".bias"]


def _lrelu(x):
    return torch.nn.functional.leaky_relu(x, 0.01)


def branch(w, net: str, spec: Spec, which: str, x_in, dir_pe, rnd, sigma_only=False):
    layers = branch_layers(spec, which)
    depth = spec.D if which == "scene" else spec.inst_D
    skips = spec.skips if which == "scene" else spec.inst_skips
    h = x_in
    for i in range(depth):
        if i in skips:
            h = torch.cat([x_in, h], -1)
        h = _lrelu(_lin(w, f"{net}.{layers[i][0]}", h, rnd))
    final, sigma, dirn, rgb = (f"{net}.{n}" for n, _, _ in layers[depth:])
    s = _lin(w, sigma, h, rnd)[:, 0]
    if sigma_only:
        return s, None
    x_final = _lin(w, final, h, rnd)
    d = _lrelu(_lin(w, dirn, torch.cat([x_final, dir_pe], -1), rnd))
    return s, torch.sigmoid(_lin(w, rgb, d, rnd))


def inputs(spec: Spec, xyz, voxel_raw):
    """(scene input, object voxel input or None) of samples xyz (N, 3) with
    their raw voxel features (N, C) or None."""
    x = pe(xyz, spec.N_freq_xyz)
    if voxel_raw is None:
        return x, None
    scn = pe(voxel_raw[:, :spec.N_scn_voxel_size], spec.N_freq_voxel)
    obj = pe(voxel_raw[:, spec.N_scn_voxel_size:], spec.N_freq_voxel)
    return torch.cat([scn, x], -1), obj


def forward(w, net: str, spec: Spec, xyz, voxel_raw, dir_pe, codes, rnd, sigma_only=False):
    """Both branches over samples (N, 3); dir_pe and codes (N, .) per sample.
    Returns (sigma, rgb, inst_sigma, inst_rgb); only sigma when `sigma_only`."""
    x, obj = inputs(spec, xyz, voxel_raw)
    s, rgb = branch(w, net, spec, "scene", x, dir_pe, rnd, sigma_only)
    if sigma_only:
        return s, None, None, None
    parts = [x] + ([obj] if obj is not None else []) + [codes]
    si, rgbi = branch(w, net, spec, "object", torch.cat(parts, -1), dir_pe, rnd)
    return s, rgb, si, rgbi
