"""Seeded weights, made on the device in two large calls (one uniform, one
normal draw from a `torch.Generator` on the device), in f32, the type the
program trains and serves its master weights in. nn.Linear's bounds
U(+-1/sqrt(fan_in)) for every weight and bias; N(0, 1) for the codes and the
voxel features (nn.Embedding's default). The sigma heads' biases, of the
scene and the object branch, are raised by the configuration's
`density_bias` (see the configuration's `assumed`). Both the program and
the reference get these tensors."""

from __future__ import annotations

from collections import OrderedDict

import torch

from .model_spec import Spec, parameter_shapes

SIGMA_HEADS = ("sigma", "instance_sigma")  # the scene's and the object's density heads


def make(spec: Spec, seed: int, device, n_cells: int = 0,
         density_bias: float = 0.0) -> "OrderedDict[str, torch.Tensor]":
    shapes = parameter_shapes(spec, n_cells)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = {n: int(torch.Size(s).numel()) for n, s, _ in shapes}
    uni = [n for n, _, init in shapes if init[0] == "uniform"]
    nrm = [n for n, _, init in shapes if init[0] == "normal"]
    u = torch.rand(sum(sizes[n] for n in uni), generator=gen, device=device)
    z = torch.randn(sum(sizes[n] for n in nrm), generator=gen, device=device)
    out = OrderedDict()
    offs = {"uniform": 0, "normal": 0}
    for name, shape, init in shapes:
        k = sizes[name]
        src = u if init[0] == "uniform" else z
        flat = src[offs[init[0]]:offs[init[0]] + k]
        offs[init[0]] += k
        t = (2.0 * flat - 1.0) * init[1] if init[0] == "uniform" else flat.clone()
        out[name] = t.reshape(shape).contiguous()
    for net in ("nerf_coarse", "nerf_fine"):
        for head in SIGMA_HEADS:
            out[f"{net}.{head}.bias"] += density_bias
    return out
