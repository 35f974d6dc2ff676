"""The eval render's two fused kernels: wrappers and plain versions.

Replaces the Pallas TPU kernels of `object_nerf_tpu/ops/pallas_mlp.py`:

* `fused_coarse_weights` (`_weights_kernel`, pallas_mlp.py:845-963): xyz
  positional encoding -> scene trunk -> sigma head -> compositing weights
  for the importance pdf;
* `fused_render_tiles` (`_render_kernel`, pallas_mlp.py:639-837): both MLP
  branches and the scene + instance compositing -> per-ray maps;
* `pack_kernel_weights` (`prepare_kernel_weights`, pallas_mlp.py:340-409),
  now in `fwd_chain.py`.

The training path's two kernels (`fused_mlp_eval` and its backward) are in
`fused_mlp_vjp.py`.

Both kernels take the classical model (positional encoding of xyz only) and
the voxel-conditioned one. For the latter `voxel_raw` (n, S, 16 + 8), the raw
trilinear features of `models/voxel_grid.voxel_lookup_raw`, is one more
operand (pallas_mlp.py:193-213): the kernel frequency-encodes it itself and
its input row is `[svox | PE(svox) | xyz | PE(xyz)]` for the scene branch and
that followed by `[ivox | PE(ivox) | code]` for the object branch, the
model's own input order. The training kernels (`fused_mlp_vjp.py`) take the
same operand and return its gradient.

The kernels are CUDA C++ for Hopper (`csrc/fused_mlp.cu`, built by
`_build.py`): two modes of the forward chain of `csrc/fused_mlp_wg.cuh`,
whose format, packing and launch `fwd_chain.py` owns. Each wrapper checks
device, dtype, shape and contiguity; on a CUDA tensor it launches its mode
(`fwd_chain.launch`) or raises, and on a CPU tensor it runs its plain
version, which sits beside it here. The wrappers are inference only (no
autograd); the plain versions are differentiable. `launch_counts` counts the
kernel launches of the chain's four wrappers and of the backward and
nothing else; it is a counter dict of `utils/trace.py`, as is
`ops/gather.py`'s.

The plain versions are built from `models/mlp.py` and `ops/compositing.py`.
With `matmul_dtype=torch.bfloat16` they round every matmul operand to bf16
and accumulate in f32 at exactly the kernels' points, so the kernels are
held to them tightly on the card; with `torch.float32` they are the exact
f32 path.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.mlp import ObjectNeRF, ObjectNeRFConfig, embed_inputs
from ..utils import trace
from . import fwd_chain
from .compositing import (
    alphas_from_sigmas, composite, composite_instance, compute_deltas,
    weights_from_alphas,
)
from .fwd_chain import (
    MAPS, PackedWeights, _check_tensor, _check_voxel_raw, check_voxel_operand,
    pack_kernel_weights,
)

# kernel launches since the last reset, by wrapper name (the training kernels'
# wrappers are in fused_mlp_vjp.py, the point-wise density's in fused_sigma.py)
launch_counts: Dict[str, int] = trace.counter_dict(
    ("fused_coarse_weights", "fused_render_tiles", "fused_mlp_eval", "fused_mlp_bwd",
     "fused_sigma_eval"))
reset_launch_counts = trace.reset  # every counter and span total of the registry


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def coarse_weights_plain(model: ObjectNeRF, cfg: ObjectNeRFConfig,
                         xyz: torch.Tensor, z_vals: torch.Tensor,
                         voxel_raw: Optional[torch.Tensor] = None,
                         last_delta_inf: bool = True,
                         matmul_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of `fused_coarse_weights`: (n, S) f32 weights."""
    check_voxel_operand(cfg, voxel_raw)
    n, s, _ = xyz.shape
    emb, _ = embed_inputs(cfg, xyz.reshape(n * s, 3), voxel_raw)
    sigma, _ = model.scene_forward(emb, sigma_only=True, matmul_dtype=matmul_dtype)
    deltas = compute_deltas(z_vals, last_delta_inf)
    return weights_from_alphas(alphas_from_sigmas(sigma.reshape(n, s), deltas))


def render_tiles_plain(model: ObjectNeRF, cfg: ObjectNeRFConfig,
                       xyz: torch.Tensor, z_vals: torch.Tensor,
                       dir_pe: torch.Tensor,
                       obj_codes: Optional[torch.Tensor] = None,
                       voxel_raw: Optional[torch.Tensor] = None,
                       forward_instance: bool = True,
                       last_delta_inf: bool = True,
                       want_weights: bool = False, white_back: bool = False,
                       matmul_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Plain version of `fused_render_tiles`: the same dict of per-ray maps."""
    check_voxel_operand(cfg, voxel_raw)
    n, s, _ = xyz.shape
    emb, obj_voxel = embed_inputs(cfg, xyz.reshape(n * s, 3), voxel_raw)
    dir_flat = dir_pe.repeat_interleave(s, dim=0)
    sigma, rgb = model.scene_forward(emb, dir_flat, matmul_dtype=matmul_dtype)
    scene = composite(sigma.reshape(n, s), rgb.reshape(n, s, 3), z_vals,
                      last_delta_inf=last_delta_inf, white_back=white_back)
    out = {"rgb": scene.rgb, "depth": scene.depth, "opacity": scene.opacity}
    if forward_instance:
        if obj_codes is None:
            obj_codes = xyz.new_zeros(n, cfg.N_obj_code_length)
        codes = obj_codes.repeat_interleave(s, dim=0)
        i_sigma, i_rgb = model.instance_forward(emb, codes, obj_voxel, emb_dir=dir_flat,
                                                matmul_dtype=matmul_dtype)
        inst = composite_instance(i_sigma.reshape(n, s), i_rgb.reshape(n, s, 3),
                                  z_vals, scene.depth, apply_occlusion=False)
        out.update(rgb_instance=inst.rgb, depth_instance=inst.depth,
                   opacity_instance=inst.opacity)
    if want_weights:
        out["weights"] = scene.weights
    return out


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


@torch.no_grad()
def fused_coarse_weights(model: ObjectNeRF, cfg: ObjectNeRFConfig,
                         xyz: torch.Tensor, z_vals: torch.Tensor,
                         voxel_raw: Optional[torch.Tensor] = None,
                         last_delta_inf: bool = True,
                         dtype=torch.bfloat16,
                         packed: Optional[PackedWeights] = None) -> torch.Tensor:
    """Coarse-pass pdf weights: scene trunk + sigma head + compositing scan.

    xyz (n, S, 3), z_vals (n, S), float32; `voxel_raw` (n, S, C_vox) for a
    voxel-conditioned model. Returns (n, S) float32 weights.
    `packed`: the coarse model's `pack_kernel_weights(..., sigma_only=True)`,
    packed here when not given."""
    n, s = xyz.shape[0], xyz.shape[1]
    device = xyz.device
    _check_tensor("xyz", xyz, (n, s, 3), device)
    _check_tensor("z_vals", z_vals, (n, s), device)
    _check_voxel_raw(cfg, voxel_raw, (n, s), device)
    if device.type == "cpu":
        return coarse_weights_plain(model, cfg, xyz, z_vals, voxel_raw, last_delta_inf, dtype)
    if packed is None:
        packed = pack_kernel_weights(model, cfg, forward_instance=False, sigma_only=True)
    weights = torch.empty((n, s), dtype=torch.float32, device=device)
    fwd_chain.launch("weights", cfg, packed, dtype, n, s, xyz, z=z_vals, vox=voxel_raw,
                     weights=weights, last_delta_inf=last_delta_inf)
    if n > 0:
        launch_counts["fused_coarse_weights"] += 1
    return weights


@torch.no_grad()
def fused_render_tiles(model: ObjectNeRF, cfg: ObjectNeRFConfig,
                       xyz: torch.Tensor, z_vals: torch.Tensor,
                       dir_pe: torch.Tensor,
                       obj_codes: Optional[torch.Tensor] = None,
                       voxel_raw: Optional[torch.Tensor] = None,
                       forward_instance: bool = True,
                       last_delta_inf: bool = True,
                       want_weights: bool = False, white_back: bool = False,
                       dtype=torch.bfloat16,
                       packed: Optional[PackedWeights] = None) -> Dict[str, torch.Tensor]:
    """One fused pass: PE -> both MLP branches -> alpha compositing.

    xyz (n, S, 3), z_vals (n, S), dir_pe (n, C_dir), obj_codes (n, C_code),
    float32; `voxel_raw` (n, S, C_vox) for a voxel-conditioned model. Returns rgb (n, 3), depth (n,), opacity (n,) and, when
    `forward_instance`, rgb_instance/depth_instance/opacity_instance, plus
    weights (n, S) when `want_weights`. `packed`: the model's
    `pack_kernel_weights(..., forward_instance)`, packed here when not
    given."""
    n, s = xyz.shape[0], xyz.shape[1]
    device = xyz.device
    _check_tensor("xyz", xyz, (n, s, 3), device)
    _check_tensor("z_vals", z_vals, (n, s), device)
    _check_tensor("dir_pe", dir_pe, (n, cfg.in_channels_dir), device)
    if obj_codes is not None:
        _check_tensor("obj_codes", obj_codes, (n, cfg.N_obj_code_length), device)
    _check_voxel_raw(cfg, voxel_raw, (n, s), device)
    if device.type == "cpu":
        return render_tiles_plain(model, cfg, xyz, z_vals, dir_pe, obj_codes, voxel_raw,
                                  forward_instance, last_delta_inf, want_weights,
                                  white_back, dtype)
    if packed is None:
        packed = pack_kernel_weights(model, cfg, forward_instance=forward_instance)
    if forward_instance and obj_codes is None:
        obj_codes = torch.zeros((n, cfg.N_obj_code_length), dtype=torch.float32,
                                device=device)
    maps = torch.empty((n, MAPS), dtype=torch.float32, device=device)
    weights = torch.empty((n, s), dtype=torch.float32, device=device) if want_weights else None
    fwd_chain.launch("render", cfg, packed, dtype, n, s, xyz, z=z_vals, dir_pe=dir_pe,
                     codes=obj_codes, vox=voxel_raw, maps=maps, weights=weights,
                     last_delta_inf=last_delta_inf, forward_instance=forward_instance)
    if n > 0:
        launch_counts["fused_render_tiles"] += 1
    rgb, opacity = maps[:, 0:3], maps[:, 4]
    if white_back:
        rgb = rgb + (1.0 - opacity[:, None])
    result = {"rgb": rgb, "depth": maps[:, 3], "opacity": opacity}
    if forward_instance:
        result.update(rgb_instance=maps[:, 5:8], depth_instance=maps[:, 8],
                      opacity_instance=maps[:, 9])
    if want_weights:
        result["weights"] = weights
    return result
