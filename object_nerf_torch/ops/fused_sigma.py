"""Point-wise density through one branch: wrapper and plain version.

Replaces the Pallas TPU kernel `fused_sigma_eval` (`_sigma_kernel`,
`object_nerf_tpu/ops/pallas_mlp.py:971-1107`): the raw density (before any
ReLU) of N arbitrary points through the scene trunk + sigma head, or through
the object trunk + sigma head with one latent code per pseudo-row of
`samples_per_row` consecutive points. It is the density query of the
mesh-extraction sweep and the coarse pass of the multi-object edit render.

The kernel is CUDA C++ for Hopper (`csrc/fused_sigma.cu`, built by
`_build.py`): the point-wise modes of the forward chain of
`csrc/fused_mlp_wg.cuh`, "sigma_scene" and "sigma_obj", one per branch,
launched by `fwd_chain.launch`. On a CUDA tensor the wrapper launches it or
raises; on a CPU tensor it runs `sigma_eval_plain`, which sits beside it here and rounds the
matmul operands to `matmul_dtype` where the kernel rounds. `launch_counts`
(shared with `fused_mlp.py`) counts kernel launches and nothing else.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.mlp import ObjectNeRF, ObjectNeRFConfig, embed_inputs
from . import fwd_chain
from .fused_mlp import launch_counts
from .fwd_chain import (
    PackedWeights, _check_tensor, _check_voxel_raw, check_voxel_operand, pack_kernel_weights,
)

BRANCHES = ("scene", "instance")


def sigma_eval_plain(model: ObjectNeRF, cfg: ObjectNeRFConfig, pts: torch.Tensor,
                     obj_codes: Optional[torch.Tensor] = None, branch: str = "scene",
                     samples_per_row: int = 64,
                     voxel_raw: Optional[torch.Tensor] = None,
                     matmul_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of `fused_sigma_eval`: pts (N, 3), obj_codes
    (N / samples_per_row, C_code), voxel_raw (N, C_vox) for a
    voxel-conditioned model -> (N,) f32 raw density."""
    check_voxel_operand(cfg, voxel_raw)
    emb, obj_voxel = embed_inputs(cfg, pts, voxel_raw)
    if branch == "scene":
        sigma, _ = model.scene_forward(emb, sigma_only=True, matmul_dtype=matmul_dtype)
    else:
        codes = obj_codes.repeat_interleave(samples_per_row, dim=0)
        sigma, _ = model.instance_forward(emb, codes, obj_voxel, sigma_only=True,
                                          matmul_dtype=matmul_dtype)
    return sigma


@torch.no_grad()
def fused_sigma_eval(model: ObjectNeRF, cfg: ObjectNeRFConfig, pts: torch.Tensor,
                     obj_codes: Optional[torch.Tensor] = None, branch: str = "scene",
                     samples_per_row: int = 64,
                     voxel_raw: Optional[torch.Tensor] = None, dtype=torch.bfloat16,
                     packed: Optional[PackedWeights] = None) -> torch.Tensor:
    """Raw density of N points through one branch of `model`.

    pts (N, 3) float32 with N divisible by `samples_per_row`; `branch` is
    "scene" (scene trunk + sigma head) or "instance" (object trunk + sigma
    head on `[PE, code]`, `obj_codes` (N / samples_per_row, C_code) holding
    one code per pseudo-row); `voxel_raw` (N, C_vox), the points' raw voxel
    features, for a voxel-conditioned model. Returns (N,) float32, before any
    ReLU: the callers clamp or mute it themselves.

    `samples_per_row` only fixes how often the code changes: the kernel takes
    any value >= 1 and any N (its 128-point tiles are not made of whole
    pseudo-rows, and it masks a ragged last tile itself), so no caller pads.
    `packed`: the model's `pack_kernel_weights(..., forward_instance=(branch
    == "instance"), sigma_only=True)` or any packing that holds the branch;
    packed here when not given. Inference only."""
    if branch not in BRANCHES:
        raise ValueError(f"branch must be one of {BRANCHES}, got {branch!r}")
    n, s = pts.shape[0], int(samples_per_row)
    if s < 1 or n % s:
        raise ValueError(f"N={n} not divisible by samples_per_row={samples_per_row}")
    if n >= 2 ** 31:
        raise ValueError(f"N={n} points exceed one launch: sweep in chunks")
    device = pts.device
    instance = branch == "instance"
    _check_tensor("pts", pts, (n, 3), device)
    if instance:
        if obj_codes is None:
            raise ValueError("obj_codes required for branch='instance'")
        _check_tensor("obj_codes", obj_codes, (n // s, cfg.N_obj_code_length), device)
    _check_voxel_raw(cfg, voxel_raw, (n,), device)
    if device.type == "cpu":
        return sigma_eval_plain(model, cfg, pts, obj_codes, branch, s, voxel_raw, dtype)
    if packed is None:
        packed = pack_kernel_weights(model, cfg, forward_instance=instance, sigma_only=True)
    sigma = torch.empty((n,), dtype=torch.float32, device=device)
    # the launch's "rays" are the runs of per_row points that share a code
    fwd_chain.launch("sigma_obj" if instance else "sigma_scene", cfg, packed, dtype, n // s, s,
                     pts, codes=obj_codes, vox=voxel_raw, out=sigma)
    if n > 0:
        launch_counts["fused_sigma_eval"] += 1
    return sigma
