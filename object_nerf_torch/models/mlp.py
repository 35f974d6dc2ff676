"""Two-branch ObjectNeRF MLP as a PyTorch module.

Counterpart of `object_nerf_tpu/models/mlp.py` (itself parity with the
reference `ObjectNeRF`, models/nerf_model.py:6-152):

* Scene branch: D layers of width W with LeakyReLU(0.01) and a skip (the
  input re-concatenated as ``[input, h]`` *before* the layers in `skips`),
  a sigma head `Linear(W, 1)` off the trunk, a no-activation
  `xyz_encoding_final Linear(W, W)`, a view-direction head
  `LeakyReLU(Linear(W + C_dir, W//2))` and `sigmoid(Linear(W//2, 3))` rgb.
* Object branch: the same topology with inst_D/inst_W/inst_skips; its input
  is ``[emb_xyz, obj_voxel?, obj_code]`` (nerf_model.py:128-132).

Parameter names follow the reference state-dict schema
(`xyz_encoding_1.0.weight`, `instance_encoding_final.0.weight`, ...;
`object_nerf_tpu/train/torch_convert.py:1-24`), so a reference Lightning
checkpoint's `nerf_coarse.*` / `nerf_fine.*` entries load with
`load_state_dict`.

`matmul_dtype=torch.bfloat16` rounds every matmul operand to bf16 and
accumulates in f32 (bias, LeakyReLU and sigmoid stay f32): exactly the
rounding points of the fused CUDA kernels, so they can be held to this
path tightly. `torch.float32` is the exact f32 path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .embedding import freq_encode, freq_encode_channels

LEAKY_SLOPE = 0.01  # torch.nn.LeakyReLU default, used throughout the reference


@dataclasses.dataclass(frozen=True)
class ObjectNeRFConfig:
    """Static architecture config; field names mirror the reference `model:`
    config block (config/default_conf.yml:8-36)."""

    D: int = 8
    W: int = 256
    skips: tuple = (4,)
    inst_D: int = 4
    inst_W: int = 128
    inst_skips: tuple = (2,)
    N_freq_xyz: int = 10
    N_freq_dir: int = 4
    N_freq_voxel: int = 6
    N_scn_voxel_size: int = 16
    N_obj_voxel_size: int = 8
    N_obj_code_length: int = 64
    use_voxel_embedding: bool = True

    @classmethod
    def from_config(cls, model_cfg) -> "ObjectNeRFConfig":
        return cls(
            D=int(model_cfg["D"]),
            W=int(model_cfg["W"]),
            skips=tuple(model_cfg["skips"]),
            inst_D=int(model_cfg["inst_D"]),
            inst_W=int(model_cfg["inst_W"]),
            inst_skips=tuple(model_cfg["inst_skips"]),
            N_freq_xyz=int(model_cfg["N_freq_xyz"]),
            N_freq_dir=int(model_cfg["N_freq_dir"]),
            N_freq_voxel=int(model_cfg["N_freq_voxel"]),
            N_scn_voxel_size=int(model_cfg.get("N_scn_voxel_size", 0)),
            N_obj_voxel_size=int(model_cfg.get("N_obj_voxel_size", 0)),
            N_obj_code_length=int(model_cfg["N_obj_code_length"]),
            use_voxel_embedding=bool(model_cfg.get("use_voxel_embedding", True)),
        )

    # -- derived channel counts (nerf_model.py:24-36,60-72) -----------------
    @property
    def scn_voxel_emb_size(self) -> int:
        if not self.use_voxel_embedding:
            return 0
        return freq_encode_channels(self.N_scn_voxel_size, self.N_freq_voxel)

    @property
    def obj_voxel_emb_size(self) -> int:
        if not self.use_voxel_embedding:
            return 0
        return freq_encode_channels(self.N_obj_voxel_size, self.N_freq_voxel)

    @property
    def xyz_pe_size(self) -> int:
        return freq_encode_channels(3, self.N_freq_xyz)

    @property
    def in_channels_xyz(self) -> int:
        return self.xyz_pe_size + self.scn_voxel_emb_size

    @property
    def in_channels_dir(self) -> int:
        return freq_encode_channels(3, self.N_freq_dir)

    @property
    def inst_channel_in(self) -> int:
        return self.in_channels_xyz + self.N_obj_code_length + self.obj_voxel_emb_size


def embed_inputs(cfg: ObjectNeRFConfig, xyz: torch.Tensor,
                 voxel_raw: Optional[torch.Tensor] = None):
    """The two branches' position inputs from sample positions xyz (N, 3) and,
    for a voxel-conditioned model, their raw voxel features (..., C_scn +
    C_obj): (emb_xyz, obj_voxel) = ([PE(scene_ftr), PE(xyz)], PE(inst_ftr)),
    the reference's `EmbeddingVoxel.forward` layout (embedding_helper.py:
    325-329); (PE(xyz), None) for a classical model. What the fused kernels
    build inside a block."""
    xyz_emb = freq_encode(xyz, cfg.N_freq_xyz)
    if voxel_raw is None:
        return xyz_emb, None
    raw = voxel_raw.reshape(xyz.shape[0], -1)
    scene_emb = freq_encode(raw[:, :cfg.N_scn_voxel_size], cfg.N_freq_voxel)
    inst_emb = freq_encode(raw[:, cfg.N_scn_voxel_size:], cfg.N_freq_voxel)
    return torch.cat([scene_emb, xyz_emb], dim=-1), inst_emb


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY_SLOPE)


def linear(layer: nn.Linear, x: torch.Tensor, matmul_dtype=torch.float32) -> torch.Tensor:
    """``x @ W.T + b`` with both operands rounded to `matmul_dtype` and an
    f32 product and bias."""
    w = layer.weight
    if matmul_dtype != torch.float32:
        x = x.to(matmul_dtype).float()
        w = w.to(matmul_dtype).float()
    return torch.matmul(x, w.t()) + layer.bias


def _block(fan_in: int, fan_out: int, act: Optional[nn.Module]) -> nn.Sequential:
    layers: List[nn.Module] = [nn.Linear(fan_in, fan_out)]
    if act is not None:
        layers.append(act)
    return nn.Sequential(*layers)


class ObjectNeRF(nn.Module):
    """Scene + object branches of one ObjectNeRF (coarse or fine)."""

    def __init__(self, cfg: ObjectNeRFConfig):
        super().__init__()
        self.cfg = cfg
        W, Wi = cfg.W, cfg.inst_W
        c_xyz, c_dir, c_inst = cfg.in_channels_xyz, cfg.in_channels_dir, cfg.inst_channel_in
        for i in range(cfg.D):
            fan_in = c_xyz if i == 0 else (W + c_xyz if i in cfg.skips else W)
            setattr(self, f"xyz_encoding_{i + 1}",
                    _block(fan_in, W, nn.LeakyReLU(LEAKY_SLOPE)))
        self.xyz_encoding_final = nn.Linear(W, W)
        self.sigma = nn.Linear(W, 1)
        self.dir_encoding = _block(W + c_dir, W // 2, nn.LeakyReLU(LEAKY_SLOPE))
        self.rgb = _block(W // 2, 3, nn.Sigmoid())
        for i in range(cfg.inst_D):
            fan_in = c_inst if i == 0 else (Wi + c_inst if i in cfg.inst_skips else Wi)
            setattr(self, f"instance_encoding_{i + 1}",
                    _block(fan_in, Wi, nn.LeakyReLU(LEAKY_SLOPE)))
        self.instance_encoding_final = _block(Wi, Wi, None)
        self.instance_sigma = nn.Linear(Wi, 1)
        self.inst_dir_encoding = _block(Wi + c_dir, Wi // 2, nn.LeakyReLU(LEAKY_SLOPE))
        self.inst_rgb = _block(Wi // 2, 3, nn.Sigmoid())

    # -- per-branch layer views ---------------------------------------------
    def branch_layers(self, branch: str) -> Dict[str, object]:
        """{"trunk": [Linear...], "skips", "final", "sigma", "dir", "rgb"} of
        the "scene" or "object" branch."""
        cfg = self.cfg
        if branch == "scene":
            return {
                "trunk": [getattr(self, f"xyz_encoding_{i + 1}")[0] for i in range(cfg.D)],
                "skips": tuple(cfg.skips),
                "final": self.xyz_encoding_final,
                "sigma": self.sigma,
                "dir": self.dir_encoding[0],
                "rgb": self.rgb[0],
            }
        if branch == "object":
            return {
                "trunk": [getattr(self, f"instance_encoding_{i + 1}")[0]
                          for i in range(cfg.inst_D)],
                "skips": tuple(cfg.inst_skips),
                "final": self.instance_encoding_final[0],
                "sigma": self.instance_sigma,
                "dir": self.inst_dir_encoding[0],
                "rgb": self.inst_rgb[0],
            }
        raise ValueError(f"unknown branch {branch!r}")

    def _run_branch(self, branch: str, input_x: torch.Tensor,
                    emb_dir: Optional[torch.Tensor], sigma_only: bool,
                    matmul_dtype) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        p = self.branch_layers(branch)
        x = input_x
        for i, layer in enumerate(p["trunk"]):
            if i in p["skips"]:
                x = torch.cat([input_x, x], dim=-1)
            x = _lrelu(linear(layer, x, matmul_dtype))
        sigma = linear(p["sigma"], x, matmul_dtype)[..., 0]
        if sigma_only:
            return sigma, None
        x_final = linear(p["final"], x, matmul_dtype)
        d_enc = _lrelu(linear(p["dir"], torch.cat([x_final, emb_dir], dim=-1), matmul_dtype))
        rgb = torch.sigmoid(linear(p["rgb"], d_enc, matmul_dtype))
        return sigma, rgb

    def scene_forward(self, emb_xyz: torch.Tensor, emb_dir: Optional[torch.Tensor] = None,
                      sigma_only: bool = False, matmul_dtype=torch.float32):
        """Scene branch. emb_xyz (N, in_channels_xyz), emb_dir (N, in_channels_dir).
        Returns (sigma (N,), rgb (N, 3) or None)."""
        return self._run_branch("scene", emb_xyz, emb_dir, sigma_only, matmul_dtype)

    def instance_forward(self, emb_xyz: torch.Tensor, obj_code: torch.Tensor,
                         obj_voxel: Optional[torch.Tensor] = None,
                         emb_dir: Optional[torch.Tensor] = None,
                         sigma_only: bool = False, matmul_dtype=torch.float32):
        """Object branch; input = [emb_xyz, obj_voxel?, obj_code]."""
        if self.cfg.use_voxel_embedding:
            if obj_voxel is None:
                raise ValueError("obj_voxel required when use_voxel_embedding")
            input_x = torch.cat([emb_xyz, obj_voxel, obj_code], dim=-1)
        else:
            input_x = torch.cat([emb_xyz, obj_code], dim=-1)
        return self._run_branch("object", input_x, emb_dir, sigma_only, matmul_dtype)

    @torch.no_grad()
    def reset_parameters_(self, generator: torch.Generator) -> "ObjectNeRF":
        """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every weight and bias, drawn
        from `generator` (torch.nn.Linear's default bounds; the JAX package's
        `_init_linear`, models/mlp.py:117-128)."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / (m.in_features ** 0.5)
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)
        return self
