"""The eval render's two fused kernels: wrappers, plain versions, packing.

Replaces the Pallas TPU kernels of `object_nerf_tpu/ops/pallas_mlp.py`:

* `fused_coarse_weights` (`_weights_kernel`, pallas_mlp.py:845-963): xyz
  positional encoding -> scene trunk -> sigma head -> compositing weights
  for the importance pdf;
* `fused_render_tiles` (`_render_kernel`, pallas_mlp.py:639-837): both MLP
  branches and the scene + instance compositing -> per-ray maps;
* `pack_kernel_weights` (`prepare_kernel_weights`, pallas_mlp.py:340-409).

The training path's two kernels (`fused_mlp_eval` and its backward) are in
`fused_mlp_vjp.py` and share the packing and the checks of this module.

Both kernels take the classical model (positional encoding of xyz only) and
the voxel-conditioned one. For the latter `voxel_raw` (n, S, 16 + 8), the raw
trilinear features of `models/voxel_grid.voxel_lookup_raw`, is one more
operand (pallas_mlp.py:193-213): the kernel frequency-encodes it itself and
its input row is `[svox | PE(svox) | xyz | PE(xyz)]` for the scene branch and
that followed by `[ivox | PE(ivox) | code]` for the object branch, the
model's own input order. The training kernels (`fused_mlp_vjp.py`) take the
same operand and return its gradient.

The kernels are CUDA C++ for Hopper (`csrc/fused_mlp.cu`, built by
`_build.py`): two modes of the forward chain of `csrc/fused_mlp_wg.cuh` that
`fused_mlp_eval` and `fused_sigma_eval` share (its weight-chunk order is
`fused_mlp_vjp.forward_chunks`; the coarse pass reads the sigma-only order of
a `sigma_only` packing, cached per layout by
`fused_mlp_vjp.forward_launch_tables`). Each wrapper checks device, dtype, shape and
contiguity; on a CUDA tensor it launches its kernel or raises, and on a CPU
tensor it runs its plain version, which sits beside it here. The wrappers are inference
only (no autograd); the plain versions are differentiable. `launch_counts` counts the
kernel launches and nothing else; it is a counter dict of `utils/trace.py`, as
is `ops/gather.py`'s, and `pack_kernel_weights` is its span `mlp.pack`.
`chain_layout` reads, per model and mode, the forward chain's weight-ring
depth and shared memory from the built library.

The plain versions are built from `models/mlp.py` and `ops/compositing.py`.
With `matmul_dtype=torch.bfloat16` they round every matmul operand to bf16
and accumulate in f32 at exactly the kernels' points, so the kernels are
held to them tightly on the card; with `torch.float32` they are the exact
f32 path.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..models.mlp import ObjectNeRF, ObjectNeRFConfig, embed_inputs
from ..utils import trace
from .compositing import (
    alphas_from_sigmas, composite, composite_instance, compute_deltas,
    weights_from_alphas,
)

# kernel launches since the last reset, by wrapper name (the training kernels'
# wrappers are in fused_mlp_vjp.py, the point-wise density's in fused_sigma.py)
launch_counts: Dict[str, int] = trace.counter_dict(
    ("fused_coarse_weights", "fused_render_tiles", "fused_mlp_eval", "fused_mlp_bwd",
     "fused_sigma_eval"))
reset_launch_counts = trace.reset  # every counter and span total of the registry


# ---------------------------------------------------------------------------
# Shapes the kernels take (constants of csrc/fused_mlp.cu)
# ---------------------------------------------------------------------------

KERNEL_SAMPLES = (32, 64, 128)  # a block holds 128 // S whole rays
SCENE_W, OBJ_W = 256, 128
SCENE_K0, OBJ_K0 = 64, 128  # input tile columns read by each branch
SCENE_K0_VOX, OBJ_K0_VOX = 320, 448  # the same of a voxel-conditioned model
MAX_VOX = 32  # raw voxel channels per sample
MAX_DIR = 32
MAX_DEPTH = 8
MAPS = 16  # [rgb, depth, opacity, rgb_inst, depth_inst, opacity_inst, 0 x 6]

# index of each entry in a branch's offset table (enum T_* in the source)
T_DEPTH, T_SKIPS, T_K0, T_TW, T_TB = 0, 1, 2, 3, 11
T_SIGW, T_SIGB, T_FINW, T_FINB = 19, 20, 21, 22
T_DIRWH, T_DIRWD, T_DIRB, T_RGBW, T_RGBB = 23, 24, 25, 26, 27
T_LEN = 28


def input_tile_columns(cfg: ObjectNeRFConfig):
    """(scene, object) input columns that the kernels read for this model:
    each branch's input width padded to the kernels' K step."""
    return (SCENE_K0_VOX, OBJ_K0_VOX) if cfg.use_voxel_embedding else (SCENE_K0, OBJ_K0)


def check_kernel_config(cfg: ObjectNeRFConfig) -> None:
    """Raise unless the CUDA kernels take this architecture."""
    problems = []
    if cfg.W != SCENE_W or cfg.inst_W != OBJ_W:
        problems.append(f"widths W={cfg.W}, inst_W={cfg.inst_W} "
                        f"(kernels take {SCENE_W}, {OBJ_W})")
    scene_k0, obj_k0 = input_tile_columns(cfg)
    if cfg.in_channels_xyz > scene_k0 or cfg.inst_channel_in > obj_k0:
        problems.append(f"branch inputs of {cfg.in_channels_xyz} / {cfg.inst_channel_in} "
                        f"channels exceed {scene_k0} / {obj_k0}")
    if cfg.use_voxel_embedding and (
            cfg.N_scn_voxel_size < 1 or cfg.N_obj_voxel_size < 1
            or cfg.N_scn_voxel_size + cfg.N_obj_voxel_size > MAX_VOX):
        problems.append(f"voxel channels {cfg.N_scn_voxel_size} + {cfg.N_obj_voxel_size} "
                        f"outside 1..{MAX_VOX}")
    if cfg.in_channels_dir > MAX_DIR:
        problems.append(f"direction PE {cfg.in_channels_dir} > {MAX_DIR} channels")
    for name, depth, skips in (("D", cfg.D, cfg.skips), ("inst_D", cfg.inst_D, cfg.inst_skips)):
        if not 1 <= depth <= MAX_DEPTH:
            problems.append(f"{name}={depth} outside 1..{MAX_DEPTH}")
        if any(not 0 < s < depth for s in skips):
            problems.append(f"skips {skips} outside 1..{name}-1")
    if problems:
        raise ValueError("CUDA eval kernels do not take this model: " + "; ".join(problems))


# ---------------------------------------------------------------------------
# Weight packing
# ---------------------------------------------------------------------------


class PackedWeights(NamedTuple):
    """One model's weights in the kernels' layout (see csrc/fused_mlp.cu):
    a bf16 buffer, an f32 bias buffer, and an offset table per branch. With
    `sigma_only` each packed branch holds its trunk and sigma head only."""

    w: torch.Tensor
    b: torch.Tensor
    scene: List[int]
    obj: Optional[List[int]]  # None: packed without the object branch
    sigma_only: bool


class _Packer:
    def __init__(self):
        self.w: List[torch.Tensor] = []
        self.b: List[torch.Tensor] = []
        self.nw = 0
        self.nb = 0

    def add_w(self, mat: torch.Tensor) -> int:
        flat = mat.detach().float().reshape(-1)
        pad = (-flat.numel()) % 8  # keep every block 16-byte aligned
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        off = self.nw
        self.w.append(flat)
        self.nw += flat.numel()
        return off

    def add_b(self, vec: torch.Tensor) -> int:
        off = self.nb
        self.b.append(vec.detach().float().reshape(-1))
        self.nb += vec.numel()
        return off

    def branch(self, model: ObjectNeRF, name: str, c_in: int, k0: int,
               c_dir: int, sigma_only: bool) -> List[int]:
        p = model.branch_layers(name)
        trunk, skips = p["trunk"], p["skips"]
        width = trunk[0].out_features
        tab = [0] * T_LEN
        tab[T_DEPTH] = len(trunk)
        tab[T_SKIPS] = sum(1 << i for i in skips)
        tab[T_K0] = k0
        for i, lin in enumerate(trunk):
            wt = lin.weight.detach().float().t()  # (in, out)
            if i == 0:
                blk = wt.new_zeros(k0, width)
                blk[:c_in] = wt
            elif i in skips:  # [input, h] rows: input padded to k0
                blk = wt.new_zeros(k0 + width, width)
                blk[:c_in] = wt[:c_in]
                blk[k0:] = wt[c_in:]
            else:
                blk = wt
            tab[T_TW + i] = self.add_w(blk)
            tab[T_TB + i] = self.add_b(lin.bias)
        tab[T_SIGW] = self.add_w(p["sigma"].weight)  # (1, width)
        tab[T_SIGB] = self.add_b(p["sigma"].bias)
        if sigma_only:
            return tab
        tab[T_FINW] = self.add_w(p["final"].weight.detach().float().t())
        tab[T_FINB] = self.add_b(p["final"].bias)
        wt = p["dir"].weight.detach().float().t()  # (width + c_dir, width/2)
        tab[T_DIRWH] = self.add_w(wt[:width])
        wd = wt.new_zeros(MAX_DIR, width // 2)
        wd[:c_dir] = wt[width:]
        tab[T_DIRWD] = self.add_w(wd)
        tab[T_DIRB] = self.add_b(p["dir"].bias)
        tab[T_RGBW] = self.add_w(p["rgb"].weight)  # (3, width/2)
        tab[T_RGBB] = self.add_b(p["rgb"].bias)
        return tab


@torch.no_grad()
def pack_kernel_weights(model: ObjectNeRF, cfg: ObjectNeRFConfig,
                        forward_instance: bool = True,
                        sigma_only: bool = False) -> PackedWeights:
    """Flatten one ObjectNeRF for the kernels, on the model's device.

    `sigma_only` keeps each branch's trunk and sigma head (the coarse pass,
    the density query); otherwise the rgb heads too. The object branch is
    packed when `forward_instance`. The renderers pack once per frame, not
    once per chunk."""
    check_kernel_config(cfg)
    with trace.span("mlp.pack"):
        pk = _Packer()
        # the scene branch reads the first columns of the object branch's input
        # row: whatever the shared tile holds past the scene's own width (codes,
        # instance voxel features) meets zero weight rows
        scene_k0, obj_k0 = input_tile_columns(cfg)
        scene = pk.branch(model, "scene", cfg.in_channels_xyz, scene_k0, cfg.in_channels_dir,
                          sigma_only)
        obj = None
        if forward_instance:
            obj = pk.branch(model, "object", cfg.inst_channel_in, obj_k0,
                            cfg.in_channels_dir, sigma_only)
        w = torch.cat(pk.w).to(torch.bfloat16).contiguous()
        b = torch.cat(pk.b).contiguous()
        return PackedWeights(w, b, scene, obj, sigma_only)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def check_voxel_operand(cfg: ObjectNeRFConfig, voxel_raw: Optional[torch.Tensor]) -> None:
    """`voxel_raw` goes with a voxel-conditioned model and with no other."""
    if cfg.use_voxel_embedding and voxel_raw is None:
        raise ValueError("voxel_raw required when cfg.use_voxel_embedding")
    if not cfg.use_voxel_embedding and voxel_raw is not None:
        raise ValueError("voxel_raw given to a model without voxel embedding")


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


def _check_tensor(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, xyz on {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_voxel_raw(cfg: ObjectNeRFConfig, voxel_raw: Optional[torch.Tensor], lead,
                     device) -> None:
    """The operand's presence, and its shape `lead + (c_svox + c_ivox,)`."""
    check_voxel_operand(cfg, voxel_raw)
    if voxel_raw is not None:
        _check_tensor("voxel_raw", voxel_raw,
                      tuple(lead) + (cfg.N_scn_voxel_size + cfg.N_obj_voxel_size,), device)


def _vox_args(cfg: ObjectNeRFConfig):
    """(c_svox, c_ivox, n_freq_vox) as the launchers take them."""
    return cfg.N_scn_voxel_size, cfg.N_obj_voxel_size, cfg.N_freq_voxel


def _check_launch(cfg: ObjectNeRFConfig, dtype, s: Optional[int], packed: PackedWeights,
                  device, need_obj: bool, need_heads: bool) -> None:
    """`s`: samples per ray of a kernel whose tile is made of whole rays
    (None for the point-wise kernel, which has no such restriction)."""
    if device.type != "cuda":
        raise ValueError(f"kernels run on CUDA or (plain version) CPU tensors, got {device}")
    if dtype != torch.bfloat16:
        raise ValueError("the CUDA kernels compute in bf16: pass dtype=torch.bfloat16, "
                         "or CPU tensors for the f32 plain version")
    check_kernel_config(cfg)
    if s is not None and s not in KERNEL_SAMPLES:
        raise ValueError(f"kernels take S in {KERNEL_SAMPLES} samples per ray, got {s}")
    if need_heads and packed.sigma_only:
        raise ValueError("packed weights hold the sigma head only")
    if need_obj and packed.obj is None:
        raise ValueError("packed weights lack the object branch")
    if packed.scene[T_K0] != input_tile_columns(cfg)[0]:
        raise ValueError("packed weights were packed for another input layout")
    if packed.w.device != device or packed.b.device != device:
        raise ValueError("packed weights are on another device than the inputs")


def _tab(values: Optional[List[int]]):
    if values is None:
        return None
    return (ctypes.c_int * T_LEN)(*values)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


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

    from ._build import check, load_library
    from .fused_mlp_vjp import forward_launch_tables

    if packed is None:
        packed = pack_kernel_weights(model, cfg, forward_instance=False, sigma_only=True)
    _check_launch(cfg, dtype, s, packed, device, need_obj=False, need_heads=False)
    weights = torch.empty((n, s), dtype=torch.float32, device=device)
    if n == 0:
        return weights
    lib = load_library()
    with torch.cuda.device(device):
        rc = lib.onerf_coarse_weights(
            xyz.data_ptr(), z_vals.data_ptr(), _ptr(voxel_raw), packed.w.data_ptr(),
            packed.b.data_ptr(), _tab(packed.scene),
            *forward_launch_tables(packed, False, True, sigma_only=True),
            weights.data_ptr(), n, s, cfg.N_freq_xyz, int(last_delta_inf), *_vox_args(cfg),
            torch.cuda.current_stream(device).cuda_stream,
        )
    check(lib, rc, "fused_coarse_weights")
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

    from ._build import check, load_library
    from .fused_mlp_vjp import forward_launch_tables

    if packed is None:
        packed = pack_kernel_weights(model, cfg, forward_instance=forward_instance)
    _check_launch(cfg, dtype, s, packed, device, need_obj=forward_instance,
                  need_heads=True)
    if forward_instance and obj_codes is None:
        obj_codes = torch.zeros((n, cfg.N_obj_code_length), dtype=torch.float32,
                                device=device)
    maps = torch.empty((n, MAPS), dtype=torch.float32, device=device)
    weights = torch.empty((n, s), dtype=torch.float32, device=device) if want_weights else None
    if n > 0:
        lib = load_library()
        with torch.cuda.device(device):
            rc = lib.onerf_render_tiles(
                xyz.data_ptr(), z_vals.data_ptr(), dir_pe.data_ptr(),
                _ptr(obj_codes) if forward_instance else None, _ptr(voxel_raw),
                packed.w.data_ptr(), packed.b.data_ptr(), _tab(packed.scene),
                _tab(packed.obj) if forward_instance else None,
                *forward_launch_tables(packed, forward_instance, True),
                maps.data_ptr(), _ptr(weights), n, s, cfg.N_freq_xyz,
                cfg.in_channels_dir, cfg.N_obj_code_length, int(forward_instance),
                int(last_delta_inf), *_vox_args(cfg),
                torch.cuda.current_stream(device).cuda_stream,
            )
        check(lib, rc, "fused_render_tiles")
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


def sincos_mismatches(x: torch.Tensor) -> int:
    """The f32 arguments of `x` (a CUDA tensor) at which the card's
    full-precision `sincosf` differs in any bit from its `sinf` / `cosf`: the
    forward chain takes both values of an encoded pair from one `sincosf`,
    where the reference order reads them as separate columns."""
    from ._build import check, load_library

    if x.device.type != "cuda" or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 CUDA tensor")
    lib = load_library()
    count = torch.zeros(1, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.onerf_sincos_check(x.data_ptr(), x.numel(), count.data_ptr(),
                                    torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, rc, "sincos_mismatches")
    return int(count.item())


# the forward chain's modes (FWD_* in csrc/fused_mlp_wg.cuh), in their order:
# fused_mlp_eval, fused_render_tiles, fused_coarse_weights, fused_sigma_eval's
# scene and object branch
CHAIN_MODES = ("eval", "render", "weights", "sigma_scene", "sigma_obj")


def chain_layout(voxel: bool, mode: str) -> Tuple[int, int]:
    """(weight-ring stages, dynamic shared memory bytes) of the forward chain's
    instantiation for the voxel-conditioned or the classical model in `mode`
    (one of `CHAIN_MODES`), as the built library lays it out. Builds the
    library on first use; launches nothing."""
    from ._build import check, load_library

    if mode not in CHAIN_MODES:
        raise ValueError(f"mode must be one of {CHAIN_MODES}, got {mode!r}")
    lib = load_library()
    stages, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.onerf_fwd_chain_layout(int(voxel), CHAIN_MODES.index(mode),
                                    ctypes.addressof(stages), ctypes.addressof(smem))
    check(lib, rc, "chain_layout")
    return stages.value, smem.value
