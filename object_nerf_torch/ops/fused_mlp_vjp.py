"""The training path's fused MLP: forward and backward kernels behind one
`torch.autograd.Function`.

Replaces two Pallas TPU kernels and the custom VJP around them:

* `fused_mlp_eval` (`_mlp_kernel`, `object_nerf_tpu/ops/pallas_mlp.py:287,
  :495-603`): both MLP branches over (n_rays, S) sample rows ->
  `(sigma, rgb, inst_sigma, inst_rgb)`, raw sigma (noise and ReLU are the
  caller's);
* `fused_mlp_bwd` (`_bwd_kernel` / `_run_bwd`,
  `object_nerf_tpu/ops/pallas_mlp_vjp.py:72, :417-557`): recompute the
  forward, sweep back, return every weight and bias gradient and the per-ray
  code gradient;
* `FusedMLP` (`make_fused_mlp_op`, `pallas_mlp_vjp.py:608-668`): the forward
  saves its inputs only, the backward packs the four output cotangents to
  (n*S, 8) and runs the backward kernel; `xyz` and `dir_pe` get no gradient.

The kernels are CUDA C++ for Hopper (`csrc/fused_mlp_train.cu`). On CUDA
tensors the wrappers launch them or raise; on CPU tensors they run the plain
versions beside them here: `mlp_eval_plain` (differentiable by autograd, the
check of the hand-derived backward) and `mlp_bwd_plain` (the hand-derived
backward in tensor code, rounding where the kernel rounds). The kernels keep
the eval kernels' tile of 128 rows of whole rays, hence their restriction to
`KERNEL_SAMPLES` samples per ray. `launch_counts` (shared with
`fused_mlp.py`) counts kernel launches and nothing else. They take the
classical model only: the voxel operand (`voxel_raw`, with its gradient
`d_voxel_raw`, pallas_mlp_vjp.py:350-375) is not ported yet, and both entry
points raise on a voxel-conditioned model.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..models.embedding import freq_encode
from ..models.mlp import LEAKY_SLOPE, ObjectNeRF, ObjectNeRFConfig
from .fused_mlp import (
    MAX_DIR, T_DIRB, T_DIRWD, T_DIRWH, T_FINB, T_FINW, T_K0, T_RGBB, T_RGBW,
    T_SIGB, T_SIGW, T_TB, T_TW, PackedWeights, _check_launch, _check_tensor, _ptr,
    _tab, launch_counts, pack_kernel_weights,
)

MLPOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _rd(x: torch.Tensor, dt) -> torch.Tensor:
    """Round to the matmul dtype and back to f32 (identity for f32)."""
    return x if dt == torch.float32 else x.to(dt).float()


def _lrelu_grad(act: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """LeakyReLU cotangent from the (rounded) post-activation, with >= 0."""
    return torch.where(act >= 0, d, d * LEAKY_SLOPE)


def mlp_eval_plain(model: ObjectNeRF, cfg: ObjectNeRFConfig, xyz: torch.Tensor,
                   dir_pe: torch.Tensor, codes: Optional[torch.Tensor] = None,
                   forward_instance: bool = True, compute_scene: bool = True,
                   matmul_dtype=torch.bfloat16) -> MLPOut:
    """Plain version of `fused_mlp_eval`: xyz (n, S, 3), dir_pe (n, C_dir),
    codes (n, C_code) -> sigma (n, S), rgb (n, S, 3), inst_sigma, inst_rgb;
    zeros for a branch that is off."""
    n, s, _ = xyz.shape
    emb = freq_encode(xyz.reshape(n * s, 3), cfg.N_freq_xyz)
    dir_flat = dir_pe.repeat_interleave(s, dim=0)
    zeros = (xyz.new_zeros(n, s), xyz.new_zeros(n, s, 3))
    scene, inst = zeros, zeros
    if compute_scene:
        sigma, rgb = model.scene_forward(emb, dir_flat, matmul_dtype=matmul_dtype)
        scene = (sigma.reshape(n, s), rgb.reshape(n, s, 3))
    if forward_instance:
        if codes is None:
            codes = xyz.new_zeros(n, cfg.N_obj_code_length)
        i_sigma, i_rgb = model.instance_forward(
            emb, codes.repeat_interleave(s, dim=0), emb_dir=dir_flat,
            matmul_dtype=matmul_dtype)
        inst = (i_sigma.reshape(n, s), i_rgb.reshape(n, s, 3))
    return scene + inst


def _branch_bwd_plain(p: Dict[str, object], prefix: Dict[str, str], cat: torch.Tensor,
                      dir_rows: torch.Tensor, g_sigma: torch.Tensor, g_rgb: torch.Tensor,
                      dt, need_cat_grad: bool, grads: Dict[str, torch.Tensor]):
    """Forward recompute with stashed activations, then the reverse sweep of
    one branch (`branch_fwd` / `branch_bwd`, pallas_mlp_vjp.py:179-285).
    Writes the gradients into `grads` under `prefix[...]`; returns the
    gradient of the concatenated input when asked for."""
    trunk, skips = p["trunk"], p["skips"]
    width = trunk[0].out_features
    c_in = cat.shape[1]
    cat = _rd(cat, dt)
    dir_rows = _rd(dir_rows, dt)

    def w_of(layer):
        return _rd(layer.weight.detach(), dt)

    # ---- forward, activations stashed at the matmul precision ---------------
    hs: List[torch.Tensor] = []
    h = cat
    for i, layer in enumerate(trunk):
        x = torch.cat([cat, h], dim=-1) if i in skips else h
        pre = x @ w_of(layer).t() + layer.bias.detach()
        h = _rd(torch.where(pre >= 0, pre, pre * LEAKY_SLOPE), dt)
        hs.append(h)
    hf = _rd(h @ w_of(p["final"]).t() + p["final"].bias.detach(), dt)
    w_dir = w_of(p["dir"])
    pre_d = hf @ w_dir[:, :width].t() + dir_rows @ w_dir[:, width:].t() + p["dir"].bias.detach()
    denc = _rd(torch.where(pre_d >= 0, pre_d, pre_d * LEAKY_SLOPE), dt)
    rgb = torch.sigmoid(denc @ w_of(p["rgb"]).t() + p["rgb"].bias.detach())

    def put(layer_key: str, gw: torch.Tensor, gb: torch.Tensor) -> None:
        grads[prefix[layer_key] + ".weight"] = gw
        grads[prefix[layer_key] + ".bias"] = gb

    # ---- reverse sweep --------------------------------------------------------
    d_pre_r = g_rgb * rgb * (1.0 - rgb)
    put("rgb", _rd(d_pre_r, dt).t() @ denc, d_pre_r.sum(0))
    d_pre_d = _lrelu_grad(denc, _rd(d_pre_r, dt) @ w_of(p["rgb"]))
    gd = _rd(d_pre_d, dt)
    put("dir", torch.cat([gd.t() @ hf, gd.t() @ dir_rows], dim=1), d_pre_d.sum(0))
    d_hf = gd @ w_dir[:, :width]
    gs = _rd(g_sigma, dt)
    put("final", _rd(d_hf, dt).t() @ hs[-1], d_hf.sum(0))
    put("sigma", gs.t() @ hs[-1], g_sigma.sum(0))
    d_h = _rd(d_hf, dt) @ w_of(p["final"]) + gs @ w_of(p["sigma"])
    d_cat = cat.new_zeros(cat.shape) if need_cat_grad else None
    for i in reversed(range(len(trunk))):
        d_pre = _lrelu_grad(hs[i], d_h)
        gp = _rd(d_pre, dt)
        w_i = w_of(trunk[i])
        if i == 0:
            x = cat
        elif i in skips:
            x = torch.cat([cat, hs[i - 1]], dim=-1)
        else:
            x = hs[i - 1]
        put(f"trunk_{i}", gp.t() @ x, d_pre.sum(0))
        if need_cat_grad and (i == 0 or i in skips):
            d_cat = d_cat + gp @ w_i[:, :c_in]
        if i > 0:
            d_h = gp @ w_i[:, -width:]
    return d_cat


def _prefixes(model: ObjectNeRF, branch: str) -> Dict[str, str]:
    """Layer key -> parameter name prefix of one branch of `model`."""
    names = {id(m): n for n, m in model.named_modules()}
    p = model.branch_layers(branch)
    out = {f"trunk_{i}": names[id(layer)] for i, layer in enumerate(p["trunk"])}
    for key in ("final", "sigma", "dir", "rgb"):
        out[key] = names[id(p[key])]
    return out


def mlp_bwd_plain(model: ObjectNeRF, cfg: ObjectNeRFConfig, xyz: torch.Tensor,
                  dir_pe: torch.Tensor, codes: torch.Tensor, g: torch.Tensor,
                  forward_instance: bool = True, matmul_dtype=torch.bfloat16,
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Plain version of `fused_mlp_bwd`: the hand-derived backward of
    `mlp_eval_plain`, given g (n*S, 8) = [g_sigma, g_rgb(3), g_inst_sigma,
    g_inst_rgb(3)]. Returns ({parameter name of `model`: gradient}, d_codes
    (n, C_code)): zeros for the object branch and the codes when it is off.
    Activations are kept at `matmul_dtype`, every d_pre is rounded to it for
    its products, bias gradients sum the unrounded d_pre."""
    n, s, _ = xyz.shape
    with torch.no_grad():
        emb = freq_encode(xyz.reshape(n * s, 3), cfg.N_freq_xyz)
        dir_rows = dir_pe.repeat_interleave(s, dim=0)
        grads: Dict[str, torch.Tensor] = {}
        _branch_bwd_plain(model.branch_layers("scene"), _prefixes(model, "scene"), emb,
                          dir_rows, g[:, 0:1], g[:, 1:4], matmul_dtype, False, grads)
        d_codes = codes.new_zeros(codes.shape)
        if forward_instance:
            cat = torch.cat([emb, codes.repeat_interleave(s, dim=0)], dim=-1)
            d_cat = _branch_bwd_plain(
                model.branch_layers("object"), _prefixes(model, "object"), cat, dir_rows,
                g[:, 4:5], g[:, 5:8], matmul_dtype, True, grads)
            d_codes = d_cat[:, emb.shape[1]:].reshape(n, s, -1).sum(dim=1)
        for name, param in model.named_parameters():
            if name not in grads:
                grads[name] = torch.zeros_like(param)
    return grads, d_codes


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


def _check_inputs(cfg: ObjectNeRFConfig, xyz, dir_pe, codes) -> Tuple[int, int]:
    if cfg.use_voxel_embedding:
        raise NotImplementedError(
            "the training kernels take no voxel operand yet (fused_mlp_eval / "
            "fused_mlp_bwd with d_voxel_raw): the eval and density kernels do")
    n, s = xyz.shape[0], xyz.shape[1]
    _check_tensor("xyz", xyz, (n, s, 3), xyz.device)
    _check_tensor("dir_pe", dir_pe, (n, cfg.in_channels_dir), xyz.device)
    if codes is not None:
        _check_tensor("codes", codes, (n, cfg.N_obj_code_length), xyz.device)
    return n, s


def _launch_eval(cfg, xyz, dir_pe, codes, packed: PackedWeights, forward_instance: bool,
                 compute_scene: bool) -> torch.Tensor:
    """Launch `mlp_eval_kernel`; returns the (n*S, 8) f32 output."""
    from ._build import check, load_library

    n, s = xyz.shape[0], xyz.shape[1]
    device = xyz.device
    out = torch.empty((n * s, 8), dtype=torch.float32, device=device)
    if n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(device):
        rc = lib.onerf_mlp_eval(
            xyz.data_ptr(), dir_pe.data_ptr(), _ptr(codes) if forward_instance else None,
            packed.w.data_ptr(), packed.b.data_ptr(), _tab(packed.scene),
            _tab(packed.obj) if forward_instance else None, out.data_ptr(), n, s,
            cfg.N_freq_xyz, cfg.in_channels_dir, cfg.N_obj_code_length,
            int(forward_instance), int(compute_scene),
            torch.cuda.current_stream(device).cuda_stream,
        )
    check(lib, rc, "fused_mlp_eval")
    launch_counts["fused_mlp_eval"] += 1
    return out


def _split_out(out: torch.Tensor, n: int, s: int) -> MLPOut:
    out = out.reshape(n, s, 8)
    return (out[..., 0].contiguous(), out[..., 1:4].contiguous(),
            out[..., 4].contiguous(), out[..., 5:8].contiguous())


def _unpack_branch(model: ObjectNeRF, branch: str, tab: List[int], c_in: int, c_dir: int,
                   gw: torch.Tensor, gb: torch.Tensor, grads: Dict[str, torch.Tensor]) -> None:
    """The inverse of `_Packer.branch` on the gradient buffers: the kernel's
    (in, out) blocks back to `Linear.weight` (out, in) gradients."""
    p, names = model.branch_layers(branch), _prefixes(model, branch)
    width, k0 = p["trunk"][0].out_features, tab[T_K0]

    def mat(off: int, rows: int, cols: int) -> torch.Tensor:
        return gw[off:off + rows * cols].reshape(rows, cols)

    def bias(off: int, size: int) -> torch.Tensor:
        return gb[off:off + size].clone()

    for i in range(len(p["trunk"])):
        off = tab[T_TW + i]
        if i == 0:
            g_in_out = mat(off, k0, width)[:c_in]
        elif i in p["skips"]:
            blk = mat(off, k0 + width, width)
            g_in_out = torch.cat([blk[:c_in], blk[k0:]], dim=0)
        else:
            g_in_out = mat(off, width, width)
        grads[names[f"trunk_{i}"] + ".weight"] = g_in_out.t().contiguous()
        grads[names[f"trunk_{i}"] + ".bias"] = bias(tab[T_TB + i], width)
    nd = width // 2
    grads[names["sigma"] + ".weight"] = mat(tab[T_SIGW], 1, width).clone()
    grads[names["sigma"] + ".bias"] = bias(tab[T_SIGB], 1)
    grads[names["final"] + ".weight"] = mat(tab[T_FINW], width, width).t().contiguous()
    grads[names["final"] + ".bias"] = bias(tab[T_FINB], width)
    grads[names["dir"] + ".weight"] = torch.cat(
        [mat(tab[T_DIRWH], width, nd), mat(tab[T_DIRWD], MAX_DIR, nd)[:c_dir]], dim=0,
    ).t().contiguous()
    grads[names["dir"] + ".bias"] = bias(tab[T_DIRB], nd)
    grads[names["rgb"] + ".weight"] = mat(tab[T_RGBW], 3, nd).clone()
    grads[names["rgb"] + ".bias"] = bias(tab[T_RGBB], 3)


def fused_mlp_bwd(model: ObjectNeRF, cfg: ObjectNeRFConfig, xyz: torch.Tensor,
                  dir_pe: torch.Tensor, codes: torch.Tensor, g: torch.Tensor,
                  forward_instance: bool = True, dtype=torch.bfloat16,
                  packed: Optional[PackedWeights] = None,
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Backward of `fused_mlp_eval` given g (n*S, 8): ({parameter name:
    gradient}, d_codes (n, C_code)). One persistent block per SM adds its
    tiles' weight gradients into its own partial; a second kernel sums the
    partials in block order, so the result is deterministic. On CPU tensors
    this is `mlp_bwd_plain`."""
    n, s = _check_inputs(cfg, xyz, dir_pe, codes)
    device = xyz.device
    _check_tensor("g", g, (n * s, 8), device)
    if device.type == "cpu":
        return mlp_bwd_plain(model, cfg, xyz, dir_pe, codes, g, forward_instance, dtype)

    from ._build import check, load_library

    if packed is None:
        packed = pack_kernel_weights(model, cfg, forward_instance=forward_instance)
    _check_launch(cfg, dtype, s, packed, device, need_obj=forward_instance, need_heads=True)
    grads = {name: torch.zeros_like(p) for name, p in model.named_parameters()}
    d_codes = torch.zeros_like(codes)
    if n == 0:
        return grads, d_codes
    lib = load_library()
    rays_per_tile = 128 // s
    n_tiles = -(-n // rays_per_tile)
    n_blocks = min(n_tiles, torch.cuda.get_device_properties(device).multi_processor_count)
    nw, nb = packed.w.numel(), packed.b.numel()
    stride = nw + nb + (-(nw + nb)) % 8
    partials = torch.empty((n_blocks, stride), dtype=torch.float32, device=device)
    flat = torch.empty((stride,), dtype=torch.float32, device=device)
    stash = torch.empty((n_blocks, lib.onerf_bwd_stash_elems()), dtype=torch.bfloat16,
                        device=device)
    with torch.cuda.device(device):
        rc = lib.onerf_mlp_bwd(
            xyz.data_ptr(), dir_pe.data_ptr(), codes.data_ptr() if forward_instance else None,
            g.data_ptr(), packed.w.data_ptr(), packed.b.data_ptr(), _tab(packed.scene),
            _tab(packed.obj) if forward_instance else None, partials.data_ptr(),
            flat.data_ptr(), stride, nw, stash.data_ptr(), d_codes.data_ptr(), n_blocks,
            n, s, cfg.N_freq_xyz, cfg.in_channels_dir, cfg.N_obj_code_length,
            int(forward_instance), torch.cuda.current_stream(device).cuda_stream,
        )
    check(lib, rc, "fused_mlp_bwd")
    launch_counts["fused_mlp_bwd"] += 1
    gw, gb = flat[:nw], flat[nw:nw + nb]
    pe = cfg.xyz_pe_size
    _unpack_branch(model, "scene", packed.scene, pe, cfg.in_channels_dir, gw, gb, grads)
    if forward_instance:
        _unpack_branch(model, "object", packed.obj, pe + cfg.N_obj_code_length,
                       cfg.in_channels_dir, gw, gb, grads)
    return grads, d_codes


# ---------------------------------------------------------------------------
# The differentiable op
# ---------------------------------------------------------------------------


class FusedMLP(torch.autograd.Function):
    """`fused_mlp_eval` with `fused_mlp_bwd` as its backward. The model's
    parameters enter as tensors (in `named_parameters()` order) so that
    autograd delivers their gradients; `ctx` keeps the inputs only, and the
    backward recomputes every activation."""

    @staticmethod
    def forward(ctx, xyz, dir_pe, codes, model, cfg, forward_instance, dtype, *params):
        ctx.model, ctx.cfg = model, cfg
        ctx.forward_instance, ctx.dtype = forward_instance, dtype
        ctx.save_for_backward(xyz, dir_pe, codes)
        n, s = xyz.shape[0], xyz.shape[1]
        if xyz.device.type == "cpu":
            with torch.no_grad():
                out = mlp_eval_plain(model, cfg, xyz, dir_pe, codes, forward_instance,
                                     True, dtype)
            return tuple(o.contiguous() for o in out)
        # the bf16 copy of the weights, kept for the backward launch
        ctx.packed = pack_kernel_weights(model, cfg, forward_instance=forward_instance)
        _check_launch(cfg, dtype, s, ctx.packed, xyz.device, need_obj=forward_instance,
                      need_heads=True)
        out = _launch_eval(cfg, xyz, dir_pe, codes, ctx.packed, forward_instance, True)
        return _split_out(out, n, s)

    @staticmethod
    def backward(ctx, g_sigma, g_rgb, g_isigma, g_irgb):
        xyz, dir_pe, codes = ctx.saved_tensors
        n, s = xyz.shape[0], xyz.shape[1]
        g = torch.cat([g_sigma.reshape(n * s, 1), g_rgb.reshape(n * s, 3),
                       g_isigma.reshape(n * s, 1), g_irgb.reshape(n * s, 3)], dim=-1)
        grads, d_codes = fused_mlp_bwd(
            ctx.model, ctx.cfg, xyz, dir_pe, codes, g.contiguous(), ctx.forward_instance,
            ctx.dtype, packed=getattr(ctx, "packed", None))
        # sample positions and ray directions never feed trainable parameters
        return (None, None, d_codes, None, None, None, None,
                *(grads[name] for name, _ in ctx.model.named_parameters()))


def fused_mlp_eval(model: ObjectNeRF, cfg: ObjectNeRFConfig, xyz: torch.Tensor,
                   dir_pe: torch.Tensor, codes: Optional[torch.Tensor] = None,
                   voxel_raw: Optional[torch.Tensor] = None,
                   forward_instance: bool = True, compute_scene: bool = True,
                   dtype=torch.bfloat16,
                   packed: Optional[PackedWeights] = None) -> MLPOut:
    """Both MLP branches over all rays x samples, differentiable with respect
    to the model's parameters and `codes`.

    xyz (n, S, 3), dir_pe (n, C_dir), codes (n, C_code), float32 ->
    (sigma (n, S), rgb (n, S, 3), inst_sigma, inst_rgb); zeros for a branch
    that is off. With `compute_scene=False` (the object branch alone), or
    with `packed` (the model's `pack_kernel_weights(..., forward_instance)`,
    packed once by a caller that renders many chunks from frozen weights),
    the call is inference only."""
    if voxel_raw is not None:
        raise NotImplementedError(
            "the training kernels take no voxel operand yet (fused_mlp_eval / "
            "fused_mlp_bwd with d_voxel_raw): the eval and density kernels do")
    n, s = _check_inputs(cfg, xyz, dir_pe, codes)
    if codes is None:
        codes = xyz.new_zeros(n, cfg.N_obj_code_length)
    if packed is not None or not compute_scene:
        with torch.no_grad():
            if xyz.device.type == "cpu":
                return mlp_eval_plain(model, cfg, xyz, dir_pe, codes, forward_instance,
                                      compute_scene, dtype)
            if packed is None:
                packed = pack_kernel_weights(model, cfg, forward_instance=forward_instance)
            _check_launch(cfg, dtype, s, packed, xyz.device, need_obj=forward_instance,
                          need_heads=True)
            out = _launch_eval(cfg, xyz, dir_pe, codes, packed, forward_instance,
                               compute_scene)
            return _split_out(out, n, s)
    return FusedMLP.apply(xyz, dir_pe, codes, model, cfg, forward_instance, dtype,
                          *model.parameters())
