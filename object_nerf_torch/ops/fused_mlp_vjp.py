"""The training path's fused MLP: forward and backward kernels behind one
`torch.autograd.Function`.

Replaces two Pallas TPU kernels and the custom VJP around them:

* `fused_mlp_eval` (`_mlp_kernel`, `object_nerf_tpu/ops/pallas_mlp.py:287,
  :495-603`): both MLP branches over (n_rays, S) sample rows ->
  `(sigma, rgb, inst_sigma, inst_rgb)`, raw sigma (noise and ReLU are the
  caller's);
* `fused_mlp_bwd` (`_bwd_kernel` / `_run_bwd`,
  `object_nerf_tpu/ops/pallas_mlp_vjp.py:72, :417-557`): recompute the
  forward, sweep back, return every weight and bias gradient, the per-ray
  code gradient and, for a voxel-conditioned model, the gradient of the raw
  voxel features `d_voxel_raw` (pallas_mlp_vjp.py:350-375);
* `FusedMLP` (`make_fused_mlp_op`, `pallas_mlp_vjp.py:608-668`): the forward
  saves its inputs only, the backward packs the four output cotangents to
  (n*S, 8) and runs the backward kernel; `xyz` and `dir_pe` get no gradient,
  `codes` and `voxel_raw` do.

The kernels are CUDA C++ for Hopper (`csrc/fused_mlp_train.cu`). On CUDA
tensors the wrappers launch them or raise; on CPU tensors they run the plain
versions beside them here: `mlp_eval_plain` (differentiable by autograd, the
check of the hand-derived backward) and `mlp_bwd_plain` (the hand-derived
backward in tensor code, rounding where the kernel rounds). The kernels keep
the eval kernels' tile of 128 rows of whole rays, hence their restriction to
`KERNEL_SAMPLES` samples per ray. The forward is the forward chain's "eval"
mode (`fwd_chain.py` owns its format and launch). `launch_counts` (shared
with `fused_mlp.py`) counts kernel launches and nothing else.

The backward runs in three launches: a sweep over the tiles that writes
every product input and rounded d_pre of the weight gradients into a
row-major workspace (`bwd_workspace_layout`), a split-K GEMM over a work list
(`wgrad_work_list`) that contracts them over all rows, and a reduction that
adds the partial sums in a fixed order (`bwd_plan` puts the three together).
The layout and the work list are built here, where the CPU tests reach them,
and passed to the kernels as small tables; the sweep reads the weights
through the forward chain's tensor maps (`fwd_chain.sweep_weight_maps`).

A voxel-conditioned model takes `voxel_raw` (n, S, 16 + 8), the raw trilinear
features of its samples, as the eval kernels do: the input row is
`[svox | PE(svox) | xyz | PE(xyz)]` for the scene branch and that followed by
`[ivox | PE(ivox) | code]` for the object branch. Its gradient goes through
the input gradient of layer 0 and the skip layers of both branches and the
chain of the frequency encoding, in f32 (`_freq_encode_vjp`).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..models.mlp import LEAKY_SLOPE, ObjectNeRF, ObjectNeRFConfig, embed_inputs
from . import fwd_chain
from .fused_mlp import launch_counts
from .fwd_chain import (
    BRANCH_WIDTHS, MAX_DIR, SWEEP_MAPS_PER_BRANCH, T_DEPTH, T_DIRB, T_DIRWD, T_DIRWH,
    T_FINB, T_FINW, T_K0, T_LEN, T_RGBB, T_RGBW, T_SIGB, T_SIGW, T_SKIPS, T_TB, T_TW,
    PackedWeights, _check_launch, _check_tensor, _check_voxel_raw, _ptr, _run_branches, _tab,
    check_voxel_operand, input_tile_columns, pack_kernel_weights, sweep_weight_maps,
)

MLPOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
# (weight and bias gradients by parameter name, d_codes (n, C_code),
#  d_voxel_raw (n, S, C_vox) f32 or None for a classical model)
BwdOut = Tuple[Dict[str, torch.Tensor], torch.Tensor, Optional[torch.Tensor]]


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
                   matmul_dtype=torch.bfloat16,
                   voxel_raw: Optional[torch.Tensor] = None) -> MLPOut:
    """Plain version of `fused_mlp_eval`: xyz (n, S, 3), dir_pe (n, C_dir),
    codes (n, C_code), voxel_raw (n, S, C_vox) for a voxel-conditioned model
    -> sigma (n, S), rgb (n, S, 3), inst_sigma, inst_rgb; zeros for a branch
    that is off. Differentiable (autograd) in every input."""
    check_voxel_operand(cfg, voxel_raw)
    n, s, _ = xyz.shape
    emb, obj_voxel = embed_inputs(cfg, xyz.reshape(n * s, 3), voxel_raw)
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
            emb, codes.repeat_interleave(s, dim=0), obj_voxel, emb_dir=dir_flat,
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


def _freq_encode_vjp(x: torch.Tensor, d: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """The gradient of `freq_encode(x, n_freqs)` (x (M, C)) given the
    cotangent d (M, C (2 n_freqs + 1)) of its output, in f32: the identity
    block, plus 2^k cos(2^k x) times a sin column's cotangent and -2^k
    sin(2^k x) times a cos column's (JAX: `(d_sin * cos(pre)) @ S^T`,
    pallas_mlp_vjp.py:350-375, with the phase folded into the cos columns)."""
    c = x.shape[1]
    out = d[:, :c].clone()
    for k in range(n_freqs):
        f = 2.0 ** k
        blk = d[:, c + 2 * c * k: c + 2 * c * (k + 1)]
        out += f * torch.cos(f * x) * blk[:, :c] - f * torch.sin(f * x) * blk[:, c:]
    return out


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
                  voxel_raw: Optional[torch.Tensor] = None) -> BwdOut:
    """Plain version of `fused_mlp_bwd`: the hand-derived backward of
    `mlp_eval_plain`, given g (n*S, 8) = [g_sigma, g_rgb(3), g_inst_sigma,
    g_inst_rgb(3)]. Returns ({parameter name of `model`: gradient}, d_codes
    (n, C_code), d_voxel_raw (n, S, C_vox) or None): zeros for the object
    branch, the codes and the instance voxel channels when it is off.
    Activations are kept at `matmul_dtype`, every d_pre is rounded to it for
    its products, bias gradients sum the unrounded d_pre; the input gradient
    and the encoding's chain stay f32."""
    check_voxel_operand(cfg, voxel_raw)
    n, s, _ = xyz.shape
    with torch.no_grad():
        emb, obj_voxel = embed_inputs(cfg, xyz.reshape(n * s, 3), voxel_raw)
        dir_rows = dir_pe.repeat_interleave(s, dim=0)
        grads: Dict[str, torch.Tensor] = {}
        use_voxel = voxel_raw is not None
        d_cat_s = _branch_bwd_plain(model.branch_layers("scene"), _prefixes(model, "scene"),
                                    emb, dir_rows, g[:, 0:1], g[:, 1:4], matmul_dtype,
                                    use_voxel, grads)
        d_codes = codes.new_zeros(codes.shape)
        d_cat_o = None
        if forward_instance:
            pieces = [emb] + ([obj_voxel] if use_voxel else [])
            cat = torch.cat(pieces + [codes.repeat_interleave(s, dim=0)], dim=-1)
            d_cat_o = _branch_bwd_plain(
                model.branch_layers("object"), _prefixes(model, "object"), cat, dir_rows,
                g[:, 4:5], g[:, 5:8], matmul_dtype, True, grads)
            d_codes = d_cat_o[:, -codes.shape[1]:].reshape(n, s, -1).sum(dim=1)
        d_vox = None
        if use_voxel:
            raw = voxel_raw.reshape(n * s, -1).float()
            c_s, c_i, nf = cfg.N_scn_voxel_size, cfg.N_obj_voxel_size, cfg.N_freq_voxel
            c_in_s, w_s, w_i = emb.shape[1], c_s * (2 * nf + 1), c_i * (2 * nf + 1)
            if d_cat_o is not None:  # the object branch reads the scene's columns too
                d_cat_s = d_cat_s + d_cat_o[:, :c_in_s]
            d_svox = _freq_encode_vjp(raw[:, :c_s], d_cat_s[:, :w_s], nf)
            d_ivox = (_freq_encode_vjp(raw[:, c_s:], d_cat_o[:, c_in_s:c_in_s + w_i], nf)
                      if d_cat_o is not None else raw.new_zeros(n * s, c_i))
            d_vox = torch.cat([d_svox, d_ivox], dim=-1).reshape(n, s, c_s + c_i)
        for name, param in model.named_parameters():
            if name not in grads:
                grads[name] = torch.zeros_like(param)
    return grads, d_codes, d_vox


# ---------------------------------------------------------------------------
# The backward's workspace, work list and reduction (csrc/fused_mlp_train.cu)
# ---------------------------------------------------------------------------

TILE_ROWS = 128  # sample rows of a sweep tile (whole rays)
WG_BOX = (64, 64)  # a TMA box of the weight-gradient kernel: (columns, rows), bf16
WG_SWIZZLE_BYTES = 128  # its swizzle span: the box's inner extent in bytes
WG_M = 128  # dW rows (input features) of one item at most: two warpgroups of 64
WG_N = 256  # dW columns of one item at most: four wgmma blocks of 64
WG_ITEMS_PER_SM = 6  # the work list fills the card about this many times
ITEM_LEN = 8  # ints per work-list item (enum I_* in the source)
WS_TAB_LEN = 13  # enum W_* in the source


@dataclasses.dataclass(frozen=True)
class BwdLayout:
    """The backward's workspace: `rows` rows (every row of the launch's
    tiles) of `cols` bf16 columns, row-major. Columns [x, x + x_cols) hold
    the input tile; then per branch (scene, and the object branch when it
    runs) `(act, fin, g, gfin, gdir)`: the first columns of its trunk
    activations (layer i at act + i W), `final`, the rounded d_pre of its
    trunk layers (layer i at g + i W), of `final` and of the direction
    layer (W/2 columns). Every block starts at a multiple of 64 columns."""

    rows: int
    cols: int
    x: int
    x_cols: int
    branches: Tuple[Tuple[int, int, int, int, int], ...]

    def tab(self) -> List[int]:
        """The kernel's WsTab."""
        out = [self.cols, self.x, self.x_cols]
        for b in range(2):
            out += list(self.branches[b]) if b < len(self.branches) else [0] * 5
        return out

    @property
    def nbytes(self) -> int:
        return 2 * self.rows * self.cols


def bwd_workspace_layout(packed: PackedWeights, cfg: ObjectNeRFConfig, n_rows: int,
                         forward_instance: bool = True) -> BwdLayout:
    """The workspace of one backward launch over `n_rows` rows (a multiple of
    TILE_ROWS): the input tile as wide as the widest branch that runs reads
    it, then each running branch's blocks."""
    if n_rows % TILE_ROWS:
        raise ValueError(f"n_rows {n_rows} is not a multiple of {TILE_ROWS}")
    scene_k0, obj_k0 = input_tile_columns(cfg)
    x_cols = obj_k0 if forward_instance else scene_k0
    col, branches = x_cols, []
    for tab, width in zip(_run_branches(packed, forward_instance), BRANCH_WIDTHS):
        depth = tab[T_DEPTH]
        act, fin = col, col + depth * width
        g = fin + width
        gfin = g + depth * width
        gdir = gfin + width
        col = gdir + width // 2
        branches.append((act, fin, g, gfin, gdir))
    return BwdLayout(n_rows, col, 0, x_cols, tuple(branches))


def wgrad_units(packed: PackedWeights, layout: BwdLayout,
                forward_instance: bool = True) -> List[Tuple[int, int, int, int, int]]:
    """The weight-gradient tiles: `(a, g, n, m, dst)` for dW[m0:m0 + m, 0:n]
    of a matrix = act[:, a:a + m]^T @ d_pre[:, g:g + n] over the workspace's
    rows, landing at element `dst` of the packed gradient. Every trunk
    layer (a skip layer as its input rows and its hidden rows), `final` and
    the direction layer's hidden part, cut into tiles of at most WG_M rows."""
    units = []
    for b, tab in enumerate(_run_branches(packed, forward_instance)):
        width, k0, depth = BRANCH_WIDTHS[b], tab[T_K0], tab[T_DEPTH]
        act, fin, g, gfin, gdir = layout.branches[b]
        mats = []  # (a, m, g, n, dst)
        for i in range(depth):
            off, skip = tab[T_TW + i], i > 0 and (tab[T_SKIPS] >> i) & 1
            if i == 0 or skip:
                mats.append((layout.x, k0, g + i * width, width, off))
            if i > 0:
                mats.append((act + (i - 1) * width, width, g + i * width, width,
                             off + k0 * width if skip else off))
        mats.append((act + (depth - 1) * width, width, gfin, width, tab[T_FINW]))
        mats.append((fin, width, gdir, width // 2, tab[T_DIRWH]))
        for a, m, gc, n, dst in mats:
            for m0 in range(0, m, WG_M):
                units.append((a + m0, gc, n, min(WG_M, m - m0), dst + m0 * n))
    return units


@dataclasses.dataclass(frozen=True)
class WgradWork:
    """The weight-gradient kernel's work list: `items` (one block each;
    ITEM_LEN ints: a, g, n, m, k0, k1, partial offset, 0) in launch order,
    the `slices` row ranges [k0, k1) shared by every tile, and per tile
    (`units`) the reduction segment that adds its slices' partials in slice
    order. The partials take `n_floats`."""

    units: List[Tuple[int, int, int, int, int]]
    slices: List[Tuple[int, int]]
    items: List[List[int]]
    segments: List[List[int]]
    n_floats: int


def wgrad_work_list(packed: PackedWeights, layout: BwdLayout, n_sm: int,
                    forward_instance: bool = True) -> WgradWork:
    """Split every weight-gradient tile over slices of the workspace's rows
    (multiples of WG_BOX[1] rows), enough of them for about WG_ITEMS_PER_SM
    items per SM. Items are ordered by tile width (the widest first), then
    slice, then tile, so that the tiles of one matrix that share a slice of
    d_pre run side by side (the second reads it from L2)."""
    units = wgrad_units(packed, layout, forward_instance)
    bk = WG_BOX[1]
    n_slices = max(1, min(layout.rows // bk, -(-WG_ITEMS_PER_SM * n_sm // len(units))))
    per = -(-layout.rows // n_slices)
    per = -(-per // bk) * bk
    slices = [(k, min(k + per, layout.rows)) for k in range(0, layout.rows, per)]
    items, segments, base = [], [], 0
    keyed = []
    for u, (a, g, n, m, dst) in enumerate(units):
        for sl, (k0, k1) in enumerate(slices):
            keyed.append(((-n, sl, u), [a, g, n, m, k0, k1, base + sl * m * n, 0]))
        segments.append([dst, m * n, base, m * n, len(slices)])
        base += len(slices) * m * n
    items = [item for _, item in sorted(keyed, key=lambda kv: kv[0])]
    return WgradWork(units, slices, items, segments, base)


# the bias and small-head gradients that the sweep sums per block: (table
# entry, length as a function of the branch width W, True for a bias)
_SWEEP_GRADS = (
    (T_SIGB, lambda w: 1, True), (T_FINB, lambda w: w, True),
    (T_DIRB, lambda w: w // 2, True), (T_RGBB, lambda w: 3, True),
    (T_SIGW, lambda w: w, False), (T_RGBW, lambda w: 3 * (w // 2), False),
    (T_DIRWD, lambda w: MAX_DIR * (w // 2), False),
)


def sweep_partials(packed: PackedWeights, forward_instance: bool = True):
    """The sweep's compact per-block partial: (gradient tables of the
    branches, floats per block, [(dst in the packed gradient, offset in the
    partial, length)]). A gradient table has the layout of a branch's offset
    table, with the entries the sweep writes pointing into the partial."""
    nw = packed.w.numel()
    gtabs, entries, off = [], [], 0
    for tab, width in zip(_run_branches(packed, forward_instance), BRANCH_WIDTHS):
        gt = [0] * T_LEN
        grads = [(T_TB + i, width, True) for i in range(tab[T_DEPTH])]
        grads += [(key, size(width), bias) for key, size, bias in _SWEEP_GRADS]
        for key, length, bias in grads:
            gt[key] = off
            entries.append(((nw if bias else 0) + tab[key], off, length))
            off += length
        gtabs.append(gt)
    return gtabs, off + (-off) % 4, entries


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """Everything one backward launch needs besides its inputs: the
    workspace layout, the weight-gradient work list, the sweep's weight maps
    and gradient tables and partial stride, and the reduction segments
    `[dst, len, src, stride, n_parts]` over `parts` (the work list's
    partials, then `n_blocks` sweep partials from `small_base`)."""

    layout: BwdLayout
    work: WgradWork
    weight_maps: List[Tuple[int, int, int]]
    gtabs: List[List[int]]
    small_base: int
    small_stride: int
    n_blocks: int
    segments: List[List[int]]

    @property
    def n_parts(self) -> int:
        return self.small_base + self.n_blocks * self.small_stride


def bwd_plan(packed: PackedWeights, cfg: ObjectNeRFConfig, n_rows: int, n_sm: int,
             n_blocks: int, forward_instance: bool = True) -> BwdPlan:
    """The backward launch over n_rows rows with `n_blocks` sweep blocks on
    a card of `n_sm` SMs."""
    layout = bwd_workspace_layout(packed, cfg, n_rows, forward_instance)
    work = wgrad_work_list(packed, layout, n_sm, forward_instance)
    gtabs, stride, entries = sweep_partials(packed, forward_instance)
    small_base = work.n_floats + (-work.n_floats) % 4
    segments = list(work.segments) + [[dst, length, small_base + off, stride, n_blocks]
                                      for dst, off, length in entries]
    return BwdPlan(layout, work, sweep_weight_maps(packed, forward_instance), gtabs,
                   small_base, stride, n_blocks, segments)


def wgrad_gemm_plain(ws: torch.Tensor, items: List[List[int]], n_floats: int) -> torch.Tensor:
    """Plain version of the weight-gradient kernel: for each work-list item,
    act[k0:k1, a:a + m]^T @ d_pre[k0:k1, g:g + n] over the workspace `ws`
    (rows, cols), in f32, at the item's offset of an (n_floats,) buffer."""
    parts = torch.zeros(n_floats, dtype=torch.float32, device=ws.device)
    x = ws.float()
    for a, g, n, m, k0, k1, off, _ in items:
        parts[off:off + m * n] = (x[k0:k1, a:a + m].t() @ x[k0:k1, g:g + n]).reshape(-1)
    return parts


def wgrad_gemm(ws: torch.Tensor, items: torch.Tensor, n_floats: int) -> torch.Tensor:
    """The weight-gradient kernel alone, as `fused_mlp_bwd` launches it after
    the sweep: `ws` (rows, cols) bf16, `items` (n_items, ITEM_LEN) int32 ->
    the (n_floats,) f32 partials (entries no item writes are undefined). On
    CPU tensors this is `wgrad_gemm_plain`."""
    if ws.device.type == "cpu":
        return wgrad_gemm_plain(ws, items.tolist(), n_floats)
    from ._build import check, load_library

    if ws.dtype != torch.bfloat16 or ws.dim() != 2 or not ws.is_contiguous():
        raise ValueError("ws must be a contiguous (rows, cols) bf16 tensor")
    if (items.dtype != torch.int32 or items.device != ws.device or items.dim() != 2
            or items.shape[1] != ITEM_LEN or not items.is_contiguous()):
        raise ValueError(f"items must be a contiguous (n, {ITEM_LEN}) int32 tensor on "
                         f"{ws.device}")
    lib = load_library()
    parts = torch.empty((n_floats,), dtype=torch.float32, device=ws.device)
    with torch.cuda.device(ws.device):
        rc = lib.onerf_wgrad(ws.data_ptr(), ws.shape[0], ws.shape[1], items.data_ptr(),
                             items.shape[0], parts.data_ptr(),
                             torch.cuda.current_stream(ws.device).cuda_stream)
    check(lib, rc, "wgrad_gemm")
    return parts


_plans: Dict[tuple, tuple] = {}


def _device_plan(packed: PackedWeights, cfg: ObjectNeRFConfig, n_rows: int, n_sm: int,
                 n_blocks: int, forward_instance: bool, device):
    """`bwd_plan` with its work list and segments as int32 tensors on the
    card, made once per shape (a training run has two)."""
    key = (tuple(packed.scene), tuple(packed.obj or ()), packed.w.numel(),
           input_tile_columns(cfg), n_rows, n_sm, n_blocks, forward_instance, str(device))
    if key not in _plans:
        if len(_plans) >= 16:
            _plans.clear()
        plan = bwd_plan(packed, cfg, n_rows, n_sm, n_blocks, forward_instance)
        _plans[key] = (plan,
                       torch.tensor(plan.work.items, dtype=torch.int32, device=device),
                       torch.tensor(plan.segments, dtype=torch.int32, device=device))
    return _plans[key]


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


def _check_inputs(cfg: ObjectNeRFConfig, xyz, dir_pe, codes, voxel_raw) -> Tuple[int, int]:
    n, s = xyz.shape[0], xyz.shape[1]
    _check_tensor("xyz", xyz, (n, s, 3), xyz.device)
    _check_tensor("dir_pe", dir_pe, (n, cfg.in_channels_dir), xyz.device)
    if codes is not None:
        _check_tensor("codes", codes, (n, cfg.N_obj_code_length), xyz.device)
    _check_voxel_raw(cfg, voxel_raw, (n, s), xyz.device)
    return n, s


def _launch_eval(cfg, xyz, dir_pe, codes, packed: PackedWeights, dtype,
                 forward_instance: bool, compute_scene: bool,
                 voxel_raw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the forward chain for `fused_mlp_eval`; returns the (n*S, 8) f32
    output."""
    n, s = xyz.shape[0], xyz.shape[1]
    out = torch.empty((n * s, 8), dtype=torch.float32, device=xyz.device)
    fwd_chain.launch("eval", cfg, packed, dtype, n, s, xyz, dir_pe=dir_pe, codes=codes,
                     vox=voxel_raw, out=out, forward_instance=forward_instance,
                     compute_scene=compute_scene)
    if n > 0:
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
                  voxel_raw: Optional[torch.Tensor] = None) -> BwdOut:
    """Backward of `fused_mlp_eval` given g (n*S, 8): ({parameter name:
    gradient}, d_codes (n, C_code), d_voxel_raw (n, S, C_vox) f32 or None).
    The tile sweep writes the workspace of `bwd_plan` and its per-block
    partials, the weight-gradient kernel one partial per item, and the
    reduction adds each gradient's partials in a fixed order; every row of
    d_voxel_raw is written once, so the result is deterministic. On CPU
    tensors this is `mlp_bwd_plain`."""
    n, s = _check_inputs(cfg, xyz, dir_pe, codes, voxel_raw)
    device = xyz.device
    _check_tensor("g", g, (n * s, 8), device)
    if device.type == "cpu":
        return mlp_bwd_plain(model, cfg, xyz, dir_pe, codes, g, forward_instance, dtype,
                             voxel_raw)

    from ._build import check, load_library

    if packed is None:
        packed = pack_kernel_weights(model, cfg, forward_instance=forward_instance)
    _check_launch(cfg, dtype, s, packed, device, need_obj=forward_instance, need_heads=True)
    grads = {name: torch.zeros_like(p) for name, p in model.named_parameters()}
    d_codes = torch.zeros_like(codes)
    d_vox = torch.empty_like(voxel_raw) if voxel_raw is not None else None
    if n == 0:
        return grads, d_codes, d_vox
    lib = load_library()
    n_rows = -(-n // (TILE_ROWS // s)) * TILE_ROWS
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    n_blocks = min(n_rows // TILE_ROWS, n_sm)
    plan, items, segs = _device_plan(packed, cfg, n_rows, n_sm, n_blocks, forward_instance,
                                     device)
    layout = plan.layout
    nw, nb = packed.w.numel(), packed.b.numel()
    ws = torch.empty((layout.rows, layout.cols), dtype=torch.bfloat16, device=device)
    parts = torch.empty((plan.n_parts,), dtype=torch.float32, device=device)
    flat = torch.zeros((nw + nb,), dtype=torch.float32, device=device)
    gobj = _tab(plan.gtabs[1]) if forward_instance else None
    with torch.cuda.device(device):
        rc = lib.onerf_mlp_bwd(
            xyz.data_ptr(), dir_pe.data_ptr(), codes.data_ptr() if forward_instance else None,
            _ptr(voxel_raw), g.data_ptr(), packed.w.data_ptr(), packed.b.data_ptr(),
            _tab(packed.scene), _tab(packed.obj) if forward_instance else None,
            _tab(plan.gtabs[0]), gobj, (ctypes.c_int * WS_TAB_LEN)(*layout.tab()),
            (ctypes.c_int * (6 * SWEEP_MAPS_PER_BRANCH))(*sum(plan.weight_maps, ())),
            ws.data_ptr(), layout.rows, parts[plan.small_base:].data_ptr(), plan.small_stride,
            items.data_ptr(), items.shape[0], parts.data_ptr(), segs.data_ptr(),
            segs.shape[0], flat.data_ptr(), d_codes.data_ptr(), _ptr(d_vox), n_blocks, n, s,
            cfg.N_freq_xyz, cfg.in_channels_dir, cfg.N_obj_code_length, int(forward_instance),
            cfg.N_scn_voxel_size, cfg.N_obj_voxel_size, cfg.N_freq_voxel,
            torch.cuda.current_stream(device).cuda_stream,
        )
    check(lib, rc, "fused_mlp_bwd")
    launch_counts["fused_mlp_bwd"] += 1
    gw, gb = flat[:nw], flat[nw:]
    c_in_s = cfg.in_channels_xyz
    _unpack_branch(model, "scene", packed.scene, c_in_s, cfg.in_channels_dir, gw, gb, grads)
    if forward_instance:
        _unpack_branch(model, "object", packed.obj, cfg.inst_channel_in,
                       cfg.in_channels_dir, gw, gb, grads)
    return grads, d_codes, d_vox


# ---------------------------------------------------------------------------
# The differentiable op
# ---------------------------------------------------------------------------


class FusedMLP(torch.autograd.Function):
    """`fused_mlp_eval` with `fused_mlp_bwd` as its backward. The model's
    parameters enter as tensors (in `named_parameters()` order) so that
    autograd delivers their gradients; `ctx` keeps the inputs only, and the
    backward recomputes every activation. `voxel_raw` may be None (a
    classical model); otherwise its gradient is the kernel's d_voxel_raw."""

    @staticmethod
    def forward(ctx, xyz, dir_pe, codes, voxel_raw, model, cfg, forward_instance, dtype,
                *params):
        ctx.model, ctx.cfg = model, cfg
        ctx.forward_instance, ctx.dtype = forward_instance, dtype
        ctx.save_for_backward(xyz, dir_pe, codes, voxel_raw)
        n, s = xyz.shape[0], xyz.shape[1]
        if xyz.device.type == "cpu":
            with torch.no_grad():
                out = mlp_eval_plain(model, cfg, xyz, dir_pe, codes, forward_instance,
                                     True, dtype, voxel_raw)
            return tuple(o.contiguous() for o in out)
        # the bf16 copy of the weights, kept for the backward launch
        ctx.packed = pack_kernel_weights(model, cfg, forward_instance=forward_instance)
        out = _launch_eval(cfg, xyz, dir_pe, codes, ctx.packed, dtype, forward_instance, True,
                           voxel_raw)
        return _split_out(out, n, s)

    @staticmethod
    def backward(ctx, g_sigma, g_rgb, g_isigma, g_irgb):
        xyz, dir_pe, codes, voxel_raw = ctx.saved_tensors
        n, s = xyz.shape[0], xyz.shape[1]
        g = torch.cat([g_sigma.reshape(n * s, 1), g_rgb.reshape(n * s, 3),
                       g_isigma.reshape(n * s, 1), g_irgb.reshape(n * s, 3)], dim=-1)
        grads, d_codes, d_vox = fused_mlp_bwd(
            ctx.model, ctx.cfg, xyz, dir_pe, codes, g.contiguous(), ctx.forward_instance,
            ctx.dtype, packed=getattr(ctx, "packed", None), voxel_raw=voxel_raw)
        # sample positions and ray directions never feed trainable parameters
        return (None, None, d_codes, d_vox, None, None, None, None,
                *(grads[name] for name, _ in ctx.model.named_parameters()))


def fused_mlp_eval(model: ObjectNeRF, cfg: ObjectNeRFConfig, xyz: torch.Tensor,
                   dir_pe: torch.Tensor, codes: Optional[torch.Tensor] = None,
                   voxel_raw: Optional[torch.Tensor] = None,
                   forward_instance: bool = True, compute_scene: bool = True,
                   dtype=torch.bfloat16,
                   packed: Optional[PackedWeights] = None) -> MLPOut:
    """Both MLP branches over all rays x samples, differentiable with respect
    to the model's parameters, `codes` and `voxel_raw`.

    xyz (n, S, 3), dir_pe (n, C_dir), codes (n, C_code), voxel_raw (n, S,
    C_vox) for a voxel-conditioned model (the raw trilinear features of the
    samples), float32 -> (sigma (n, S), rgb (n, S, 3), inst_sigma, inst_rgb);
    zeros for a branch that is off. With `compute_scene=False` (the object
    branch alone), or with `packed` (the model's `pack_kernel_weights(...,
    forward_instance)`, packed once by a caller that renders many chunks from
    frozen weights), the call is inference only."""
    n, s = _check_inputs(cfg, xyz, dir_pe, codes, voxel_raw)
    if codes is None:
        codes = xyz.new_zeros(n, cfg.N_obj_code_length)
    if packed is not None or not compute_scene:
        with torch.no_grad():
            if xyz.device.type == "cpu":
                return mlp_eval_plain(model, cfg, xyz, dir_pe, codes, forward_instance,
                                      compute_scene, dtype, voxel_raw)
            if packed is None:
                packed = pack_kernel_weights(model, cfg, forward_instance=forward_instance)
            out = _launch_eval(cfg, xyz, dir_pe, codes, packed, dtype, forward_instance,
                               compute_scene, voxel_raw)
            return _split_out(out, n, s)
    return FusedMLP.apply(xyz, dir_pe, codes, voxel_raw, model, cfg, forward_instance, dtype,
                          *model.parameters())
