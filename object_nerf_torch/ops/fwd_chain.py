"""The forward chain's format and launch: the one owner of both.

The forward chain (`fwd_chain_kernel<VOX, MODE>` in `csrc/fused_mlp_wg.cuh`)
is the kernel behind four wrappers, one mode each but the density's two:

* "eval": `fused_mlp_eval` (`fused_mlp_vjp.py`), both branches per row;
* "render": `fused_render_tiles` (`fused_mlp.py`), the same composited per ray;
* "weights": `fused_coarse_weights` (`fused_mlp.py`), the scene trunk, its
  sigma head and the pdf weights;
* "sigma_scene", "sigma_obj": `fused_sigma_eval` (`fused_sigma.py`), one
  branch's raw density per point.

This module holds everything the host knows of it. The kernel format:
`pack_kernel_weights` lays one model out as the kernels read it (the
backward `fused_mlp_bwd` reads the same packing), `check_kernel_config` and
`_check_launch` say which models and operands the kernels take. The chain's
tables: the weight matrices as the tensor maps of its weight ring
(`sweep_weight_maps`, which the backward's sweep reads too), and the order in
which its producer streams their chunks (`forward_chunks`), built once per
packing layout (`forward_launch_tables`). The launch: `launch(mode, ...)`
fills one `FwdArgs` (the mirror of the source's struct) and calls the
library's one entry point, `onerf_fwd_chain`.

The mode is the one selector. It fixes which heads run (the chunk order
stops at the sigma head unless the mode is "eval" or "render", as
`FwdCfg::HEADS` in the source) and, but in "eval" and "render", which
branches run (`chain_branches`).

The wrappers check their operands, run their plain versions on CPU tensors
and call `launch` on CUDA tensors; they count their own launches in
`fused_mlp.launch_counts`. `chain_layout` reads, per model and mode, the
chain's weight-ring depth and shared memory from the built library.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..models.mlp import ObjectNeRF, ObjectNeRFConfig
from ..utils import trace
from ._build import check, load_library

# ---------------------------------------------------------------------------
# Shapes the kernels take (constants of csrc/fused_mlp_common.cuh)
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
# The weight maps and the chunk order
# ---------------------------------------------------------------------------

BRANCH_WIDTHS = (SCENE_W, OBJ_W)
SWEEP_MAPS_PER_BRANCH = 10  # enum WM_*: trunk layers 0-7, `final`, the direction layer
SWEEP_BOX = (64, 64)  # the backward sweep's weight boxes: (columns, rows), bf16

# the chain's modes (FWD_* in csrc/fused_mlp_wg.cuh), in their order
CHAIN_MODES = ("eval", "render", "weights", "sigma_scene", "sigma_obj")
# the modes that run the rgb heads (FwdCfg::HEADS); the others stop at sigma
HEAD_MODES = ("eval", "render")
# the modes whose tile is made of whole rays, S in KERNEL_SAMPLES
_RAY_MODES = ("eval", "render", "weights")
# the branches each mode runs, (forward_instance, compute_scene); None: the
# caller's choice
_MODE_BRANCHES = {"eval": (None, None), "render": (None, True), "weights": (False, True),
                  "sigma_scene": (False, True), "sigma_obj": (True, False)}

# the producer streams these chunks through the weight ring
FWD_MAX_CHUNKS = 320  # chunks of one tile at most (FWD_MAX_CHUNKS in the source)
FWD_STAGE_BYTES = 16384  # one chunk, one stage of the ring (FWD_STAGE)


def _run_branches(packed: PackedWeights, forward_instance: bool) -> List[List[int]]:
    return [packed.scene] + ([packed.obj] if forward_instance else [])


def sweep_weight_maps(packed: PackedWeights,
                      forward_instance: bool = True) -> List[Tuple[int, int, int]]:
    """The weight matrices the forward chain and the backward's sweep
    multiply by, as the TMA tensor maps of their weight rings: per branch
    slot (trunk layer i at i, `final` at 8, the direction layer's hidden part
    at 9) the matrix's (element offset in the packed weights, rows,
    columns), row-major bf16; (0, 0, 0) for a slot that no matrix takes,
    among them `final` and the direction layer of a `sigma_only` packing,
    which holds neither. A skip layer is one map: its input rows, then its
    hidden rows."""
    maps = [(0, 0, 0)] * (2 * SWEEP_MAPS_PER_BRANCH)
    for bi, tab in enumerate(_run_branches(packed, forward_instance)):
        width, k0, base = BRANCH_WIDTHS[bi], tab[T_K0], bi * SWEEP_MAPS_PER_BRANCH
        for i in range(tab[T_DEPTH]):
            skip = i > 0 and (tab[T_SKIPS] >> i) & 1
            rows = k0 if i == 0 else (k0 + width if skip else width)
            maps[base + i] = (tab[T_TW + i], rows, width)
        if not packed.sigma_only:
            maps[base + 8] = (tab[T_FINW], width, width)
            maps[base + 9] = (tab[T_DIRWH], width, width // 2)
    return maps


def chain_branches(mode: str, forward_instance: Optional[bool] = None,
                   compute_scene: Optional[bool] = None) -> Tuple[bool, bool]:
    """(forward_instance, compute_scene) of a launch in `mode`: the caller's
    for "eval" (True where not given), the caller's object branch and the
    scene for "render"; the other modes fix both and take neither."""
    if mode not in _MODE_BRANCHES:
        raise ValueError(f"mode must be one of {CHAIN_MODES}, got {mode!r}")
    out = []
    for fixed, given in zip(_MODE_BRANCHES[mode], (forward_instance, compute_scene)):
        if fixed is not None and given is not None:
            raise ValueError(f"mode {mode!r} fixes the branches it runs")
        out.append(fixed if fixed is not None else given is None or bool(given))
    return out[0], out[1]


def forward_chunk_rows(cols: int) -> int:
    """K rows of one chunk of a matrix of `cols` columns: a row of 64-column
    boxes across the matrix that fills one FWD_STAGE_BYTES stage (32 rows of
    the 256-wide scene layers, 64 of the 128-wide ones, 128 of the object
    branch's 64-wide direction layer)."""
    return FWD_STAGE_BYTES // (2 * cols)


def forward_chunks(packed: PackedWeights, mode: str, forward_instance: Optional[bool] = None,
                   compute_scene: Optional[bool] = None) -> List[Tuple[int, int, int]]:
    """The weight chunks of one tile of the forward chain in `mode`, in the
    order its producer loads them and each consumer warpgroup reads them:
    `(slot, row, boxes)`, rows [row, row + forward_chunk_rows(cols)) of the
    (rows, cols) matrix of `sweep_weight_maps` slot `slot`, as `boxes` = cols
    / 64 TMA boxes. Per branch that runs (`chain_branches`): trunk layer 0
    (the input rows), each later layer (a skip layer's input rows, then its
    hidden rows), then, in the modes with the rgb heads, `final` and the
    direction layer's hidden part. The order does not depend on the data, so
    the producer runs ahead across layers, branches and tiles."""
    return _chunks(packed, mode, *chain_branches(mode, forward_instance, compute_scene))


def _chunks(packed: PackedWeights, mode: str, forward_instance: bool,
            compute_scene: bool) -> List[Tuple[int, int, int]]:
    heads = mode in HEAD_MODES
    if packed.sigma_only and heads:
        raise ValueError("a sigma_only packing holds no `final` or direction layer")
    maps = sweep_weight_maps(packed, forward_instance)
    out: List[Tuple[int, int, int]] = []
    for bi, tab in enumerate(_run_branches(packed, forward_instance)):
        if bi == 0 and not compute_scene:
            continue
        base, width, k0 = bi * SWEEP_MAPS_PER_BRANCH, BRANCH_WIDTHS[bi], tab[T_K0]

        def rows(slot: int, r0: int, n: int) -> None:
            cols = maps[base + slot][2]
            out.extend((base + slot, r, cols // SWEEP_BOX[0])
                       for r in range(r0, r0 + n, forward_chunk_rows(cols)))

        for i in range(tab[T_DEPTH]):
            skip = i > 0 and (tab[T_SKIPS] >> i) & 1
            if i == 0 or skip:
                rows(i, 0, k0)
            if i > 0:
                rows(i, k0 if skip else 0, width)
        if heads:
            rows(8, 0, width)
            rows(9, 0, width)
    if len(out) > FWD_MAX_CHUNKS:
        raise ValueError(f"{len(out)} weight chunks per tile exceed {FWD_MAX_CHUNKS}")
    return out


def forward_weight_bytes(packed: PackedWeights, mode: str,
                         forward_instance: Optional[bool] = None,
                         compute_scene: Optional[bool] = None) -> int:
    """Bytes of weights one tile of the forward chain copies from L2 into
    shared memory (every block reads every chunk once per tile)."""
    return FWD_STAGE_BYTES * len(forward_chunks(packed, mode, forward_instance, compute_scene))


def forward_launch_tables(packed: PackedWeights, mode: str,
                          forward_instance: Optional[bool] = None,
                          compute_scene: Optional[bool] = None):
    """The forward chain's tables as `onerf_fwd_chain` takes them: the
    branches' offset tables (T_LEN ints; the object branch's None unless it
    runs), the weight maps (WM_LEN x 3 ints), the chunk order (n x 3 ints)
    and n. They depend on the packing's offset tables alone, so they are
    built once per layout."""
    forward_instance, compute_scene = chain_branches(mode, forward_instance, compute_scene)
    return _launch_tables(tuple(packed.scene), None if packed.obj is None else tuple(packed.obj),
                          packed.sigma_only, mode, forward_instance, compute_scene)


@functools.lru_cache(maxsize=64)
def _launch_tables(scene, obj, packed_sigma_only, mode, forward_instance, compute_scene):
    layout = PackedWeights(None, None, list(scene), None if obj is None else list(obj),
                           packed_sigma_only)
    maps = sweep_weight_maps(layout, forward_instance)
    flat = [v for c in _chunks(layout, mode, forward_instance, compute_scene) for v in c]
    return (_tab(scene), _tab(obj) if forward_instance else None,
            (ctypes.c_int * (3 * len(maps)))(*(v for m in maps for v in m)),
            (ctypes.c_int * max(1, len(flat)))(*flat), len(flat) // 3)


# ---------------------------------------------------------------------------
# Checks of the wrappers' operands
# ---------------------------------------------------------------------------


def check_voxel_operand(cfg: ObjectNeRFConfig, voxel_raw: Optional[torch.Tensor]) -> None:
    """`voxel_raw` goes with a voxel-conditioned model and with no other."""
    if cfg.use_voxel_embedding and voxel_raw is None:
        raise ValueError("voxel_raw required when cfg.use_voxel_embedding")
    if not cfg.use_voxel_embedding and voxel_raw is not None:
        raise ValueError("voxel_raw given to a model without voxel embedding")


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


# ---------------------------------------------------------------------------
# The launch
# ---------------------------------------------------------------------------


class VoxDims(ctypes.Structure):
    """`struct VoxDims` of csrc/fused_mlp_common.cuh."""

    _fields_ = [("c_s", ctypes.c_int), ("c_i", ctypes.c_int), ("n_fv", ctypes.c_int)]


class FwdArgs(ctypes.Structure):
    """`struct FwdArgs` of csrc/fused_mlp_wg.cuh, field by field: one
    launch's device pointers (null where the mode reads none), the voxel
    widths, the launch's shape and what it computes."""

    _fields_ = [
        ("xyz", ctypes.c_void_p), ("z", ctypes.c_void_p), ("dir_pe", ctypes.c_void_p),
        ("codes", ctypes.c_void_p), ("vox", ctypes.c_void_p), ("w", ctypes.c_void_p),
        ("b", ctypes.c_void_p), ("out", ctypes.c_void_p), ("maps", ctypes.c_void_p),
        ("weights", ctypes.c_void_p), ("vd", VoxDims), ("n_rays", ctypes.c_int),
        ("S", ctypes.c_int), ("n_freq", ctypes.c_int), ("c_dir", ctypes.c_int),
        ("code_len", ctypes.c_int), ("forward_instance", ctypes.c_int),
        ("compute_scene", ctypes.c_int), ("last_delta_inf", ctypes.c_int),
    ]


def _tab(values: Optional[List[int]]):
    if values is None:
        return None
    return (ctypes.c_int * T_LEN)(*values)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def launch(mode: str, cfg: ObjectNeRFConfig, packed: PackedWeights, dtype, n_rays: int,
           s: int, xyz: torch.Tensor, *, z=None, dir_pe=None, codes=None, vox=None,
           out=None, maps=None, weights=None, last_delta_inf: bool = False,
           forward_instance: Optional[bool] = None,
           compute_scene: Optional[bool] = None) -> None:
    """Launch the forward chain in `mode` (one of `CHAIN_MODES`) over
    `n_rays` runs of `s` rows on xyz's device and current stream: nothing
    when n_rays is 0, after the checks. The caller has checked the operands'
    shapes; `forward_instance` and `compute_scene` as `chain_branches` takes
    them. Outputs: `out` (eval: (n_rays * s, 8) rows; the point-wise modes:
    (n_rays * s,) densities, a "ray" a run of s points that share a code),
    `maps` and `weights` (render: (n_rays, MAPS), and (n_rays, s) or None;
    coarse weights: `weights`)."""
    inst, scene = chain_branches(mode, forward_instance, compute_scene)
    device = xyz.device
    _check_launch(cfg, dtype, s if mode in _RAY_MODES else None, packed, device,
                  need_obj=inst, need_heads=mode in HEAD_MODES)
    if n_rays == 0:
        return
    tables = _launch_tables(tuple(packed.scene),
                            None if packed.obj is None else tuple(packed.obj),
                            packed.sigma_only, mode, inst, scene)
    args = FwdArgs(
        xyz.data_ptr(), _ptr(z), _ptr(dir_pe), _ptr(codes) if inst else None, _ptr(vox),
        packed.w.data_ptr(), packed.b.data_ptr(), _ptr(out), _ptr(maps), _ptr(weights),
        VoxDims(cfg.N_scn_voxel_size, cfg.N_obj_voxel_size, cfg.N_freq_voxel), n_rays, s,
        cfg.N_freq_xyz, cfg.in_channels_dir, cfg.N_obj_code_length, inst, scene,
        last_delta_inf)
    lib = load_library()
    with torch.cuda.device(device):
        rc = lib.onerf_fwd_chain(
            int(vox is not None), CHAIN_MODES.index(mode), ctypes.addressof(args), *tables,
            torch.cuda.current_stream(device).cuda_stream)
    check(lib, rc, f"forward chain ({mode})")


def chain_layout(voxel: bool, mode: str) -> Tuple[int, int]:
    """(weight-ring stages, dynamic shared memory bytes) of the forward chain's
    instantiation for the voxel-conditioned or the classical model in `mode`
    (one of `CHAIN_MODES`), as the built library lays it out. Builds the
    library on first use; launches nothing."""
    if mode not in CHAIN_MODES:
        raise ValueError(f"mode must be one of {CHAIN_MODES}, got {mode!r}")
    lib = load_library()
    stages, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.onerf_fwd_chain_layout(int(voxel), CHAIN_MODES.index(mode),
                                    ctypes.addressof(stages), ctypes.addressof(smem))
    check(lib, rc, "chain_layout")
    return stages.value, smem.value


def sincos_mismatches(x: torch.Tensor) -> int:
    """The f32 arguments of `x` (a CUDA tensor) at which the card's
    full-precision `sincosf` differs in any bit from its `sinf` / `cosf`: the
    forward chain takes both values of an encoded pair from one `sincosf`,
    where the reference order reads them as separate columns."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 CUDA tensor")
    lib = load_library()
    count = torch.zeros(1, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.onerf_sincos_check(x.data_ptr(), x.numel(), count.data_ptr(),
                                    torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, rc, "sincos_mismatches")
    return int(count.item())
