"""The two probe kernels of the voxel path: wrappers and plain versions.

Replace two Pallas TPU kernels that exist to answer a question about the
voxel-conditioned render, not to render:

* `pe_probe` (`make_kernel`, `scripts/profile_pe_micro.py:53-113`): what does
  the in-kernel positional encoding of the 27 raw channels [xyz 3 | scene
  voxel 16 | instance voxel 8] cost on top of the MLP trunk? Per row: the
  encoding `sin(x @ S)` by one of `MODES`, the concatenation `[x | PE]` of 375
  columns, an 8-layer 256-wide ReLU chain without biases, the row sum.
* `scale_copy` (`dummy_pallas`, `scripts/profile_voxel_split.py:127-139`,
  `o = 2 x`): a trivial kernel to launch next to a gather.

The kernels are CUDA C++ for Hopper (`csrc/probes.cu`, built by `_build.py`).
`pe_probe`'s runs on the forward chain's building blocks: a producer
warpgroup streams the packed trunk (`pack_probe_trunk`) by TMA in the chunk
order of `probe_chunks` over the tensor maps of `probe_weight_maps`, and the
encoding is one more tensor-core product, by the mode's
`pack_probe_encoding` matrix `[I_27 | S_mode | 0]`, whose epilogue applies the
mode's activation (`probe_activation`). On CUDA tensors the wrappers launch
the kernels or raise; on CPU tensors they run the plain versions beside them
here. `launch_counts` (a counter dict of `utils/trace.py`) counts kernel
launches and nothing else. The scripts
that ask the questions are `object_nerf_torch/scripts/profile_pe_micro.py` and
`profile_voxel_split.py`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence, Tuple

import torch

from .fused_mlp_vjp import (
    FWD_MAX_CHUNKS, SWEEP_BOX, SWEEP_MAPS_PER_BRANCH, forward_chunk_rows,
)
from ..utils import trace

launch_counts: Dict[str, int] = trace.counter_dict(("pe_probe", "scale_copy"))
reset_launch_counts = trace.reset  # every counter and span total of the registry

# the script's mode names, in the order of the kernel's enum
MODES = ("none", "xyz_only", "split", "split_nosin", "split_polysin",
         "combined", "combined_nosin", "combined_polysin")
N_RAW, N_PE, WIDTH, DEPTH = 27, 348, 256, 8
K0 = 384  # the first layer's 375 input rows, zero-padded for the kernel
ENC_K = 32  # the encoding product's K: the raw channels, zero-padded
_PIECES = ((0, 3), (3, 19), (19, 27))  # xyz, scene voxel, instance voxel channels
# the kernel's activations of the encoded columns (ACT_* in the source)
ACTIVATIONS = ("sin", "none", "polysin")


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 sum (the script's `_dot`)."""
    return _bf(a) @ _bf(w)


def sin_turns(u: torch.Tensor) -> torch.Tensor:
    """sin(2 pi u): one round + subtract range reduction and a degree-11 odd
    polynomial on [-0.5, 0.5] (`scripts/profile_pe_micro.py:34-50`). Here the
    polynomial is the subject of the measurement, so it is copied."""
    z = u - torch.round(u)
    w = z * z
    p = torch.full_like(z, -12.27205003)
    for c in (41.20590088, -76.58021788, 81.59619567, -41.34142188, 6.28318282):
        p = p * w + c
    return p * z


def probe_input_row(x: torch.Tensor, s_xyz: torch.Tensor, s_svox: torch.Tensor,
                    s_ivox: torch.Tensor, s_all: torch.Tensor, mode: str) -> torch.Tensor:
    """The plain version's first-layer input `[x | PE]`, (N, 375) f32 (the
    first layer rounds it to bf16)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    n = x.shape[0]
    act = {"": torch.sin, "_nosin": lambda t: t, "_polysin": sin_turns}
    if mode == "none":
        pe = x.new_zeros(n, N_PE)
    elif mode == "xyz_only":
        pe = torch.cat([torch.sin(_dot(x[:, :3], s_xyz)), x.new_zeros(n, N_PE - 60)], dim=-1)
    elif mode.startswith("split"):
        f = act[mode[len("split"):]]
        pe = torch.cat([f(_dot(x[:, a:b], s))
                        for (a, b), s in zip(_PIECES, (s_xyz, s_svox, s_ivox))], dim=-1)
    else:
        pe = act[mode[len("combined"):]](_dot(x, s_all))
    return torch.cat([x, pe], dim=-1)


def pe_probe_plain(x: torch.Tensor, s_xyz: torch.Tensor, s_svox: torch.Tensor,
                   s_ivox: torch.Tensor, s_all: torch.Tensor,
                   trunk: Sequence[torch.Tensor], mode: str) -> torch.Tensor:
    """Plain version of `pe_probe`: (N, 1) f32."""
    h = probe_input_row(x, s_xyz, s_svox, s_ivox, s_all, mode)
    for w in trunk:
        h = _bf(torch.relu(_dot(h, w)))
    return h.sum(dim=-1, keepdim=True)


def pack_probe_trunk(trunk: Sequence[torch.Tensor]) -> torch.Tensor:
    """The chain's weights as one bf16 buffer in the kernel's layout: the
    first layer's (375, 256) rows zero-padded to 384, then 7 x (256, 256)."""
    first = trunk[0].new_zeros(K0, WIDTH)
    first[:N_RAW + N_PE] = trunk[0]
    return torch.cat([first.reshape(-1)] + [w.reshape(-1) for w in trunk[1:]]) \
        .to(torch.bfloat16).contiguous()


def probe_activation(mode: str) -> int:
    """The kernel's activation of the encoded columns in `mode`, an index of
    ACTIVATIONS: the sine (`xyz_only`, `split`, `combined`), the polynomial
    sine (`*_polysin`), or none (`*_nosin`, and `none`, whose encoded columns
    are the product's exact zeros)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode.endswith("_polysin"):
        return ACTIVATIONS.index("polysin")
    if mode in ("xyz_only", "split", "combined"):
        return ACTIVATIONS.index("sin")
    return ACTIVATIONS.index("none")


def pack_probe_encoding(s_xyz: torch.Tensor, s_svox: torch.Tensor, s_ivox: torch.Tensor,
                        s_all: torch.Tensor, mode: str) -> torch.Tensor:
    """The encoding of `mode` as one matrix E, (ENC_K, K0) bf16 (rows the raw
    channels, zero-padded to 32): the identity in columns 0-26, then the S
    entries the mode multiplies by in columns 27-374 (`s_all`; the three pieces'
    blocks on the diagonal; the xyz block alone; none), zeros elsewhere. Then
    `bf16(x) @ E` with the mode's activation (`probe_activation`) in the
    columns from 27 on is the mode's `[x | PE]` up to the order of the f32
    sums: a raw channel times 1 is itself, a zero entry adds exactly 0, and
    every activation maps 0 to 0."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    e = s_all.new_zeros(ENC_K, K0)
    e.diagonal()[:N_RAW] = 1.0
    if mode.startswith("combined"):
        e[:N_RAW, N_RAW:N_RAW + N_PE] = s_all
    elif mode != "none":
        col = N_RAW
        for (a, b), s in zip(_PIECES, (s_xyz, s_svox, s_ivox)):
            e[a:b, col:col + s.shape[1]] = s
            col += s.shape[1]
            if mode == "xyz_only":
                break
    return e.to(torch.bfloat16)


def probe_weight_maps() -> List[Tuple[int, int, int]]:
    """The tensor maps of the packed trunk as the kernel's producer reads it
    (the forward chain's weight-map slots): layer i in slot i, its (element
    offset, rows, columns); (0, 0, 0) for the slots no layer takes."""
    maps, off = [(0, 0, 0)] * (2 * SWEEP_MAPS_PER_BRANCH), 0
    for i in range(DEPTH):
        rows = K0 if i == 0 else WIDTH
        maps[i] = (off, rows, WIDTH)
        off += rows * WIDTH
    return maps


def probe_chunks() -> List[Tuple[int, int, int]]:
    """The weight chunks of one tile, in the order the producer loads them and
    each consumer warpgroup reads them: `(slot, row, boxes)`, rows [row, row +
    forward_chunk_rows(256)) = 32 rows of layer `slot`, as 4 boxes of 64
    columns. Layer 0's 384 rows are 12 chunks, each later layer's 256 rows 8:
    68 a tile."""
    out = [(slot, row, cols // SWEEP_BOX[0])
           for slot, (_, rows, cols) in enumerate(probe_weight_maps()[:DEPTH])
           for row in range(0, rows, forward_chunk_rows(cols))]
    assert len(out) <= FWD_MAX_CHUNKS
    return out


@functools.lru_cache(maxsize=1)
def _launch_tables():
    """`probe_weight_maps` and `probe_chunks` as the launcher takes them."""
    maps, chunks = probe_weight_maps(), probe_chunks()
    return ((ctypes.c_int * (3 * len(maps)))(*(v for m in maps for v in m)),
            (ctypes.c_int * (3 * len(chunks)))(*(v for c in chunks for v in c)), len(chunks))


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 {tuple(shape)} tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


@torch.no_grad()
def pe_probe(x: torch.Tensor, s_xyz: torch.Tensor, s_svox: torch.Tensor,
             s_ivox: torch.Tensor, s_all: torch.Tensor, trunk: Sequence[torch.Tensor],
             mode: str, packed: torch.Tensor = None) -> torch.Tensor:
    """x (N, 27); S matrices (3, 60), (16, 192), (8, 96), (27, 348); trunk
    [(375, 256), 7 x (256, 256)], all float32 -> (N, 1) float32. bf16
    products, f32 sums. `packed`: `pack_probe_trunk(trunk)`, packed here when
    not given. The mode's encoding matrix is packed at every call."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    n, device = x.shape[0], x.device
    _check("x", x, (n, N_RAW), device)
    for name, s, shape in (("s_xyz", s_xyz, (3, 60)), ("s_svox", s_svox, (16, 192)),
                           ("s_ivox", s_ivox, (8, 96)), ("s_all", s_all, (N_RAW, N_PE))):
        _check(name, s, shape, device)
    if len(trunk) != DEPTH:
        raise ValueError(f"trunk must hold {DEPTH} matrices, got {len(trunk)}")
    for i, w in enumerate(trunk):
        _check(f"trunk[{i}]", w, (N_RAW + N_PE if i == 0 else WIDTH, WIDTH), device)
    if device.type == "cpu":
        return pe_probe_plain(x, s_xyz, s_svox, s_ivox, s_all, trunk, mode)
    if device.type != "cuda":
        raise ValueError(f"pe_probe runs on CUDA or (plain version) CPU tensors, got {device}")
    if n >= 2 ** 31:
        raise ValueError(f"N={n} rows exceed one launch")

    from ._build import check, load_library

    if packed is None:
        packed = pack_probe_trunk(trunk)
    if packed.dtype != torch.bfloat16 or packed.device != device or not packed.is_contiguous() \
            or packed.numel() != K0 * WIDTH + (DEPTH - 1) * WIDTH * WIDTH:
        raise ValueError("packed must be pack_probe_trunk(trunk) on the inputs' device")
    out = torch.empty((n, 1), dtype=torch.float32, device=device)
    if n == 0:
        return out
    enc = pack_probe_encoding(s_xyz, s_svox, s_ivox, s_all, mode)
    lib = load_library()
    with torch.cuda.device(device):
        rc = lib.onerf_pe_probe(x.data_ptr(), enc.data_ptr(), packed.data_ptr(),
                                *_launch_tables(), out.data_ptr(), n, probe_activation(mode),
                                torch.cuda.current_stream(device).cuda_stream)
    check(lib, rc, "pe_probe")
    launch_counts["pe_probe"] += 1
    return out


def scale_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of `scale_copy`: `2 x`
    (`scripts/profile_voxel_split.py:127-128`)."""
    return x * 2.0


@torch.no_grad()
def scale_copy(x: torch.Tensor) -> torch.Tensor:
    """`2 x` of a contiguous float32 tensor of any shape."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous float32, got {x.dtype}")
    if x.device.type == "cpu":
        return scale_copy_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"scale_copy runs on CUDA or (plain version) CPU tensors, "
                         f"got {x.device}")

    from ._build import check, load_library

    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    lib = load_library()
    with torch.cuda.device(x.device):
        rc = lib.onerf_scale_copy(x.data_ptr(), out.data_ptr(), x.numel(),
                                  torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, rc, "scale_copy")
    launch_counts["scale_copy"] += 1
    return out
