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
On CUDA tensors the wrappers launch them or raise; on CPU tensors they run
the plain versions beside them here. `launch_counts` counts kernel launches
and nothing else. The scripts that ask the questions are
`object_nerf_torch/scripts/profile_pe_micro.py` and `profile_voxel_split.py`.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

launch_counts: Dict[str, int] = {"pe_probe": 0, "scale_copy": 0}

# the script's mode names, in the order of the kernel's enum
MODES = ("none", "xyz_only", "split", "split_nosin", "split_polysin",
         "combined", "combined_nosin", "combined_polysin")
N_RAW, N_PE, WIDTH, DEPTH = 27, 348, 256, 8
K0 = 384  # the first layer's 375 input rows, zero-padded for the kernel
_PIECES = ((0, 3), (3, 19), (19, 27))  # xyz, scene voxel, instance voxel channels


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


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


def pe_probe_plain(x: torch.Tensor, s_xyz: torch.Tensor, s_svox: torch.Tensor,
                   s_ivox: torch.Tensor, s_all: torch.Tensor,
                   trunk: Sequence[torch.Tensor], mode: str) -> torch.Tensor:
    """Plain version of `pe_probe`: (N, 1) f32."""
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
    h = torch.cat([x, pe], dim=-1)
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
    not given."""
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

    from ._build import check, load_library

    if packed is None:
        packed = pack_probe_trunk(trunk)
    out = torch.empty((n, 1), dtype=torch.float32, device=device)
    if n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(device):
        rc = lib.onerf_pe_probe(x.data_ptr(), s_xyz.data_ptr(), s_svox.data_ptr(),
                                s_ivox.data_ptr(), s_all.data_ptr(), packed.data_ptr(),
                                out.data_ptr(), n, MODES.index(mode),
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
