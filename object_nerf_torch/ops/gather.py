"""Row gather and the voxel corner-table lookup: wrappers and plain versions.

* `gather_rows`: `out[i, :] = table[idx[i], :]`. Replaces the Pallas TPU
  kernel `dma_gather` (`scripts/profile_dma_gather.py:39-92`), the row fetch
  of the voxel corner table, one row of 8 x 24 channels per sample.
* `corner_lookup`: the dense-route trilinear lookup of a corner table
  (`models/voxel_grid.make_corner_table`) in one launch: the sample
  addressing of `corner_index_weights`, the fetch of the sample's row and the
  f32 8-corner sum, with the row never written to device memory. Its plain
  version `corner_lookup_plain` is that chain in torch.

Both kernels are CUDA C++ for Hopper (`csrc/gather_rows.cu`, built by
`_build.py`). On CUDA tensors a wrapper launches its kernel or raises; on CPU
tensors it runs its plain version, which sits beside it here. The wrappers
carry no gradient: the table gradient of a training step's lookups is the
hand-written backward of `models/voxel_grid.CornerTable` (one `index_add_`
segment-sum of the rows and weights `corner_lookup` returns with
`with_addressing`, and the transpose of the table build). `launch_counts` (a
counter dict of `utils/trace.py`) counts kernel launches and nothing else.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..utils import trace

launch_counts: Dict[str, int] = trace.counter_dict(("gather_rows", "corner_lookup"))
reset_launch_counts = trace.reset  # every counter and span total of the registry

ROW_DTYPES = (torch.bfloat16, torch.float32)

_constants: Dict[tuple, torch.Tensor] = {}


def constant(values: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    """`torch.tensor(values, dtype=dtype, device=device)` of a (nested)
    tuple, made once per (values, dtype, device) and kept; callers never
    write it. A later call copies nothing from the host, so a CUDA graph can
    capture its caller."""
    key = (values, dtype, torch.device(device))
    t = _constants.get(key)
    if t is None:
        t = _constants[key] = torch.tensor(values, dtype=dtype, device=device)
    return t


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of `gather_rows`: `table.index_select(0, idx)`."""
    return table.index_select(0, idx)


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                check_indices: bool = True) -> torch.Tensor:
    """(N, C) rows of `table` (R, C) at `idx` (N,) int32.

    `table` is bf16 or f32 with rows of a multiple of 16 bytes; both tensors
    contiguous and on one device. With `check_indices` an index outside
    [0, R) raises before anything is read (the check fetches two scalars from
    the device); a caller whose indices are clipped into the table by
    construction passes False and skips that synchronisation."""
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"table must be (R, C) and idx (N,), got {tuple(table.shape)} "
                         f"and {tuple(idx.shape)}")
    if table.dtype not in ROW_DTYPES:
        raise ValueError(f"table must be bfloat16 or float32, got {table.dtype}")
    if idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32, got {idx.dtype}")
    if idx.device != table.device:
        raise ValueError(f"idx is on {idx.device}, table on {table.device}")
    if not table.is_contiguous() or not idx.is_contiguous():
        raise ValueError("table and idx must be contiguous")
    n, (r, c) = idx.shape[0], table.shape
    if check_indices and n > 0:
        lo, hi = torch.aminmax(idx)
        lo, hi = int(lo), int(hi)
        if lo < 0 or hi >= r:
            raise IndexError(f"idx spans [{lo}, {hi}], table has {r} rows")
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows runs on CUDA or (plain version) CPU tensors, "
                         f"got {table.device}")
    row_bytes = c * table.element_size()
    if row_bytes % 16 or table.data_ptr() % 16:
        raise ValueError(f"rows of {row_bytes} bytes: the kernel copies 16-byte vectors "
                         f"from a 16-byte aligned table")

    from ._build import check, load_library

    out = torch.empty((n, c), dtype=table.dtype, device=table.device)
    if n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(table.device):
        rc = lib.onerf_gather_rows(table.data_ptr(), idx.data_ptr(), out.data_ptr(), n,
                                   row_bytes,
                                   torch.cuda.current_stream(table.device).cuda_stream)
    check(lib, rc, "gather_rows")
    launch_counts["gather_rows"] += 1
    return out


# channels of a corner block that one thread of `corner_lookup_kernel` sums:
# one 16-byte load of a bf16 table, two of an f32 one
CORNER_SLICE = 8


def trilinear_weights(p: torch.Tensor) -> torch.Tensor:
    """(N, 8) corner weights in binary corner order ((0, 0, 0), (0, 0, 1),
    ..., (1, 1, 1): the blocks of a corner-table row) from fractions (N, 3)."""
    u, v, w = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    lu, lv, lw = 1.0 - u, 1.0 - v, 1.0 - w
    return torch.cat(
        [lu * lv * lw, lu * lv * w, lu * v * lw, lu * v * w,
         u * lv * lw, u * lv * w, u * v * lw, u * v * w], dim=-1)


def corner_index_weights(topo, static, xyz: torch.Tensor):
    """Dense-route sample addressing: (flat (N,) int32 padded-cell row index,
    wts (N, 8) f32 trilinear weights, zeroed for out-of-bounds samples,
    sample_valid (N,) bool). `topo` is a `models.voxel_grid.VoxelTopology`
    (its `voxel_offset`, `voxel_size`), `static` a `VoxelStatic` (its
    `shape`).

    `sum(ct[flat].reshape(N, 8, C) * wts[..., None], 1)` is the masked
    trilinear lookup: an out-of-bounds sample reads a valid (clipped) row with
    weight 0."""
    _, Y, Z = static.shape
    xyz_scaled = (xyz + topo.voxel_offset) / topo.voxel_size
    base = torch.floor(xyz_scaled)
    q0 = base.to(torch.int32)
    shape = constant(tuple(static.shape), torch.int32, xyz.device)
    sample_valid = ((q0 >= -1) & (q0 <= shape - 1)).all(dim=-1)
    pb = torch.minimum((q0 + 1).clamp(min=0), shape)  # padded-frame base cell
    flat = (pb[:, 0] * (Y + 1) + pb[:, 1]) * (Z + 1) + pb[:, 2]
    wts = trilinear_weights(xyz_scaled - base) * sample_valid[:, None]
    return flat, wts, sample_valid


def corner_sum(rows: torch.Tensor, wts: torch.Tensor, channels: int) -> torch.Tensor:
    """The f32 trilinear sum of fetched corner rows (N, 8 C) with weights (N, 8)."""
    return (rows.reshape(-1, 8, channels).float() * wts[..., None]).sum(dim=1)


def corner_lookup_plain(ct: torch.Tensor, xyz: torch.Tensor, topo, static,
                        with_addressing: bool = False) -> Tuple[torch.Tensor, ...]:
    """Plain version of `corner_lookup`: `corner_index_weights`, the rows by
    `gather_rows_plain` and `corner_sum`; differentiable in `ct`."""
    flat, wts, sample_valid = corner_index_weights(topo, static, xyz)
    out = corner_sum(gather_rows_plain(ct, flat), wts, static.channels)
    if with_addressing:
        return out, ~sample_valid, flat, wts
    return out, ~sample_valid


def corner_lookup(ct: torch.Tensor, xyz: torch.Tensor, topo, static,
                  with_addressing: bool = False) -> Tuple[torch.Tensor, ...]:
    """Trilinear lookup of samples xyz (N, 3) f32 in the corner table `ct`
    ((X+1)(Y+1)(Z+1), 8 C), bf16 or f32, of a grid of `static.shape` (X, Y,
    Z): (out (N, C) f32, invalid (N,) bool), and with `with_addressing` also
    (flat (N,) int32, wts (N, 8) f32) for a table gradient.

    Of `topo` (a `models.voxel_grid.VoxelTopology`) it reads `voxel_offset`
    (3,) and `voxel_size` () f32, of `static` (a `VoxelStatic`) `shape` and
    `channels`.

    On CUDA tensors one launch of `corner_lookup_kernel`, with no host
    synchronisation (the grid's shape passes as kernel arguments, the voxel
    offset and size by pointer). It does the same f32 and int32 operations
    in the same order as `corner_lookup_plain` on the card, so the row
    index, the weights and the flag are bit-equal to the chain's. Its
    8-corner sums are within 1e-6 of their terms' magnitude, and bit-equal
    as long as ATen reduces the chain's (N, 8, C) product in the order the
    kernel copies (`tests/test_torch_kernels_cuda.py`). On CPU tensors
    `corner_lookup_plain`. Everything contiguous and on one device; C a
    multiple of `CORNER_SLICE`."""
    c = static.channels
    if c % CORNER_SLICE:
        raise ValueError(f"{c} channels: the lookup sums slices of {CORNER_SLICE} channels")
    if ct.dim() != 2 or ct.shape[1] != 8 * c:
        raise ValueError(f"ct must be (rows, 8 x {c}), got {tuple(ct.shape)}")
    if xyz.dim() != 2 or xyz.shape[1] != 3:
        raise ValueError(f"xyz must be (N, 3), got {tuple(xyz.shape)}")
    if ct.dtype not in ROW_DTYPES:
        raise ValueError(f"ct must be bfloat16 or float32, got {ct.dtype}")
    params = (xyz, topo.voxel_offset, topo.voxel_size)
    if any(t.dtype != torch.float32 for t in params):
        raise ValueError("xyz, voxel_offset and voxel_size must be float32")
    if any(t.device != ct.device for t in params):
        raise ValueError(f"ct is on {ct.device}, xyz on {xyz.device}, the voxel offset and "
                         f"size on {topo.voxel_offset.device} / {topo.voxel_size.device}")
    if not (ct.is_contiguous() and all(t.is_contiguous() for t in params)):
        raise ValueError("ct, xyz, voxel_offset and voxel_size must be contiguous")
    X, Y, Z = static.shape
    if ct.shape[0] != (X + 1) * (Y + 1) * (Z + 1):
        raise ValueError(f"ct has {ct.shape[0]} rows, a grid of {static.shape} has "
                         f"{(X + 1) * (Y + 1) * (Z + 1)}")
    if ct.device.type == "cpu":
        return corner_lookup_plain(ct, xyz, topo, static, with_addressing)
    if ct.device.type != "cuda":
        raise ValueError(f"corner_lookup runs on CUDA or (plain version) CPU tensors, "
                         f"got {ct.device}")
    if ct.data_ptr() % 16:
        raise ValueError("the kernel reads 16-byte vectors from a 16-byte aligned table")

    from ._build import check, load_library

    n = xyz.shape[0]
    out = torch.empty((n, c), dtype=torch.float32, device=ct.device)
    invalid = torch.empty((n,), dtype=torch.bool, device=ct.device)
    flat = wts = None
    if with_addressing:
        flat = torch.empty((n,), dtype=torch.int32, device=ct.device)
        wts = torch.empty((n, 8), dtype=torch.float32, device=ct.device)
    if n == 0:
        return (out, invalid, flat, wts) if with_addressing else (out, invalid)
    lib = load_library()
    with torch.cuda.device(ct.device):
        rc = lib.onerf_corner_lookup(
            ct.data_ptr(), int(ct.dtype == torch.bfloat16), xyz.data_ptr(),
            topo.voxel_offset.data_ptr(), topo.voxel_size.data_ptr(), out.data_ptr(),
            invalid.data_ptr(), None if flat is None else flat.data_ptr(),
            None if wts is None else wts.data_ptr(), n, c, X, Y, Z,
            torch.cuda.current_stream(ct.device).cuda_stream)
    check(lib, rc, "corner_lookup")
    launch_counts["corner_lookup"] += 1
    if with_addressing:
        return out, invalid, flat, wts
    return out, invalid
