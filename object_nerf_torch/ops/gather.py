"""Row gather `out[i, :] = table[idx[i], :]`: wrapper and plain version.

Replaces the Pallas TPU kernel `dma_gather`
(`scripts/profile_dma_gather.py:39-92`): the row fetch of the voxel corner
table (`models/voxel_grid.voxel_lookup_dense`), one row of 8 x 24 channels per
sample. The kernel is CUDA C++ for Hopper (`csrc/gather_rows.cu`, built by
`_build.py`). On a CUDA table the wrapper launches it or raises; on a CPU
table it runs `gather_rows_plain`, which sits beside it here. The wrapper
carries no gradient: the table gradient of a training step's lookups is the
hand-written backward of `models/voxel_grid.CornerTable` (one
`index_add_` segment-sum and the transpose of the table build).
`launch_counts` counts kernel launches and nothing else.
"""

from __future__ import annotations

from typing import Dict

import torch

launch_counts: Dict[str, int] = {"gather_rows": 0}

ROW_DTYPES = (torch.bfloat16, torch.float32)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


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
