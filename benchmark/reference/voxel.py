"""The sparse voxel grid of the reference's `EmbeddingVoxel`
(models/embedding_helper.py): normalise the scene's point cloud by
(scene_center, scale_factor), quantise it at the voxel size (a margin of 3
cells), mark occupied cells, dilate them by an all-ones cube of side
`neighbor_marks`; a sample's feature is the trilinear sum of its 8
neighbour corners, a corner outside the grid or in an empty cell giving 0."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Grid:
    shape: tuple
    occupied: torch.Tensor  # (X*Y*Z,) bool
    offset: torch.Tensor  # (3,) f32, -bounds_min in the normalised frame
    voxel_size: float  # normalised units

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.shape))


def build(pcd: np.ndarray, scene: dict, device) -> Grid:
    pts = (np.asarray(pcd, np.float64) - np.asarray(scene["scene_center"])) \
        / float(scene["scale_factor"])
    vs = float(scene["voxel_size"]) / float(scene["scale_factor"])
    lo, hi = pts.min(0), pts.max(0)
    shape = tuple(int((hi[i] - lo[i]) / vs) + 3 for i in range(3))
    q = np.round((pts - lo) / vs).astype(np.int64)
    q = q[np.all((q >= 0) & (q < np.array(shape)), axis=1)]
    occ = torch.zeros(shape, dtype=torch.float32)
    occ[tuple(torch.from_numpy(q).T)] = 1.0
    k = int(scene["neighbor_marks"])
    if k % 2 != 1:
        raise ValueError("neighbor_marks must be odd")
    occ = torch.nn.functional.max_pool3d(occ[None, None], k, stride=1, padding=k // 2)[0, 0]
    return Grid(shape, (occ > 0).reshape(-1).to(device),
                torch.tensor(-lo, dtype=torch.float32, device=device), vs)


def dense_features(grid: Grid, table: torch.Tensor) -> torch.Tensor:
    """(X+2, Y+2, Z+2, C): the occupied cells' rows of `table` (one row per
    occupied cell, in C order of the cells), zero elsewhere and on a border
    of one cell. Differentiable in `table`."""
    X, Y, Z = grid.shape
    idx = torch.nonzero(grid.occupied).squeeze(1)
    dense = table.new_zeros(grid.n_cells, table.shape[1]).index_copy(0, idx, table)
    dense = dense.reshape(X, Y, Z, -1)
    return torch.nn.functional.pad(dense, (0, 0, 1, 1, 1, 1, 1, 1))


def lookup(grid: Grid, padded: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Trilinear features (N, C) at normalised points xyz (N, 3)."""
    s = (xyz + grid.offset) / grid.voxel_size
    base = torch.floor(s)
    f = s - base
    b = base.long() + 1  # the padded frame
    lim = torch.tensor([grid.shape[0] + 1, grid.shape[1] + 1, grid.shape[2] + 1],
                       device=xyz.device)
    out = 0.0
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                q = b + torch.tensor([cx, cy, cz], device=xyz.device)
                inside = ((q >= 0) & (q <= lim)).all(-1)
                qc = torch.minimum(q.clamp(min=0), lim)
                w = ((f[:, 0] if cx else 1 - f[:, 0]) * (f[:, 1] if cy else 1 - f[:, 1])
                     * (f[:, 2] if cz else 1 - f[:, 2])) * inside
                out = out + padded[qc[:, 0], qc[:, 1], qc[:, 2]] * w[:, None]
    return out
