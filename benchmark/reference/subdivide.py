"""The reference's voxel subdivision (`EmbeddingVoxel.voxel_subdivision`,
models/embedding_helper.py:247-302), written from its description: halve
the voxel size; every occupied voxel spawns the 8 children at its lattice
point plus {0, 1/2}^3 of its size; the grid keeps its offset and doubles
its shape; each child's features are the trilinear resample of the coarse
grid at the child's position (`voxel.lookup`). Plain float32 torch.

Departures from the published code, none of which changes a child's cell
or features:

* The features stay a lattice, one row per cell of the fine grid (zero in
  an empty cell), as `voxel.py` keeps them, not rows of an embedding table
  reached through an index map; the training reference takes the occupied
  cells' rows in C order (`train.leaves`).
* The children's positions are computed in float64 from the voxel size
  as float32 holds it, the frame of every lookup, and rounded once to
  float32.
* Children never share a cell (child (i, c) lands on 2 i + c), so the
  published code's rule for a shared cell has nothing to decide here.
* The prune that the schedule runs before this is not repeated: the
  benchmark hands in the unpruned grid and holds the program's grid after
  its prunes to this one cell for cell."""

from __future__ import annotations

import itertools
from typing import Tuple

import torch

from . import no_tf32, voxel

CHILDREN = torch.tensor(list(itertools.product((0, 1), repeat=3)))  # (8, 3)


@torch.no_grad()
def subdivide(grid: voxel.Grid, lattice: torch.Tensor) -> Tuple[voxel.Grid, torch.Tensor]:
    """(fine grid, fine lattice (2X * 2Y * 2Z, C) f32) of a coarse grid and
    its lattice (X * Y * Z, C)."""
    no_tf32()
    X, Y, Z = grid.shape
    dev = lattice.device
    parents = torch.nonzero(grid.occupied.reshape(X, Y, Z))  # (K, 3), C order
    cells = (2 * parents[:, None, :] + CHILDREN.to(dev)[None]).reshape(-1, 3)
    half = float(torch.tensor(grid.voxel_size, dtype=torch.float32)) / 2
    xyz = (cells.double() * half - grid.offset.double()).float()
    padded = voxel.dense_features(grid, lattice[grid.occupied].float())
    feats = voxel.lookup(grid, padded, xyz)

    shape = (2 * X, 2 * Y, 2 * Z)
    flat = (cells[:, 0] * shape[1] + cells[:, 1]) * shape[2] + cells[:, 2]
    occupied = torch.zeros(shape[0] * shape[1] * shape[2], dtype=torch.bool, device=dev)
    occupied[flat] = True
    fine = lattice.new_zeros(len(occupied), lattice.shape[1], dtype=torch.float32)
    fine[flat] = feats
    return voxel.Grid(shape, occupied, grid.offset, half), fine
