"""Sparse voxel feature grid with trilinear interpolation.

Counterpart of `object_nerf_tpu/models/voxel_grid.py` (itself parity with the
reference `EmbeddingVoxel`, models/embedding_helper.py:77-479):

* Build (`build_voxel_grid`, :135-214): normalise a scene point cloud by
  (scene_center, scale_factor), quantise at voxel_size, mark occupancy, dilate
  with an all-ones cube of size `neighbor_marks`, and map occupied cells to
  rows of a fixed-capacity `(capacity, channels)` feature table.
* Lookup (`voxel_lookup_raw`, :596-643): trilinear interpolation over the 8
  neighbour corners; out-of-bounds or empty corners contribute zero. Three
  routes: the corner table (`voxel_lookup_dense`, one row fetch per sample),
  the per-corner gather for grids whose corner table would exceed
  `DENSE_CELL_TABLE_LIMIT_BYTES`, and the nearest-cell lookup.
* `voxel_embed` (:646-665): the full `EmbeddingVoxel.forward`.
* The table gradient (`corner_table_transpose`, :456-474, and the
  segment-sum backward of the row fetch, :296-330; as the JAX split step
  writes it, `train/split_step.py:242-271`): `CornerTable` builds the
  corner table of one training step (or one eval frame) once; every lookup
  of the step reads it,
  and the backward of all of them is ONE `index_add_` segment-sum of the
  weighted row cotangents into an f32 table and the linear transpose of the
  build (8 slice-adds and one `row_to_cell` gather), in f32 whether the
  table was built in bf16 or not (the cast's derivative is the identity, as
  `_take_rows_bf16`, :307-330). `PlainCornerTable` is its plain version
  (autograd through an f32 build).
* Progressive training (`prune_empty_voxels`, `subdivide_voxels`,
  :759-888): host-orchestrated; the topology they return lives on the grid's
  device.

The corner table is `((X+1)(Y+1)(Z+1), 8 C)`: row p holds the features of the
8 corners of the padded-frame base cell p, so a sample's whole neighbourhood
is ONE contiguous row. On a CUDA table `voxel_lookup_dense` and
`CornerTable.lookup` are one launch of the hand-written
`ops.gather.corner_lookup` kernel (addressing, row fetch and 8-corner sum;
the addressing `corner_index_weights` and the plain chain live beside it in
`ops/gather.py`); everything else here is plain tensor code. Topology
tensors live on an explicit device; the build runs on the host in numpy.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.gather import constant, corner_lookup, corner_lookup_plain, trilinear_weights
from ..utils import trace
from .embedding import freq_encode

INSTANCE_FTR_C = 8  # instance channels at the tail of the table (embedding_helper.py:185)

# corner tables built since the last reset (a frame or a sweep builds one), a
# counter dict of `utils/trace.py`; the build, the lookups of `CornerTable` and
# its table gradient are the spans `voxel.table`, `voxel.lookup`, `voxel.table_grad`
build_counts = trace.counter_dict(("corner_table",))


class VoxelTopology(NamedTuple):
    """Non-trainable voxel-grid state (buffers in the reference)."""

    idx_map: torch.Tensor  # (X*Y*Z,) int32 flattened; -1 = empty
    occupancy: torch.Tensor  # (X*Y*Z,) bool
    voxel_size: torch.Tensor  # () f32, normalised units
    voxel_offset: torch.Tensor  # (3,) f32, -bounds_min
    n_occupied: torch.Tensor  # () int32
    # inverse of idx_map: table row -> flat cell index (X*Y*Z for unused rows)
    row_to_cell: torch.Tensor  # (capacity,) int32

    def to(self, device) -> "VoxelTopology":
        return VoxelTopology(*(t.to(device) for t in self))


@dataclasses.dataclass(frozen=True)
class VoxelStatic:
    """Shape-defining metadata."""

    shape: Tuple[int, int, int]
    channels: int
    n_freq_voxel: int
    n_max_voxels: int

    @property
    def scene_channels(self) -> int:
        return self.channels - INSTANCE_FTR_C


# ---------------------------------------------------------------------------
# Build (host-side numpy; runs once at dataset setup)
# ---------------------------------------------------------------------------


def _row_to_cell_from_idx_map(idx_map: np.ndarray, capacity: int) -> np.ndarray:
    """Invert a dense cell->row idx map into row->flat-cell. Unused rows map
    to the trash cell `n_cells` (one past the grid)."""
    idx = np.asarray(idx_map).reshape(-1)
    n_cells = idx.shape[0]
    rtc = np.full((capacity,), n_cells, np.int32)
    cells = np.flatnonzero(idx >= 0)
    rtc[idx[cells]] = cells.astype(np.int32)
    return rtc


def _topology(idx_map: np.ndarray, occ: np.ndarray, voxel_size: float, offset,
              capacity: int, device) -> VoxelTopology:
    idx_map = np.asarray(idx_map).reshape(-1).astype(np.int32)
    return VoxelTopology(
        idx_map=torch.from_numpy(idx_map),
        occupancy=torch.from_numpy(np.asarray(occ).reshape(-1).astype(bool)),
        voxel_size=torch.tensor(np.float32(voxel_size)),
        voxel_offset=torch.from_numpy(np.asarray(offset, dtype=np.float32).copy()),
        n_occupied=torch.tensor(int((idx_map >= 0).sum()), dtype=torch.int32),
        row_to_cell=torch.from_numpy(_row_to_cell_from_idx_map(idx_map, capacity)),
    ).to(device)


def topology_from_dict(d, capacity: Optional[int] = None, device="cpu") -> VoxelTopology:
    """Rebuild a VoxelTopology from a checkpoint dict of arrays or tensors.
    `capacity` is the feature table's row count; row_to_cell is derived when
    absent."""
    d = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    if "row_to_cell" not in d:
        idx = d["idx_map"].numpy()
        if capacity is None:
            capacity = int(idx.max()) + 1 if (idx >= 0).any() else 1
        d["row_to_cell"] = torch.from_numpy(_row_to_cell_from_idx_map(idx, capacity))
    return VoxelTopology(
        idx_map=d["idx_map"].reshape(-1).to(torch.int32),
        occupancy=d["occupancy"].reshape(-1).to(torch.bool),
        voxel_size=d["voxel_size"].reshape(()).to(torch.float32),
        voxel_offset=d["voxel_offset"].reshape(3).to(torch.float32),
        n_occupied=d["n_occupied"].reshape(()).to(torch.int32),
        row_to_cell=d["row_to_cell"].reshape(-1).to(torch.int32),
    ).to(device)


def topology_to_dict(topo: VoxelTopology):
    """The topology as CPU tensors under its field names (for checkpoints)."""
    return {k: v.detach().cpu() for k, v in topo._asdict().items()}


def _dilate_occupancy(occ: np.ndarray, k: int) -> np.ndarray:
    """All-ones k^3 dilation (the reference's Conv3d trick,
    embedding_helper.py:154-169) via shifted ORs."""
    if k <= 1:
        return occ
    r = (k - 1) // 2
    out = np.zeros_like(occ)
    for dx in range(-r, k - r):
        for dy in range(-r, k - r):
            for dz in range(-r, k - r):
                src = occ[
                    max(0, -dx): occ.shape[0] - max(0, dx),
                    max(0, -dy): occ.shape[1] - max(0, dy),
                    max(0, -dz): occ.shape[2] - max(0, dz),
                ]
                out[
                    max(0, dx): occ.shape[0] - max(0, -dx),
                    max(0, dy): occ.shape[1] - max(0, -dy),
                    max(0, dz): occ.shape[2] - max(0, -dz),
                ] |= src
    return out


def build_voxel_grid(pcd_xyz: np.ndarray, scene_center, scale_factor: float,
                     voxel_size_world: float, neighbor_marks: int, channels: int,
                     n_freq_voxel: int, n_max_voxels: int,
                     generator: Optional[torch.Generator] = None,
                     auto_capacity: bool = True, device="cpu"):
    """Construct (features, topology, static) from a raw point cloud.

    pcd_xyz: (N, 3) world-space points (e.g. from read_ply). Returns
    (features (capacity, channels) f32, VoxelTopology, VoxelStatic) on
    `device`. Features are N(0, 1) (torch.nn.Embedding's default) drawn from
    the CPU `generator` (seed 0 when None), so a seed means the same table on
    every device.

    auto_capacity sizes the table to ~9x the occupied count (a power of two,
    capped by n_max_voxels): room for the one 8x subdivision of progressive
    training with 12.5 % headroom."""
    pts = (np.asarray(pcd_xyz, np.float64) - np.asarray(scene_center)) / scale_factor
    voxel_size = voxel_size_world / scale_factor
    bounds_min = pts.min(0)
    bounds_max = pts.max(0)
    offset = -bounds_min
    # +3 margin matches the reference (embedding_helper.py:119-123)
    shape = tuple(int((bounds_max[i] - bounds_min[i]) / voxel_size) + 3 for i in range(3))

    q = np.round((pts + offset) / voxel_size).astype(np.int64)
    valid = np.all((q >= 0) & (q < np.array(shape)), axis=1)
    q = q[valid]
    occ = np.zeros(shape, dtype=bool)
    occ[q[:, 0], q[:, 1], q[:, 2]] = True
    occ = _dilate_occupancy(occ, neighbor_marks)

    n_occ = int(occ.sum())
    if n_occ > n_max_voxels:
        raise ValueError(f"{n_occ} occupied voxels exceed capacity {n_max_voxels}")
    capacity = n_max_voxels
    if auto_capacity:
        capacity = min(n_max_voxels, max(1024, 1 << int(np.ceil(np.log2(n_occ * 9)))))

    idx_map = np.full(shape, -1, dtype=np.int32)
    idx_map[occ] = np.arange(n_occ, dtype=np.int32)

    if generator is None:
        generator = torch.Generator().manual_seed(0)
    features = torch.randn((capacity, channels), generator=generator).to(device)
    topo = _topology(idx_map, occ, voxel_size, offset, capacity, device)
    static = VoxelStatic(shape=shape, channels=channels, n_freq_voxel=n_freq_voxel,
                         n_max_voxels=capacity)
    return features, topo, static


def from_torch_buffers(vt, n_freq_voxel: int, device="cpu"):
    """(features, topo, static) from a reference checkpoint's buffers.

    `vt` is the "voxel" dict of `train.convert.load_reference_ckpt`: the
    features table and voxel_size / voxel_offset / voxel_shape /
    voxel_occupancy / voxel_idx_map (embedding_helper.py:107-137,187-200).
    Row indices of the table are preserved exactly."""
    features = torch.as_tensor(np.asarray(vt["features"], np.float32)).to(device)
    shape = tuple(int(x) for x in np.asarray(vt["voxel_shape"]))
    idx_map = np.asarray(vt["voxel_idx_map"]).reshape(-1).astype(np.int32)
    topo = _topology(idx_map, np.asarray(vt["voxel_occupancy"]),
                     float(np.asarray(vt["voxel_size"])), np.asarray(vt["voxel_offset"]),
                     int(features.shape[0]), device)
    static = VoxelStatic(shape=shape, channels=int(features.shape[-1]),
                         n_freq_voxel=int(n_freq_voxel), n_max_voxels=int(features.shape[0]))
    return features, topo, static


def build_voxel_grid_from_config(pcd_xyz, cfg, generator=None, device="cpu"):
    """Convenience wrapper reading the reference config schema."""
    return build_voxel_grid(
        pcd_xyz,
        scene_center=cfg.dataset_extra.scene_center,
        scale_factor=float(cfg.dataset_extra.scale_factor),
        voxel_size_world=float(cfg.dataset_extra.voxel_size),
        neighbor_marks=int(cfg.dataset_extra.neighbor_marks),
        channels=int(cfg.model.N_scn_voxel_size) + int(cfg.model.N_obj_voxel_size),
        n_freq_voxel=int(cfg.model.N_freq_voxel),
        n_max_voxels=int(cfg.model.N_max_voxels),
        generator=generator, device=device,
    )


# ---------------------------------------------------------------------------
# Lookup
# ---------------------------------------------------------------------------

_CORNERS = np.array(
    [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
     [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]],
    dtype=np.int64,
)  # binary order matches the reference's itertools.product weights
_CORNER_TUPLES = tuple(map(tuple, _CORNERS.tolist()))


def _flat_index(q: torch.Tensor, shape) -> torch.Tensor:
    return (q[..., 0] * shape[1] + q[..., 1]) * shape[2] + q[..., 2]


def _shape_tensor(static: VoxelStatic, device) -> torch.Tensor:
    return constant(tuple(static.shape), torch.int64, device)


def _gather_rows(features: torch.Tensor, topo: VoxelTopology, static: VoxelStatic,
                 q: torch.Tensor):
    """Per-cell row gather with out-of-bounds / empty masking: q (..., 3)
    integer cell coordinates -> (ftr (..., C), invalid (...,) bool)
    (get_voxel_feature_sparse_from_quantized, embedding_helper.py:331-352)."""
    shape = _shape_tensor(static, q.device)
    oob = ((q < 0) | (q >= shape)).any(dim=-1)
    q_safe = torch.minimum(q.clamp(min=0), shape - 1)
    emb_idx = topo.idx_map[_flat_index(q_safe, static.shape)].long()
    invalid = oob | (emb_idx < 0)
    ftr = features[emb_idx.clamp(min=0)]
    ftr = torch.where(invalid[..., None], torch.zeros((), dtype=ftr.dtype, device=ftr.device),
                      ftr)
    return ftr, invalid


# Transient corner-table budget for the dense lookup route; above it the
# per-corner gather route is used instead. 2 GiB covers the reference's
# flagship progressive run after its subdivision: an ~8 x 8 x 3 m ScanNet
# scene at 0.1 m voxels subdivides to (166, 166, 66), a 1.34 GiB f32 table.
DENSE_CELL_TABLE_LIMIT_BYTES = 2 << 30


def dense_table_bytes(static: VoxelStatic) -> int:
    """f32 size of the dense corner table for this grid."""
    n_pcells = (static.shape[0] + 1) * (static.shape[1] + 1) * (static.shape[2] + 1)
    return n_pcells * 8 * static.channels * 4


def dense_path_ok(static: VoxelStatic) -> bool:
    return dense_table_bytes(static) <= DENSE_CELL_TABLE_LIMIT_BYTES


def make_corner_table(features: torch.Tensor, topo: VoxelTopology, static: VoxelStatic,
                      lowp: bool = False) -> torch.Tensor:
    """Materialise the ((X+1)(Y+1)(Z+1), 8 C) corner table.

    1. Gather the dense cell grid from the table (`features[idx_map]`, empty
       cells zeroed);
    2. zero-pad the grid by one cell on every side, so out-of-bounds corners
       contribute exactly 0 (embedding_helper.py:346-351);
    3. lay the 8 shifted views side by side: row p, block k holds
       padded[p + corner_k]. A pure copy, written as eight slices and one
       `cat`.

    Base cells are indexed in the padded frame: pb = floor(xyz_scaled) + 1,
    valid for floor coordinates in [-1, shape - 1]. `lowp` casts the features
    to bf16 before the build (a pure copy, so cast-then-build equals
    build-then-cast). Differentiable with respect to `features`. Eval
    renderers build it once per frame and hand it to every chunk
    (`voxel_lookup_dense(..., ct=...)`)."""
    X, Y, Z = static.shape
    C = static.channels
    build_counts["corner_table"] += 1
    with trace.span("voxel.table", stream=True):
        if lowp:
            features = features.to(torch.bfloat16)
        idx = topo.idx_map.long()
        dense = torch.where((idx >= 0)[:, None], features[idx.clamp(min=0)],
                            torch.zeros((), dtype=features.dtype, device=features.device))
        p = torch.nn.functional.pad(dense.reshape(X, Y, Z, C), (0, 0, 1, 1, 1, 1, 1, 1))
        views = [p[bx:bx + X + 1, by:by + Y + 1, bz:bz + Z + 1] for bx, by, bz in _CORNERS]
        return torch.cat(views, dim=-1).reshape(-1, 8 * C)


def corner_table_transpose(d_ct: torch.Tensor, row_to_cell: torch.Tensor,
                           static: VoxelStatic) -> torch.Tensor:
    """d_features (capacity, C) f32 from a corner-table cotangent d_ct
    ((X+1)(Y+1)(Z+1), 8 C): the linear transpose of `make_corner_table`.
    Block k of row p came from padded cell p + corner_k, so it is added back
    there (8 slice-adds); the padding is dropped, and each table row takes
    its cell's sum through `row_to_cell` (one gather; rows of no cell read
    the zero trash row). No scatter into capacity rows: idx_map and
    row_to_cell are mutually inverse (`corner_table_transpose`,
    object_nerf_tpu/models/voxel_grid.py:456-474)."""
    X, Y, Z = static.shape
    C = static.channels
    d = d_ct.reshape(X + 1, Y + 1, Z + 1, 8, C).float()
    padded = d.new_zeros(X + 2, Y + 2, Z + 2, C)
    for k, (bx, by, bz) in enumerate(_CORNERS):
        padded[bx:bx + X + 1, by:by + Y + 1, bz:bz + Z + 1] += d[..., k, :]
    d_dense = padded[1:X + 1, 1:Y + 1, 1:Z + 1].reshape(-1, C)
    d_dense = torch.cat([d_dense, d_dense.new_zeros(1, C)])  # the trash cell
    return d_dense[row_to_cell.long()]


def corner_table_grad(cotangents, topo: VoxelTopology, static: VoxelStatic) -> torch.Tensor:
    """d_features from the lookups of one table: `cotangents` is a list of
    (d_out (N, C), flat (N,), wts (N, 8)). d_rows = d_out (x) wts in f32, ONE
    `index_add_` segment-sum over all of them into an f32 corner table, then
    `corner_table_transpose` (split_step.py:242-271)."""
    C = static.channels
    d_rows = torch.cat([(d.reshape(-1, 1, C).float() * w[:, :, None]).reshape(-1, 8 * C)
                        for d, _, w in cotangents])
    flat = torch.cat([f for _, f, _ in cotangents]).long()
    X, Y, Z = static.shape
    d_ct = d_rows.new_zeros(((X + 1) * (Y + 1) * (Z + 1), 8 * C)).index_add_(0, flat, d_rows)
    del d_rows
    return corner_table_transpose(d_ct, topo.row_to_cell, static)


class _TableToken(torch.autograd.Function):
    """The feature table's entry into a step's graph. Every lookup of the
    table consumes the token and leaves its cotangent in `pending`; autograd
    runs this backward once, after all of them: the whole table gradient."""

    @staticmethod
    def forward(ctx, features, pending, topo, static):
        ctx.pending, ctx.topo, ctx.static = pending, topo, static
        return features.new_zeros(1)

    @staticmethod
    def backward(ctx, _):
        if not ctx.pending:
            return None, None, None, None
        with trace.span("voxel.table_grad"):  # on autograd's thread for a CUDA table
            d_features = corner_table_grad(ctx.pending, ctx.topo, ctx.static)
        ctx.pending.clear()
        return d_features, None, None, None


class _CornerLookup(torch.autograd.Function):
    """One lookup of a step's table: `corner_lookup` with its addressing (one
    launch of the kernel on a CUDA table, the plain chain on a CPU one). Its
    backward only files (d_out, flat, wts) for the table's token."""

    @staticmethod
    def forward(ctx, token, ct, xyz, topo, static, pending):
        out, invalid, flat, wts = corner_lookup(ct, xyz, topo, static, with_addressing=True)
        ctx.pending = pending
        ctx.save_for_backward(flat, wts)
        ctx.mark_non_differentiable(invalid, flat, wts)
        return out, invalid, flat, wts

    @staticmethod
    def backward(ctx, d_out, *_):
        flat, wts = ctx.saved_tensors
        ctx.pending.append((d_out, flat, wts))
        return d_out.new_zeros(1), None, None, None, None, None


class CornerTable:
    """The corner table of one training step (the JAX split step's P1,
    train/split_step.py:131-152) or one eval frame: built once from
    `features`, in bf16 when `lowp`, and read by every `lookup` of the step
    or frame. Built under autograd from a table that requires a gradient,
    the table gradient of all lookups is one segment-sum and one transpose
    (`corner_table_grad`), in f32 whatever `lowp`; built under
    `torch.no_grad()` it is an eval table."""

    def __init__(self, features: torch.Tensor, topo: VoxelTopology, static: VoxelStatic,
                 lowp: bool = False):
        self.topo, self.static = topo, static
        with torch.no_grad():
            self.ct = make_corner_table(features, topo, static, lowp=lowp)
        # the lookups' cotangents; the token's backward (not this object)
        # holds it, so the graph keeps no reference cycle to the table
        pending: list = []
        self._pending = pending
        self._token = None
        if torch.is_grad_enabled() and features.requires_grad:
            self._token = _TableToken.apply(features, pending, topo, static)

    def lookup(self, xyz: torch.Tensor, with_addressing: bool = False):
        """(ftr (N, C) f32, invalid (N,) bool) at normalised xyz (N, 3), as
        `voxel_lookup_dense`; `with_addressing` also returns (flat, wts)."""
        with trace.span("voxel.lookup", stream=True):
            if self._token is None:
                return corner_lookup(self.ct, xyz, self.topo, self.static, with_addressing)
            looked = _CornerLookup.apply(self._token, self.ct, xyz, self.topo, self.static,
                                         self._pending)
        return looked if with_addressing else looked[:2]


class PlainCornerTable:
    """Plain version of `CornerTable`: autograd through an f32 build and
    `index_select`; with `lowp` the table holds the bf16 values and passes
    the gradient unchanged (straight through), the JAX package's rule."""

    def __init__(self, features: torch.Tensor, topo: VoxelTopology, static: VoxelStatic,
                 lowp: bool = False):
        self.topo, self.static = topo, static
        ct = make_corner_table(features, topo, static)
        if lowp:
            ct = ct + (ct.to(torch.bfloat16).float() - ct).detach()
        self.ct = ct

    def lookup(self, xyz: torch.Tensor):
        return corner_lookup_plain(self.ct, xyz, self.topo, self.static)


def voxel_lookup_dense(features: Optional[torch.Tensor], topo: VoxelTopology,
                       static: VoxelStatic, xyz: torch.Tensor, lowp: bool = False,
                       ct: Optional[torch.Tensor] = None, with_addressing: bool = False):
    """Trilinear lookup through the corner table: one row fetch per sample.

    xyz (N, 3) normalised coordinates -> (ftr (N, C) f32, invalid (N,) bool).
    `ct`: a prebuilt `make_corner_table` (`features` may be None then);
    without it the table is built here, in bf16 when `lowp`, and under
    autograd the table gradient reaches `features` through
    `CornerTable`'s hand-written backward (f32 whatever `lowp`). The lookup
    of a CUDA table is the `corner_lookup` kernel, which carries no gradient
    (a prebuilt CUDA table that requires one is refused), of a CPU table its
    plain version; the 8-corner sum runs in f32. `with_addressing` also
    returns (flat, wts)."""
    if ct is None:
        return CornerTable(features, topo, static, lowp=lowp).lookup(
            xyz, with_addressing=with_addressing)
    if ct.device.type == "cuda" and torch.is_grad_enabled() and ct.requires_grad:
        raise ValueError("the row fetch of a prebuilt CUDA corner table carries no gradient: "
                         "pass `features` and no `ct` (the table gradient of "
                         "CornerTable), or look up under torch.no_grad()")
    return corner_lookup(ct, xyz, topo, static, with_addressing)


def voxel_lookup_raw(features: Optional[torch.Tensor], topo: VoxelTopology,
                     static: VoxelStatic, xyz: torch.Tensor, trilinear: bool = True,
                     lowp: bool = False, ct: Optional[torch.Tensor] = None):
    """Raw (un-encoded) voxel features at xyz: (ftr (N, C), invalid (N,)).

    Trilinear lookups take the corner-table route when the grid is small
    enough to materialise it (or `ct` is given); the per-corner gather route
    remains for huge grids, and the nearest-cell lookup for `trilinear=False`.
    `invalid` means all 8 corners empty on the gather route and sample out of
    bounds on the dense route; the renders consume only `ftr`."""
    if ct is not None and not trilinear:
        raise ValueError("ct (prebuilt corner table) implies the trilinear dense path; "
                         "the nearest-neighbor lookup never consults it")
    xyz_scaled = (xyz + topo.voxel_offset) / topo.voxel_size
    if not trilinear:
        q = torch.round(xyz_scaled).long()
        return _gather_rows(features, topo, static, q)
    if ct is not None or dense_path_ok(static):
        return voxel_lookup_dense(features, topo, static, xyz, lowp=lowp, ct=ct)

    base = torch.floor(xyz_scaled)
    q = base.long()[:, None, :] + constant(_CORNER_TUPLES, torch.int64, xyz.device)[None]
    ftr, invalid = _gather_rows(features, topo, static, q)  # (N, 8, C), (N, 8)
    wts = trilinear_weights(xyz_scaled - base)
    out = (ftr * wts[..., None]).sum(dim=1)
    return out, invalid.all(dim=-1)


def voxel_embed(features: Optional[torch.Tensor], topo: VoxelTopology, static: VoxelStatic,
                xyz: torch.Tensor, n_freq_xyz: int = 10, ct: Optional[torch.Tensor] = None):
    """The full EmbeddingVoxel.forward (embedding_helper.py:325-329): returns
    (emb_xyz = [PE(scene_ftr), PE(xyz)], obj_voxel = PE(inst_ftr))."""
    raw, _ = voxel_lookup_raw(features, topo, static, xyz, trilinear=True, ct=ct)
    scene_x = raw[:, : static.scene_channels]
    inst_x = raw[:, static.scene_channels:]
    scene_emb = freq_encode(scene_x, static.n_freq_voxel)
    inst_emb = freq_encode(inst_x, static.n_freq_voxel)
    xyz_emb = freq_encode(xyz, n_freq_xyz)
    return torch.cat([scene_emb, xyz_emb], dim=-1), inst_emb


def check_occupancy(topo: VoxelTopology, static: VoxelStatic, xyz: torch.Tensor):
    """Occupancy at rounded xyz (embedding_helper.py:413-427)."""
    q = torch.round((xyz + topo.voxel_offset) / topo.voxel_size).long()
    shape = _shape_tensor(static, xyz.device)
    oob = ((q < 0) | (q >= shape)).any(dim=-1)
    q_safe = torch.minimum(q.clamp(min=0), shape - 1)
    occ = topo.occupancy[_flat_index(q_safe, static.shape)]
    return occ & ~oob


def voxel_lookup_grid_sample(features: torch.Tensor, static: VoxelStatic, xyz: torch.Tensor,
                             bounds: torch.Tensor) -> torch.Tensor:
    """Dense grid_sample-style trilinear lookup: the reference's unused
    `forward_voxel_features_dense` variant (embedding_helper.py:429-479).

    The first X*Y*Z table rows are read as a dense (X, Y, Z, C) grid; points
    normalise to [0, 1] over `bounds` ((2, 3): lo / hi) and sample with
    `grid_sample(align_corners=True, padding_mode="border")` semantics. Two
    reference quirks are reproduced on purpose: point coordinate k samples
    grid axis 2 - k (its rearrange keeps (X, Y, Z) while grid_sample's x
    addresses the innermost axis), and no sample is zeroed by occupancy
    (`ind_occu = ind_full`, :441-443). Returns raw (M, C) features."""
    X, Y, Z = static.shape
    sizes = torch.tensor([X, Y, Z], dtype=torch.float32, device=xyz.device)
    lo, hi = bounds[0], bounds[1]
    u = (xyz - lo) / (hi - lo)
    p = u.flip(-1) * (sizes - 1.0)
    p = torch.minimum(p.clamp(min=0.0), sizes - 1.0)  # border padding
    i0 = torch.floor(p).long()
    i1 = torch.minimum(i0 + 1, _shape_tensor(static, xyz.device) - 1)
    f = p - i0
    out = torch.zeros((xyz.shape[0], features.shape[-1]), dtype=features.dtype,
                      device=features.device)
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                ix = i1[:, 0] if cx else i0[:, 0]
                iy = i1[:, 1] if cy else i0[:, 1]
                iz = i1[:, 2] if cz else i0[:, 2]
                w = ((f[:, 0] if cx else 1.0 - f[:, 0])
                     * (f[:, 1] if cy else 1.0 - f[:, 1])
                     * (f[:, 2] if cz else 1.0 - f[:, 2]))
                out = out + features[(ix * Y + iy) * Z + iz] * w[:, None]
    return out


def ray_box_intersection(topo: VoxelTopology, static: VoxelStatic, rays_o: torch.Tensor,
                         rays_d: torch.Tensor, near: torch.Tensor, far: torch.Tensor,
                         n_samples: int = 256):
    """Brute-force near/far tightening by occupancy probing
    (embedding_helper.py:304-323)."""
    t = torch.linspace(0.0, 1.0, n_samples, device=rays_o.device)
    z = near * (1 - t) + far * t  # (N, S)
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    occ = check_occupancy(topo, static, xyz.reshape(-1, 3)).reshape(z.shape)
    near_out = (z + (~occ) * 1e9).min(dim=-1, keepdim=True).values
    near_out = torch.where(near_out > 1e5, near, near_out)
    far_out = (z * occ).max(dim=-1, keepdim=True).values
    far_out = torch.where(far_out == 0, far, far_out)
    return near_out, far_out


# ---------------------------------------------------------------------------
# Progressive training: prune + subdivide (host-orchestrated)
# ---------------------------------------------------------------------------


@torch.no_grad()
def prune_empty_voxels(features: torch.Tensor, topo: VoxelTopology, static: VoxelStatic,
                       sigma_fn, generator: Optional[torch.Generator] = None,
                       uniform: Optional[torch.Tensor] = None, max_alpha_th: float = 0.5,
                       samples_per_voxel: int = 16 ** 3, voxel_batch: int = 256,
                       ) -> VoxelTopology:
    """Drop the voxels whose largest alpha over random interior samples is
    below `max_alpha_th` (`prune_empty_voxels`,
    object_nerf_tpu/models/voxel_grid.py:759-820; reference
    embedding_helper.py:202-245). Returns the new topology (same shapes, on
    the grid's device); the table keeps its rows.

    The occupied voxels go in batches of `voxel_batch` (the last one padded
    with the origin, as in the JAX package), `samples_per_voxel` points each,
    jittered by U(-v/2, v/2) per axis. `sigma_fn(pts (M, 3), voxel_raw (M, C))
    -> (M,)` is the density of the points (`fused_sigma_eval` on the fine
    scene branch, whose plain version runs on CPU tensors); their raw voxel
    features come from one f32 corner table built here. The uniform draws
    come from `generator` (on the grid's device; None: its default one) or,
    in batch order, from `uniform` (n_batches * voxel_batch *
    samples_per_voxel, 3), which a test fills with the JAX package's draws."""
    occ3 = topo.occupancy.cpu().numpy().reshape(static.shape)
    idx_occ = np.argwhere(occ3)  # (K, 3)
    if len(idx_occ) == 0:
        return topo  # nothing left to prune
    device = features.device
    voxel_size = float(topo.voxel_size)
    offset = topo.voxel_offset.cpu().numpy()
    voxel_xyz = idx_occ.astype(np.float32) * voxel_size - offset
    ct = make_corner_table(features, topo, static) if dense_path_ok(static) else None

    n, step = len(voxel_xyz), int(voxel_batch)
    per_batch = step * samples_per_voxel
    empty = []
    for b, i in enumerate(range(0, n, step)):
        chunk = voxel_xyz[i:i + step]
        pad = step - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.zeros((pad, 3), np.float32)])
        pts = torch.from_numpy(np.repeat(chunk, samples_per_voxel, axis=0)).to(device)
        if uniform is not None:
            u = uniform[b * per_batch:(b + 1) * per_batch].to(device)
        else:
            u = torch.rand(pts.shape, generator=generator, device=device)
        pts = (pts + (u * voxel_size - voxel_size / 2)).contiguous()
        raw, _ = voxel_lookup_raw(features, topo, static, pts, ct=ct)
        sigma = sigma_fn(pts, raw.contiguous())
        # alpha over 1 m of field (embedding_helper.py:224-226)
        alphas = 1.0 - torch.exp(-torch.relu(sigma))
        alphas = alphas.reshape(step, samples_per_voxel).amax(-1).cpu().numpy()
        empty.append(alphas[:step - pad] < max_alpha_th)
    empty = np.concatenate(empty)[:n]

    keep3 = occ3.copy()
    drop = idx_occ[empty]
    keep3[drop[:, 0], drop[:, 1], drop[:, 2]] = False
    idx_map = topo.idx_map.cpu().numpy().reshape(static.shape).copy()
    dropped_rows = idx_map[drop[:, 0], drop[:, 1], drop[:, 2]]
    idx_map[drop[:, 0], drop[:, 1], drop[:, 2]] = -1
    # pruned rows point at the trash cell, so the table gradient skips them
    row_to_cell = topo.row_to_cell.cpu().numpy().copy()
    row_to_cell[dropped_rows[dropped_rows >= 0]] = int(np.prod(static.shape))
    dev = topo.idx_map.device
    return topo._replace(
        idx_map=torch.from_numpy(idx_map.reshape(-1)).to(dev),
        occupancy=torch.from_numpy(keep3.reshape(-1)).to(dev),
        n_occupied=torch.tensor(int(keep3.sum()), dtype=torch.int32, device=dev),
        row_to_cell=torch.from_numpy(row_to_cell).to(dev),
    )


@torch.no_grad()
def subdivide_voxels(features: torch.Tensor, topo: VoxelTopology, static: VoxelStatic,
                     chunk: int = 1 << 18):
    """Halve the voxel size: every occupied voxel spawns 8 children whose
    features are the trilinear resample of the parent grid at the child
    positions (`subdivide_voxels`, object_nerf_tpu/models/voxel_grid.py:
    823-888; reference embedding_helper.py:247-302).

    Returns (new features, new topology, new static) on the grid's device:
    the shape doubles, the table keeps its capacity and every row that no
    child takes keeps its value. Children that land on one cell are written
    in order, the last one wins (the reference's index_put). Raises when
    the children outnumber the table's rows."""
    occ3 = topo.occupancy.cpu().numpy().reshape(static.shape)
    idx_occ = np.argwhere(occ3)
    voxel_size = float(topo.voxel_size)
    offset = topo.voxel_offset.cpu().numpy().astype(np.float64)
    voxel_xyz = idx_occ.astype(np.float64) * voxel_size - offset

    target = voxel_size / 2
    children = [voxel_xyz + c * target for c in _CORNERS.astype(np.float64)]
    new_xyz = np.concatenate(children, 0)
    new_coord = np.round((new_xyz + offset) / target).astype(np.int64)

    new_shape = tuple(s * 2 for s in static.shape)
    if len(new_xyz) > static.n_max_voxels:
        raise ValueError(
            f"subdivision needs {len(new_xyz)} voxels > capacity {static.n_max_voxels}")

    # resample the features at the child positions from the OLD grid
    device = features.device
    ct = make_corner_table(features, topo, static) if dense_path_ok(static) else None
    feats = []
    for i in range(0, len(new_xyz), chunk):
        # row-major: np.argwhere's columns make new_xyz column-major
        pts = torch.from_numpy(np.ascontiguousarray(new_xyz[i:i + chunk], np.float32)).to(device)
        feats.append(voxel_lookup_raw(features, topo, static, pts, ct=ct)[0].cpu())
    new_ftrs = torch.cat(feats).numpy() if feats else np.zeros((0, static.channels), np.float32)

    occ_new = np.zeros(new_shape, dtype=bool)
    occ_new[new_coord[:, 0], new_coord[:, 1], new_coord[:, 2]] = True
    n_occ = int(occ_new.sum())
    idx_map_new = np.full(new_shape, -1, dtype=np.int32)
    idx_map_new[occ_new] = np.arange(n_occ, dtype=np.int32)

    assign = idx_map_new[new_coord[:, 0], new_coord[:, 1], new_coord[:, 2]]
    # children that share a cell: the last one wins
    _, first_of_reversed = np.unique(assign[::-1], return_index=True)
    last = len(assign) - 1 - first_of_reversed
    feat_np = features.detach().cpu().numpy().copy()
    feat_np[assign[last]] = new_ftrs[last]

    new_topo = _topology(idx_map_new, occ_new, target, offset.astype(np.float32),
                         int(features.shape[0]), topo.idx_map.device)
    new_static = dataclasses.replace(static, shape=new_shape)
    return torch.from_numpy(feat_np).to(device), new_topo, new_static
