"""How fast is the hand-written row gather beside PyTorch's own, and the
fused voxel lookup beside the chain it replaced?

    python -m object_nerf_torch.scripts.profile_dma_gather [n_idx [rows]]

Counterpart of `scripts/profile_dma_gather.py`, asking its question of this
card: the voxel corner-table fetch is one random row of 8 x 24 channels per
sample. On the shape of that script (890,000 x 192 table, bf16 and f32,
983,040 random indices = 7680 rays x 128 samples) it times

  gather_rows            the hand-written kernel (`ops/gather.py`)
  index_select           the library call that computes the same function
  gather_rows + reduce   the row fetch followed by the trilinear 8-corner sum
  index_select + reduce  the same through the library call ("production
                         shape": what `voxel_lookup_dense` does per pass)

each as a median over launches by CUDA events, with the rows' bytes over the
time as the achieved memory rate, and checks that the two gathers agree bit
for bit. Then, on the benchmark room's grid ((63, 63, 27) cells of 0.1,
a 114,688-row corner table, bf16 and f32) at the render's fine-pass
(983,040 samples) and coarse-pass (491,520) shapes, samples drawn uniformly
over the grid's box and a margin around it, it times

  corner_lookup          the fused lookup kernel (addressing, corner-row
                         fetch and 8-corner sum in one launch)
  corner_lookup_plain    the torch chain it replaced (`corner_index_weights`,
                         `index_select`, the f32 sum)

against the byte bound: xyz read, `out` (f32) and the flag written, and the
distinct table rows the samples name, each once, at 3.35 TB/s. Every line
carries the card's name and power limit.
"""

from __future__ import annotations

import sys
from types import SimpleNamespace

import numpy as np
import torch

from ..models.voxel_grid import VoxelStatic
from ..ops.gather import corner_lookup, corner_lookup_plain, gather_rows, gather_rows_plain
from ._timing import card_line, median_ms, require_cuda

PEAK_BYTES_S = 3.35e12  # H100 SXM
ROOM_GRID, VOXEL, CHANNELS = (63, 63, 27), 0.1, 24


def main(argv) -> None:
    dev = require_cuda()
    n_idx = int(argv[0]) if len(argv) > 0 else 983040  # 7680 x 128
    rows = int(argv[1]) if len(argv) > 1 else 890000
    c = 8 * 24
    card = card_line()
    rng = np.random.RandomState(0)
    idx = torch.from_numpy(rng.randint(0, rows, size=(n_idx,)).astype(np.int32)).to(dev)
    wts = torch.from_numpy(rng.rand(n_idx, 8).astype(np.float32)).to(dev)
    print(f"[{card}] table ({rows}, {c}), idx {n_idx}")

    def reduce(r):
        return (r.reshape(-1, 8, c // 8).float() * wts[..., None]).sum(dim=1)

    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32 ")):
        table = torch.from_numpy(rng.randn(rows, c).astype(np.float32)).to(dev).to(dtype)
        if not torch.equal(gather_rows(table, idx), gather_rows_plain(table, idx)):
            raise SystemExit(f"[{tag}] gather_rows disagrees with index_select")
        moved = 2 * n_idx * c * table.element_size() + 4 * n_idx
        for name, fn in (
            ("gather_rows         ", lambda: gather_rows(table, idx, check_indices=False)),
            ("index_select        ", lambda: gather_rows_plain(table, idx)),
            ("gather_rows + reduce", lambda: reduce(gather_rows(table, idx,
                                                                check_indices=False))),
            ("index_select+ reduce", lambda: reduce(gather_rows_plain(table, idx))),
        ):
            ms = median_ms(fn)
            print(f"[{card}] [{tag}] {name}: {ms:7.3f} ms ({ms * 1e6 / n_idx:5.2f} ns/row, "
                  f"rows alone {moved / ms / 1e6:6.0f} GB/s)")
    profile_corner_lookup(dev, card, rng)


def profile_corner_lookup(dev, card, rng) -> None:
    """The fused lookup and its plain chain at the render's two pass shapes."""
    static = VoxelStatic(ROOM_GRID, CHANNELS, 6, 1 << 17)
    topo = SimpleNamespace(voxel_offset=torch.zeros(3, device=dev),
                           voxel_size=torch.tensor(VOXEL, device=dev))
    n_rows = (ROOM_GRID[0] + 1) * (ROOM_GRID[1] + 1) * (ROOM_GRID[2] + 1)
    table32 = torch.from_numpy(rng.randn(n_rows, 8 * CHANNELS).astype(np.float32)).to(dev)
    box = np.asarray(ROOM_GRID, np.float32) * VOXEL
    for n in (983040, 491520):  # 7680 rays x 128 fine, x 64 coarse samples
        xyz = torch.from_numpy(
            (rng.rand(n, 3) * 1.2 - 0.1).astype(np.float32) * box).to(dev)
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32 ")):
            table = table32.to(dtype)
            out, inv, flat, wts = corner_lookup(table, xyz, topo, static, with_addressing=True)
            want = corner_lookup_plain(table, xyz, topo, static, with_addressing=True)
            if not (torch.equal(flat, want[2]) and torch.equal(inv, want[1])
                    and torch.equal(wts, want[3])):
                raise SystemExit(f"[{tag}] corner_lookup's addressing differs from the chain's")
            gap = (out - want[0]).abs().max().item()
            distinct = int(torch.unique(flat).numel())
            nbytes = n * (12 + 4 * CHANNELS + 1) + distinct * 8 * CHANNELS * table.element_size()
            bound = nbytes / PEAK_BYTES_S * 1e3
            for name, fn in (
                ("corner_lookup       ", lambda: corner_lookup(table, xyz, topo, static)),
                ("corner_lookup_plain ", lambda: corner_lookup_plain(table, xyz, topo, static)),
            ):
                ms = median_ms(fn)
                print(f"[{card}] [{tag}] {name} {n} samples ({distinct} distinct rows): "
                      f"{ms:7.3f} ms, bound {bound:.3f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s), "
                      f"{bound / ms * 100:5.1f} % of it; max |fused - chain| {gap:.2e}")


if __name__ == "__main__":
    main(sys.argv[1:])
