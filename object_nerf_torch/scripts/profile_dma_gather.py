"""How fast is the hand-written row gather beside PyTorch's own?

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
for bit. Every line carries the card's name and power limit.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.gather import gather_rows, gather_rows_plain
from ._timing import card_line, median_ms, require_cuda


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


if __name__ == "__main__":
    main(sys.argv[1:])
