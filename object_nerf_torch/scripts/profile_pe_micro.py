"""What does the in-kernel positional encoding cost on top of the trunk?

    python -m object_nerf_torch.scripts.profile_pe_micro [n_rows]

Counterpart of `scripts/profile_pe_micro.py`, asking its question of this
card. Per row the voxel kernels encode 27 raw channels (xyz 3, scene voxel 16,
instance voxel 8) to 348 sines before the first layer. `ops/probes.pe_probe`
runs that encoding by one of eight modes in front of an 8-layer 256-wide chain
that stands for the trunk, over the fine pass's row count (7680 rays x 128
samples = 983,040). Timed, as in the original: `none` (the chain alone, the
lower bound), `combined` (one 27-wide sum per column, sinf),
`combined_polysin` (the same with the polynomial sine) and `split_polysin`
(sums over the piece's own 3, 16 or 8 channels), each as a median over
launches by CUDA events beside the card's name and power limit, and held
against the plain version first.
"""

from __future__ import annotations

import sys

from ..ops import probes
from ._fixtures import probe_inputs
from ._timing import card_line, median_ms, require_cuda

TIMED_MODES = ("none", "combined", "combined_polysin", "split_polysin")


def main(argv) -> None:
    dev = require_cuda()
    n_rows = int(argv[0]) if argv else 7680 * 128
    card = card_line()
    x, s, trunk = probe_inputs(n_rows, dev)
    packed = probes.pack_probe_trunk(trunk)
    flop = 2 * n_rows * (375 * 256 + 7 * 256 * 256)
    base = None
    for mode in TIMED_MODES:
        got = probes.pe_probe(x, *s, trunk, mode, packed=packed)
        want = probes.pe_probe_plain(x, *s, trunk, mode)
        err = ((got - want).abs().max() / want.abs().max()).item()
        del got, want
        ms = median_ms(lambda: probes.pe_probe(x, *s, trunk, mode, packed=packed), 10)
        base = ms if base is None else base
        print(f"[{card}] {mode:17s}: {ms:8.3f} ms ({ms - base:+7.3f} ms over none; chain "
              f"{flop / ms / 1e9:6.1f} TFLOP/s; max rel err vs plain {err:.1e})")


if __name__ == "__main__":
    main(sys.argv[1:])
