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
(sums over the piece's own 3, 16 or 8 channels). Each mode is held against the
plain version first, then timed against the same function as plain torch
calls on cuBLAS (`torch_chain`, the library yardstick) in turns (library,
kernel, kernel, library; the L2 flushed before each turn), beside the card's
name and power limit.
"""

from __future__ import annotations

import statistics
import sys

import torch

from ..ops import probes
from ._fixtures import probe_inputs
from ._timing import card_line, require_cuda, turns_ms

TIMED_MODES = ("none", "combined", "combined_polysin", "split_polysin")
ROUNDS, LAUNCHES = 3, 5  # rounds of four turns, calls a turn


def torch_chain(x: torch.Tensor, enc: torch.Tensor, trunk_bf16, act: int) -> torch.Tensor:
    """`pe_probe` as plain torch calls on cuBLAS, 22 of them (21 with no
    activation): bf16(x) padded to 32 channels, times the mode's `enc`
    (`pack_probe_encoding`) into f32, the activation in place on columns
    27-374, the row in bf16 (375 columns and 9 zeros), eight bf16 products
    each followed by an in-place ReLU (`trunk_bf16`: the trunk's matrices in
    bf16, the first zero-padded to 384 rows), the f32 row sum. The polynomial
    sine is `probes.sin_turns`, about 15 elementwise passes over the (N, 348)
    f32 columns: no one library call computes it, so the polynomial modes'
    time is an upper bound."""
    xb = torch.nn.functional.pad(x.to(torch.bfloat16), (0, probes.ENC_K - probes.N_RAW))
    row = torch.mm(xb, enc, out_dtype=torch.float32)
    pe = row[:, probes.N_RAW:probes.N_RAW + probes.N_PE]
    if act == probes.ACTIVATIONS.index("sin"):
        pe.sin_()
    elif act == probes.ACTIVATIONS.index("polysin"):
        pe.copy_(probes.sin_turns(pe))
    h = row.to(torch.bfloat16)
    for w in trunk_bf16:
        h = torch.relu_(torch.mm(h, w))
    return h.sum(dim=1, keepdim=True, dtype=torch.float32)


def chain_operands(s, trunk, mode: str):
    """`torch_chain`'s operands for `mode`: its encoding matrix, the trunk in
    bf16 (the first matrix zero-padded to 384 rows), the activation."""
    first = torch.nn.functional.pad(trunk[0], (0, 0, 0, probes.K0 - trunk[0].shape[0]))
    return (probes.pack_probe_encoding(*s, mode),
            [w.to(torch.bfloat16) for w in [first] + list(trunk[1:])],
            probes.probe_activation(mode))


def main(argv) -> None:
    dev = require_cuda()
    n_rows = int(argv[0]) if argv else 7680 * 128
    card = card_line()
    x, s, trunk = probe_inputs(n_rows, dev)
    packed = probes.pack_probe_trunk(trunk)
    flop = 2 * n_rows * (375 * 256 + 7 * 256 * 256)
    base = None
    for mode in TIMED_MODES:
        ops = chain_operands(s, trunk, mode)
        want = probes.pe_probe_plain(x, *s, trunk, mode)
        scale = want.abs().max()
        err = ((probes.pe_probe(x, *s, trunk, mode, packed=packed) - want).abs().max()
               / scale).item()
        lib_err = ((torch_chain(x, *ops) - want).abs().max() / scale).item()
        del want
        turns = turns_ms({"kernel": lambda: probes.pe_probe(x, *s, trunk, mode, packed=packed),
                          "torch": lambda: torch_chain(x, *ops)},
                         ("torch", "kernel", "kernel", "torch"), ROUNDS, LAUNCHES)
        ms, lib = statistics.median(turns["kernel"]), statistics.median(turns["torch"])
        base = ms if base is None else base
        print(f"[{card}] {mode:17s}: {ms:8.3f} ms ({ms - base:+7.3f} ms over none; chain "
              f"{flop / ms / 1e9:6.1f} TFLOP/s; max rel err vs plain {err:.1e}); torch bf16 "
              f"chain {lib:8.3f} ms (max rel err vs plain {lib_err:.1e}); turns kernel "
              + " ".join(f"{t:.3f}" for t in turns["kernel"]) + ", torch "
              + " ".join(f"{t:.3f}" for t in turns["torch"]))


if __name__ == "__main__":
    main(sys.argv[1:])
