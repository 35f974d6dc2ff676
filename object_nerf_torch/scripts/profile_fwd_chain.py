"""Where one tile's time goes in the forward chain of `fused_mlp_eval` and
`fused_render_tiles` (`ops/csrc/fused_mlp_wg.cuh`), on the card.

    python -m object_nerf_torch.scripts.profile_fwd_chain [--tiles 3]

The shipped kernels carry no instrumentation. This script copies the package
into `object_nerf_torch/_build/fwd_chain_timeline/` (the build directory, which
git does not keep), adds `%globaltimer` stamps to the copy's chain for block 0
only (when a producer lane issues each weight chunk; when each consumer
warpgroup wants each chunk and when it is ready; when each trunk layer's
epilogue ends; the phases of each tile's input build), builds the copy, and
launches its `fused_mlp_eval` at 2048 rays x 128 samples, classical and voxel
(random weights and inputs from a seed), in a child process. Per tile it
prints the input build's phases, the products' and the epilogues' shares,
the consumers' waits on the ring's `full` barriers and how early the producer
issued the chunks. The stamps cost a few global stores per chunk, so the
tile times here run a little longer than the kernels' own (`profile_mlp.py`).
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
TREE = PKG / "_build" / "fwd_chain_timeline"
BATCH, SAMPLES = 2048, 128
TRACE = 16384  # stamps: issue [0, 4096), want / ready of warpgroup 0 and 1, epilogues, builds
W0, R0, E0, B0 = 4096, 8192, 12288, 15000

# (file in ops/csrc, anchor, text that follows it) for the copy's stamps
_STAMPS = [
    ("fused_mlp_wg.cuh", "constexpr int FWD_THREADS = 384;",
     "\n__device__ unsigned long long g_trace[16384];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t; asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t)); return t; }"),
    ("fused_mlp_wg.cuh", "  int stage, phase;", " int count = 0;"),
    ("fused_mlp_wg.cuh", "  __device__ __forceinline__ uint32_t next() {",
     "\n    const bool tr = blockIdx.x == 0 && (threadIdx.x == 128 || threadIdx.x == 256) &&"
     " count < 2048;\n    const int o = threadIdx.x == 256 ? 2048 : 0;\n"
     "    if (tr) g_trace[4096 + o + count] = gtime();"),
    ("fused_mlp_wg.cuh", "    mbar_wait(full + 8 * stage, phase);",
     "\n    if (tr) g_trace[8192 + o + count] = gtime();"),
    ("fused_mlp_wg.cuh", "  __device__ __forceinline__ void advance() {", "\n    ++count;"),
    ("fused_mlp_wg.cuh", "          mbar_wait(empty + 8 * stage, phase ^ 1);  // a fresh stage passes",
     "\n          if (blockIdx.x == 0 && gj < 4096) g_trace[gj] = gtime();"),
    ("fused_mlp_wg.cuh", "    fence_proxy_async();  // H is complete for the next product's reads\n"
     "    wg_bar(bar);",
     "\n    if (blockIdx.x == 0 && threadIdx.x == 128 && p.count < 2048)"
     " g_trace[12288 + p.count] = gtime();"),
    ("fused_mlp_wg.cuh", "                                          float* zrow, float* db, int bar) {",
     "\n  const bool trb = blockIdx.x == 0 && threadIdx.x == 128;\n"
     "  const int tbi = 15000 + 4 * (int)(g0 / 128 / gridDim.x);\n"
     "  if (trb && tbi < 16380) g_trace[tbi] = gtime();"),
    ("fused_mlp_wg.cuh", "  if (zrow != nullptr) stage_copy<1>(zrow, a.z + g0, 64, valid);\n  wg_bar(bar);",
     "\n  if (trb && tbi < 16380) g_trace[tbi + 1] = gtime();"),
    ("fused_mlp_wg.cuh", "  if (inst) fwd_dir_bias<WO / 2>(obj, a.w, a.b, dirs, nr, db + 2 * (WS / 2));",
     "\n  if (trb && tbi < 16380) g_trace[tbi + 2] = gtime();"),
    ("fused_mlp_wg.cuh", "  fence_proxy_async();  // X is complete for the products' reads\n  wg_bar(bar);",
     "\n  if (trb && tbi < 16380) g_trace[tbi + 3] = gtime();"),
    ("fused_mlp_train.cu", 'extern "C" {',
     "\nint onerf_trace(void* out) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));\n}\n"),
]


def _make_tree() -> None:
    if TREE.exists():
        shutil.rmtree(TREE)
    shutil.copytree(PKG, TREE / PKG.name, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = TREE / PKG.name / "ops" / "csrc"
    for name, anchor, add in _STAMPS:
        path = csrc / name
        text = path.read_text()
        if text.count(anchor) != 1:
            raise SystemExit(f"{name}: the anchor {anchor!r} is not there once: update the stamps")
        path.write_text(text.replace(anchor, anchor + add))
    build = TREE / PKG.name / "ops" / "_build.py"
    text = build.read_text()
    anchor = '    "onerf_scale_copy": [_P, _P, _L, _P],'
    build.write_text(text.replace(anchor, anchor + '\n    "onerf_trace": [_P],'))


def _us(t, t0) -> float:
    return (int(t) - t0) / 1e3


def _child(voxel: bool, tiles: int) -> None:
    """Run inside the copy: launch, read the stamps, print the timeline."""
    import numpy as np
    import torch

    from object_nerf_torch.models.embedding import freq_encode
    from object_nerf_torch.models.mlp import ObjectNeRF, ObjectNeRFConfig
    from object_nerf_torch.ops import _build, fused_mlp_vjp as fv
    from object_nerf_torch.ops.fused_mlp import pack_kernel_weights

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    cfg = ObjectNeRFConfig(use_voxel_embedding=voxel)
    model = ObjectNeRF(cfg).reset_parameters_(gen).to(dev)
    packed = pack_kernel_weights(model, cfg, True)
    z = torch.sort(0.5 + 4.0 * torch.rand(BATCH, SAMPLES, generator=gen), -1).values
    d = torch.nn.functional.normalize(torch.randn(BATCH, 3, generator=gen), dim=-1)
    xyz = (d[:, None] * z[..., None]).contiguous().to(dev)
    dir_pe = freq_encode(d, cfg.N_freq_dir).contiguous().to(dev)
    codes = torch.randn(BATCH, cfg.N_obj_code_length, generator=gen).to(dev)
    raw = None
    if voxel:
        n_vox = cfg.N_scn_voxel_size + cfg.N_obj_voxel_size
        raw = (torch.randn(BATCH, SAMPLES, n_vox, generator=gen) * 0.5).to(dev)
    lib = _build.load_library()
    with torch.no_grad():
        for _ in range(3):  # the stamps of the last launch remain
            fv._launch_eval(cfg, xyz, dir_pe, codes, packed, True, True, raw)
    torch.cuda.synchronize()
    st = np.zeros(TRACE, dtype=np.uint64)
    if lib.onerf_trace(st.ctypes.data) != 0:
        raise SystemExit("reading the stamps failed")
    nc = len(fv.forward_chunks(packed, True, True))
    t0 = int(st[B0])
    name = "voxel" if voxel else "classical"
    for k in range(tiles):
        b = [_us(x, t0) for x in st[B0 + 4 * k:B0 + 4 * k + 4]]
        nxt = _us(st[B0 + 4 * (k + 1)], t0) if k + 1 < tiles else float("nan")
        js = range(k * nc, (k + 1) * nc)
        issue = [_us(st[j], t0) for j in js]
        want = [[_us(st[W0 + o + j], t0) for j in js] for o in (0, 2048)]
        ready = [[_us(st[R0 + o + j], t0) for j in js] for o in (0, 2048)]
        ends = [(j - k * nc, _us(st[E0 + j + 1], t0)) for j in js if st[E0 + j + 1]]
        epi = sum(e - ready[0][jl] for jl, e in ends)
        waits = [sum(max(0.0, r - w) for r, w in zip(ready[g], want[g])) for g in (0, 1)]
        lead = sum(w - i for w, i in zip(want[0], issue)) / nc
        print(f"{name} tile {k}: period {nxt - b[0]:.2f} us; input build {b[3] - b[0]:.2f} us "
              f"(staging {b[1] - b[0]:.2f}, direction biases {b[2] - b[1]:.2f}, encoding "
              f"{b[3] - b[2]:.2f}); products and epilogues {ready[0][-1] - want[0][0]:.2f} us, "
              f"of which the {len(ends)} trunk epilogues (last chunk ready to layer done) "
              f"{epi:.2f} us; waits on full: warpgroup 0 {waits[0]:.2f} us, warpgroup 1 "
              f"{waits[1]:.2f} us over {nc} chunks; a chunk issued {lead:.2f} us before "
              f"warpgroup 0 wanted it, on average")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiles", type=int, default=3)
    ap.add_argument("--child", choices=("classical", "voxel"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _child(args.child == "voxel", args.tiles)
        return 0
    from ._timing import card_line, require_cuda

    require_cuda()
    card = card_line()
    print(card)
    _make_tree()
    for model in ("classical", "voxel"):
        proc = subprocess.run([sys.executable, "-m", f"{PKG.name}.scripts.profile_fwd_chain",
                               "--child", model, "--tiles", str(args.tiles)], cwd=TREE,
                              capture_output=True, text=True, timeout=900)
        print(proc.stdout.rstrip(), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
    print(f"(block 0 of fused_mlp_eval at {BATCH} x {SAMPLES}; {card})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
