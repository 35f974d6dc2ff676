"""Where one tile's time goes in the backward's tile sweep (`mlp_bwd_kernel` in
`ops/csrc/fused_mlp_train.cu`), on the card.

    python -m object_nerf_torch.scripts.profile_bwd_sweep [--tiles 3] [--split-only]

The shipped kernel carries no instrumentation. This script copies the package
into `object_nerf_torch/_build/bwd_sweep_timeline/` (the build directory, which
git does not keep), adds `%globaltimer` stamps to the copy's sweep for block 0
only, builds the copy, and runs `fused_mlp_bwd` in a child process per model
(classical, voxel) and samples per ray (64, 128) at the training step's
shapes (2048 rays, both branches, one-sign cotangents of a mean-reduced
loss's size), on random weights and inputs from a seed. One thread of block 0
(the first thread of consumer warpgroup 0) stamps the end of each phase of
its tile: waits on the weight ring, products (with the epilogue stores from
registers that run between them), epilogues, stagings of the voxel tile, the
d_vox reduction, the small heads, the input build, the cross-warpgroup
barrier and the outputs; the producer lanes stamp the issue of each chunk.
Per tile it prints the period, the time of each phase, the chunks and how far
ahead of the consumer's wait their copies were issued.

Then (and alone, with `--split-only`, which needs no stamps and so runs on
any checkout of the package) the device ms of one launch of each of the
backward's three kernels from `torch.profiler` over 10 launches of the
shipped library, at the same shapes. The stamps cost a few global stores per
phase, so the tile times here run a little longer than the kernel's own.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
TREE = PKG / "_build" / "bwd_sweep_timeline"
BATCH = 2048
SAMPLES = (64, 128)
KINDS = ("tile", "ring wait", "product", "lockstep", "epilogue", "store", "load", "d_vox",
         "small heads", "input build", "issue", "outputs", "column sums", "head sums",
         "head loop", "head barrier", "head gwd", "code sums", "fwd epilogue", "rgb head",
         "D write")
K = {name: i for i, name in enumerate(KINDS)}
N_STAMPS, N_ISSUES = 1 << 16, 1 << 14
# the thread that stamps its phases (the first of consumer warpgroup 0), and
# the declarations the stamps use (in fused_mlp_wg.cuh's unnamed namespace,
# so that each source that includes it keeps its own)
STAMP_THREAD = 128
_DECL = (
    "__device__ unsigned long long g_tt[%d];\n__device__ int g_tk[%d];\n"
    "__device__ unsigned long long g_ti[%d];\n__device__ int g_tn;\n__shared__ int s_tn;\n"
    "__device__ __forceinline__ unsigned long long gtime() {\n"
    "  unsigned long long t; asm volatile(\"mov.u64 %%0, %%globaltimer;\" : \"=l\"(t)); return t; }\n"
    "__device__ __forceinline__ void stamp(int k) {\n"
    "  if (blockIdx.x == 0 && threadIdx.x == %d) {\n"
    "    const int n = s_tn;\n"
    "    if (n < %d) { g_tt[n] = gtime(); g_tk[n] = k; s_tn = n + 1; g_tn = n + 1; } } }\n"
) % (N_STAMPS, N_STAMPS, N_ISSUES, STAMP_THREAD, N_STAMPS)


def _s(kind: str) -> str:
    return f"stamp({K[kind]});"


# (file in ops/csrc, text, the text with the copy's stamps): each text is
# there once. The stamping thread marks the end of each phase: its wait for a
# chunk of the ring (the time before it is the products issued since the
# last stamp), the end of each product, epilogue, staging, d_vox reduction,
# the small heads, the input build and the tile's outputs; the producer
# lanes mark when they issue each chunk (by its number in the block's order).
_STAMPS = [
    ("fused_mlp_wg.cuh", "constexpr int FWD_THREADS = 384;",
     "constexpr int FWD_THREADS = 384;\n" + _DECL),
    ("fused_mlp_wg.cuh", "    mbar_wait(full + 8 * stage, phase);\n",
     f"    {_s('product')}\n    mbar_wait(full + 8 * stage, phase);\n    {_s('ring wait')}\n"),
    ("fused_mlp_wg.cuh", "  wgmma_wait<0>();\n  p.release(prev);\n  fence_acc(acc);\n}\n",
     f"  wgmma_wait<0>();\n  p.release(prev);\n  fence_acc(acc);\n  {_s('product')}\n}}\n"),
    ("fused_mlp_wg.cuh", "  fence_acc(acc);\n  fence_frag(h);\n}\n",
     f"  fence_acc(acc);\n  fence_frag(h);\n  {_s('product')}\n}}\n"),
    ("fused_mlp_train.cu", "  wgmma_wait<0>();\n  p.release(prev);\n  fence_acc(acc);\n}\n",
     f"  wgmma_wait<0>();\n  p.release(prev);\n  fence_acc(acc);\n  {_s('product')}\n}}\n"),
    ("fused_mlp_train.cu", "      mbar_expect_tx(bar, FWD_STAGE);\n",
     "      mbar_expect_tx(bar, FWD_STAGE);\n"
     f"      if (blockIdx.x == 0 && gj < {N_ISSUES}) g_ti[gj] = gtime();\n"),
    ("fused_mlp_train.cu", "        h[2 * g + u] = pack_bf16(v0, v1);\n      }\n    }\n",
     f"        h[2 * g + u] = pack_bf16(v0, v1);\n      }}\n    }}\n    {_s('fwd epilogue')}\n"),
    ("fused_mlp_train.cu", "    warp_rows_store(w, w.gg, ld, fin ? o.fin : o.act + i * N, N);\n",
     "    warp_rows_store(w, w.gg, ld, fin ? o.fin : o.act + i * N, N);\n"
     f"    {_s('store')}\n"),
    ("fused_mlp_train.cu", "    store_pairs(w.gs, 2 * g2, d);\n  }\n",
     f"    store_pairs(w.gs, 2 * g2, d);\n  }}\n  {_s('epilogue')}\n"),
    ("fused_mlp_train.cu", "  warp_rows_store(w, w.gg, ld, col, N);\n",
     f"  warp_rows_store(w, w.gg, ld, col, N);\n  {_s('store')}\n"),
    ("fused_mlp_train.cu",
     "    dbias[k] = prior[q] + (w.col[k] + w.col[N + k] + w.col[2 * N + k] + w.col[3 * N + k]);\n"
     "  }\n}\n",
     "    dbias[k] = prior[q] + (w.col[k] + w.col[N + k] + w.col[2 * N + k] + w.col[3 * N + k]);\n"
     f"  }}\n  {_s('column sums')}\n}}\n"),
    ("fused_mlp_train.cu",
     "  wg_bar(w.bar);  // the rgb head's d_pre and the direction activation are in\n",
     "  wg_bar(w.bar);  // the rgb head's d_pre and the direction activation are in\n"
     f"  {_s('rgb head')}\n"),
    ("fused_mlp_train.cu", "    // per column k of the direction layer, one pass over the rows: the rgb\n",
     f"    {_s('head sums')}\n    // per column k of the direction layer, one pass over the rows: the rgb\n"),
    ("fused_mlp_train.cu", "      *pb = (first ? 0.f : *pb) + colsum;\n    }\n  }\n",
     f"      *pb = (first ? 0.f : *pb) + colsum;\n    }}\n  }}\n  {_s('head loop')}\n"),
    ("fused_mlp_train.cu", "  wg_bar(w.bar);\n  if (w.t == 0) {\n    float* pb = gp + gt.v[T_SIGB];",
     f"  wg_bar(w.bar);\n  {_s('head barrier')}\n"
     "  if (w.t == 0) {\n    float* pb = gp + gt.v[T_SIGB];"),
    ("fused_mlp_train.cu", "  tile_store(w, w.gg, ld, o.gdir, ND);\n",
     f"  {_s('head gwd')}\n  tile_store(w, w.gg, ld, o.gdir, ND);\n"),
    ("fused_mlp_train.cu", "  if (branch == 1) {  // per 16-row group, as the classical sweep's code sums\n",
     f"  {_s('d_vox')}\n  if (branch == 1) {{  // per 16-row group, as the classical sweep's code sums\n"),
    ("fused_mlp_train.cu", "    wg_bar(w.bar);  // D is read\n",
     f"    {_s('code sums')}\n    wg_bar(w.bar);  // D is read\n"),
    ("fused_mlp_train.cu", "  // ---- `final` and the sigma head",
     f"  {_s('small heads')}\n  // ---- `final` and the sigma head"),
    ("fused_mlp_train.cu", "  sum_colsum<N>(w, gp + gt.v[T_SIGW], first);\n",
     f"  sum_colsum<N>(w, gp + gt.v[T_SIGW], first);\n  {_s('small heads')}\n"),
    ("fused_mlp_train.cu", "    wg_bar(w.bar);\n    reduce_input_grad(",
     f"    wg_bar(w.bar);\n    {_s('D write')}\n    reduce_input_grad("),
    ("fused_mlp_train.cu", "        first_code = false;\n      }\n      if (i == 0) break;",
     f"        first_code = false;\n        {_s('epilogue')}\n      }}\n      if (i == 0) break;"),
    ("fused_mlp_train.cu", "  fence_proxy_async();  // X is complete for the products' reads\n"
     "  wg_bar(w.bar);\n}\n",
     "  fence_proxy_async();  // X is complete for the products' reads\n"
     f"  wg_bar(w.bar);\n  {_s('load')}\n}}\n"),
    ("fused_mlp_train.cu",
     "    wg_bar(wk.bar);  // the warpgroup's previous tile is done with its buffers\n",
     "    wg_bar(wk.bar);  // the warpgroup's previous tile is done with its buffers\n"
     f"    {_s('tile')}\n"),
    ("fused_mlp_train.cu", "    branch_backward<WS, VOX, C>(0,",
     f"    {_s('input build')}\n    branch_backward<WS, VOX, C>(0,"),
    ("fused_mlp_train.cu", '      asm volatile("bar.sync 3, 256;" ::: "memory");\n',
     '      asm volatile("bar.sync 3, 256;" ::: "memory");\n'
     f"      {_s('lockstep')}\n"),
    ("fused_mlp_train.cu",
     "        if (r < wk.real) d_vox[(wk.g0 + r) * cv + ch] = wk.dv[r * MAX_VOX + ch];\n"
     "      }\n    }\n",
     "        if (r < wk.real) d_vox[(wk.g0 + r) * cv + ch] = wk.dv[r * MAX_VOX + ch];\n"
     f"      }}\n    }}\n    {_s('outputs')}\n"),
    ("fused_mlp_train.cu", "    for (int s = 0; s < C::STAGES; ++s) {\n      mbar_init(full + 8 * s, 1);",
     "    s_tn = 0;\n"
     "    for (int s = 0; s < C::STAGES; ++s) {\n      mbar_init(full + 8 * s, 1);"),
]
_READER = ('\nextern "C" int onerf_trace_bwd(void* tt, void* tk, void* ti, void* n) {\n'
           "  int e = (int)cudaMemcpyFromSymbol(tt, g_tt, sizeof(g_tt));\n"
           "  if (!e) e = (int)cudaMemcpyFromSymbol(tk, g_tk, sizeof(g_tk));\n"
           "  if (!e) e = (int)cudaMemcpyFromSymbol(ti, g_ti, sizeof(g_ti));\n"
           "  if (!e) e = (int)cudaMemcpyFromSymbol(n, g_tn, sizeof(int));\n"
           "  return e;\n}\n")


def _make_tree() -> None:
    if TREE.exists():
        shutil.rmtree(TREE)
    shutil.copytree(PKG, TREE / PKG.name, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = TREE / PKG.name / "ops" / "csrc"
    for name, old, new in _STAMPS:
        path = csrc / name
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not there once: update the stamps")
        path.write_text(text.replace(old, new))
    path = csrc / "fused_mlp_train.cu"
    path.write_text(path.read_text() + _READER)
    build = TREE / PKG.name / "ops" / "_build.py"
    text = build.read_text()
    anchor = '    "onerf_scale_copy": [_P, _P, _L, _P],'
    build.write_text(text.replace(anchor, anchor + '\n    "onerf_trace_bwd": [_P, _P, _P, _P],'))


def _setup(voxel: bool, s: int):
    import torch

    from object_nerf_torch.models.embedding import freq_encode
    from object_nerf_torch.models.mlp import ObjectNeRF, ObjectNeRFConfig
    from object_nerf_torch.ops import fused_mlp_vjp as fv
    from object_nerf_torch.ops.fwd_chain import pack_kernel_weights

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    cfg = ObjectNeRFConfig(use_voxel_embedding=voxel)
    model = ObjectNeRF(cfg).reset_parameters_(gen).to(dev)
    n = BATCH
    z = torch.sort(0.5 + 4.0 * torch.rand(n, s, generator=gen), -1).values
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=-1)
    xyz = (d[:, None] * z[..., None]).contiguous().to(dev)
    dir_pe = freq_encode(d, cfg.N_freq_dir).contiguous().to(dev)
    codes = torch.randn(n, cfg.N_obj_code_length, generator=gen).to(dev)
    raw = None
    if voxel:
        n_vox = cfg.N_scn_voxel_size + cfg.N_obj_voxel_size
        raw = (torch.randn(n, s, n_vox, generator=gen) * 0.5).to(dev)
    g = (torch.randn(n * s, 8, generator=gen).abs() * 1e-4).to(dev)
    packed = pack_kernel_weights(model, cfg, True)

    def run():
        with torch.no_grad():
            fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, g, packed=packed, voxel_raw=raw)
    return run


def _child(voxel: bool, s: int, tiles: int) -> None:
    """Run inside the copy: launch, read the stamps, print the timeline."""
    import numpy as np
    import torch

    from object_nerf_torch.ops import _build

    run = _setup(voxel, s)
    lib = _build.load_library()
    for _ in range(3):  # the stamps of the last launch remain
        run()
    torch.cuda.synchronize()
    tt = np.zeros(N_STAMPS, dtype=np.uint64)
    tk = np.zeros(N_STAMPS, dtype=np.int32)
    ti = np.zeros(N_ISSUES, dtype=np.uint64)
    n = np.zeros(1, dtype=np.int32)
    if lib.onerf_trace_bwd(tt.ctypes.data, tk.ctypes.data, ti.ctypes.data, n.ctypes.data):
        raise SystemExit("reading the stamps failed")
    tt, tk, ti = tt[:n[0]].astype(np.int64), tk[:n[0]], ti.astype(np.int64)
    starts = [i for i in range(len(tk)) if tk[i] == K["tile"]]
    name = f"{'voxel' if voxel else 'classical'} x {s}"
    chunk0 = 0
    for k in range(min(tiles, len(starts))):
        lo = starts[k]
        hi = starts[k + 1] if k + 1 < len(starts) else len(tk)
        by = {kind: 0.0 for kind in KINDS}
        for i in range(lo + 1, hi):
            by[KINDS[tk[i]]] += (tt[i] - tt[i - 1]) / 1e3
        period = (tt[hi] - tt[lo]) / 1e3 if hi < len(tk) else (tt[hi - 1] - tt[lo]) / 1e3
        # the j-th chunk of the tile: the thread began to wait for it at the
        # stamp before its j-th "ring wait" stamp
        waits = [i for i in range(lo + 1, hi) if tk[i] == K["ring wait"]]
        nc = len(waits)
        issued = ti[chunk0:chunk0 + nc]
        leads = [tt[i - 1] - x for i, x in zip(waits, issued) if x > 0]
        lead = float(np.mean(leads)) / 1e3 if leads else float("nan")
        chunk0 += nc
        parts = "; ".join(f"{kind} {v:.2f}" for kind, v in by.items() if v > 0)
        print(f"{name} tile {k}: period {period:.2f} us; {parts} us; {nc} chunks, a chunk "
              f"issued {lead:.2f} us before the stamping thread waited for it, on average")


def _split(voxel: bool, s: int) -> None:
    """Device ms of one launch of each of the backward's three kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    run = _setup(voxel, s)
    run()
    torch.cuda.synchronize()
    n = 10
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    split = {"mlp_bwd_kernel": 0.0, "wgrad_kernel": 0.0, "reduce_segments_kernel": 0.0}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for piece in split:
                if piece in e.key:
                    split[piece] += e.self_device_time_total / 1e3 / n
    print(f"{'voxel' if voxel else 'classical'} x {s}: " +
          ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiles", type=int, default=3)
    ap.add_argument("--split-only", action="store_true")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        model, s = args.child.split(":")
        _child(model == "voxel", int(s), args.tiles)
        return 0
    from ._timing import card_line, require_cuda

    require_cuda()
    card = card_line()
    print(card)
    if not args.split_only:
        _make_tree()
        for model in ("classical", "voxel"):
            for s in SAMPLES:
                proc = subprocess.run(
                    [sys.executable, "-m", f"{PKG.name}.scripts.profile_bwd_sweep", "--child",
                     f"{model}:{s}", "--tiles", str(args.tiles)], cwd=TREE, capture_output=True,
                    text=True, timeout=900)
                print(proc.stdout.rstrip(), flush=True)
                if proc.returncode != 0:
                    print(proc.stderr[-4000:], file=sys.stderr)
                    return proc.returncode
    for model in ("classical", "voxel"):
        for s in SAMPLES:
            _split(model == "voxel", s)
    print(f"(block 0 of each launch; {card})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
