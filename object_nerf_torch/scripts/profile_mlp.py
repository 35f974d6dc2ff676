"""Compare the fused MLP kernels across checkouts: their time at the main
path's shapes, and the memory the backward takes.

    python -m object_nerf_torch.scripts.profile_mlp [--launches N] [--rows 1,2,3,4,5,6]
        [--step-peak]

For the classical-PE model and the voxel-conditioned one (16 + 8 voxel
channels, 6 octaves), on random weights and inputs from a seed, the median
device ms of one launch (CUDA events, each launch between its own pair) of
each kernel of PERF.md's table at the shapes of its rows:
1. `fused_coarse_weights` at 7680 rays x 64 samples (an eval chunk);
2. `fused_render_tiles` at 7680 x 128 (both branches);
3. `fused_mlp_eval` at 2048 x 64 and x 128 (the training step), and at the
   edit path's 4096 x 128 with one branch (the scene alone, the object
   alone, weights packed beforehand);
4. `fused_mlp_bwd` at 2048 x 64 and x 128 (one-sign cotangents of a
   mean-reduced loss's size), with the device memory one launch adds at its
   peak (`max_memory_allocated` over what was allocated before it);
5. `fused_sigma_eval` at 262,144 points, scene and object branch;
6. `pe_probe` at 983,040 rows (7680 rays x 128 samples) in the four modes
   that `profile_pe_micro.py` times, on the inputs it draws.
`--step-peak` adds the peak device memory of one training step (batch 2048,
64 + 64 samples, the synthetic scene's rays; the voxel model on the
ScanNet-scale room's grid of `_fixtures.py`). Rows 1-5 are also timed
against the same function as a chain of torch calls (`torch_coarse_weights`,
`torch_render_tiles`, `torch_mlp_eval`, `torch_mlp_bwd`, `torch_sigma_eval`:
per layer one bf16 `mm` on cuBLAS into f32, the bias and the activation; the
skip concatenation and the heads; the compositing in torch; for row 4
`torch.autograd` of that chain on the same cotangent), in turns (library,
kernel, kernel, library; the L2 flushed before each turn), as
`profile_pe_micro.py` times row 6. Prints the card's name and power limit,
one line per measurement, and one JSON line.

It calls only entry points that the port has had since its voxel model was
first trained, with the same arguments, so the same file, copied into an
older checkout of the package, times that checkout on the same card: compare
two versions on one card, in turns (old, new, new, old). That comparison is
what it is for; the kernels' numbers of record (checks, bounds, splits) are
`chip_smoke.py`'s.
"""

from __future__ import annotations

import argparse
import json
import statistics
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

from ..config import load_config
from ..data import dataset_dict
from ..data.ply_io import write_ply
from ..models.embedding import freq_encode
from ..models.mlp import LEAKY_SLOPE, ObjectNeRF, ObjectNeRFConfig, embed_inputs
from ..ops import probes
from ..ops.compositing import (
    alphas_from_sigmas, composite, composite_instance, compute_deltas, weights_from_alphas,
)
from ..ops.fused_mlp import fused_coarse_weights, fused_render_tiles
from ..ops.fused_mlp_vjp import fused_mlp_bwd, fused_mlp_eval
from ..ops.fused_sigma import fused_sigma_eval
from ..ops.fwd_chain import pack_kernel_weights
from ..train.system import ObjectNeRFSystem
from ._fixtures import SCENE, probe_inputs, scannet_scale_pcd
from ._timing import card_line, median_ms, require_cuda, turns_ms

BATCH = 2048
SAMPLES = (64, 128)
CHUNK = 7680  # rays of an eval chunk
EDIT_CHUNK = 4096  # rays of an edit chunk
SIGMA_POINTS = 4096 * 64
PROBE_ROWS = 7680 * 128
PROBE_MODES = ("none", "combined", "combined_polysin", "split_polysin")
SEED = 0
LIBRARY_ROUNDS, LIBRARY_LAUNCHES = 3, 5  # rounds of four turns, calls a turn
LIBRARY = ("torch bf16 chain: per layer bf16 mm on cuBLAS into f32, bias, activation; the "
           "skip concatenation and the heads (rows 1-2: and the compositing)")


# ---------------------------------------------------------------------------
# Rows 1-5 as chains of torch calls (the library yardstick)
# ---------------------------------------------------------------------------


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 a @ bf16 b, f32 sums, f32 result: one cuBLAS call on the card
    (`out_dtype`); on the CPU, which lacks that overload, the same product
    through f32 copies."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _ChainMM(torch.autograd.Function):
    """x @ w.T with both rounded to bf16 and f32 sums; the backward is two
    more bf16 products of the cotangent rounded to bf16, f32 out (the input
    gradient stays f32, as the kernel's does)."""

    @staticmethod
    def forward(ctx, x, w):
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        return _mm(xb, wb.t())

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        gb = g.to(torch.bfloat16)
        return _mm(gb, wb), _mm(gb.t(), xb)


def chain_layers(model: ObjectNeRF, grad: bool = False):
    """The two branches' layers for the torch chain: ({"scene" | "object":
    {"trunk": [(w, b)], "skips", "sigma", "final", "dir", "rgb"}}, leaves).
    Weights are cast to bf16 once; with `grad` every weight and bias is an
    f32 leaf that requires grad instead, and `leaves` maps the model's
    parameter names to them."""
    names = {id(m): n for n, m in model.named_modules()}
    leaves = {}

    def pair(lin):
        if not grad:
            return lin.weight.detach().to(torch.bfloat16), lin.bias.detach()
        w = lin.weight.detach().clone().requires_grad_()
        b = lin.bias.detach().clone().requires_grad_()
        leaves[names[id(lin)] + ".weight"], leaves[names[id(lin)] + ".bias"] = w, b
        return w, b

    layers = {}
    for branch in ("scene", "object"):
        p = model.branch_layers(branch)
        layers[branch] = {"trunk": [pair(lin) for lin in p["trunk"]], "skips": p["skips"],
                          **{k: pair(p[k]) for k in ("sigma", "final", "dir", "rgb")}}
    return layers, leaves


def _linear(h: torch.Tensor, wb) -> torch.Tensor:
    w, b = wb
    if w.requires_grad:
        return _ChainMM.apply(h, w) + b
    return _mm(h.to(torch.bfloat16), w.t()) + b


def _chain_branch(L, x, emb_dir, sigma_only: bool):
    h = x
    for i, wb in enumerate(L["trunk"]):
        if i in L["skips"]:
            h = torch.cat([x, h], dim=-1)
        h = F.leaky_relu(_linear(h, wb), LEAKY_SLOPE)
    sigma = _linear(h, L["sigma"])[:, 0]
    if sigma_only:
        return sigma, None
    h = _linear(h, L["final"])
    h = F.leaky_relu(_linear(torch.cat([h, emb_dir], dim=-1), L["dir"]), LEAKY_SLOPE)
    return sigma, torch.sigmoid(_linear(h, L["rgb"]))


def _object_input(emb, obj_voxel, codes, per_row: int):
    rows = codes.repeat_interleave(per_row, dim=0)
    return torch.cat([emb] + ([obj_voxel] if obj_voxel is not None else []) + [rows], dim=-1)


def _raw(voxel_raw):
    return None if voxel_raw is None else voxel_raw.float()


def torch_mlp_eval(L, cfg, xyz, dir_pe, codes, voxel_raw=None):
    """Row 3 (`fused_mlp_eval`, both branches) as torch calls: sigma (n, S),
    rgb (n, S, 3), inst_sigma, inst_rgb."""
    n, s, _ = xyz.shape
    emb, obj_voxel = embed_inputs(cfg, xyz.reshape(n * s, 3), _raw(voxel_raw))
    dirs = dir_pe.repeat_interleave(s, dim=0)
    sigma, rgb = _chain_branch(L["scene"], emb, dirs, False)
    i_sigma, i_rgb = _chain_branch(L["object"], _object_input(emb, obj_voxel, codes, s),
                                   dirs, False)
    return (sigma.reshape(n, s), rgb.reshape(n, s, 3), i_sigma.reshape(n, s),
            i_rgb.reshape(n, s, 3))


def torch_coarse_weights(L, cfg, xyz, z_vals, voxel_raw=None):
    """Row 1 (`fused_coarse_weights`) as torch calls: (n, S) pdf weights."""
    n, s, _ = xyz.shape
    emb, _ = embed_inputs(cfg, xyz.reshape(n * s, 3), _raw(voxel_raw))
    sigma, _ = _chain_branch(L["scene"], emb, None, True)
    return weights_from_alphas(alphas_from_sigmas(sigma.reshape(n, s),
                                                  compute_deltas(z_vals, True)))


def torch_render_tiles(L, cfg, xyz, z_vals, dir_pe, codes, voxel_raw=None):
    """Row 2 (`fused_render_tiles`, both branches) as torch calls: the same
    per-ray maps."""
    sigma, rgb, i_sigma, i_rgb = torch_mlp_eval(L, cfg, xyz, dir_pe, codes, voxel_raw)
    scene = composite(sigma, rgb, z_vals)
    inst = composite_instance(i_sigma, i_rgb, z_vals, scene.depth, apply_occlusion=False)
    return {"rgb": scene.rgb, "depth": scene.depth, "opacity": scene.opacity,
            "rgb_instance": inst.rgb, "depth_instance": inst.depth,
            "opacity_instance": inst.opacity}


def torch_sigma_eval(L, cfg, pts, codes, branch: str, per_row: int, voxel_raw=None):
    """Row 5 (`fused_sigma_eval`) as torch calls: (N,) raw density."""
    emb, obj_voxel = embed_inputs(cfg, pts, _raw(voxel_raw))
    if branch == "scene":
        return _chain_branch(L["scene"], emb, None, True)[0]
    return _chain_branch(L["object"], _object_input(emb, obj_voxel, codes, per_row),
                         None, True)[0]


def torch_mlp_bwd(L, leaves, cfg, xyz, dir_pe, codes, g, voxel_raw=None):
    """Row 4 (`fused_mlp_bwd`) as torch calls: `torch.autograd` of
    `torch_mlp_eval` on `chain_layers(model, grad=True)` for the cotangent g
    (n*S, 8). Returns ({parameter name: gradient}, d_codes, d_voxel_raw or
    None), as `fused_mlp_bwd` does."""
    n, s, _ = xyz.shape
    with torch.enable_grad():
        c = codes.detach().requires_grad_()
        raw = None if voxel_raw is None else voxel_raw.detach().float().requires_grad_()
        outs = torch_mlp_eval(L, cfg, xyz, dir_pe, c, raw)
        g4 = g.reshape(n, s, 8)
        inputs = list(leaves.values()) + [c] + ([raw] if raw is not None else [])
        got = torch.autograd.grad(outs, inputs,
                                  [g4[..., 0], g4[..., 1:4], g4[..., 4], g4[..., 5:8]])
    k = len(leaves)
    return dict(zip(leaves, got[:k])), got[k], (got[k + 1] if raw is not None else None)


def _inputs(cfg, n, s, dev, gen):
    z = torch.sort(0.5 + 4.0 * torch.rand(n, s, generator=gen), -1).values
    o, d = torch.randn(n, 3, generator=gen) * 0.3, torch.randn(n, 3, generator=gen)
    d = d / d.norm(dim=-1, keepdim=True)
    xyz = (o[:, None] + d[:, None] * z[..., None]).contiguous().to(dev)
    dir_pe = freq_encode(d, cfg.N_freq_dir).contiguous().to(dev)
    codes = (torch.randn(n, cfg.N_obj_code_length, generator=gen) * 0.1).to(dev)
    raw = None
    if cfg.use_voxel_embedding:
        n_vox = cfg.N_scn_voxel_size + cfg.N_obj_voxel_size
        raw = (torch.randn(n, s, n_vox, generator=gen) * 0.5).to(dev)
    g = (torch.randn(n * s, 8, generator=gen).abs() * 1e-4).to(dev)
    return xyz, dir_pe, codes, raw, g


def _peak_bytes(fn, dev) -> int:
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    fn()
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev) - base


def _step_peak(dev, voxel: bool) -> int:
    """Peak device memory of one training step (the whole allocation at its
    peak, the model and optimizer state included)."""
    root = Path(__file__).resolve().parents[2]
    args = [f"dataset_config={root / 'config' / 'synthetic.yml'}", f"train.batch_size={BATCH}",
            "model.N_samples=64", "model.N_importance=64", "model.perturb=1",
            "model.noise_std=1", "train.optimizer=adam", "train.lr_scheduler=poly",
            f"train.seed={SEED}", "train.num_epochs=5", "train.nan_check_every=1000000"]
    with tempfile.TemporaryDirectory() as tmp:
        if voxel:
            pcd = str(Path(tmp) / "room.ply")
            write_ply(pcd, scannet_scale_pcd())
            args += ["img_wh=[64,48]", "model.use_voxel_embedding=true",
                     "model.N_max_voxels=800000", f"dataset_extra.pcd_path={pcd}",
                     f"dataset_extra.scale_factor={SCENE['scale_factor']}",
                     "dataset_extra.scene_center=["
                     + ",".join(map(str, SCENE["scene_center"])) + "]",
                     f"dataset_extra.voxel_size={SCENE['voxel_size_world']}",
                     f"dataset_extra.neighbor_marks={SCENE['neighbor_marks']}",
                     "dataset_extra.near=0.05", "dataset_extra.far=2.4"]
        else:
            args += ["model.use_voxel_embedding=false"]
        config = load_config(cli_args=args)
        kw = dict(img_wh=tuple(config.img_wh), dataset_extra=config.dataset_extra)
        system = ObjectNeRFSystem(config, dataset=dataset_dict["synthetic"]("train", **kw),
                                  device=dev)
    system.training_step(system.train_dataset.sample_batch(BATCH, system.batch_rng))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    system.training_step(system.train_dataset.sample_batch(BATCH, system.batch_rng))
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev)


def _time(out, key, fn, launches, card):
    fn()  # builds the kernels on the first call
    with torch.no_grad():
        out["ms"][key] = median_ms(fn, launches)
    print(f"{key}: {out['ms'][key]:.3f} ms/launch (median of {launches}); {card}")


def library_turns(kernel, chain):
    """(kernel ms, chain ms, turns): medians of `turns_ms` in turns of
    library, kernel, kernel, library."""
    turns = turns_ms({"kernel": kernel, "torch": chain}, ("torch", "kernel", "kernel", "torch"),
                     LIBRARY_ROUNDS, LIBRARY_LAUNCHES)
    return statistics.median(turns["kernel"]), statistics.median(turns["torch"]), turns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--launches", type=int, default=10)
    ap.add_argument("--rows", default="1,2,3,4,5,6", help="rows of PERF.md's table to time")
    ap.add_argument("--step-peak", action="store_true")
    args = ap.parse_args(argv)
    rows = {int(r) for r in args.rows.split(",")}
    dev = require_cuda()
    card = card_line()
    print(card)
    out = {"card": card, "ms": {}, "launch_peak_bytes": {},
           "library": {"chain": LIBRARY, "ms_in_turns": {}, "library_ms": {}}}

    def vs_library(key, kernel, chain):
        ms, lib, turns = library_turns(kernel, chain)
        out["library"]["ms_in_turns"][key], out["library"]["library_ms"][key] = ms, lib
        print(f"{key}: in turns kernel {ms:.3f} ms, torch chain {lib:.3f} ms (turns kernel "
              + " ".join(f"{t:.3f}" for t in turns["kernel"]) + ", torch "
              + " ".join(f"{t:.3f}" for t in turns["torch"]) + f"); {card}")

    gen = torch.Generator().manual_seed(SEED)
    for voxel in (False, True):
        cfg = ObjectNeRFConfig(use_voxel_embedding=voxel)
        model = ObjectNeRF(cfg).reset_parameters_(gen).to(dev)
        name = "voxel" if voxel else "classical"
        packed = pack_kernel_weights(model, cfg, True)
        coarse = pack_kernel_weights(model, cfg, False, sigma_only=True)
        layers = chain_layers(model)[0]
        with torch.no_grad():
            if 1 in rows or 2 in rows:
                for s in (64, 128):
                    xyz, dir_pe, codes, raw, _ = _inputs(cfg, CHUNK, s, dev, gen)
                    z = (xyz - xyz[:, :1]).norm(dim=-1).contiguous()
                    if s == 64 and 1 in rows:
                        key = f"fused_coarse_weights {name} {CHUNK}x{s}"
                        run = lambda: fused_coarse_weights(model, cfg, xyz, z, voxel_raw=raw,
                                                           packed=coarse)
                        _time(out, key, run, args.launches, card)
                        vs_library(key, run,
                                   lambda: torch_coarse_weights(layers, cfg, xyz, z, raw))
                    if s == 128 and 2 in rows:
                        key = f"fused_render_tiles {name} {CHUNK}x{s}"
                        run = lambda: fused_render_tiles(model, cfg, xyz, z, dir_pe, codes, raw,
                                                         packed=packed)
                        _time(out, key, run, args.launches, card)
                        vs_library(key, run, lambda: torch_render_tiles(
                            layers, cfg, xyz, z, dir_pe, codes, raw))
                    del xyz, dir_pe, codes, raw, z
            if 3 in rows:
                for n, s, flags in ((BATCH, 64, (True, True)), (BATCH, 128, (True, True)),
                                    (EDIT_CHUNK, 128, (False, True)),
                                    (EDIT_CHUNK, 128, (True, False))):
                    xyz, dir_pe, codes, raw, _ = _inputs(cfg, n, s, dev, gen)
                    what = {(True, True): "", (False, True): " scene only",
                            (True, False): " object only"}[flags]
                    key = f"fused_mlp_eval {name} {n}x{s}{what}"
                    run = lambda: fused_mlp_eval(model, cfg, xyz, dir_pe, codes, raw, *flags,
                                                 packed=packed)
                    _time(out, key, run, args.launches, card)
                    if not what:  # the chain computes both branches
                        vs_library(key, run, lambda: torch_mlp_eval(layers, cfg, xyz, dir_pe,
                                                                    codes, raw))
                    del xyz, dir_pe, codes, raw
            if 5 in rows:
                n_rows = SIGMA_POINTS // 64
                xyz, _, codes, raw, _ = _inputs(cfg, n_rows, 64, dev, gen)
                pts = xyz.reshape(-1, 3)
                raw = None if raw is None else raw.reshape(SIGMA_POINTS, -1)
                sig = pack_kernel_weights(model, cfg, True, sigma_only=True)
                for branch in ("scene", "instance"):
                    key = f"fused_sigma_eval {name} {SIGMA_POINTS} points {branch}"
                    run = lambda: fused_sigma_eval(model, cfg, pts, codes, branch, 64,
                                                   voxel_raw=raw, packed=sig)
                    _time(out, key, run, args.launches, card)
                    vs_library(key, run, lambda: torch_sigma_eval(layers, cfg, pts, codes,
                                                                  branch, 64, raw))
                del xyz, codes, raw, pts, sig
        if 4 in rows:
            for s in SAMPLES:
                xyz, dir_pe, codes, raw, g = _inputs(cfg, BATCH, s, dev, gen)

                def run():
                    fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, g, packed=packed,
                                  voxel_raw=raw)

                run()
                key = f"fused_mlp_bwd {name} {BATCH}x{s}"
                out["launch_peak_bytes"][key] = _peak_bytes(run, dev)
                _time(out, key, run, args.launches, card)
                layers_g, leaves = chain_layers(model, grad=True)
                vs_library(key, run, lambda: torch_mlp_bwd(layers_g, leaves, cfg, xyz, dir_pe,
                                                           codes, g, raw))
                del layers_g, leaves
                print(f"{key}: one launch adds {out['launch_peak_bytes'][key] / 1e9:.3f} GB at "
                      f"its peak; {card}")
                del xyz, dir_pe, codes, raw, g
        del model, packed, coarse, layers
    if 6 in rows:
        x, s, trunk = probe_inputs(PROBE_ROWS, dev)
        ptrunk = probes.pack_probe_trunk(trunk)
        for mode in PROBE_MODES:
            _time(out, f"pe_probe {mode} {PROBE_ROWS} rows",
                  lambda: probes.pe_probe(x, *s, trunk, mode, packed=ptrunk), args.launches, card)
        del x, s, trunk, ptrunk
    if args.step_peak:
        out["step_peak_bytes"] = {}
        for voxel in (False, True):
            torch.cuda.empty_cache()
            key = "voxel" if voxel else "classical"
            out["step_peak_bytes"][key] = _step_peak(dev, voxel)
            print(f"{key} training step ({BATCH} rays, 64 + 64): peak device memory "
                  f"{out['step_peak_bytes'][key] / 1e9:.3f} GB; {card}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
