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
ScanNet-scale room's grid of `_fixtures.py`). Prints the card's name and
power limit, one line per measurement, and one JSON line.

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
import tempfile
from pathlib import Path

import torch

from ..config import load_config
from ..data import dataset_dict
from ..data.ply_io import write_ply
from ..models.embedding import freq_encode
from ..models.mlp import ObjectNeRF, ObjectNeRFConfig
from ..ops import probes
from ..ops.fused_mlp import fused_coarse_weights, fused_render_tiles, pack_kernel_weights
from ..ops.fused_mlp_vjp import fused_mlp_bwd, fused_mlp_eval
from ..ops.fused_sigma import fused_sigma_eval
from ..train.system import ObjectNeRFSystem
from ._fixtures import SCENE, probe_inputs, scannet_scale_pcd
from ._timing import card_line, median_ms, require_cuda

BATCH = 2048
SAMPLES = (64, 128)
CHUNK = 7680  # rays of an eval chunk
EDIT_CHUNK = 4096  # rays of an edit chunk
SIGMA_POINTS = 4096 * 64
PROBE_ROWS = 7680 * 128
PROBE_MODES = ("none", "combined", "combined_polysin", "split_polysin")
SEED = 0


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
    out = {"card": card, "ms": {}, "launch_peak_bytes": {}}
    gen = torch.Generator().manual_seed(SEED)
    for voxel in (False, True):
        cfg = ObjectNeRFConfig(use_voxel_embedding=voxel)
        model = ObjectNeRF(cfg).reset_parameters_(gen).to(dev)
        name = "voxel" if voxel else "classical"
        packed = pack_kernel_weights(model, cfg, True)
        coarse = pack_kernel_weights(model, cfg, False, sigma_only=True)
        with torch.no_grad():
            if 1 in rows or 2 in rows:
                for s in (64, 128):
                    xyz, dir_pe, codes, raw, _ = _inputs(cfg, CHUNK, s, dev, gen)
                    z = (xyz - xyz[:, :1]).norm(dim=-1).contiguous()
                    if s == 64 and 1 in rows:
                        _time(out, f"fused_coarse_weights {name} {CHUNK}x{s}",
                              lambda: fused_coarse_weights(model, cfg, xyz, z, voxel_raw=raw,
                                                           packed=coarse), args.launches, card)
                    if s == 128 and 2 in rows:
                        _time(out, f"fused_render_tiles {name} {CHUNK}x{s}",
                              lambda: fused_render_tiles(model, cfg, xyz, z, dir_pe, codes, raw,
                                                         packed=packed), args.launches, card)
                    del xyz, dir_pe, codes, raw, z
            if 3 in rows:
                for n, s, flags in ((BATCH, 64, (True, True)), (BATCH, 128, (True, True)),
                                    (EDIT_CHUNK, 128, (False, True)),
                                    (EDIT_CHUNK, 128, (True, False))):
                    xyz, dir_pe, codes, raw, _ = _inputs(cfg, n, s, dev, gen)
                    what = {(True, True): "", (False, True): " scene only",
                            (True, False): " object only"}[flags]
                    _time(out, f"fused_mlp_eval {name} {n}x{s}{what}",
                          lambda: fused_mlp_eval(model, cfg, xyz, dir_pe, codes, raw, *flags,
                                                 packed=packed), args.launches, card)
                    del xyz, dir_pe, codes, raw
            if 5 in rows:
                n_rows = SIGMA_POINTS // 64
                xyz, _, codes, raw, _ = _inputs(cfg, n_rows, 64, dev, gen)
                pts = xyz.reshape(-1, 3)
                raw = None if raw is None else raw.reshape(SIGMA_POINTS, -1)
                sig = pack_kernel_weights(model, cfg, True, sigma_only=True)
                for branch in ("scene", "instance"):
                    _time(out, f"fused_sigma_eval {name} {SIGMA_POINTS} points {branch}",
                          lambda: fused_sigma_eval(model, cfg, pts, codes, branch, 64,
                                                   voxel_raw=raw, packed=sig),
                          args.launches, card)
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
                print(f"{key}: one launch adds {out['launch_peak_bytes'][key] / 1e9:.3f} GB at "
                      f"its peak; {card}")
                del xyz, dir_pe, codes, raw, g
        del model, packed, coarse
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
