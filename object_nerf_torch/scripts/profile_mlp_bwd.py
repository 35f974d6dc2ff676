"""Compare `fused_mlp_bwd` across checkouts: its time at the training shapes
and the memory it takes.

    python -m object_nerf_torch.scripts.profile_mlp_bwd [--launches N]

For the classical-PE model and the voxel-conditioned one (16 + 8 voxel
channels, 6 octaves) at 2048 rays x 64 and x 128 samples, on random weights
and inputs from a seed (one-sign cotangents of a mean-reduced loss's size):
the median device ms of one backward launch (CUDA events, each launch
between its own pair), and the device memory one launch adds at its peak
(`max_memory_allocated` over what was allocated before it); then the peak
device memory of one training step (batch 2048, 64 + 64 samples, the
synthetic scene's rays; the voxel model on the ScanNet-scale room's grid of
`_fixtures.py`), the figure a user's card must hold. Prints the card's name
and power limit, one line per measurement, and one JSON line.

It calls only entry points that the port has had since its voxel model was
first trained, so the same file, copied into an older checkout of the
package, times that checkout on the same card: compare two versions on one
card, in turns (old, new, new, old). That comparison is what it is for; the
backward's numbers of record (its split by kernel, its bound, its checks)
are `chip_smoke.py`'s, phases 6 and 16.
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
from ..ops.fused_mlp import pack_kernel_weights
from ..ops.fused_mlp_vjp import fused_mlp_bwd
from ..train.system import ObjectNeRFSystem
from ._fixtures import SCENE, scannet_scale_pcd
from ._timing import card_line, median_ms, require_cuda

BATCH = 2048
SAMPLES = (64, 128)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--launches", type=int, default=10)
    args = ap.parse_args(argv)
    dev = require_cuda()
    card = card_line()
    print(card)
    out = {"card": card, "ms": {}, "launch_peak_bytes": {}}
    gen = torch.Generator().manual_seed(SEED)
    for voxel in (False, True):
        cfg = ObjectNeRFConfig(use_voxel_embedding=voxel)
        model = ObjectNeRF(cfg).reset_parameters_(gen).to(dev)
        packed = pack_kernel_weights(model, cfg, True)
        for s in SAMPLES:
            xyz, dir_pe, codes, raw, g = _inputs(cfg, BATCH, s, dev, gen)

            def run():
                fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, g, packed=packed, voxel_raw=raw)

            run()  # builds the kernels on the first call
            key = f"{'voxel' if voxel else 'classical'} {BATCH}x{s}"
            out["launch_peak_bytes"][key] = _peak_bytes(run, dev)
            with torch.no_grad():
                out["ms"][key] = median_ms(run, args.launches)
            print(f"fused_mlp_bwd {key}: {out['ms'][key]:.3f} ms/launch (median of "
                  f"{args.launches}), one launch adds {out['launch_peak_bytes'][key] / 1e9:.3f} "
                  f"GB at its peak; {card}")
            del xyz, dir_pe, codes, raw, g
        del model, packed
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
