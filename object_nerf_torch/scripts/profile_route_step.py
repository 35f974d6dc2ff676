"""How far do two bf16 computations of a voxel training step drift apart on
the scannet-keyed desk scene, with and without the `rays_in_bbox` route?

    python -m object_nerf_torch.scripts.profile_route_step [seeds]

Writes the procedural desk at 640x480 (`make_synthetic_dataset`, 12 frames,
ScanNet box files) under `logs/`, builds the voxel model of
`config/scannet_base_0113_multi.yml` pointed at it (`use_bbox_only_for_test`
false, so training takes the route), raises the scene sigma biases by 1 as
`chip_smoke.py` does, and for each batch seed, route on and off, and the
object branch's sigma bias raised by 0 or 1, takes one step from the same
weights and draws through the kernels, through the plain bf16 path and
through the plain f32 path. It prints, per gradient tensor relative to its
largest plain-bf16 entry, the worst MLP gradient and the table gradient of
kernels against plain bf16, beside the plain bf16 step's distance to f32.
Every line carries the card's name and power limit.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import shutil
import sys

import numpy as np
import torch

from ..config import load_config
from ..data import dataset_dict
from ..render.renderer import RenderDraws
from ..train import system as system_mod
from ..train.optim import make_optimizer
from .make_synthetic_dataset import make_dataset, write_scannet_boxes
from ._timing import card_line, require_cuda

W, H, BATCH = 640, 480, 2048
TABLE = "embedding_xyz.embedding_space_ftr.weight"


def _rel(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def main(argv) -> None:
    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    seeds = int(argv[0]) if argv else 3
    card = card_line()
    root = os.getcwd()
    scene = os.path.join(root, "logs", "profile_route_step_desk")
    shutil.rmtree(scene, ignore_errors=True)
    make_dataset(scene, (W, H), 12)
    write_scannet_boxes(scene, "scene0113_00")
    cfg = load_config(cli_args=[
        f"dataset_config={os.path.join(root, 'config', 'scannet_base_0113_multi.yml')}",
        f"img_wh=[{W},{H}]", f"dataset_extra.root_dir={scene}",
        f"dataset_extra.split={scene}/split", f"dataset_extra.scans_dir={scene}/scans",
        f"dataset_extra.bbox_dir={scene}", "dataset_extra.scene_id=scene0113_00",
        f"dataset_extra.pcd_path={scene}/pcd.ply", "dataset_extra.instance_id=[1,2]",
        "dataset_extra.val_instance_id=1", "dataset_extra.bg_instance_id=[0]",
        "dataset_extra.inst_seg_tag=instance", "dataset_extra.scene_center=[0,0,0]",
        "dataset_extra.validate_idx=11", "dataset_extra.use_bbox_only_for_test=false",
        f"train.batch_size={BATCH}", "model.perturb=1", "model.noise_std=1",
        "train.optimizer=adam", "train.lr_scheduler=poly", "train.seed=0"])
    ds = dataset_dict[cfg.dataset_name]("train", img_wh=(W, H), dataset_extra=cfg.dataset_extra)
    for inst_bias in (0.0, 1.0):
        system = system_mod.ObjectNeRFSystem(cfg, dataset=ds, device=dev)
        with torch.no_grad():
            for m in (system.models.nerf_coarse, system.models.nerf_fine):
                m.sigma.bias += 1.0
                m.instance_sigma.bias += inst_bias
        for route in (True, False):
            st = dataclasses.replace(system.settings, rays_in_bbox=route)
            for seed in range(seeds):
                batch = system._device_batch(ds.sample_batch(BATCH, np.random.RandomState(seed)))
                draws = RenderDraws.sample(st, BATCH, dev,
                                           torch.Generator(device=dev).manual_seed(seed))
                copies = [copy.deepcopy(system.models) for _ in range(3)]
                for models, plain, dtype in zip(copies, (False, True, True),
                                                (torch.bfloat16, torch.bfloat16, torch.float32)):
                    step = system_mod.make_train_step(
                        dataclasses.replace(st, matmul_dtype=dtype), dict(cfg.loss),
                        make_optimizer(cfg.train, models.parameters()), system.lr_schedule,
                        plain=plain)
                    step(models, batch, draws=draws, voxel_topo=system.voxel_topo,
                         voxel_static=system.voxel_static)
                torch.cuda.synchronize()
                kern, bf16, f32 = (dict(m.named_parameters()) for m in copies)
                err = {k: _rel(kern[k].grad, bf16[k].grad) for k in bf16}
                ctrl = {k: _rel(bf16[k].grad, f32[k].grad) for k in bf16}
                table, table_ctrl = err.pop(TABLE), ctrl.pop(TABLE)
                worst = max(err, key=err.get)
                print(f"{card}: route {route}, object sigma bias +{inst_bias:g}, batch {seed}: "
                      f"table gradient {table:.2e} (plain bf16 vs f32 {table_ctrl:.2e}, ratio "
                      f"{table / table_ctrl:.2f}); worst MLP gradient {err[worst]:.2e} at "
                      f"{worst} (plain bf16 vs f32 {ctrl[worst]:.2e})", flush=True)
    shutil.rmtree(scene, ignore_errors=True)


if __name__ == "__main__":
    main(sys.argv[1:])
