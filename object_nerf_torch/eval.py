"""Evaluation: render frames from a checkpoint and report PSNR/SSIM.

    python -m object_nerf_torch.eval dataset_config=config/synthetic.yml \\
        ckpt_path=<reference .ckpt> [device=cuda] [split=val] [n_frames=1] \\
        [chunk=7680]

Counterpart of `scripts/eval.py`: loads a reference Lightning checkpoint
(or a state dict in its schema, or one of the port's checkpoints; a
voxel-conditioned one brings its grid along), renders whole frames through the fused
eval path (the CUDA kernels on `device=cuda`, the default; their plain
versions on `device=cpu`) and prints per-frame and mean masked PSNR and
SSIM.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def main(argv) -> None:
    from .config import load_config
    from .data import dataset_dict
    from .device import resolve_device
    from .render.renderer import RenderSettings
    from .train.convert import load_reference_ckpt, voxel_grid_from_ckpt
    from .train.metrics import psnr, ssim
    from .train.system import init_params, render_image

    config = load_config(cli_args=argv)
    if not config.get("ckpt_path"):
        raise SystemExit("ckpt_path not set")
    if config.dataset_name not in dataset_dict:
        raise SystemExit(f"dataset {config.dataset_name!r} is not ported yet "
                         f"(have: {sorted(dataset_dict)})")
    device = resolve_device(config.get("device", "cuda"))
    split = config.get("split", "val")
    n_frames = int(config.get("n_frames", 1))
    chunk = int(config.get("chunk", 7680))

    ds = dataset_dict[config.dataset_name](
        split=split, img_wh=tuple(config.img_wh), dataset_extra=config.dataset_extra)
    settings = RenderSettings.from_config(config, white_back=ds.white_back, is_eval=True)
    sd, voxel = load_reference_ckpt(config.ckpt_path, with_voxel=True)
    if (voxel is not None) != settings.mlp.use_voxel_embedding:
        raise SystemExit(f"{config.ckpt_path} holds {'a' if voxel is not None else 'no'} "
                         f"voxel grid, but model.use_voxel_embedding is "
                         f"{settings.mlp.use_voxel_embedding}")
    # a voxel checkpoint brings its own grid: the table's rows are indexed by it
    features, voxel_topo, voxel_static = (None, None, None) if voxel is None else \
        voxel_grid_from_ckpt(voxel, settings.mlp.N_freq_voxel, device)
    models = init_params(torch.Generator().manual_seed(0), settings, config.model,
                         device=device, voxel_features=features)
    models.load_state_dict(sd)

    w, h = tuple(config.img_wh)
    typ = "fine" if settings.N_importance > 0 else "coarse"
    psnrs, ssims = [], []
    count = min(n_frames, len(ds.poses))
    for i in range(count):
        batch = ds.whole_image_batch(i)
        out = render_image(models, settings, batch, chunk=chunk, device=device,
                           voxel_topo=voxel_topo, voxel_static=voxel_static)
        mask = np.asarray(batch["valid_mask"], bool)
        if "instance_mask" in batch:
            mask = mask & np.asarray(batch["instance_mask"], bool)
        pred = torch.from_numpy(out[f"rgb_{typ}"])
        gt = torch.from_numpy(np.asarray(batch["rgbs"], np.float32))
        p = float(psnr(pred, gt, torch.from_numpy(mask)[:, None]))
        s = float(ssim(pred.reshape(h, w, 3), gt.reshape(h, w, 3)))
        psnrs.append(p)
        ssims.append(s)
        print(f"frame {i}: psnr {p:.3f}  ssim {s:.4f}")
    print(f"mean: psnr {np.mean(psnrs):.3f}  ssim {np.mean(ssims):.4f}")


if __name__ == "__main__":
    main(sys.argv[1:])
