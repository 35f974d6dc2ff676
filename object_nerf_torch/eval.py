"""Evaluation: render frames from a checkpoint and report PSNR/SSIM.

    python -m object_nerf_torch.eval dataset_config=config/toy_desk_2.yml \\
        ckpt_path=<reference .ckpt> [device=cuda] [split=val] [n_frames=1] \\
        [chunk=7680] [save_images=<dir>] [dtype=float32]

Counterpart of `scripts/eval.py`: loads a reference Lightning checkpoint
(or a state dict in its schema, or one of the port's checkpoints; a
voxel-conditioned one brings its grid along), renders whole frames through the fused
eval path (the CUDA kernels on `device=cuda`, the default; their plain
versions on `device=cpu`, in bf16 as the kernels compute unless
`dtype=float32`) and prints per-frame and mean masked PSNR and SSIM. A
dataset whose rays are bounded by the instance box (`is_rays_in_bbox`, a
ScanNet config under `use_bbox`) renders on the `rays_in_bbox` route, as the
JAX script's `ObjectNeRFSystem(val_dataset=ds)` does. `save_images=<dir>`
writes each frame as `eval_<i>.png`. With `tpu.distributed=true` under
`torchrun` every rank renders every W-th chunk of each frame
(`parallel/mesh.py`) and rank 0 prints and writes.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch


def main(argv) -> None:
    from .config import load_config
    from .data import dataset_dict
    from .data.png_io import write_png
    from .device import resolve_device
    from .parallel import mesh
    from .render.renderer import RenderSettings
    from .train.convert import load_reference_ckpt, voxel_grid_from_ckpt
    from .train.metrics import psnr, ssim
    from .train.system import init_params, render_image

    config = load_config(cli_args=argv)
    mesh.initialize_from_config(config)
    lead = mesh.rank() == 0
    if not config.get("ckpt_path"):
        raise SystemExit("ckpt_path not set")
    if config.dataset_name not in dataset_dict:
        raise SystemExit(f"unknown dataset {config.dataset_name!r} "
                         f"(have: {sorted(dataset_dict)})")
    device = resolve_device(config.get("device", "cuda"))
    split = config.get("split", "val")
    n_frames = int(config.get("n_frames", 1))
    chunk = int(config.get("chunk", 7680))
    save_dir = config.get("save_images")
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    dtype = str(config.get("dtype", "bfloat16"))
    if dtype not in dtypes:
        raise SystemExit(f"dtype={dtype}: bfloat16 or float32")

    ds = dataset_dict[config.dataset_name](
        split=split, img_wh=tuple(config.img_wh), dataset_extra=config.dataset_extra)
    in_bbox = bool(getattr(ds, "is_rays_in_bbox", lambda: False)())
    settings = RenderSettings.from_config(config, white_back=ds.white_back, is_eval=True,
                                          rays_in_bbox=in_bbox, matmul_dtype=dtypes[dtype])
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
    count = min(n_frames, len(ds.frames) if hasattr(ds, "frames") else len(ds.poses))
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
        if not lead:
            continue
        print(f"frame {i}: psnr {p:.3f}  ssim {s:.4f}")
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            img = np.clip(out[f"rgb_{typ}"].reshape(h, w, 3), 0, 1)
            write_png(os.path.join(save_dir, f"eval_{i:04d}.png"),
                      (img * 255).astype(np.uint8))
    if lead:
        print(f"mean: psnr {np.mean(psnrs):.3f}  ssim {np.mean(ssims):.4f}")
    mesh.barrier()
    mesh.destroy()


if __name__ == "__main__":
    main(sys.argv[1:])
