"""Training CLI.

    python -m object_nerf_torch.train dataset_config=config/toy_desk_2.yml \
        exp_name=desk [device=cuda] ["img_wh=[640,480]"] [train.batch_size=2048]

Counterpart of the JAX package's `train.py:20-140`, with the same dotted
overrides (`default_conf.yml < dataset yaml < key=value arguments`): builds
the datasets (a scan on disk through `GenericDataset` for the ScanNet and
ToyDesk configs, or the procedural `config/synthetic.yml`) and an
`ObjectNeRFSystem` on `device` (default `cuda`; `device=cpu` runs the
kernels' plain versions), writes the run-config snapshot and a copy of the
source tree (`snapshot_source`, default on), trains with `fit`, saves a
checkpoint whenever validation PSNR improves, one per epoch
(`train.save_top_k`: -1 keeps all, k > 0 the best k by the epoch's own
validation PSNR, 0 none) and a `last`, under `logs/<time>_<exp_name>/`.
Validation scalars and the 7-panel validation image go to TensorBoard when
`tensorboardX` imports (best effort, as in the JAX CLI); `tpu.profile_dir`
records a few steps with `torch.profiler` (`ObjectNeRFSystem.fit`), the
program's spans (`utils/trace.py`) among them.
`ckpt_path=<file>` resumes from one of these checkpoints, or starts from a
reference checkpoint's weights.

Data parallel (`train.py:29-33`): with `tpu.distributed=true` the process
joins a `torch.distributed` group (`parallel/mesh.initialize_distributed`:
`RANK`, `WORLD_SIZE`, `LOCAL_RANK` from `torchrun`, the rendezvous at
`tpu.coordinator` = `host:port` or torchrun's; NCCL on `device=cuda`, gloo on
`device=cpu`) and raises if it cannot. One process per GPU:

    torchrun --nproc_per_node=8 -m object_nerf_torch.train \
        dataset_config=config/toy_desk_2.yml tpu.distributed=true

`train.batch_size` is the global batch (each rank trains on its share).
Only rank 0 prints the config and writes the run directory, TensorBoard and
checkpoints; the others wait for it.
"""

from __future__ import annotations

import os
import sys
import time


def main(argv) -> None:
    from ..config import load_config
    from ..data import dataset_dict
    from ..parallel import mesh
    from .checkpoint import save_checkpoint, save_config_snapshot
    from .system import ObjectNeRFSystem

    config = load_config(cli_args=argv)
    mesh.initialize_from_config(config)
    lead = mesh.rank() == 0
    if "root_dir" not in config.dataset_extra and config.dataset_name != "synthetic":
        raise SystemExit(
            "error: no scene selected: pass dataset_config=config/<scene>.yml "
            "(e.g. config/toy_desk_2.yml, or config/synthetic.yml for the "
            "built-in test scene)")
    if config.dataset_name not in dataset_dict:
        raise SystemExit(f"unknown dataset {config.dataset_name!r} (have: "
                         f"{sorted(dataset_dict)})")
    log_path = os.path.join("logs", time.strftime("%Y-%m-%d_%H-%M-%S") + "_" + config.exp_name)
    config["log_path"] = log_path
    if lead:
        print("-" * 40)
        print(config.to_yaml())
        print("-" * 40)

    dataset_cls = dataset_dict[config.dataset_name]
    kwargs = dict(img_wh=tuple(config.img_wh), dataset_extra=config.dataset_extra)
    system = ObjectNeRFSystem(config, dataset=dataset_cls(split="train", **kwargs),
                              val_dataset=dataset_cls(split="val", **kwargs),
                              device=config.get("device", "cuda"))
    writer = None
    if lead:
        save_config_snapshot(log_path, config)
        if config.get("snapshot_source", True):
            from ..utils.snapshot import make_source_code_snapshot

            make_source_code_snapshot(log_path)
        writer = _summary_writer(log_path)

    best_psnr = float("-inf")
    epoch_psnr = float("-inf")  # the best val/psnr seen within the current epoch

    def on_val(epoch, it, metrics, sys_):
        nonlocal best_psnr, epoch_psnr
        if writer is not None:
            step = sys_.global_step
            for k, v in metrics.items():
                writer.add_scalar(k, float(v), step)
            try:  # best effort: tensorboardX draws images with PIL, which it does not require
                panel = sys_.val_image_panel()
                if panel is not None:
                    writer.add_images("val/GT_pred_depth", panel, step, dataformats="NHWC")
            except ImportError as e:
                print(f"  [val] image panel skipped: {e}")
        vp = metrics.get("val/psnr", float("-inf"))
        epoch_psnr = max(epoch_psnr, vp)
        if vp > best_psnr:
            best_psnr = vp
            save_checkpoint(log_path, sys_)
        print(f"  [val] epoch {epoch} it {it}: psnr {vp:.2f} (best {best_psnr:.2f})")

    save_top_k = int(config.train.get("save_top_k", -1))
    epoch_ckpts = []  # [(the epoch's own best val/psnr, path)]

    def on_epoch_end(epoch, sys_):
        nonlocal epoch_psnr
        save_checkpoint(log_path, sys_, name="last")
        if save_top_k != 0:
            epoch_ckpts.append((epoch_psnr, save_checkpoint(log_path, sys_,
                                                            name=f"epoch_{epoch}")))
            if 0 < save_top_k < len(epoch_ckpts):
                epoch_ckpts.sort(key=lambda t: t[0], reverse=True)
                for _, stale in epoch_ckpts[save_top_k:]:
                    stale.unlink(missing_ok=True)
                del epoch_ckpts[save_top_k:]
        epoch_psnr = float("-inf")

    system.fit(callbacks=[on_val], epoch_end_callbacks=[on_epoch_end])
    if lead:
        save_checkpoint(log_path, system)
        if writer is not None:
            writer.close()
        print(f"Done. Logs + checkpoints in {log_path}")
    mesh.barrier()
    mesh.destroy()


def _summary_writer(log_path):
    """A tensorboardX `SummaryWriter` on the run directory, or None (said
    once) when tensorboardX does not import: logging, not the device path."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError as e:
        print(f"TensorBoard logging off: tensorboardX does not import ({e})")
        return None
    return SummaryWriter(log_path)


if __name__ == "__main__":
    main(sys.argv[1:])
