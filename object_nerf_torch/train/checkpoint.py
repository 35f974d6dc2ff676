"""Training checkpoints: `torch.save` files that resume a run exactly.

Counterpart of `object_nerf_tpu/train/checkpoint.py` (Orbax directories
there; loading those is not ported). A checkpoint is one file holding

* `state_dict`: the models under the reference's key names
  (`nerf_coarse.xyz_encoding_1.0.weight`, ...), so
  `train.convert.load_reference_ckpt` reads it like a reference `.ckpt`;
* `optimizer`: the optimizer's state dict (moments, lookahead slow weights);
* `step`, `epoch`: the global step and the epoch it falls in;
* `generator`, `batch_rng`: the states of the device generator (perturbation
  and density noise) and of the numpy batch sampler;
* `voxel_topo`, `voxel_static`: a voxel-conditioned model's grid (the
  topology's tensors and the static's fields; the feature table is in the
  state dict as `embedding_xyz.embedding_space_ftr.weight`), None otherwise:
  a grid that progressive training pruned or subdivided comes back as it
  was saved, with the optimizer state of its table.
  The JAX package stores the same two beside its params
  (`object_nerf_tpu/train/system.py:406-426`), so an eval or mesh run finds
  the grid its table rows are indexed by.

Restored on the same device type, the next step repeats bit for bit what the
uninterrupted run computed.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import torch

FORMAT = "object_nerf_torch/1"
SNAPSHOT_NAME = "run_config_snapshot.yaml"
SUFFIX = ".ckpt"


def save_config_snapshot(log_dir, config) -> None:
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    config.save(Path(log_dir) / SNAPSHOT_NAME)


def save_checkpoint(ckpt_dir, system, name: Optional[str] = None) -> Path:
    """Write `<ckpt_dir>/<name>.ckpt` (default name `step_<global step>`) from
    an `ObjectNeRFSystem`; returns the path."""
    from ..models.voxel_grid import topology_to_dict

    step = system.global_step
    path = Path(ckpt_dir) / f"{name or f'step_{step}'}{SUFFIX}"
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    torch.save({
        "format": FORMAT,
        "state_dict": {k: v.detach().cpu() for k, v in system.models.state_dict().items()},
        "optimizer": system.optimizer.state_dict(),
        "step": step,
        "epoch": step // system.steps_per_epoch,
        "generator": system.generator.get_state(),
        "batch_rng": system.batch_rng.get_state(),
        "voxel_topo": (topology_to_dict(system.voxel_topo)
                       if system.voxel_topo is not None else None),
        "voxel_static": (dataclasses.asdict(system.voxel_static)
                         if system.voxel_static is not None else None),
    }, tmp)
    tmp.replace(path)
    return path


def latest_checkpoint(ckpt_dir) -> Optional[Path]:
    """The `step_*` / `epoch_*` / `last` checkpoint of `ckpt_dir` with the
    highest global step, or None."""
    best, best_step = None, -1
    for path in sorted(Path(ckpt_dir).glob(f"*{SUFFIX}")):
        step = int(torch.load(path, map_location="cpu", weights_only=False).get("step", -1))
        if step > best_step:
            best, best_step = path, step
    return best


def restore_system(system, path) -> None:
    """Load `path` into an `ObjectNeRFSystem`: one of this module's
    checkpoints (everything is restored) or a reference `.ckpt` / bare state
    dict (weights only; missing modules keep their fresh initialisation).
    The file is unpickled in full: load only checkpoints from a trusted
    source."""
    from .convert import load_reference_ckpt, voxel_grid_from_ckpt

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd, voxel = load_reference_ckpt(ckpt, with_voxel=True)
    if (voxel is not None) != system.use_voxel:
        raise ValueError(f"{path} holds {'a' if voxel is not None else 'no'} voxel grid, but "
                         f"model.use_voxel_embedding is {system.use_voxel}")
    own = isinstance(ckpt, dict) and ckpt.get("format") == FORMAT
    if voxel is not None:
        # the checkpoint's table rows are indexed by its own topology: adopt both
        feats, system.voxel_topo, system.voxel_static = voxel_grid_from_ckpt(
            voxel, int(system.config.model.N_freq_voxel), system.device)
        if feats.shape != system.models.voxel_features.shape:
            if own:
                raise ValueError(
                    f"{path} holds a {tuple(feats.shape)} feature table, the system a "
                    f"{tuple(system.models.voxel_features.shape)} one")
            # a reference table has its own capacity: take it, with a fresh optimizer
            system.adopt_voxel_features(feats)
    if not own:
        result = system.models.load_state_dict(sd, strict=False)
        if result.unexpected_keys:
            raise ValueError(f"unexpected checkpoint entries: {result.unexpected_keys[:5]}")
        print(f"loaded weights from {path}")
        return
    system.models.load_state_dict(ckpt["state_dict"])
    system.optimizer.load_state_dict(ckpt["optimizer"])
    system.train_step.global_step = int(ckpt["step"])
    system.generator.set_state(ckpt["generator"])
    system.batch_rng.set_state(ckpt["batch_rng"])
    print(f"resumed from {path} at step {system.global_step}")
