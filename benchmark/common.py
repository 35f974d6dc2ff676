"""What the drivers share: the cell's configuration as the program's config
keys, the seeded weights loaded into the program's models, the random draws
of a training step, and the device's description."""

from __future__ import annotations

import subprocess
from typing import Dict

import numpy as np
import torch

from .model_spec import LATTICE, TABLE, Spec

CHECKED_FRAMES = 2  # frames of a render or edit window that the reference renders again
REFERENCE_BLOCK = 4096  # rays the reference renders at a time

DRAW_FIELDS = ("perturb", "noise_coarse", "noise_inst_coarse", "pdf", "noise_fine",
               "noise_inst_fine")


def seed_parts(seed: int, stream: int):
    """A numpy seed for one stream of a run's draws (any whole seed)."""
    return [int(seed) % (1 << 63), stream]


def draws(spec: Spec, n: int, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """One training step's draws, in the order of the step's key split:
    uniform perturbations (n, N_samples), normal densities' noise (n,
    N_samples) twice, uniform pdf draws (n, N_importance), normal noise (n,
    N_samples + N_importance) twice."""
    s_c, s_f = spec.N_samples, spec.N_samples + spec.N_importance

    def u(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def z(*shape):
        return torch.randn(shape, generator=gen, device=device)

    return dict(zip(DRAW_FIELDS, (u(n, s_c), z(n, s_c), z(n, s_c), u(n, spec.N_importance),
                                  z(n, s_f), z(n, s_f))))


def model_keys(cfg: dict) -> list:
    """The configuration's model block as the program's `key=value` overrides."""
    m = cfg["model"]
    out = []
    for k, v in m.items():
        if isinstance(v, bool):
            v = str(v).lower()
        elif isinstance(v, list):
            v = "[" + ",".join(str(x) for x in v) + "]"
        out.append(f"model.{k}={v}")
    return out


@torch.no_grad()
def load_weights(models: torch.nn.Module, weights: Dict[str, torch.Tensor],
                 row_to_cell=None) -> Dict[str, torch.Tensor]:
    """Copy the benchmark's weights into the program's parameters, by the
    reference's names; a voxel model's table rows take the lattice's rows at
    the cells the program's grid maps them to (zero for unused rows). Returns
    the program's initial parameters by name (the table as loaded)."""
    named = dict(models.named_parameters())
    want = {k for k in weights if k != LATTICE} | ({TABLE} if LATTICE in weights else set())
    if set(named) != want:
        raise RuntimeError("the program's parameters are not the published model's: "
                           f"{sorted(set(named) ^ want)}")
    for k, t in weights.items():
        if k == LATTICE:
            lat = torch.cat([t, t.new_zeros(1, t.shape[1])])
            named[TABLE].copy_(lat[row_to_cell.long().clamp(max=t.shape[0])])
        else:
            named[k].copy_(t)
    return {k: p.detach().clone() for k, p in named.items()}


def device_info(device) -> dict:
    """The result line's `device`: the one card a cell uses, its peak memory."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def grid_inputs(cfg: dict, device):
    """(point cloud, reference grid) of a voxel configuration, or (None, None)."""
    from . import scenes
    from .reference import voxel

    if not cfg["model"]["use_voxel_embedding"]:
        return None, None
    pcd = {"room": scenes.room_pcd}[cfg["scene"]["kind"]]()
    return pcd, voxel.build(pcd, cfg["scene"], device)


def finite_host(maps: Dict[str, np.ndarray]) -> bool:
    return all(np.isfinite(v).all() for v in maps.values())


def make_weights(spec: Spec, cfg: dict, seed: int, device, n_cells: int = 0):
    """The configuration's seeded weights (`weights.make`)."""
    from . import weights

    return weights.make(spec, seed, device, n_cells, float(cfg["density_bias"]))


def program_counters() -> Dict[str, int]:
    """The program's own launch counters: the fused kernels, the row
    gathers and the corner-table builds since the last reset."""
    from object_nerf_torch.models import voxel_grid
    from object_nerf_torch.ops import fused_mlp, gather

    return {**fused_mlp.launch_counts, **gather.launch_counts, **voxel_grid.build_counts}


def reset_program_counters() -> None:
    from object_nerf_torch.models import voxel_grid
    from object_nerf_torch.ops import fused_mlp, gather

    fused_mlp.reset_launch_counts()
    gather.reset_launch_counts()
    voxel_grid.build_counts["corner_table"] = 0
