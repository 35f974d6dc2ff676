"""The `train` traffic: the program's training step, `TrainStep.__call__` as
`ObjectNeRFSystem` builds it (`system.train_step`), on batches drawn from a
seeded pool of traced rays.

Set-up: the pool (`pool_rays` distinct pixels of `views` seeded views, with
the dataset's batch schema), the seeded weights loaded into the system's
models, then the checked steps: `CHECKED_STEPS` batches of rows that all
differ, with draws the benchmark makes, through the window's own call and
upload. After the first, the first gradient's norm per leaf is read from
Adam's state (exp_avg / (1 - beta1)); after the last, the change of every
leaf since the weights were loaded. Then `warmup_steps` more steps. The
window: a batch of `batch` rows drawn with replacement from the pool,
uploaded from the host, the step's draws made on the device, the step;
again until `seconds` have passed, then one synchronise. The reference
repeats the checked steps from the same weights, batches and draws."""

from __future__ import annotations

import contextlib
import gc
import os
import tempfile

import numpy as np
import torch

from .. import common, flops, scenes
from ..harness import span
from ..model_spec import Spec
from ..reference import model as ref_model
from ..reference import no_tf32
from ..reference import train as ref_train

CHECKED_STEPS = 3  # the steps the reference follows
BATCH_KEYS = ("rays", "rgbs", "depths", "valid_mask", "instance_mask",
              "instance_mask_weight", "pass_through_mask", "instance_ids")


class Driver:
    kind = "train"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.spec = Spec.from_config(cfg["model"])
        self.batch = int(traffic["batch"])

    # -- set-up ----------------------------------------------------------------------
    def _system(self, pcd):
        from object_nerf_torch.config import load_config
        from object_nerf_torch.data.ply_io import write_ply
        from object_nerf_torch.train.system import ObjectNeRFSystem

        cfg, sc, tr = self.cfg, self.cfg["scene"], self.cfg["train"]
        keys = common.model_keys(cfg) + [
            f"train.{k}={v}" for k, v in tr.items()] + [
            f"loss.{k}={v}" for k, v in cfg["loss"].items()] + [
            f"train.batch_size={self.batch}", "train.progressive_train=false",
            f"train.seed={self.seed % (1 << 31)}",
            f"dataset_extra.scale_factor={sc['scale_factor']}",
            "dataset_extra.scene_center=[" + ",".join(map(str, sc["scene_center"])) + "]"]
        with contextlib.ExitStack() as stack:
            if pcd is not None:
                tmp = stack.enter_context(tempfile.TemporaryDirectory())
                path = os.path.join(tmp, "scene.ply")
                write_ply(path, pcd)
                keys += [f"dataset_extra.pcd_path={path}",
                         f"dataset_extra.voxel_size={sc['voxel_size']}",
                         f"dataset_extra.neighbor_marks={sc['neighbor_marks']}"]
            return ObjectNeRFSystem(load_config(cli_args=keys), dataset=None,
                                    device=self.device)

    def _upload(self, idx):
        return {k: torch.from_numpy(self.pool[k][idx]).to(self.device) for k in BATCH_KEYS}

    def _step(self, batch, d):
        from object_nerf_torch.render.renderer import RenderDraws

        sys_ = self.system
        return sys_.train_step(sys_.models, batch, draws=RenderDraws(**d),
                               voxel_topo=sys_.voxel_topo, voxel_static=sys_.voxel_static)

    def setup(self) -> None:
        tr = self.traffic
        self.pool = scenes.ray_pool(self.cfg["scene"], self.seed, int(tr["views"]),
                                    tuple(tr["img_wh"]), int(tr["pool_rays"]))
        self.pcd, self.grid = common.grid_inputs(self.cfg, self.device)
        n_cells = self.grid.n_cells if self.grid is not None else 0
        self.weights = common.make_weights(self.spec, self.cfg, self.seed, self.device,
                                           n_cells)
        self.system = self._system(self.pcd)
        rtc = self.system.voxel_topo.row_to_cell if self.grid is not None else None
        self.grid_ok = (self.grid is None
                        or tuple(self.system.voxel_static.shape) == self.grid.shape)
        p0 = common.load_weights(self.system.models, self.weights, rtc)
        self.gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.rng = np.random.default_rng(common.seed_parts(self.seed, 3))

        # the checked steps: rows that all differ, the benchmark's draws
        k = CHECKED_STEPS
        rows = self.rng.permutation(len(self.pool["rays"]))[:k * self.batch]
        self.checked = [rows[i * self.batch:(i + 1) * self.batch] for i in range(k)]
        self.checked_draws = []
        losses, grad_norms = [], None
        named = dict(self.system.models.named_parameters())
        opt = self.system.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        # the checked steps lie in the schedule's first epoch: lr as configured
        self.lrs = [float(self.cfg["train"]["lr"])] * k
        for i, idx in enumerate(self.checked):
            d = common.draws(self.spec, self.batch, self.gen, self.device)
            self.checked_draws.append(d)
            m = self._step(self._upload(idx), d)
            losses.append(m["train/loss"])
            if i == 0:  # no state: the optimizer took no step
                grad_norms = {n: (opt.state[p]["exp_avg"].norm() / (1 - beta1)
                                  if "exp_avg" in opt.state.get(p, {}) else torch.zeros(()))
                              for n, p in named.items()}
        change = {n: (p.detach() - p0[n]).norm() for n, p in named.items()}
        self.prog = {"losses": [float(v) for v in losses],
                     "grad_norms": {n: float(v) for n, v in grad_norms.items()},
                     "change_norms": {n: float(v) for n, v in change.items()}}
        del p0
        for _ in range(int(tr["warmup_steps"])):
            self._window_step(None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the window --------------------------------------------------------------------
    def _window_step(self, bad):
        idx = self.rng.integers(0, len(self.pool["rays"]), self.batch)
        with span("bench.upload"):
            batch = self._upload(idx)
        with span("bench.draws"):
            d = common.draws(self.spec, self.batch, self.gen, self.device)
        with span("bench.step"):
            m = self._step(batch, d)
        if bad is not None:
            bad += ~torch.isfinite(m["train/loss"])

    def unit_flops(self) -> float:
        return flops.train_step_flops(self.spec, self.batch)

    def end_to_end(self, units: int, window_s: float) -> dict:
        """Rays of every step of the window over the whole window."""
        return {"train_rays_per_s": units * self.batch / window_s}

    def counters(self):
        return common.program_counters()

    def reset_counters(self) -> None:
        common.reset_program_counters()

    def run_unit(self, bad) -> None:
        self._window_step(bad)

    def failed(self, bad) -> int:
        return int(bad)

    def new_bad(self):
        return torch.zeros((), dtype=torch.int64, device=self.device)

    # -- after the window ----------------------------------------------------------------
    def free(self) -> None:
        self.system = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def program_readings(self) -> dict:
        return self.prog

    def reference(self, rounding: str = "exact", half: bool = False) -> dict:
        """The reference's readings of the checked steps; `half` leaves out
        the second half of every batch (a fault the comparison must catch)."""
        no_tf32()
        n = self.batch // 2 if half else self.batch
        batches, draws = [], []
        for idx, d in zip(self.checked, self.checked_draws):
            b = self._upload(idx[:n])
            b = {k: (v.float() if v.dtype == torch.float64 else v) for k, v in b.items()}
            batches.append(b)
            draws.append({k: v[:n] for k, v in d.items()})
        return ref_train.run(self.weights, self.spec, self.grid, batches, draws, self.lrs,
                             self.cfg["loss"], _frustum(self.cfg),
                             ref_model.ROUNDINGS[rounding])

    def compare(self, prog: dict, ref: dict):
        from ..compare import train_numbers

        nums = train_numbers(prog, ref)
        if not self.grid_ok:
            nums = {k: float("inf") for k in nums}
        return nums


def _frustum(cfg) -> float:
    fb = float(cfg["model"]["frustum_bound"])
    return fb / float(cfg["scene"]["scale_factor"]) if fb > 0 else 0.0
