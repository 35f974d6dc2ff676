"""The `train_subdivided` traffic: the `train` traffic's step on the grid that
the progressive schedule trains on after its epoch-5 subdivision, as epochs
5 to 29 of a progressive run do.

Set-up: the pool, the seeded weights loaded on the coarse grid, then the
program's own epoch hooks `ObjectNeRFSystem.on_epoch_start(e)` for e = 0
... `hook_epochs` - 1, as `fit` calls them (the published schedule: a
prune at every epoch > 2, the subdivision at epoch 5); then the initial
parameters, the checked steps and the warm-up steps as in `train`. The
first checked step runs eagerly on the new grid's signature, the second
captures the step's graph, the third replays it. The window is `train`'s.

The reference subdivides the coarse grid and its lattice itself
(`reference/subdivide.py`) and repeats the checked steps on the fine grid,
at the learning rates the program's optimizer took. Besides `train`'s
numbers, `subdiv_gap` holds the program's table after the hooks against the
reference's fine lattice; a grid after the hooks that differs from the
reference's in shape or in any cell's occupancy makes every number
infinite."""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import common, scenes
from ..model_spec import LATTICE
from ..reference import subdivide as ref_subdivide
from . import train


class Driver(train.Driver):
    kind = "train"  # a step is the unit, as in `train` (metrics/step_host_ms.py)

    def _system(self, pcd):
        system = super()._system(pcd)
        # `train` turns the schedule off; here the configuration's setting stands
        system.config.train.progressive_train = bool(self.cfg["train"]["progressive_train"])
        return system

    def setup(self) -> None:
        tr = self.traffic
        self.pool = scenes.ray_pool(self.cfg["scene"], self.seed, int(tr["views"]),
                                    tuple(tr["img_wh"]), int(tr["pool_rays"]))
        self.pcd, self.grid = common.grid_inputs(self.cfg, self.device)
        self.weights = common.make_weights(self.spec, self.cfg, self.seed, self.device,
                                           self.grid.n_cells)
        self.system = sys_ = self._system(self.pcd)
        common.load_weights(sys_.models, self.weights, sys_.voxel_topo.row_to_cell)
        for epoch in range(int(tr["hook_epochs"])):
            sys_.on_epoch_start(epoch)
        # the grid after the hooks, and its occupied cells' rows of the table
        topo = sys_.voxel_topo
        self.hooked = (tuple(sys_.voxel_static.shape), topo.occupancy.cpu())
        cells = torch.nonzero(topo.occupancy).squeeze(1)
        with torch.no_grad():
            table_rows = sys_.models.voxel_features[topo.idx_map[cells].long()].float().cpu()
        named = dict(sys_.models.named_parameters())
        p0 = {k: p.detach().clone() for k, p in named.items()}
        self.gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.rng = np.random.default_rng(common.seed_parts(self.seed, 3))

        # the checked steps: rows that all differ, the benchmark's draws
        k = train.CHECKED_STEPS
        rows = self.rng.permutation(len(self.pool["rays"]))[:k * self.batch]
        self.checked = [rows[i * self.batch:(i + 1) * self.batch] for i in range(k)]
        self.checked_draws, self.lrs = [], []
        losses, grad_norms = [], None
        opt = sys_.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        for i, idx in enumerate(self.checked):
            d = common.draws(self.spec, self.batch, self.gen, self.device)
            self.checked_draws.append(d)
            m = self._step(self._upload(idx), d)
            losses.append(m["train/loss"])
            self.lrs.append(float(opt.param_groups[0]["lr"]))  # the rate the step took
            if i == 0:  # no state: the optimizer took no step
                grad_norms = {n: (opt.state[p]["exp_avg"].norm() / (1 - beta1)
                                  if "exp_avg" in opt.state.get(p, {}) else torch.zeros(()))
                              for n, p in named.items()}
        change = {n: (p.detach() - p0[n]).norm() for n, p in named.items()}
        self.prog = {"losses": [float(v) for v in losses],
                     "grad_norms": {n: float(v) for n, v in grad_norms.items()},
                     "change_norms": {n: float(v) for n, v in change.items()},
                     "table_rows": table_rows}
        del p0
        for _ in range(int(tr["warmup_steps"])):
            self._window_step(None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fine(self):
        """The reference's fine grid and lattice (computed once)."""
        if not hasattr(self, "_fine_grid"):
            self._fine_grid = ref_subdivide.subdivide(self.grid, self.weights[LATTICE])
        return self._fine_grid

    def reference(self, rounding: str = "exact", half: bool = False) -> dict:
        """`train`'s reference on the fine grid and lattice, and the fine
        lattice's occupied rows (`table_rows`)."""
        fine, lattice = self._fine()
        coarse, weights = self.grid, self.weights
        self.grid, self.weights = fine, {**weights, LATTICE: lattice}
        try:
            out = super().reference(rounding, half)
        finally:
            self.grid, self.weights = coarse, weights
        out["table_rows"] = lattice[fine.occupied].cpu()
        return out

    def compare(self, prog: dict, ref: dict):
        from ..compare import train_numbers

        nums = train_numbers(prog, ref)
        fine, _ = self._fine()
        a, b = prog["table_rows"], ref["table_rows"]
        shape, occupied = self.hooked
        same_grid = (shape == tuple(fine.shape) and torch.equal(occupied, fine.occupied.cpu())
                     and a.shape == b.shape)
        nums["subdiv_gap"] = (float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                              if same_grid else math.inf)
        if not same_grid or not math.isfinite(nums["subdiv_gap"]):
            nums = {k: math.inf for k in nums}
        return nums
