"""The `render` traffic: one user rendering a novel-view sequence, closed
loop. Each frame: the rays of a seeded pinhole view (`views` of them, in
turn) and their instance ids from the scene's instance map are uploaded,
the program's eval render (the function `make_render_fn` returns, chunk
`chunk`) renders them, and the six maps come back to the host; then the
next frame. After the window, `common.CHECKED_FRAMES` frames drawn from the seed
among those rendered are rendered again by the reference and compared."""

from __future__ import annotations

import gc

import numpy as np
import torch

from .. import common, flops, scenes
from ..harness import span
from ..model_spec import Spec
from ..reference import model as ref_model
from ..reference import no_tf32
from ..reference import render as ref_render


class Driver:
    kind = "render"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.spec = Spec.from_config(cfg["model"])
        self.wh = tuple(traffic["img_wh"])

    def setup(self) -> None:
        from object_nerf_torch.models import voxel_grid as vg
        from object_nerf_torch.models.mlp import ObjectNeRFConfig
        from object_nerf_torch.render.renderer import RenderSettings
        from object_nerf_torch.train.system import init_params, make_render_fn

        cfg, sc, m = self.cfg, self.cfg["scene"], self.cfg["model"]
        tr = self.traffic
        self.frames = scenes.frames(sc, self.seed, int(tr["views"]), self.wh)
        self.pcd, self.grid = common.grid_inputs(cfg, self.device)
        n_cells = self.grid.n_cells if self.grid is not None else 0
        self.weights = common.make_weights(self.spec, cfg, self.seed, self.device,
                                           n_cells)
        mcfg = ObjectNeRFConfig(**{k: (tuple(m[k]) if k.endswith("skips") else m[k])
                                   for k in ObjectNeRFConfig.__dataclass_fields__})
        dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        settings = RenderSettings(mlp=mcfg, N_samples=m["N_samples"],
                                  N_importance=m["N_importance"], perturb=0.0, noise_std=0.0,
                                  is_eval=True, forward_instance=True, matmul_dtype=dtype)
        features, self.topo, static = None, None, None
        if self.grid is not None:
            features, self.topo, static = vg.build_voxel_grid(
                self.pcd, scene_center=sc["scene_center"], scale_factor=sc["scale_factor"],
                voxel_size_world=sc["voxel_size"], neighbor_marks=sc["neighbor_marks"],
                channels=self.spec.voxel_channels, n_freq_voxel=self.spec.N_freq_voxel,
                n_max_voxels=m["N_max_voxels"], device=self.device)
        self.grid_ok = self.grid is None or tuple(static.shape) == self.grid.shape
        self.models = init_params(torch.Generator().manual_seed(0), settings,
                                  {"N_max_objs": m["N_max_objs"]}, device=self.device,
                                  voxel_features=features)
        common.load_weights(self.models, self.weights,
                            self.topo.row_to_cell if self.topo is not None else None)
        self.render = make_render_fn(settings, static, chunk=int(tr["chunk"]))
        self.done = []  # (view, host maps) of every frame of the window
        for _ in range(int(tr["warmup_frames"])):
            self._frame(0)
        self.done = []

    def _frame(self, i: int):
        v = i % len(self.frames)
        rays, ids = self.frames[v]
        with span("bench.upload"):
            r = torch.from_numpy(rays).to(self.device)
            ids_t = torch.from_numpy(ids).to(self.device)
        with span("bench.frame"):
            out = self.render(self.models, r, ids_t, self.topo)
        with span("bench.fetch"):
            host = {k: t.cpu().numpy() for k, t in out.items()}
        self.done.append((v, host))

    def unit_flops(self) -> float:
        return flops.render_frame_flops(self.spec, self.wh[0] * self.wh[1])

    def end_to_end(self, units: int, window_s: float) -> dict:
        """Pixels of every frame of the window over the whole window."""
        return {"render_rays_per_s": units * self.wh[0] * self.wh[1] / window_s}

    def counters(self):
        return common.program_counters()

    def reset_counters(self) -> None:
        common.reset_program_counters()

    def new_bad(self):
        return None

    def run_unit(self, bad) -> None:
        self._frame(len(self.done))

    def failed(self, bad) -> int:
        return sum(not common.finite_host(h) for _, h in self.done)

    def free(self) -> None:
        self.models = self.render = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _checked(self):
        k = min(common.CHECKED_FRAMES, len(self.done))
        rng = np.random.default_rng(common.seed_parts(self.seed, 4))
        return sorted(rng.choice(len(self.done), size=k, replace=False).tolist())

    def program_readings(self) -> dict:
        return {"frames": [self.done[i][1] for i in self._checked()]}

    def reference(self, rounding: str = "exact") -> dict:
        """The reference's maps of the checked frames, in blocks of rays."""
        no_tf32()
        rnd = ref_model.ROUNDINGS[rounding]
        block = common.REFERENCE_BLOCK
        out = []
        ctx = ref_render.grid_context(self.grid, {**self.weights, **_table(self)})
        for i in self._checked():
            rays, ids = self.frames[self.done[i][0]]
            parts = []
            for a in range(0, len(rays), block):
                r = torch.from_numpy(rays[a:a + block]).to(self.device)
                t = torch.from_numpy(ids[a:a + block]).to(self.device)
                parts.append(ref_render.eval_rays(self.weights, self.spec, ctx, r, t, rnd))
            out.append({k: torch.cat([p[k] for p in parts]) for k in parts[0]})
        return {"frames": out}

    def compare(self, prog: dict, ref: dict):
        from ..compare import render_numbers

        nums = render_numbers(prog, ref)
        if not self.grid_ok:
            nums = {k: float("inf") for k in nums}
        return nums


def _table(drv) -> dict:
    from ..model_spec import LATTICE, TABLE

    if drv.grid is None:
        return {}
    return {TABLE: drv.weights[LATTICE][drv.grid.occupied]}
