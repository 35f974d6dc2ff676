"""The `desk_edit` traffic: one user editing the desk of the ToyDesk 2 demo
interactively, closed loop, through `EditableRenderer.render_edit` on a
voxel-conditioned model. The desk's objects `moved` are carved out of the
background and drawn again, each turned about its box's z axis by the
demo's `pure_rotation` at a progress drawn from the seed for each frame (one
progress for all of them, as in the demo), seen from the seeded views of
`desk.poses` in turn (`views` of them): K = 1 + len(moved) ray sets a frame.
A frame's latency is the host time from setting the objects' poses to its
maps on the host, as in `edit.py`. After the window, `common.CHECKED_FRAMES`
frames drawn from the seed are rendered again by `reference/voxel_edit.py`
and compared; `object_hit` is the union of the moved objects' box hits."""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from .. import common, desk
from ..harness import span
from ..model_spec import Spec
from ..reference import model as ref_model
from ..reference import no_tf32
from ..reference import render as ref_render
from ..reference import voxel
from ..reference import voxel_edit as ref_voxel_edit
from . import edit, render


class Driver(edit.Driver):
    kind = "edit"  # a frame is the unit: `edit.frame` (metrics/step_host_ms.py)

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.spec = Spec.from_config(cfg["model"])
        self.wh = tuple(traffic["img_wh"])
        self.moved = [int(i) for i in traffic["moved"]]
        if traffic["edit_type"] != "pure_rotation":
            raise ValueError(f"the desk edit traffic turns objects: {traffic['edit_type']!r}")
        self.fovx = math.degrees(2 * math.atan(0.5 / cfg["scene"]["focal_frac"]))

    def setup(self) -> None:
        from object_nerf_torch.config import Config, load_config
        from object_nerf_torch.edit.editable_renderer import EditableRenderer
        from object_nerf_torch.models import voxel_grid as vg
        from object_nerf_torch.models.mlp import ObjectNeRFConfig
        from object_nerf_torch.render.renderer import RenderSettings
        from object_nerf_torch.train.system import init_params

        cfg, sc, m, tr = self.cfg, self.cfg["scene"], self.cfg["model"], self.traffic
        if not m["use_voxel_embedding"]:
            raise ValueError("the desk edit traffic serves the voxel model")
        rng = np.random.default_rng(common.seed_parts(self.seed, 5))
        self.poses = desk.poses(sc, rng, int(tr["views"]))
        self.progress = rng.uniform(0.0, 1.0, int(tr["progress_draws"]))
        self.boxes = desk.object_boxes(sc)
        self.pcd = desk.pcd(sc)
        self.grid = voxel.build(self.pcd, sc, self.device)
        self.weights = common.make_weights(self.spec, cfg, self.seed, self.device,
                                           self.grid.n_cells)
        features, topo, static = vg.build_voxel_grid(
            self.pcd, scene_center=sc["scene_center"], scale_factor=sc["scale_factor"],
            voxel_size_world=sc["voxel_size"], neighbor_marks=sc["neighbor_marks"],
            channels=self.spec.voxel_channels, n_freq_voxel=self.spec.N_freq_voxel,
            n_max_voxels=m["N_max_voxels"], device=self.device)
        self.grid_ok = tuple(static.shape) == self.grid.shape
        mcfg = ObjectNeRFConfig(**{k: (tuple(m[k]) if k.endswith("skips") else m[k])
                                   for k in ObjectNeRFConfig.__dataclass_fields__})
        settings = RenderSettings(mlp=mcfg, N_samples=m["N_samples"],
                                  N_importance=m["N_importance"])
        models = init_params(torch.Generator().manual_seed(0), settings,
                             {"N_max_objs": m["N_max_objs"]}, device=self.device,
                             voxel_features=features)
        common.load_weights(models, self.weights, topo.row_to_cell)
        ckpt = load_config(cli_args=common.model_keys(cfg) + [
            f"dataset_extra.near={sc['near']}", f"dataset_extra.far={sc['far']}",
            f"dataset_extra.scale_factor={sc['scale_factor']}",
            "dataset_extra.scene_center=[" + ",".join(map(str, sc["scene_center"])) + "]",
        ]).to_dict()
        ckpt["dataset_name"] = "toydesk"
        with tempfile.TemporaryDirectory() as tmp:  # the boxes are read here, once
            path = os.path.join(tmp, "bbox.json")
            with open(path, "w") as f:
                json.dump({"labels": [
                    {"id": int(i), "data": {"position": [float(x) for x in b[0]],
                                            "quaternion": [float(x) for x in b[1]],
                                            "scale": [float(x) for x in b[2]]}}
                    for i, b in self.boxes.items()]}, f)
            ckpt["dataset_extra"]["bbox_dir"] = path
            self.renderer = EditableRenderer(Config({"ckpt_config": ckpt,
                                                     "chunk": int(tr["chunk"])}),
                                             models=models, device=self.device,
                                             voxel_grid=(topo, static))
            self.renderer.remove_scene_object_by_ids(self.moved)  # reads each moved box
        self._hit_shares()
        self.done, self.latency = [], []
        for _ in range(int(tr["warmup_frames"])):
            self._frame(0)
        self.done, self.latency = [], []

    def _hit_shares(self) -> None:
        """Each view's share of pixels whose ray hits a moved box, at progress
        0.5 (no turn), on stderr."""
        shares = []
        for v, c2w in enumerate(self.poses):
            _, hit = ref_voxel_edit.ray_sets(self.cfg["scene"], self.boxes, self.wh, c2w,
                                             self.fovx, self.moved, self._edits(0.5))
            shares.append(float(hit.mean()))
            print(f"desk edit view {v}: hit share {shares[-1]:.6f}", file=sys.stderr)
        print(f"desk edit views: mean hit share {np.mean(shares):.6f}", file=sys.stderr)

    def _edits(self, p: float):
        pose = desk.pure_rotation(p)
        return {oid: pose for oid in self.moved}

    def _frame(self, i: int):
        v, p = i % len(self.poses), float(self.progress[i % len(self.progress)])
        twc = np.eye(4)
        twc[:3] = self.poses[v]
        w, h = self.wh
        t0 = time.perf_counter()
        with span("bench.edit"):
            r = self.renderer
            r.reset_active_object_ids()
            for oid, pose in self._edits(p).items():
                r.set_object_pose_transform(oid, pose, 0)
            out = r.render_edit(h, w, twc, self.fovx, chunk=int(self.traffic["chunk"]))
        self.latency.append(time.perf_counter() - t0)
        self.done.append((v, p, out))

    def reference(self, rounding: str = "exact") -> dict:
        no_tf32()
        rnd = ref_model.ROUNDINGS[rounding]
        block = common.REFERENCE_BLOCK
        sc, out = self.cfg["scene"], []
        ctx = ref_render.grid_context(self.grid, {**self.weights, **render._table(self)})
        for i in self._checked():
            v, p, _ = self.done[i]
            sets, hit = ref_voxel_edit.ray_sets(sc, self.boxes, self.wh, self.poses[v],
                                                self.fovx, self.moved, self._edits(p))
            parts = []
            for a in range(0, len(hit), block):
                blk = [(torch.from_numpy(r[a:a + block]).to(self.device), oid)
                       for r, oid in sets]
                parts.append(ref_voxel_edit.render(self.weights, self.spec, ctx, sc,
                                                   self.boxes, self.moved, blk, rnd))
            maps = {k: torch.cat([q[k] for q in parts]) for k in parts[0]}
            maps["object_hit"] = torch.from_numpy(hit)
            out.append(maps)
        return {"frames": out}

    def compare(self, prog: dict, ref: dict):
        nums = super().compare(prog, ref)
        if not self.grid_ok:
            nums = {k: math.inf for k in nums}
        return nums
