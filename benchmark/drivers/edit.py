"""The `edit` traffic: one user editing interactively, closed loop, through
`EditableRenderer.render_edit`. The scene's objects are ToyDesk boxes around
its spheres; object `moved` is carved out of the background and drawn again
on the demo's duplication trajectory at a progress drawn from the seed for
each frame, seen from the seeded orbit's views in turn (`views` of them).
A frame's latency is the host time from setting the object's pose to its
maps on the host. After the window, `common.CHECKED_FRAMES` frames drawn from the
seed are rendered again by the reference and compared."""

from __future__ import annotations

import gc
import json
import math
import os
import tempfile
import time

import numpy as np
import torch

from .. import common, flops, scenes
from ..harness import span
from ..model_spec import Spec
from ..reference import edit as ref_edit
from ..reference import model as ref_model
from ..reference import no_tf32


class Driver:
    kind = "edit"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.spec = Spec.from_config(cfg["model"])
        self.wh = tuple(traffic["img_wh"])
        self.moved = int(traffic["moved"])
        self.fovx = math.degrees(2 * math.atan(0.5 / cfg["scene"]["focal_frac"]))

    def setup(self) -> None:
        from object_nerf_torch.config import Config, load_config
        from object_nerf_torch.edit.editable_renderer import EditableRenderer
        from object_nerf_torch.models.mlp import ObjectNeRFConfig
        from object_nerf_torch.render.renderer import RenderSettings
        from object_nerf_torch.train.system import init_params

        cfg, sc, m, tr = self.cfg, self.cfg["scene"], self.cfg["model"], self.traffic
        if m["use_voxel_embedding"]:
            raise ValueError("the edit traffic serves the classical model")
        rng = np.random.default_rng(common.seed_parts(self.seed, 5))
        self.poses = scenes.poses(sc, rng, int(tr["views"]))
        self.progress = rng.uniform(0.0, 1.0, int(tr["progress_draws"]))
        self.boxes = scenes.object_boxes(sc)
        self.weights = common.make_weights(self.spec, cfg, self.seed, self.device)
        mcfg = ObjectNeRFConfig(**{k: (tuple(m[k]) if k.endswith("skips") else m[k])
                                   for k in ObjectNeRFConfig.__dataclass_fields__})
        models = init_params(torch.Generator().manual_seed(0), RenderSettings(mlp=mcfg),
                             {"N_max_objs": m["N_max_objs"]}, device=self.device)
        common.load_weights(models, self.weights)
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
                                             models=models, device=self.device)
            self.renderer.remove_scene_object_by_ids([self.moved])
            self.renderer.set_object_pose_transform(self.moved, np.eye(4), 0)
        self.done, self.latency = [], []
        for _ in range(int(tr["warmup_frames"])):
            self._frame(0)
        self.done, self.latency = [], []

    def _frame(self, i: int):
        v, p = i % len(self.poses), float(self.progress[i % len(self.progress)])
        twc = np.eye(4)
        twc[:3] = self.poses[v]
        w, h = self.wh
        t0 = time.perf_counter()
        with span("bench.edit"):
            r = self.renderer
            r.reset_active_object_ids()
            r.set_object_pose_transform(self.moved, scenes.duplication_pose(p), 0)
            out = r.render_edit(h, w, twc, self.fovx, chunk=int(self.traffic["chunk"]))
        self.latency.append(time.perf_counter() - t0)
        self.done.append((v, p, out))

    def unit_flops(self) -> float:
        return flops.render_frame_flops(self.spec, self.wh[0] * self.wh[1])

    def end_to_end(self, units: int, window_s: float) -> dict:
        """The 95th percentile of every frame's latency in the window, in ms."""
        return {"edit_frame_p95_ms": 1e3 * float(np.percentile(self.latency, 95))}

    def counters(self):
        return common.program_counters()

    def reset_counters(self) -> None:
        common.reset_program_counters()

    def new_bad(self):
        return None

    def run_unit(self, bad) -> None:
        self._frame(len(self.done))

    def failed(self, bad) -> int:
        return sum(not common.finite_host(o) for _, _, o in self.done)

    def free(self) -> None:
        self.renderer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _checked(self):
        k = min(common.CHECKED_FRAMES, len(self.done))
        rng = np.random.default_rng(common.seed_parts(self.seed, 6))
        return sorted(rng.choice(len(self.done), size=k, replace=False).tolist())

    def program_readings(self) -> dict:
        return {"frames": [self.done[i][2] for i in self._checked()]}

    def reference(self, rounding: str = "exact") -> dict:
        no_tf32()
        rnd = ref_model.ROUNDINGS[rounding]
        block = common.REFERENCE_BLOCK
        sc, out = self.cfg["scene"], []
        for i in self._checked():
            v, p, _ = self.done[i]
            sets = ref_edit.ray_sets(sc, self.boxes, self.wh, self.poses[v], self.fovx,
                                     self.moved, scenes.duplication_pose(p))
            parts = []
            for a in range(0, len(sets[0][0]), block):
                blk = [(torch.from_numpy(r[a:a + block]).to(self.device), oid)
                       for r, oid in sets]
                parts.append(ref_edit.render(self.weights, self.spec, sc, self.boxes,
                                             [self.moved], blk, rnd))
            maps = {k: torch.cat([q[k] for q in parts]) for k in parts[0]}
            maps["object_hit"] = torch.from_numpy(sets[1][0][:, 7] > 0)
            out.append(maps)
        return {"frames": out}

    def compare(self, prog: dict, ref: dict):
        from ..compare import edit_numbers

        return edit_numbers(prog, ref)
