"""The `route` traffic: one user rendering views of one object, closed loop,
on the `rays_in_bbox` route of a configuration that bounds its test rays by
the object's box (`use_bbox` with `use_bbox_only_for_test`).

Each frame is one validation view of the object as the program's
`GenericDataset` builds it (`data/generic_dataset.py`): the eye drawn from
the seed in the room's eye range, 1.5-3.0 m from the box's centre and
outside the box, aimed at the centre; every ray bounded by the box, near =
tmin / scale_factor and far = tmax / scale_factor, near = far = 0 for a ray
that misses it; every ray's instance id the box's object. The program
renders the frame with `RenderSettings(rays_in_bbox=True)` through
`make_render_fn`, under the spans of `drivers/render.py`. After the window
the reference (`reference/route.py`) renders the checked frames again, and
`route_numbers` compares them over all pixels and over the box's hits."""

from __future__ import annotations

import math
import sys
from typing import Dict

import numpy as np
import torch

from .. import common, route_flops, scenes
from ..reference import model as ref_model
from ..reference import no_tf32
from ..reference import render as ref_render
from ..reference import route as ref_route
from . import render

# the eye range of `scenes.poses` in the room, and the eye's distance to the box centre
EYE_LO, EYE_HI = np.array([-2.2, -2.2, 0.8]), np.array([2.2, 2.2, 1.8])
EYE_DIST = (1.5, 3.0)


def box_bounds(scene: dict, obj: int) -> np.ndarray:
    """(2, 3) [min; max] in metres of the axis-aligned box of object `obj`
    (`scenes.object_boxes`: 2.2 radii a side)."""
    pos, _, size = scenes.object_boxes(scene)[obj]
    return np.stack([pos - 0.5 * size, pos + 0.5 * size])


def slab_test(bounds: np.ndarray, o: np.ndarray, d: np.ndarray):
    """(hit, tmin, tmax) of rays (o, d) against the box `bounds`, tmin and
    tmax 0 on a miss, a ray from inside the box a miss: a frozen copy of
    `object_nerf_torch/data/geo_utils.py:ray_aabb_intersect`."""
    inv = 1.0 / np.where(d == 0, 1.0e-14, d)
    t0, t1 = (bounds[0] - o) * inv, (bounds[1] - o) * inv
    tmin = np.minimum(t0, t1).max(axis=-1)
    tmax = np.maximum(t0, t1).min(axis=-1)
    hit = (tmin <= tmax) & (tmin >= 0) & (tmax >= 0)
    return hit, np.where(hit, tmin, 0.0), np.where(hit, tmax, 0.0)


def box_rays(scene: dict, bounds: np.ndarray, o: np.ndarray, d: np.ndarray):
    """(rays (N, 8) f32 in the normalised frame, hit (N,) bool) of world rays
    (o, d) bounded by the box: `generic_dataset.py`'s rule under
    `use_bbox_only_for_test`, near = tmin / scale_factor, far = tmax /
    scale_factor, both 0 on a miss."""
    scale = float(scene["scale_factor"])
    hit, tmin, tmax = slab_test(bounds, o, d)
    rays = np.concatenate([(o - np.asarray(scene["scene_center"], np.float64)) / scale, d,
                           (tmin / scale)[:, None], (tmax / scale)[:, None]], -1)
    return rays.astype(np.float32), hit


def route_frames(scene: dict, seed: int, n_views: int, wh, obj: int):
    """`n_views` seeded views of object `obj`: a list of (rays (H*W, 8) f32,
    instance ids (H*W,) int64, all `obj`; hit (H*W,) bool)."""
    rng = np.random.default_rng(common.seed_parts(seed, 5))
    bounds = box_bounds(scene, obj)
    centre = bounds.mean(0)
    w, h = wh
    pix = np.arange(w * h)
    out = []
    for _ in range(n_views):
        while True:
            eye = rng.uniform(EYE_LO, EYE_HI)
            dist = np.linalg.norm(eye - centre)
            inside = bool(np.all((eye >= bounds[0]) & (eye <= bounds[1])))
            if EYE_DIST[0] <= dist <= EYE_DIST[1] and not inside:
                break
        o, d = scenes.pixel_rays(scene, wh, scenes.look_at(eye, centre), pix)
        rays, hit = box_rays(scene, bounds, o, d)
        out.append((rays, np.full(w * h, obj, np.int64), hit))
    return out


class Driver(render.Driver):
    kind = "render"  # a frame is the unit: `render.frame` (metrics/step_host_ms.py)

    def setup(self) -> None:
        from object_nerf_torch.models import voxel_grid as vg
        from object_nerf_torch.models.mlp import ObjectNeRFConfig
        from object_nerf_torch.render.renderer import RenderSettings
        from object_nerf_torch.train.system import init_params, make_render_fn

        cfg, sc, m = self.cfg, self.cfg["scene"], self.cfg["model"]
        tr = self.traffic
        views = route_frames(sc, self.seed, int(tr["views"]), self.wh, int(tr["box_object"]))
        self.frames = [(rays, ids) for rays, ids, _ in views]
        self.hits = [hit for _, _, hit in views]
        for v, hit in enumerate(self.hits):
            if not hit.any():
                raise RuntimeError(f"route view {v} does not see the box")
            print(f"route view {v}: hit share {hit.mean():.6f}", file=sys.stderr)
        self.pcd, self.grid = common.grid_inputs(cfg, self.device)
        self.weights = common.make_weights(self.spec, cfg, self.seed, self.device,
                                           self.grid.n_cells)
        mcfg = ObjectNeRFConfig(**{k: (tuple(m[k]) if k.endswith("skips") else m[k])
                                   for k in ObjectNeRFConfig.__dataclass_fields__})
        dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        settings = RenderSettings(mlp=mcfg, N_samples=m["N_samples"],
                                  N_importance=m["N_importance"], perturb=0.0, noise_std=0.0,
                                  is_eval=True, forward_instance=True, rays_in_bbox=True,
                                  matmul_dtype=dtype)
        features, self.topo, static = vg.build_voxel_grid(
            self.pcd, scene_center=sc["scene_center"], scale_factor=sc["scale_factor"],
            voxel_size_world=sc["voxel_size"], neighbor_marks=sc["neighbor_marks"],
            channels=self.spec.voxel_channels, n_freq_voxel=self.spec.N_freq_voxel,
            n_max_voxels=m["N_max_voxels"], device=self.device)
        self.grid_ok = tuple(static.shape) == self.grid.shape
        self.models = init_params(torch.Generator().manual_seed(0), settings,
                                  {"N_max_objs": m["N_max_objs"]}, device=self.device,
                                  voxel_features=features)
        common.load_weights(self.models, self.weights, self.topo.row_to_cell)
        self.render = make_render_fn(settings, static, chunk=int(tr["chunk"]))
        self.done = []
        for _ in range(int(tr["warmup_frames"])):
            self._frame(0)
        self.done = []

    def unit_flops(self) -> float:
        return route_flops.route_frame_flops(self.spec, self.wh[0] * self.wh[1])

    def reference(self, rounding: str = "exact") -> dict:
        """The reference's maps of the checked frames, in blocks of rays, each
        frame with its rays' `hit` of the box."""
        no_tf32()
        rnd = ref_model.ROUNDINGS[rounding]
        block = common.REFERENCE_BLOCK
        ctx = ref_render.grid_context(self.grid, {**self.weights, **render._table(self)})
        out = []
        for i in self._checked():
            v = self.done[i][0]
            rays, ids = self.frames[v]
            parts = []
            for a in range(0, len(rays), block):
                r = torch.from_numpy(rays[a:a + block]).to(self.device)
                t = torch.from_numpy(ids[a:a + block]).to(self.device)
                parts.append(ref_route.eval_rays(self.weights, self.spec, ctx, r, t, rnd))
            maps = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
            maps["hit"] = torch.from_numpy(self.hits[v])
            out.append(maps)
        return {"frames": out}

    def compare(self, prog: dict, ref: dict):
        nums = route_numbers(prog, ref)
        if not self.grid_ok:
            nums = {k: math.inf for k in nums}
        return nums


# the scene composite's colour and the object composite's (on its white background)
ROUTE_MAPS = {"rgb_rmse": "rgb_fine", "inst_rgb_rmse": "rgb_instance_fine"}


def route_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """Over the checked frames, for each number of `ROUTE_MAPS`: the root
    mean square gap of its map between the program and the reference over
    all pixels, and (`hit_` before its name) over the pixels whose ray hits
    the box (the reference frame's `hit`). The misses, most of a frame, stay
    in the first two: their output is defined (module docstring of
    `reference/route.py`), but they would dilute a gap on the object."""
    names = list(ROUTE_MAPS) + [f"hit_{k}" for k in ROUTE_MAPS]
    bad = dict.fromkeys(names, math.inf)
    if not prog["frames"] or len(prog["frames"]) != len(ref["frames"]):
        return bad
    gaps = {k: [] for k in names}
    for p, r in zip(prog["frames"], ref["frames"]):
        hit = torch.as_tensor(r["hit"]).cpu()
        for k, key in ROUTE_MAPS.items():
            if key not in p:
                return bad
            want = torch.as_tensor(r[key]).double().cpu()
            d = torch.as_tensor(p[key]).double().cpu() - want
            if d.shape != want.shape or not torch.isfinite(d).all():
                return bad
            gaps[k].append(d)
            gaps[f"hit_{k}"].append(d[hit])
    out = {}
    for k, parts in gaps.items():
        d = torch.cat(parts)
        if not len(d):
            return bad  # the checked frames show no hit of the box
        out[k] = float((d ** 2).mean().sqrt())
    return out
