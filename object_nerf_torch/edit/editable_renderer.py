"""Editable scene renderer: move / rotate / duplicate / remove objects.

Counterpart of `object_nerf_tpu/edit/editable_renderer.py` (reference
`EditableRenderer`, render_tools/editable_renderer.py:52-332):

* edit state: `active_object_ids` (0 = background), per-(object,
  duplication) pose transforms, per-object `BBoxRayHelper`s,
  `object_to_remove` -> background carve-out boxes;
* `render_edit(h, w, Twc, fovx)`: per active object, the user pose is
  conjugated into the object's canonical frame,
  `transform = inv(Tow_orig) @ user_pose @ Tow_orig`, `Tow = inv(transform)`:
  **object motion is implemented by counter-transforming the camera rays**;
  one ray set per object with box-clipped near/far (0/0 on a miss, hence
  muted samples), then joint sort-merge compositing (`render/multi.py`);
* `render_origin` renders the unedited scene through the same path;
* `load_frame_meta` reads dataset camera poses (+fov) for demo trajectories.

Pose math and the ray-box intersections stay on the host (numpy, once per
frame). A frame is the span `edit.frame` of `utils/trace.py`, its host steps
the spans `edit.rays`, `edit.compact`, `edit.upload` and `edit.fetch`, and its
chunks the counters `edit.chunks` and `edit.chunks_mixed`. A frame's rays are
uploaded once, the kernel weights are packed once, every chunk goes through
`render_multi_fused_eval` (the CUDA kernels on `device=cuda`, their plain
versions on `device=cpu`), the chunks' maps stay on the device and come back
in one copy per frame. The kernels mask a ragged
last tile themselves, so the tail chunk is not padded. A voxel-conditioned
model brings its grid (from a port checkpoint's `voxel_topo` /
`voxel_static`, or a reference `.ckpt`'s buffers; JAX: editable_renderer.py:
150-190); its corner table is built once per frame, in bf16 on the card,
and every chunk's lookups read it (:271-291). Under a `torch.distributed`
process group (JAX: the renderer's `mesh`, :70-142, :385-388) each rank
renders the chunks `r, r + W, ...` of the compacted order, so the mixed
chunks spread over the ranks, and one all-gather gives every rank the frame.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List

import numpy as np
import torch

from ..config import Config
from ..data.geo_utils import center_pose_from_avg
from ..data.ray_utils import get_ray_directions, get_rays
from ..device import resolve_device
from ..models import voxel_grid as vg
from ..parallel import mesh
from ..render.multi import compact_hit_order, pack_multi_weights, render_multi_fused_eval
from ..render.renderer import RenderSettings
from ..utils import trace
from .bbox import BBoxRayHelper, boxes_to_arrays


def read_testing_config(cli_args=None, config_path=None) -> Config:
    """Edit-time config: edit yaml < CLI, then the checkpoint's training
    snapshot (`run_config_snapshot.yaml` beside it) under `ckpt_config`
    (editable_renderer.py:25-49)."""
    cli = Config.from_dotlist(cli_args or [])
    if config_path is None:
        config_path = cli["config"]
    cfg = Config.from_yaml(config_path)
    cfg.merge(cli)

    ckpt_dir = os.path.dirname(os.path.abspath(cfg.ckpt_path))
    ckpt_conf_path = os.path.join(ckpt_dir, "run_config_snapshot.yaml")
    cfg["ckpt_config_path"] = ckpt_conf_path
    cfg["ckpt_config"] = Config.from_yaml(ckpt_conf_path).to_dict()
    pcd_file = os.path.join(ckpt_dir, "pcd.ply")
    if os.path.exists(pcd_file):
        cfg.ckpt_config.dataset_extra.pcd_path = pcd_file
    return cfg


class EditableRenderer:
    def __init__(self, config, models=None, device=None, voxel_grid=None):
        """config: the merged edit config (`read_testing_config`). `models`:
        an `ObjectNeRFModels` to render (tests inject fresh weights), with
        `voxel_grid` = (topology, static) when it is voxel-conditioned; else
        `config.ckpt_path` is loaded, one of the port's checkpoints or a
        reference `.ckpt`, with its grid. Runs on `device` (default:
        `config.device`, else `cuda`). `tpu.compact_edit_rays` (the key of
        the edit configs that both packages read; default on) turns hit
        compaction off for the dense composite."""
        self.config = config
        self.ckpt_config = Config(config.ckpt_config)
        self.device = resolve_device(device if device is not None
                                     else config.get("device"))

        dataset_extra = self.ckpt_config.dataset_extra
        self.near = float(config.get("near", dataset_extra.near))
        self.far = float(config.get("far", dataset_extra.far))
        self.scale_factor = float(dataset_extra.scale_factor)
        self.pose_avg = np.concatenate(
            [np.eye(3), np.array(dataset_extra["scene_center"])[:, None]], 1)

        self.use_voxel = bool(self.ckpt_config.model.get("use_voxel_embedding", True))
        self.compact_rays = bool(
            dict(config.get("tpu", {}) or {}).get("compact_edit_rays", True))
        # the CUDA kernels compute in bf16; the CPU path is the exact f32 one
        self.settings = RenderSettings.from_config(
            self.ckpt_config, is_eval=True,
            matmul_dtype=torch.bfloat16 if self.device.type == "cuda" else torch.float32)

        self.voxel_topo, self.voxel_static = None, None
        if models is None:
            models, voxel_grid = self._load_model(config.ckpt_path)
        if self.use_voxel != (voxel_grid is not None):
            raise ValueError("a voxel-conditioned model renders with its voxel_grid "
                             "(topology, static), and no other model takes one")
        self.models = models.to(self.device).eval()
        if voxel_grid is not None:
            self.voxel_topo = voxel_grid[0].to(self.device)
            self.voxel_static = voxel_grid[1]

        self.object_to_remove: List[int] = []
        self.active_object_ids: List[int] = [0]
        self.object_pose_transform: Dict[str, np.ndarray] = {}
        self.object_bbox_ray_helpers: Dict[str, BBoxRayHelper] = {}
        self.bbox_enlarge = 0.0
        # chunks of the last frame, and how many of them rendered every ray set
        # (the others rendered the background set alone)
        self.last_chunk_plan: Dict[str, int] = {"chunks": 0, "mixed": 0}

    # -- model loading ---------------------------------------------------------
    def _load_model(self, ckpt_path):
        """(models, voxel grid (topology, static) or None) from a port
        checkpoint or a reference `.ckpt`: a voxel model's table rows are
        indexed by the checkpoint's own topology, which comes along."""
        from ..train.convert import load_reference_ckpt, voxel_grid_from_ckpt
        from ..train.system import init_params

        sd, voxel = load_reference_ckpt(ckpt_path, with_voxel=True)
        if (voxel is not None) != self.use_voxel:
            raise ValueError(f"{ckpt_path} holds {'a' if voxel is not None else 'no'} voxel "
                             f"grid, but model.use_voxel_embedding is {self.use_voxel}")
        features, grid = None, None
        if voxel is not None:
            features, topo, static = voxel_grid_from_ckpt(
                voxel, int(self.ckpt_config.model.N_freq_voxel))
            grid = (topo, static)
        models = init_params(torch.Generator().manual_seed(0), self.settings,
                             self.ckpt_config.model, device="cpu", voxel_features=features)
        models.load_state_dict(sd)
        return models, grid

    # -- frame metadata ----------------------------------------------------------
    def load_frame_meta(self):
        dataset_extra = self.ckpt_config.dataset_extra
        with open(os.path.join(dataset_extra.root_dir, "transforms_full.json")) as f:
            self.dataset_meta = json.load(f)
        self.fov_x_deg_dataset = self.dataset_meta["camera_angle_x"] * 180 / np.pi
        fix_rot = np.array([1, 0, 0, 0, -1, 0, 0, 0, -1]).reshape(3, 3)
        poses, idxs = [], []
        for frame in self.dataset_meta["frames"]:
            pose = np.array(frame["transform_matrix"])
            pose[:3, :3] = pose[:3, :3] @ fix_rot
            poses.append(pose)
            idxs.append(frame["idx"])
        order = np.argsort(np.array(idxs))
        self.poses = np.array(poses)[order]

    def get_camera_pose_by_frame_idx(self, frame_idx):
        return self.poses[frame_idx]

    # -- edit state -----------------------------------------------------------
    def remove_scene_object_by_ids(self, obj_ids):
        self.object_to_remove = list(obj_ids)
        for obj_id in obj_ids:
            self.initialize_object_bbox(obj_id)

    def reset_active_object_ids(self):
        self.active_object_ids = [0]

    def set_object_pose_transform(self, obj_id: int, pose: np.ndarray, obj_dup_id: int = 0):
        self.active_object_ids.append(obj_id)
        if str(obj_id) not in self.object_bbox_ray_helpers:
            self.initialize_object_bbox(obj_id)
        self.object_pose_transform[f"{obj_id}_{obj_dup_id}"] = pose

    def initialize_object_bbox(self, obj_id: int):
        self.object_bbox_ray_helpers[str(obj_id)] = BBoxRayHelper(
            self.config.get("ckpt_config_path", Config(
                {"dataset_name": self.ckpt_config.dataset_name,
                 "dataset_extra": self.ckpt_config.dataset_extra})),
            obj_id)

    def get_object_bbox_helper(self, obj_id: int):
        return self.object_bbox_ray_helpers[str(obj_id)]

    def get_skipping_bbox_helper(self):
        return {str(i): self.object_bbox_ray_helpers[str(i)] for i in self.object_to_remove}

    # -- ray generation ----------------------------------------------------------
    def generate_rays(self, obj_id: int, rays_o, rays_d):
        """(N, 8) rays; objects get box-clipped near/far, misses get 0/0
        (editable_renderer.py:153-181)."""
        n = len(rays_o)
        if obj_id == 0:
            near = np.full((n, 1), self.near / self.scale_factor, np.float32)
            far = np.full((n, 1), self.far / self.scale_factor, np.float32)
        else:
            hit, near, far = self.object_bbox_ray_helpers[str(obj_id)] \
                .get_ray_bbox_intersections(rays_o, rays_d, self.scale_factor,
                                            bbox_enlarge=self.bbox_enlarge)
            near = np.where(hit[:, None], near, 0.0).astype(np.float32)
            far = np.where(hit[:, None], far, 0.0).astype(np.float32)
        return np.concatenate(
            [rays_o.astype(np.float32), rays_d.astype(np.float32), near, far], -1)

    # -- rendering ------------------------------------------------------------
    def _render_multi(self, rays_list, obj_ids, white_back, chunk) -> Dict[str, np.ndarray]:
        """K ray sets (N, 8) of one frame (host arrays) -> the final pass's
        maps as host arrays, in pixel order."""
        n = rays_list[0].shape[0]
        dev = self.device
        settings = dataclasses.replace(self.settings, white_back=white_back, perturb=0.0,
                                       noise_std=0.0, is_eval=True)

        # hit compaction: reorder the pixels so that object-box hits are
        # contiguous; the all-miss chunks then render the background set alone
        # (1e-8 away from the dense composite, see compact_hit_order)
        with trace.span("edit.compact"):
            plan = compact_hit_order(rays_list, obj_ids, chunk) if self.compact_rays else None
            if plan is not None:
                rays_list = [np.asarray(r)[plan[0]] for r in rays_list]
        with trace.span("edit.upload"):
            skip_helpers = self.get_skipping_bbox_helper()
            skip_boxes = None
            if skip_helpers:
                a, b, s = boxes_to_arrays(skip_helpers, self.scale_factor)
                skip_boxes = (torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev), s)
            rays_dev = [torch.from_numpy(np.ascontiguousarray(r, np.float32)).to(dev)
                        for r in rays_list]
            perm = torch.from_numpy(plan[0]).to(dev) if plan is not None else None
        packed = pack_multi_weights(self.models, settings, obj_ids) \
            if dev.type == "cuda" else None
        voxel_ctx = None
        if self.use_voxel:  # one corner table per frame, read by every chunk
            features = self.models.voxel_features.detach()
            voxel_ctx = (features, self.voxel_topo, self.voxel_static)
            if vg.dense_path_ok(self.voxel_static):
                voxel_ctx += (vg.CornerTable(
                    features, self.voxel_topo, self.voxel_static,
                    lowp=settings.matmul_dtype == torch.bfloat16),)

        n_chunks = -(-n // chunk)
        self.last_chunk_plan = {"chunks": n_chunks,
                                "mixed": n_chunks if plan is None else plan[1]}
        trace.count("edit.chunks", n_chunks)
        trace.count("edit.chunks_mixed", self.last_chunk_plan["mixed"])

        def render_chunk(ci):
            mixed = plan is None or ci < plan[1]
            sets = rays_dev if mixed else rays_dev[:1]
            return render_multi_fused_eval(
                self.models, [r[ci * chunk:(ci + 1) * chunk] for r in sets],
                list(obj_ids) if mixed else [0], settings, skip_boxes=skip_boxes,
                packed=packed, voxel_ctx=voxel_ctx)

        merged = mesh.render_chunks(n, chunk, render_chunk)
        with trace.span("edit.fetch"):  # waits for the frame's device work
            if perm is not None:
                # scatter back to pixel order: row j carries ray perm[j]
                merged = {k: torch.empty_like(v).index_copy_(0, perm, v)
                          for k, v in merged.items()}
            return {k: v.cpu().numpy() for k, v in merged.items()}

    def edit_ray_sets(self, h: int, w: int, camera_pose_Twc: np.ndarray,
                      fovx_deg: float = 70):
        """The frame's ray sets under the current edit state: (K arrays
        (h*w, 8), their object ids), one set per active object."""
        focal = (w / 2) / np.tan((fovx_deg / 2) / (180 / np.pi))
        directions = get_ray_directions(h, w, focal)
        Twc = center_pose_from_avg(self.pose_avg, camera_pose_Twc)

        obj_ids, rays_list, processed = [], [], []
        for obj_id in self.active_object_ids:
            dup_cnt = int(np.sum(np.array(processed) == obj_id))
            if obj_id == 0:
                Tow = np.eye(4)
            else:
                object_pose = self.object_pose_transform[f"{obj_id}_{dup_cnt}"]
                Tow_orig = self.get_object_bbox_helper(obj_id).get_world_to_object_transform()
                # counter-transform the rays (editable_renderer.py:246-249)
                transform = np.linalg.inv(Tow_orig) @ object_pose @ Tow_orig
                Tow = np.linalg.inv(transform)
            processed.append(obj_id)
            Toc = Tow @ Twc
            Toc[:, 3] /= self.scale_factor
            rays_o, rays_d = get_rays(directions, Toc[:3, :4].astype(np.float32))
            rays_list.append(self.generate_rays(obj_id, rays_o, rays_d))
            obj_ids.append(obj_id)
        return rays_list, obj_ids

    def render_edit(self, h: int, w: int, camera_pose_Twc: np.ndarray, fovx_deg: float = 70,
                    render_bg_only: bool = False, render_obj_only: bool = False,
                    white_back: bool = False, chunk: int = 4096) -> Dict[str, np.ndarray]:
        """Render the edited scene from `camera_pose_Twc` (4, 4): `rgb_*`
        (h*w, 3), `depth_*`, `opacity_*` of the final pass. Hit compaction
        follows `self.compact_rays`."""
        with trace.span("edit.frame"):
            if render_bg_only:
                self.active_object_ids = [0]
            if render_obj_only:
                self.active_object_ids = [i for i in self.active_object_ids if i != 0]
            with trace.span("edit.rays"):
                rays_list, obj_ids = self.edit_ray_sets(h, w, camera_pose_Twc, fovx_deg)
            return self._render_multi(rays_list, obj_ids, white_back, chunk)

    def render_origin(self, h: int, w: int, camera_pose_Twc: np.ndarray,
                      fovx_deg: float = 70, chunk: int = 4096) -> Dict[str, np.ndarray]:
        focal = (w / 2) / np.tan((fovx_deg / 2) / (180 / np.pi))
        directions = get_ray_directions(h, w, focal)
        Twc = center_pose_from_avg(self.pose_avg, camera_pose_Twc)
        Twc[:, 3] /= self.scale_factor
        rays_o, rays_d = get_rays(directions, Twc[:3, :4].astype(np.float32))
        rays = self.generate_rays(0, rays_o, rays_d)
        return self._render_multi([rays], [0], False, chunk)
