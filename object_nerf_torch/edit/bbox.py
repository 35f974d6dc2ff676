"""Object bounding-box helpers for editable rendering.

Own copy of `object_nerf_tpu/edit/bbox.py` (numpy, host side). Parity with
the reference `BBoxRayHelper` (utils/bbox_utils.py:9-207):

* ScanNet: axis-aligned detection bboxes `(cx,cy,cz,dx,dy,dz,obj_id)` from
  `{scene_id}_bbox.npy`, world->box via the scan's `axisAlignment` matrix;
  `bbox_c` recenter for the object frame.
* ToyDesk: oriented bboxes from json (position, quaternion, scale);
  `axis_align_mat = inv([R|t])`.
* `get_ray_bbox_intersections`: rays (NeRF-normalized) -> unscale ->
  de-center (scene_center) -> box frame -> slab test -> near/far rescaled.
* `check_xyz_in_bounds` / `check_in_any_boxes_np`: point-in-box tests used
  to carve removed objects out of the background; `boxes_to_arrays` packs the
  boxes for the same test on the device (`render/multi.py:_in_any_box`).
"""

from __future__ import annotations

import copy
import json
import os
from typing import Dict

import numpy as np

from ..data.geo_utils import ray_aabb_intersect
from ..config import Config


def _quat_to_rot(q):
    """Quaternion (x, y, z, w) -> rotation matrix (scipy convention)."""
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1 - (xx + yy)],
        ]
    )


class BBoxRayHelper:
    def __init__(self, dataset_config, instance_id: int):
        """dataset_config: path to a config yaml (the training snapshot) or a
        Config object with dataset_name/dataset_extra."""
        if isinstance(dataset_config, (str, os.PathLike)):
            full_conf = Config.from_yaml(dataset_config)
        else:
            full_conf = dataset_config
        self.conf = full_conf["dataset_extra"]
        self.scale_factor = float(self.conf["scale_factor"])
        self.instance_id = int(instance_id)
        self.dataset_name = full_conf["dataset_name"]

        if self.dataset_name == "scannet_base":
            self.scene_id = self.conf["scene_id"]
            self._read_bbox_scannet()
        elif self.dataset_name == "toydesk":
            self._read_bbox_desk()
        else:
            raise ValueError(f"unsupported dataset {self.dataset_name!r}")

    # -- loading -------------------------------------------------------------
    def _read_bbox_scannet(self):
        scene_info_file = os.path.join(
            self.conf["scans_dir"], f"{self.scene_id}/{self.scene_id}.txt"
        )
        for line in open(scene_info_file):
            if "axisAlignment" in line:
                vals = [
                    float(x)
                    for x in line.rstrip().strip("axisAlignment = ").split(" ")
                ]
                self.axis_align_mat = np.array(vals).reshape(4, 4)
                break
        scene_bbox = np.load(
            os.path.join(self.conf["bbox_dir"], f"{self.scene_id}_bbox.npy")
        )
        center = None
        for b in scene_bbox:
            if int(b[6]) != self.instance_id:
                continue
            half = np.array([b[3], b[4], b[5]]) * 0.5
            center = np.array([b[0], b[1], b[2]])
            self.bbox_bounds = np.array([center - half, center + half])
        if center is None:
            raise ValueError(f"instance {self.instance_id} not in bbox file")
        self.bbox_c = center
        self.pose_avg = np.eye(4)
        self.pose_avg[:3, 3] = np.array(self.conf["scene_center"])

    def _read_bbox_desk(self):
        with open(self.conf["bbox_dir"]) as f:
            labels = json.load(f)["labels"]
        for l in labels:
            if int(l["id"]) != self.instance_id or "position" not in l["data"]:
                continue
            pos = np.array(l["data"]["position"])
            rmat = _quat_to_rot(l["data"]["quaternion"])
            scale = np.array(l["data"]["scale"])
            self.bbox_c = pos
            m = np.eye(4)
            m[:3, :3] = rmat
            m[:3, 3] = pos
            self.axis_align_mat = np.linalg.inv(m)
            self.bbox_bounds = np.array([-scale / 2, scale / 2])
            break
        else:
            raise ValueError(f"instance {self.instance_id} not in bbox json")
        self.pose_avg = np.eye(4)
        self.pose_avg[:3, 3] = np.array(self.conf["scene_center"])

    # -- transforms ----------------------------------------------------------
    def get_axis_align_mat(self, rescaled=False):
        if rescaled:
            m = copy.deepcopy(self.axis_align_mat)
            m[:3, 3] /= self.scale_factor
            return m
        return self.axis_align_mat

    def get_world_to_object_transform(self):
        """Tow: recenter o axis_align o pose_avg (bbox_utils.py:34-39)."""
        recenter = np.eye(4)
        if self.dataset_name == "scannet_base":
            recenter[:3, 3] = -self.bbox_c
        return recenter @ self.axis_align_mat @ self.pose_avg

    def world_to_box_affine(self):
        """Single (4,4) affine: NeRF-scaled xyz*scale -> box coords."""
        return self.axis_align_mat @ self.pose_avg

    def _to_box_coords(self, rays_o, rays_d, scale_factor):
        rays_o = rays_o * scale_factor
        T = self.pose_avg
        o = rays_o @ T[:3, :3].T + T[:3, 3]
        A = self.axis_align_mat
        o = o @ A[:3, :3].T + A[:3, 3]
        # parity quirk: directions use the *unrotated* camera dirs through
        # axis_align only (bbox_utils.py:112-116 applies A to rays_d, not
        # the pose_avg-rotated ones - pose_avg rot is identity here anyway)
        d = rays_d @ A[:3, :3].T
        return o, d

    def get_ray_bbox_intersections(
        self, rays_o, rays_d, scale_factor=None, bbox_enlarge: float = 0.0
    ):
        """Returns (hit (N,), near (N,1), far (N,1)) in NeRF scale."""
        if scale_factor is None:
            scale_factor = self.scale_factor
        o, d = self._to_box_coords(np.asarray(rays_o), np.asarray(rays_d),
                                   scale_factor)
        bounds = copy.deepcopy(self.bbox_bounds)
        if bbox_enlarge > 0:
            bounds[0] -= bbox_enlarge
            bounds[1] += bbox_enlarge
        hit, tmin, tmax = ray_aabb_intersect(bounds, o, d)
        return (
            hit,
            (tmin / scale_factor)[:, None].astype(np.float32),
            (tmax / scale_factor)[:, None].astype(np.float32),
        )

    def check_xyz_in_bounds(self, xyz, scale_factor=None, bbox_enlarge=0.0):
        if scale_factor is None:
            scale_factor = self.scale_factor
        p = np.asarray(xyz) * scale_factor
        T = self.pose_avg
        p = p @ T[:3, :3].T + T[:3, 3]
        A = self.axis_align_mat
        p = p @ A[:3, :3].T + A[:3, 3]
        bounds = copy.deepcopy(self.bbox_bounds)
        if bbox_enlarge > 0:
            z_min = bounds[0][2]
            bounds[0] -= bbox_enlarge
            bounds[1] += bbox_enlarge
            bounds[0][2] = z_min  # keep the ground plane (bbox_utils.py:172-176)
        elif bbox_enlarge < 0:
            bounds[0][2] -= bbox_enlarge
        return np.all((p >= bounds[0]) & (p <= bounds[1]), axis=-1)


def boxes_to_arrays(boxes: Dict[str, BBoxRayHelper], scale_factor: float):
    """Pack helpers into (affines (B,4,4), bounds (B,2,3), scale) arrays for
    the removal-muting test of render_rays_multi on the device."""
    affines = np.stack([b.world_to_box_affine() for b in boxes.values()])
    bounds = np.stack([b.bbox_bounds for b in boxes.values()])
    return affines.astype(np.float32), bounds.astype(np.float32), scale_factor


def check_in_any_boxes_np(boxes, xyz, scale_factor=None, bbox_enlarge=0.0):
    """Union point-in-box test (bbox_utils.py:189-207)."""
    shape = xyz.shape[:-1]
    flat = np.asarray(xyz).reshape(-1, 3)
    inb = np.zeros(len(flat), bool)
    for b in boxes.values():
        inb |= b.check_xyz_in_bounds(flat, scale_factor, bbox_enlarge)
    return inb.reshape(shape)
