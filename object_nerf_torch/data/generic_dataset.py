"""NeRF-style RGB-D dataset (ScanNet / ToyDesk) with instance masks.

Counterpart of `object_nerf_tpu/data/generic_dataset.py:80-418` (reference
datasets/generic_dataset.py:23-502), registered under the same names
(`generic_dataset`, `scannet_base`, `toydesk`), with the same buffers:

* reads `transforms_full.json`, focal from `camera_angle_x`;
* train frames: split file, start index, validate-index exclusion, NaN/Inf
  pose rejection, observation angle/distance check, skip step, max size;
  val = the single `validate_idx` frame;
* per frame: the OpenCV -> OpenGL rotation fix (`FIX_ROT`), pose centring by
  `scene_center` and `scale_factor`, the LANCZOS-resized RGB, 16-bit depth in
  millimetres clipped above 4 m and turned from z-depth into ray depth,
  per-instance masks with rebalance weights (fixed fg/bg or distance
  transform) and background + self pass-through masks, the 20-pixel border
  valid mask, and per-ray near/far from the instance box under `use_bbox`;
* rays packed `(H*W, 8) = [o, d, near, far]`; training samples one random
  instance per ray; the train buffers can be cached in an `.npz` keyed on the
  config.

The frames are read by the port's own PNG codec (`png_io`) and resampled by
`image_utils.resize_lanczos` / `resize_nearest`, which reproduce PIL's and
cv2's results: no PIL or cv2. `sample_batch(batch_size, rng)` draws from an
explicit `np.random.RandomState`, by default the dataset's own seeded one
(the JAX original draws from the global `np.random`); the same `RandomState`
gives the same batch as the JAX package's `sample_batch(rng=...)`.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np

from . import register_dataset
from .geo_utils import center_pose_from_avg, observe_angle_distance, ray_aabb_intersect
from .image_utils import (
    compute_distance_transform_weights, rebalance_mask, resize_lanczos, resize_nearest,
)
from .png_io import read_png
from .ray_utils import get_ray_directions, get_rays

FIX_ROT = np.array([1, 0, 0, 0, -1, 0, 0, 0, -1], dtype=np.float64).reshape(3, 3)


def _load_image_rgb(path, img_wh):
    """(H*W, 3) float32 in [0, 1]: PIL's LANCZOS resize of an 8-bit PNG."""
    img = read_png(path)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: colour frames are 8-bit, this one is {img.dtype}")
    arr = resize_lanczos(img, img_wh).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, -1)
    return arr[..., :3].reshape(-1, 3)


def _load_single_channel(path, img_wh):
    """A depth or instance map as stored (cv2's IMREAD_ANYDEPTH), resized by
    cv2's INTER_NEAREST, or None when the file is missing."""
    if not os.path.exists(path):
        return None
    img = read_png(path)
    if img.ndim != 2:
        raise ValueError(f"{path}: expected a single-channel PNG, got {img.shape[-1]} "
                         f"channels")
    return resize_nearest(img, img_wh)


def _load_depth(path, img_wh, scale_factor, dir_norm):
    depth = _load_single_channel(path, img_wh)
    if depth is None:
        return np.zeros(img_wh[0] * img_wh[1], np.float32)
    depth = depth * 1e-3
    depth[depth > 4] = 0
    depth = depth.astype(np.float32).reshape(-1)
    return depth / scale_factor * dir_norm


@register_dataset("generic_dataset")
@register_dataset("scannet_base")
@register_dataset("toydesk")
class GenericDataset:
    def __init__(self, split="train", img_wh=(640, 480), dataset_extra=None,
                 cache_dir=None, seed: int = 0):
        self.split = split
        self.img_wh = tuple(img_wh)
        self.conf = dataset_extra
        self.root_dir = self.conf["root_dir"]
        self.scene_id = self.conf.get("scene_id", "")
        self.scale_factor = float(self.conf["scale_factor"])
        self.near = float(self.conf["near"])
        self.far = float(self.conf["far"])
        self.white_back = False
        self._rng = np.random.RandomState(seed)

        self.pose_avg = np.concatenate(
            [np.eye(3), np.array(self.conf["scene_center"], np.float64)[:, None]], 1)

        # the 20-pixel border valid mask (reference generic_dataset.py:44-52)
        border = 20
        w, h = self.img_wh
        bmask = np.ones((h, w), bool)
        bmask[:border] = bmask[-border:] = False
        bmask[:, :border] = bmask[:, -border:] = False
        self.bmask = bmask.reshape(-1)

        self.use_bbox = bool(self.conf.get("use_bbox", False))
        if self.use_bbox:
            self.read_bbox_info()

        self.bg_instance_ids = list(self.conf.get("bg_instance_id", []))
        self.instance_ids = list(self.conf.get("instance_id", [0]))

        self._read_meta(cache_dir)

    # -- bbox ----------------------------------------------------------------
    def read_bbox_info(self):
        """ScanNet `axisAlignment` and the `_bbox.npy` row of
        `val_instance_id` (reference generic_dataset.py:66-89)."""
        scene_info_file = os.path.join(
            self.conf["scans_dir"], f"{self.scene_id}/{self.scene_id}.txt")
        for line in open(scene_info_file):
            if "axisAlignment" in line:
                vals = [float(x)
                        for x in line.rstrip().strip("axisAlignment = ").split(" ")]
                self.axis_align_mat = np.array(vals).reshape(4, 4)
                break
        scene_bbox = np.load(os.path.join(self.conf["bbox_dir"], f"{self.scene_id}_bbox.npy"))
        for b in scene_bbox:
            if int(b[6]) != int(self.conf["val_instance_id"]):
                continue
            half = np.array([b[3], b[4], b[5]]) * 0.5
            center = np.array([b[0], b[1], b[2]])
            self.bbox_bounds = np.array([center - half, center + half])

    def transform_rays_to_bbox_coordinates(self, rays_o, rays_d):
        rays_o = rays_o * self.scale_factor
        T = self.pose_avg
        rays_o = rays_o @ T[:3, :3].T + T[:3, 3]
        A = self.axis_align_mat
        rays_o = rays_o @ A[:3, :3].T + A[:3, 3]
        # as the reference: axis alignment applied to the directions before
        # the pose rotation (reference generic_dataset.py:103, JAX :148)
        rays_d_b = rays_d @ A[:3, :3].T
        return rays_o, rays_d_b

    def is_rays_in_bbox(self):
        if self.conf.get("use_bbox_only_for_test", False) and self.split == "train":
            return False
        return self.use_bbox

    # -- meta ----------------------------------------------------------------
    def _filtered_frames(self):
        with open(os.path.join(self.root_dir, "transforms_full.json")) as f:
            self.meta = json.load(f)
        frames = self.meta["frames"]
        validate_idx = self.conf.get("validate_idx", -1)

        if self.split == "train":
            split_file = os.path.join(self.conf["split"], "train.txt")
            if os.path.exists(split_file):
                split_inds = set(np.loadtxt(split_file).astype(int).tolist())
                frames = [f for f in frames if f["idx"] in split_inds]
            start = self.conf.get("train_start_idx", 0)
            frames = [f for f in frames if f["idx"] >= start and f["idx"] != validate_idx]

            def obs_ok(f):
                T = np.array(f["transform_matrix"])
                if not np.isfinite(T).all():
                    return False
                if not self.conf.get("enable_observation_check", False):
                    return True
                angle, dist = observe_angle_distance(T, self.pose_avg[:3, 3])
                return (angle < self.conf["max_obs_angle"]
                        and dist < self.conf["max_obs_distance"])

            frames = [f for f in frames if obs_ok(f)]
            frames = frames[::int(self.conf.get("train_skip_step", 1))]
            frames = frames[: int(self.conf.get("train_max_size", 10**9))]
        elif self.split == "val":
            frames = [f for f in frames if f["idx"] == validate_idx]
        return frames

    def _cache_key(self):
        payload = json.dumps(
            {"split": self.split, "img_wh": self.img_wh,
             "conf": {k: str(v) for k, v in sorted(dict(self.conf).items())}},
            sort_keys=True)
        return hashlib.sha1(payload.encode()).hexdigest()[:16]

    _BUFFERS = ("rays", "rgbs", "depths", "valid_mask", "frame_indices",
                "instance_masks", "instance_weights", "pass_through", "inst_ids")

    def _read_meta(self, cache_dir):
        frames = self._filtered_frames()
        w, h = self.img_wh
        self.focal = 0.5 * w / np.tan(0.5 * self.meta["camera_angle_x"])
        self.directions = get_ray_directions(h, w, self.focal)
        self.dir_norm = np.linalg.norm(self.directions, axis=-1).reshape(-1)
        self.frames = frames

        if self.split != "train":
            return  # val/test frames are read on demand

        cache_path = None
        if cache_dir:
            cache_path = Path(cache_dir) / f"rays_{self._cache_key()}.npz"
            if cache_path.exists():
                data = np.load(cache_path)
                for k in data.files:
                    setattr(self, k, data[k])
                return

        buffers = {k: [] for k in self._BUFFERS}
        for idx, frame in enumerate(frames):
            sample = self.read_frame_data(frame, self.instance_ids[0])
            if sample is None:
                continue
            masks, wts, passes, ids = [], [], [], []
            ok = True
            for i_inst, inst_id in enumerate(self.instance_ids):
                s = sample if i_inst == 0 else self.read_frame_data(frame, inst_id,
                                                                    instance_only=True)
                if s is None:
                    ok = False
                    break
                masks.append(s["instance_mask"])
                wts.append(s["instance_mask_weight"])
                passes.append(s["pass_through_mask"])
                ids.append(np.full(len(s["instance_mask"]), inst_id, np.int64))
            if not ok:
                continue
            for k in ("rays", "rgbs", "depths", "valid_mask"):
                buffers[k].append(sample[k])
            buffers["frame_indices"].append(np.full(len(sample["rays"]), idx, np.int64))
            buffers["instance_masks"].append(np.stack(masks, -1))
            buffers["instance_weights"].append(np.stack(wts, -1))
            buffers["pass_through"].append(np.stack(passes, -1))
            buffers["inst_ids"].append(np.stack(ids, -1))

        self.rays = np.concatenate(buffers["rays"]).astype(np.float32)
        self.rgbs = np.concatenate(buffers["rgbs"]).astype(np.float32)
        self.depths = np.concatenate(buffers["depths"]).astype(np.float32)
        self.valid_mask = np.concatenate(buffers["valid_mask"])
        self.frame_indices = np.concatenate(buffers["frame_indices"])
        self.instance_masks = np.concatenate(buffers["instance_masks"])
        self.instance_weights = np.concatenate(buffers["instance_weights"]).astype(np.float32)
        self.pass_through = np.concatenate(buffers["pass_through"])
        self.inst_ids = np.concatenate(buffers["inst_ids"])

        if cache_path:
            cache_path.parent.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(cache_path, **{k: getattr(self, k) for k in self._BUFFERS})

    # -- per frame --------------------------------------------------------------
    def _instance_mask_of(self, inst_map, instance_id):
        if isinstance(instance_id, (list, tuple)):
            m = np.zeros(inst_map.shape, bool)
            for i in instance_id:
                m |= inst_map == i
            return m
        return inst_map == instance_id

    def read_frame_data(self, frame, instance_id, instance_only=False):
        w, h = self.img_wh
        n = w * h

        if self.conf.get("use_instance_mask", False) and instance_id != 0:
            inst_path = os.path.join(
                self.root_dir, f"{frame['file_path']}.{self.conf['inst_seg_tag']}.png")
            inst_map = _load_single_channel(inst_path, self.img_wh)
            if inst_map is None:
                return None
            instance_mask = self._instance_mask_of(inst_map, instance_id)
            strategy = self.conf.get("mask_rebalance_strategy", "fg_bg_reweight")
            if strategy == "fg_bg_reweight":
                weight = rebalance_mask(instance_mask,
                                        fg_weight=self.conf.get("fg_weight", 1.0),
                                        bg_weight=self.conf.get("bg_weight", 0.05))
            else:
                weight = compute_distance_transform_weights(
                    instance_mask, uncertain_pixel_distance=0.05 * w)
            pass_through = self._instance_mask_of(inst_map,
                                                  self.bg_instance_ids + [instance_id])
            instance_mask = instance_mask.reshape(-1)
            weight = weight.reshape(-1)
            pass_through = pass_through.reshape(-1)
        else:
            instance_mask = np.ones(n, bool)
            weight = np.zeros(n, np.float32)
            pass_through = instance_mask.copy()

        if instance_only:
            return {
                "instance_mask": instance_mask,
                "instance_mask_weight": weight,
                "pass_through_mask": pass_through,
                "instance_ids": np.full(n, instance_id, np.int64),
            }

        pose = np.array(frame["transform_matrix"], np.float64)
        pose[:3, :3] = pose[:3, :3] @ FIX_ROT
        pose = center_pose_from_avg(self.pose_avg, pose)
        pose[:, 3] /= self.scale_factor
        c2w = pose[:3, :4].astype(np.float32)

        img_path = os.path.join(self.root_dir, f"{frame['file_path']}.png")
        if not os.path.exists(img_path):
            return None
        rgbs = _load_image_rgb(img_path, self.img_wh)
        depths = _load_depth(
            os.path.join(self.root_dir, f"{frame['file_path']}.depth.png"),
            self.img_wh, self.scale_factor, self.dir_norm)

        rays_o, rays_d = get_rays(self.directions, c2w)

        bbox_only_for_test = self.conf.get("use_bbox_only_for_test", False)
        if self.use_bbox and not (bbox_only_for_test and self.split == "train"):
            o_b, d_b = self.transform_rays_to_bbox_coordinates(rays_o, rays_d)
            hit, tmin, tmax = ray_aabb_intersect(self.bbox_bounds, o_b, d_b)
            near = (tmin / self.scale_factor)[:, None].astype(np.float32)
            far = (tmax / self.scale_factor)[:, None].astype(np.float32)
            if self.conf.get("use_instance_mask", False):
                instance_mask = instance_mask & hit
            if bbox_only_for_test:
                near[~hit] = 0.0
                far[~hit] = 0.0
            else:
                near[~hit] = self.near / self.scale_factor
                far[~hit] = self.far / self.scale_factor
        else:
            near = np.full((n, 1), self.near / self.scale_factor, np.float32)
            far = np.full((n, 1), self.far / self.scale_factor, np.float32)

        rays = np.concatenate(
            [rays_o.astype(np.float32), rays_d.astype(np.float32), near, far], -1)
        return {
            "rays": rays,
            "rgbs": rgbs,
            "depths": depths,
            "c2w": c2w,
            "valid_mask": self.bmask.copy(),
            "instance_mask": instance_mask,
            "instance_mask_weight": weight,
            "pass_through_mask": pass_through,
            "instance_ids": np.full(n, instance_id, np.int64),
        }

    # -- batch API -------------------------------------------------------------
    def __len__(self):
        if self.split == "train":
            return len(self.rays)
        return max(1, len(self.frames))

    def sample_batch(self, batch_size: int, rng: np.random.RandomState | None = None):
        """Random rays, each with a random instance (reference
        generic_dataset.py:475-490), drawn from `rng` (default: the
        dataset's own)."""
        rng = rng or self._rng
        idx = rng.randint(0, len(self.rays), size=batch_size)
        k = rng.randint(0, self.instance_masks.shape[-1], size=batch_size)
        sel = np.arange(batch_size)
        return {
            "rays": self.rays[idx],
            "rgbs": self.rgbs[idx],
            "depths": self.depths[idx],
            "valid_mask": self.valid_mask[idx],
            "instance_mask": self.instance_masks[idx][sel, k],
            "instance_mask_weight": self.instance_weights[idx][sel, k],
            "pass_through_mask": self.pass_through[idx][sel, k],
            "instance_ids": self.inst_ids[idx][sel, k],
            # the ray's source frame (reference generic_dataset.py:487)
            "frame_idx": self.frame_indices[idx],
        }

    def whole_image_batch(self, frame: int = 0):
        """One whole frame for validation, with `val_instance_id`'s masks."""
        f = self.frames[frame if self.split != "val" else 0]
        sample = self.read_frame_data(f, self.conf.get("val_instance_id", 0))
        if sample is None:
            raise FileNotFoundError(f"frame {f['file_path']} of {self.root_dir} is unreadable")
        return sample
