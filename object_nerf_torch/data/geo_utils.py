"""Geometry utilities: pose averaging/centering and ray-AABB intersection.

Own copy of `object_nerf_tpu/data/geo_utils.py:20-111` (numpy, host side);
the device-side twin there is not needed: the edit renderer intersects rays
on the host, once per frame.

The reference's per-ray Numba loop (datasets/geo_utils.py:111-162) is a fully
vectorized numpy slab test here.

Quirk preserved for parity: the reference returns a MISS whenever tmin < 0
or tmax < 0, i.e. rays whose origin is inside the box report no hit
(geo_utils.py:158-160, acknowledged FIXME at :128). The editable renderer
depends on this to mute those rays, so it is kept behind
`miss_when_inside=True`.
"""

from __future__ import annotations

import numpy as np


def _slab_test(bounds_min, bounds_max, rays_o, rays_d):
    d = np.where(rays_d == 0, 1.0e-14, rays_d)
    inv = 1.0 / d
    t0 = (bounds_min - rays_o) * inv
    t1 = (bounds_max - rays_o) * inv
    tmin_axis = np.minimum(t0, t1)
    tmax_axis = np.maximum(t0, t1)
    tmin = tmin_axis.max(axis=-1)
    tmax = tmax_axis.min(axis=-1)
    return tmin, tmax


def ray_aabb_intersect(
    bounds: np.ndarray,
    rays_o: np.ndarray,
    rays_d: np.ndarray,
    miss_when_inside: bool = True,
):
    """Batched ray-AABB slab test.

    bounds: (2, 3) [min; max]; rays_o/rays_d: (N, 3).
    Returns (hit (N,) bool, tmin (N,), tmax (N,)) with tmin/tmax zeroed on
    miss, the same contract as the reference `bbox_intersection_batch`.
    """
    tmin, tmax = _slab_test(bounds[0], bounds[1], rays_o, rays_d)
    hit = tmin <= tmax
    if miss_when_inside:
        hit = hit & (tmin >= 0) & (tmax >= 0)
    tmin = np.where(hit, tmin, 0.0)
    tmax = np.where(hit, tmax, 0.0)
    return hit, tmin, tmax


# ---------------------------------------------------------------------------
# Pose utilities (datasets/geo_utils.py:17-108 semantics)
# ---------------------------------------------------------------------------


def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def average_poses(poses: np.ndarray) -> np.ndarray:
    """Average camera pose of (N, 3, 4) c2w matrices -> (3, 4)."""
    center = poses[..., 3].mean(0)
    z = normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)


def center_poses(poses: np.ndarray, pose_avg: np.ndarray | None = None):
    """Re-express all poses in the average-pose frame. Returns (poses, avg)."""
    if pose_avg is None:
        pose_avg = average_poses(poses)
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = pose_avg[:3, :4]
    last_row = np.tile(np.array([0, 0, 0, 1.0]), (len(poses), 1, 1))
    poses_homo = np.concatenate([poses, last_row], 1)
    poses_centered = np.linalg.inv(pose_avg_homo) @ poses_homo
    return poses_centered[:, :3], pose_avg


def center_pose_from_avg(pose_avg: np.ndarray, pose: np.ndarray) -> np.ndarray:
    """Center a single (3|4, 4) pose by the average pose; returns (4, 4)."""
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = pose_avg[:3]
    pose_homo = np.eye(4)
    pose_homo[:3] = pose[:3]
    return np.linalg.inv(pose_avg_homo) @ pose_homo


def observe_angle_distance(pose: np.ndarray, obj_center: np.ndarray):
    """View angle (deg) and distance from a c2w pose to a point (JAX
    `data/geo_utils.py:104-111`): the angle between the camera's +z axis and
    the direction to the point."""
    view_dir = pose[:3, :3] @ np.array([0.0, 0.0, 1.0])
    c2o = obj_center - pose[:3, 3]
    distance = np.linalg.norm(c2o)
    c2o = c2o / distance
    angle = np.arccos(np.clip(c2o.dot(view_dir), -1.0, 1.0)) * 180.0 / np.pi
    return angle, distance
