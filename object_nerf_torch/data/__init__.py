"""Datasets. `dataset_dict` maps the reference's dataset names to classes
(JAX `data/__init__.py`): `generic_dataset`, `scannet_base` and `toydesk`
(`GenericDataset`, scans on disk) and the procedural `synthetic` scene."""

from .ray_utils import get_ray_directions, get_rays
from .geo_utils import (
    average_poses,
    center_pose_from_avg,
    center_poses,
    observe_angle_distance,
    ray_aabb_intersect,
)

dataset_dict = {}


def register_dataset(name):
    def deco(cls):
        dataset_dict[name] = cls
        return cls

    return deco


from .generic_dataset import GenericDataset  # noqa: E402  (registers itself)
from .synthetic import SyntheticDataset  # noqa: E402

__all__ = [
    "get_ray_directions",
    "get_rays",
    "ray_aabb_intersect",
    "average_poses",
    "center_poses",
    "center_pose_from_avg",
    "observe_angle_distance",
    "dataset_dict",
    "register_dataset",
    "GenericDataset",
    "SyntheticDataset",
]
