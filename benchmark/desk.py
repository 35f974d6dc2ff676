"""The desk of the ToyDesk 2 edit demo, in its published world units (numpy,
host): its objects, their point cloud, their oriented boxes and seeded
cameras. No capture is in reach (zju3dv/object_nerf `our_desk_2`,
`datasets/desk_bbox/desk2/bbox.json`, `pcd_from_mesh.ply`), so a procedural
desk stands in for it; `configs/objnerf-voxel-toydesk2.json` states every
assumption under `assumed`.

Up is +z. The desk top is a plane of `DESK_SIZE` units, `DESK_DROP` below
the configuration's `scene_center`; objects 1-5 stand on it, each a sphere
or an axis-aligned box, none overlapping another. Each object's oriented box
is turned about z by a fixed yaw and holds the object's extent in the box's
own frame, times `BOX_MARGIN`. The point cloud samples the desk top and the
objects' visible surfaces at `PCD_DENSITY` points a square unit, dense
enough that every surface voxel of 0.3 units holds a point."""

from __future__ import annotations

import numpy as np

from . import scenes

DESK_SIZE = (18.0, 10.0)
DESK_DROP = 1.5
BOX_MARGIN = 1.1
PCD_DENSITY = 450.0  # points a square unit: about 40 in a 0.3 x 0.3 voxel face

# (id, kind, centre (x, y) from the desk's centre, size, yaw of its box in degrees):
# a box's size is (dx, dy, dz), a sphere's its radius
OBJECTS = (
    (1, "box", (-2.4, -0.4), (1.6, 1.2, 1.1), 20.0),
    (2, "sphere", (0.2, 0.9), 0.75, 35.0),
    (3, "box", (2.4, -0.7), (1.2, 1.2, 2.0), 50.0),
    (4, "sphere", (-5.2, 2.4), 1.3, 15.0),
    (5, "box", (1.4, 3.0), (2.6, 1.1, 0.8), 60.0),
)

# the eye's distance to the desk's centre, its height above the desk's plane
# and its azimuth from the desk's front (-y), on an arc in front of the desk
EYE_DIST = (4.0, 7.0)
EYE_ELEVATION = (25.0, 45.0)  # degrees
EYE_AZIMUTH = (-50.0, 50.0)  # degrees


def desk_centre(scene: dict) -> np.ndarray:
    c = np.asarray(scene["scene_center"], np.float64)
    return c - np.array([0.0, 0.0, DESK_DROP])


def _yaw_quat(deg: float) -> np.ndarray:
    """(x, y, z, w) of a turn about z."""
    t = np.deg2rad(deg) / 2
    return np.array([0.0, 0.0, np.sin(t), np.cos(t)])


def _centre(scene: dict, obj) -> np.ndarray:
    _, kind, (x, y), size, _ = obj
    height = 2 * size if kind == "sphere" else size[2]
    return desk_centre(scene) + np.array([x, y, height / 2])


def object_boxes(scene: dict):
    """{instance id: (position, quaternion (x, y, z, w), scale)} of the desk's
    objects, the form of `scenes.object_boxes` and of ToyDesk's `bbox.json`."""
    out = {}
    for obj in OBJECTS:
        iid, kind, _, size, yaw = obj
        if kind == "sphere":
            extent = np.full(3, 2.0 * size)
        else:
            c, s = abs(np.cos(np.deg2rad(yaw))), abs(np.sin(np.deg2rad(yaw)))
            extent = np.array([size[0] * c + size[1] * s, size[0] * s + size[1] * c, size[2]])
        out[iid] = (_centre(scene, obj), _yaw_quat(yaw), BOX_MARGIN * extent)
    return out


def pcd(scene: dict) -> np.ndarray:
    """The desk's point cloud (fixed, seed 0): the desk top and the objects'
    surfaces above it."""
    rng = np.random.RandomState(0)
    d = desk_centre(scene)
    w, h = DESK_SIZE
    n = int(PCD_DENSITY * w * h)
    top = np.stack([rng.uniform(-w / 2, w / 2, n), rng.uniform(-h / 2, h / 2, n),
                    np.zeros(n)], -1) + d
    pts = [top]
    for obj in OBJECTS:
        _, kind, _, size, _ = obj
        c = _centre(scene, obj)
        if kind == "sphere":
            k = int(PCD_DENSITY * 4 * np.pi * size ** 2)
            u = rng.randn(k, 3)
            u /= np.linalg.norm(u, axis=-1, keepdims=True)
            u = u[c[2] + size * u[:, 2] >= d[2]]
            pts.append(c + size * u)
            continue
        half = np.asarray(size) / 2
        for ax in range(3):
            for sgn in (-1.0, 1.0):
                if ax == 2 and sgn < 0:
                    continue  # the face on the desk
                others = [a for a in range(3) if a != ax]
                k = int(PCD_DENSITY * 4 * half[others[0]] * half[others[1]])
                face = rng.uniform(-1.0, 1.0, (k, 3)) * half
                face[:, ax] = sgn * half[ax]
                pts.append(c + face)
    return np.concatenate(pts).astype(np.float32)


def poses(scene: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    """(n, 3, 4) seeded camera poses on the arc in front of the desk, each
    aimed at the desk's centre."""
    d = desk_centre(scene)
    out = []
    for _ in range(n):
        dist = rng.uniform(*EYE_DIST)
        el, az = np.deg2rad(rng.uniform(*EYE_ELEVATION)), np.deg2rad(rng.uniform(*EYE_AZIMUTH))
        eye = d + dist * np.array([np.cos(el) * np.sin(az), -np.cos(el) * np.cos(az),
                                   np.sin(el)])
        out.append(scenes.look_at(eye, d))
    return np.stack(out)


def pure_rotation(progress: float) -> np.ndarray:
    """The demo's `pure_rotation` edit at progress p in [0, 1]: a turn of
    (2p - 1) * 180 degrees about the box's z axis (`get_pure_rotation`)."""
    return scenes._rot_z((2.0 * progress - 1.0) * 180.0)
