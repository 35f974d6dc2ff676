"""Seeded scenes, cameras and rays of the benchmark's traffic (numpy, host).

Frozen copies, so that later changes to the program cannot move the inputs:
the room point cloud is `object_nerf_torch/scripts/_fixtures.py:
scannet_scale_pcd`; the spheres-over-plane tracer (`trace`, `_ray_sphere`,
`_ray_plane_z`, `_shade`, `_checker`, `look_at`) is
`object_nerf_torch/data/synthetic.py`; the pinhole directions are
`object_nerf_torch/data/ray_utils.py:get_ray_directions` (no +0.5 pixel
centre). The room tracer is new: the inside of the 6 x 6 x 2.5 m shell that
the point cloud samples (floor, four walls, a ceiling) with its two spheres
as instances 1 and 2.

Rays are (N, 8) = [origin, unit direction, near, far] in the normalised
frame of the configuration ((world - scene_center) / scale_factor); depths
are distances along the ray in that frame, 0 where the ray leaves the
[near, far] range or hits nothing (the reference's invalid depth).
"""

from __future__ import annotations

import numpy as np

# -- the room (object_nerf_torch/scripts/_fixtures.py) -------------------------------

ROOM_HALF, ROOM_HEIGHT = 3.0, 2.5
ROOM_SPHERES = (((0.8, 0.0, 0.6), 0.6, (0.85, 0.3, 0.25), 1),
                ((-0.9, 0.5, 0.45), 0.45, (0.25, 0.45, 0.85), 2))


def room_pcd() -> np.ndarray:
    """The ScanNet-scale room's point cloud (fixed, seed 0): floor, four
    walls and the two spheres' surfaces."""
    rng = np.random.RandomState(0)
    pts = []
    f = rng.rand(60000, 3).astype(np.float32)
    pts.append(f * [6.0, 6.0, 0.0] - [3.0, 3.0, 0.0])
    for ax, sgn in ((0, -3.0), (0, 3.0), (1, -3.0), (1, 3.0)):
        wpts = rng.rand(25000, 3).astype(np.float32) * [6.0, 6.0, 2.5]
        wpts[:, :2] -= 3.0
        wpts[:, ax] = sgn
        pts.append(wpts)
    for c, r in ([[0.8, 0.0, 0.6], 0.6], [[-0.9, 0.5, 0.45], 0.45]):
        d = rng.randn(20000, 3)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        pts.append((np.asarray(c) + r * d).astype(np.float32))
    return np.concatenate(pts)


# -- spheres over a plane (object_nerf_torch/data/synthetic.py) -----------------------

SYNTH_SPHERES = (((0.3, 0.0, 0.25), 0.25, (0.9, 0.2, 0.2), 1),
                 ((-0.35, 0.2, 0.2), 0.2, (0.2, 0.5, 0.9), 2),
                 ((0.0, -0.35, 0.15), 0.15, (0.2, 0.8, 0.3), 3))


def _ray_sphere(o, d, c, r):
    """Nearest positive hit t or +inf. o,d: (N,3)."""
    oc = o - np.asarray(c)
    b = np.sum(oc * d, -1)
    cc = np.sum(oc * oc, -1) - r * r
    disc = b * b - cc
    t = np.where(disc >= 0, -b - np.sqrt(np.maximum(disc, 0)), np.inf)
    return np.where(t > 1e-4, t, np.inf)


def _ray_plane_z(o, d, z=0.0):
    t = (z - o[:, 2]) / np.where(np.abs(d[:, 2]) < 1e-9, 1e-9, d[:, 2])
    return np.where(t > 1e-4, t, np.inf)


def _shade(points, normals, base_color):
    light = np.array([0.4, 0.3, 0.85])
    light = light / np.linalg.norm(light)
    lam = np.clip(normals @ light, 0.0, 1.0)[:, None]
    return np.clip(np.asarray(base_color) * (0.35 + 0.65 * lam), 0.0, 1.0)


def _checker(points, scale: float = 4.0):
    c = ((np.floor(points[:, 0] * scale) + np.floor(points[:, 1] * scale)) % 2)[:, None]
    return 0.35 + 0.3 * c * np.ones((len(points), 3))


def _trace_spheres(o, d, spheres, best_t, rgb, inst):
    for c, r, color, iid in spheres:
        t = _ray_sphere(o, d, c, r)
        closer = t < best_t
        if closer.any():
            pt = o[closer] + t[closer, None] * d[closer]
            rgb[closer] = _shade(pt, (pt - np.asarray(c)) / r, color)
            inst[closer] = iid
            best_t = np.where(closer, t, best_t)
    return best_t


def trace_synthetic(o, d):
    """(rgb (N,3), t (N,) world distance, 0 on a miss, instance id (N,))."""
    n = len(o)
    best_t = _ray_plane_z(o, d, 0.0)
    hit_plane = np.isfinite(best_t)
    rgb = np.zeros((n, 3))
    inst = np.zeros((n,), np.int64)
    p = o + np.where(hit_plane, best_t, 0.0)[:, None] * d
    rgb[hit_plane] = _checker(p[hit_plane])
    sky = ~hit_plane
    rgb[sky] = np.stack([0.6 + 0.2 * d[sky, 2], 0.7 + 0.2 * d[sky, 2],
                         0.9 * np.ones(sky.sum())], -1).clip(0, 1)
    best_t = _trace_spheres(o, d, SYNTH_SPHERES, best_t, rgb, inst)
    return rgb, np.where(np.isfinite(best_t), best_t, 0.0), inst


def trace_room(o, d):
    """The inside of the room from origins inside it: (rgb, t, instance id)."""
    n = len(o)
    safe = np.where(np.abs(d) < 1e-9, 1e-9, d)
    tx = (np.where(d[:, 0] > 0, ROOM_HALF, -ROOM_HALF) - o[:, 0]) / safe[:, 0]
    ty = (np.where(d[:, 1] > 0, ROOM_HALF, -ROOM_HALF) - o[:, 1]) / safe[:, 1]
    tz = (np.where(d[:, 2] > 0, ROOM_HEIGHT, 0.0) - o[:, 2]) / safe[:, 2]
    ts = np.stack([tx, ty, tz], -1)
    face = np.argmin(ts, -1)
    best_t = ts[np.arange(n), face]
    p = o + best_t[:, None] * d
    rgb = np.empty((n, 3))
    wall_x = np.where(d[:, 0] > 0, 0.0, 1.0)[:, None] * [0.15, -0.1, 0.05]
    rgb[:] = np.asarray([0.7, 0.68, 0.6]) + wall_x + 0.08 * np.sin(3.0 * p[:, 2:3])
    wy = face == 1
    rgb[wy] = (np.asarray([0.55, 0.62, 0.7]) + 0.1 * np.cos(2.0 * p[wy, 0:1])
               * np.where(d[wy, 1:2] > 0, 1.0, -1.0))
    floor = (face == 2) & (d[:, 2] < 0)
    rgb[floor] = _checker(p[floor], scale=2.0)
    ceil = (face == 2) & (d[:, 2] > 0)
    rgb[ceil] = 0.9
    inst = np.zeros((n,), np.int64)
    best_t = _trace_spheres(o, d, ROOM_SPHERES, best_t, rgb, inst)
    return rgb.clip(0.0, 1.0), best_t, inst


TRACERS = {"room": trace_room, "spheres": trace_synthetic}


# -- cameras ---------------------------------------------------------------------------


def look_at(eye, target, up=np.array([0.0, 0.0, 1.0])):
    """c2w (3,4) with the reference camera convention (x right, y up, -z fwd)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    cam_up = np.cross(right, fwd)
    return np.stack([right, cam_up, -fwd, eye], axis=1).astype(np.float32)


def poses(scene: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    """(n, 3, 4) seeded camera poses: inside the room, looking at a point of
    it; or on an orbit around the spheres."""
    out = []
    for _ in range(n):
        if scene["kind"] == "room":
            while True:
                eye = rng.uniform([-2.2, -2.2, 0.8], [2.2, 2.2, 1.8])
                target = rng.uniform([-2.6, -2.6, 0.2], [2.6, 2.6, 1.6])
                if np.linalg.norm(target - eye) > 1.0:
                    break
        else:
            ang = rng.uniform(0.0, 2.0 * np.pi)
            radius = 1.8 + 0.2 * np.sin(3 * ang)
            eye = np.array([radius * np.cos(ang), radius * np.sin(ang),
                            1.1 + 0.2 * np.cos(2 * ang)])
            target = np.array([0.0, 0.0, 0.2])
        out.append(look_at(eye, target))
    return np.stack(out)


def pixel_rays(scene: dict, wh, c2w: np.ndarray, pix: np.ndarray):
    """World rays (o, d) of pixels `pix` (flat indices, row-major) of a
    pinhole camera of width w, height h and focal `focal_frac` * w."""
    w, h = wh
    focal = scene["focal_frac"] * w
    i = (pix % w).astype(np.float32)
    j = (pix // w).astype(np.float32)
    dirs = np.stack([(i - w / 2) / focal, -(j - h / 2) / focal, -np.ones_like(i)], -1)
    d = dirs @ c2w[:, :3].T
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return np.broadcast_to(c2w[:, 3], d.shape).astype(np.float64), d.astype(np.float64)


def normalised_rays(scene: dict, o, d, t):
    """(rays (N, 8) f32 in the normalised frame, depth (N,) f32, 0 where
    invalid)."""
    center = np.asarray(scene["scene_center"], np.float64)
    scale = float(scene["scale_factor"])
    near, far = float(scene["near"]), float(scene["far"])
    depth = t / scale
    depth = np.where((depth > far) | (depth <= 0), 0.0, depth)
    n = len(o)
    rays = np.concatenate([(o - center) / scale, d, np.full((n, 1), near),
                           np.full((n, 1), far)], -1)
    return rays.astype(np.float32), depth.astype(np.float32)


def ray_pool(scene: dict, seed: int, n_views: int, wh, n_rays: int) -> dict:
    """A training pool: `n_rays` distinct pixels of `n_views` seeded views,
    traced, each with a random instance of the scene's to supervise (the
    dataset's batch schema: rgbs, depths, valid and instance masks, the
    rebalance weights, the pass-through mask, instance ids)."""
    rng = np.random.default_rng([seed, 1])
    w, h = wh
    cams = poses(scene, rng, n_views)
    flat = rng.choice(n_views * w * h, size=n_rays, replace=False)
    view, pix = flat // (w * h), flat % (w * h)
    o = np.empty((n_rays, 3))
    d = np.empty((n_rays, 3))
    for v in range(n_views):
        sel = view == v
        o[sel], d[sel] = pixel_rays(scene, wh, cams[v], pix[sel])
    rgb, t, inst = TRACERS[scene["kind"]](o, d)
    rays, depth = normalised_rays(scene, o, d, t)
    ids = np.asarray(scene["instance_ids"], np.int64)
    k = ids[rng.integers(0, len(ids), n_rays)]
    mask = inst == k
    return {
        "rays": rays,
        "rgbs": rgb.astype(np.float32),
        "depths": depth,
        "valid_mask": np.ones(n_rays, bool),
        "instance_mask": mask,
        "instance_mask_weight": np.where(mask, scene["fg_weight"],
                                         scene["bg_weight"]).astype(np.float32),
        "pass_through_mask": mask | (inst == 0),
        "instance_ids": k,
    }


def frames(scene: dict, seed: int, n_views: int, wh):
    """Whole frames of `n_views` seeded views: a list of (rays (H*W, 8) f32,
    instance ids (H*W,) int64 from the scene's instance map)."""
    rng = np.random.default_rng([seed, 2])
    w, h = wh
    pix = np.arange(w * h)
    out = []
    for c2w in poses(scene, rng, n_views):
        o, d = pixel_rays(scene, wh, c2w, pix)
        _, t, inst = TRACERS[scene["kind"]](o, d)
        rays, _ = normalised_rays(scene, o, d, t)
        out.append((rays, inst))
    return out


# -- the edit demo (object_nerf_torch/edit/__main__.py, chip_smoke.py phase 9) ----------


def object_boxes(scene: dict):
    """{instance id: (position, quaternion (x, y, z, w), scale)}: the spheres of
    the scene as ToyDesk oriented boxes, 2.2 radii a side, unrotated."""
    spheres = {"room": ROOM_SPHERES, "spheres": SYNTH_SPHERES}[scene["kind"]]
    return {iid: (np.asarray(c, np.float64), np.array([0.0, 0.0, 0.0, 1.0]),
                  np.full(3, 2.2 * r)) for c, r, _, iid in spheres}


def _rot_z(deg: float) -> np.ndarray:
    t = np.deg2rad(deg)
    m = np.eye(4)
    m[0, 0] = m[1, 1] = np.cos(t)
    m[0, 1] = -np.sin(t)
    m[1, 0] = np.sin(t)
    return m


def duplication_pose(progress: float, duplication_id: int = 0) -> np.ndarray:
    """The demo's object trajectory (`get_transformation_with_duplication_offset`):
    a swing about z of up to 10 degrees, and a shift."""
    s = np.sin(progress * np.pi * 2)
    pose = _rot_z(s * 10)
    if duplication_id > 0:
        pose[0, 3] -= s * 0.05
        pose[1, 3] -= 0.2
    else:
        pose[0, 3] += s * 0.05
        pose[1, 3] += 0.55
    return pose
