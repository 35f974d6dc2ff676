"""Write the procedural test scene to disk as a NeRF-style dataset.

    python -m object_nerf_torch.scripts.make_synthetic_dataset \\
        out=data/synthetic_desk "img_wh=[96,72]" n_frames=24 [scene_id=scene0000_00]

Counterpart of the JAX package's `scripts/make_synthetic_dataset.py:23-119`
(the default scene; its `detail` variant is not carried over), writing every
PNG through the port's own codec (`data/png_io.py`), so neither cv2 nor PIL
is needed. The ToyDesk layout the datasets read: `transforms_full.json`
(OpenCV-convention poses with `idx`), `full/<i>.png` RGB, `<i>.depth.png`
(16-bit millimetres of z-depth), `<i>.instance.png` (16-bit instance ids), a
point cloud `pcd.ply` for the voxel grid, an oriented box per object in
`bbox.json`, and `split/train.txt` (every frame but the last two).

With `scene_id`, also the ScanNet box files of `config/scannet_base_*.yml`
(`write_scannet_boxes`): `scans/<scene_id>/<scene_id>.txt` with an identity
`axisAlignment` and `<scene_id>_bbox.npy` with one row [centre, size, id]
per object, so the `use_bbox` path runs on the same scene.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from ..data.ply_io import write_ply
from ..data.png_io import write_png
from ..data.ray_utils import get_ray_directions, get_rays
from ..data.synthetic import _default_spheres, look_at, trace

FIX_ROT = np.array([1, 0, 0, 0, -1, 0, 0, 0, -1]).reshape(3, 3)


def frame_images(i: int, img_wh=(96, 72), n_frames=24):
    """Frame `i` of the orbit: (rgb (H, W, 3) uint8, z-depth in mm (H, W)
    uint16, instance ids (H, W) uint16, OpenCV-convention pose (4, 4)), the
    arrays `make_dataset` writes."""
    w, h = img_wh
    focal = 0.7 * w
    directions = get_ray_directions(h, w, focal)
    dirs_norm = np.linalg.norm(directions.reshape(-1, 3), axis=-1)
    ang = 2 * np.pi * i / n_frames
    radius = 1.8 + 0.2 * np.sin(3 * ang)
    eye = np.array([radius * np.cos(ang), radius * np.sin(ang), 1.1 + 0.2 * np.cos(2 * ang)])
    c2w = look_at(eye, np.array([0.0, 0.0, 0.2]))
    rays_o, rays_d = get_rays(directions, c2w)
    rgb, depth, inst = trace(rays_o, rays_d, _default_spheres())
    depth = np.where(depth > 5.0, 0.0, depth)
    zdepth = np.where(depth > 0, depth / dirs_norm, 0.0)
    pose_cv = np.eye(4)
    pose_cv[:3, :3] = c2w[:3, :3] @ FIX_ROT
    pose_cv[:3, 3] = c2w[:3, 3]
    return ((rgb.reshape(h, w, 3) * 255).astype(np.uint8),
            (zdepth.reshape(h, w) * 1000).astype(np.uint16),
            inst.reshape(h, w).astype(np.uint16), pose_cv)


def make_dataset(out_dir, img_wh=(96, 72), n_frames=24, filters="up") -> str:
    """Write the scene under `out_dir`; `filters` are the PNG row filters
    (`png_io.write_png`). Returns `out_dir`."""
    w, h = img_wh
    out = str(out_dir)
    os.makedirs(os.path.join(out, "full"), exist_ok=True)
    fov_x = 2 * np.arctan(w / 2 / (0.7 * w))
    spheres = _default_spheres()

    frames = []
    for i in range(n_frames):
        rgb, zdepth, inst, pose_cv = frame_images(i, img_wh, n_frames)
        write_png(os.path.join(out, "full", f"{i}.png"), rgb, filters)
        write_png(os.path.join(out, "full", f"{i}.depth.png"), zdepth, filters)
        write_png(os.path.join(out, "full", f"{i}.instance.png"), inst, filters)
        frames.append({"file_path": f"./full/{i}",
                       "transform_matrix": pose_cv.tolist(), "idx": i})

    with open(os.path.join(out, "transforms_full.json"), "w") as f:
        json.dump({"camera_angle_x": float(fov_x), "frames": frames}, f, indent=2)

    # point cloud: surface samples of the plane and the spheres
    rng = np.random.RandomState(0)
    pts = [rng.rand(1500, 3) * [2.8, 2.8, 0.0] - [1.4, 1.4, 0.0]]
    for s in spheres:
        d = rng.randn(600, 3)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        pts.append(s.center + s.radius * d)
    write_ply(os.path.join(out, "pcd.ply"), np.concatenate(pts))

    # ToyDesk-style oriented boxes of the labelled objects (instance id > 0)
    labels = [{"id": int(s.instance_id),
               "data": {"position": [float(x) for x in s.center],
                        "quaternion": [0.0, 0.0, 0.0, 1.0],
                        "scale": [float(2.2 * s.radius)] * 3}}
              for s in spheres if s.instance_id > 0]
    with open(os.path.join(out, "bbox.json"), "w") as f:
        json.dump({"labels": labels}, f, indent=2)

    split_dir = os.path.join(out, "split")
    os.makedirs(split_dir, exist_ok=True)
    with open(os.path.join(split_dir, "train.txt"), "w") as f:
        f.write("\n".join(str(i) for i in range(n_frames - 2)))
    print(f"wrote {n_frames} frames to {out}")
    return out


def write_scannet_boxes(out_dir, scene_id: str) -> None:
    """The ScanNet box files of the scene (`GenericDataset.read_bbox_info`):
    `scans/<scene_id>/<scene_id>.txt` (identity `axisAlignment`) and
    `<scene_id>_bbox.npy`, rows [cx, cy, cz, dx, dy, dz, instance id]."""
    scans = os.path.join(str(out_dir), "scans", scene_id)
    os.makedirs(scans, exist_ok=True)
    with open(os.path.join(scans, f"{scene_id}.txt"), "w") as f:
        f.write("axisAlignment = " + " ".join(f"{v:g}" for v in np.eye(4).reshape(-1)) + "\n")
    rows = [[*s.center, *([2.2 * s.radius] * 3), s.instance_id]
            for s in _default_spheres() if s.instance_id > 0]
    np.save(os.path.join(str(out_dir), f"{scene_id}_bbox.npy"), np.asarray(rows, np.float64))


def main(argv) -> str:
    from ..config import Config

    cfg = Config.from_dotlist(argv)
    out = make_dataset(cfg.get("out", "data/synthetic_desk"),
                       img_wh=tuple(cfg.get("img_wh", [96, 72])),
                       n_frames=int(cfg.get("n_frames", 24)))
    if cfg.get("scene_id"):
        write_scannet_boxes(out, str(cfg.scene_id))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
