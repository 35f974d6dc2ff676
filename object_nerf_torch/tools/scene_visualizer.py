"""Scene visualizer CLI (the reference tools/scene_visualizer.py contract).

    python -m object_nerf_torch.tools.scene_visualizer dataset_config=config/toy_desk_2.yml \\
        out=scene_vis.html [draw_poses=true] [draw_bbox=true] [mesh=m.ply]

Counterpart of the JAX package's `tools/scene_visualizer.py:23-70`, on the
port's config, box helper and PLY reader. `out=*.html` writes a standalone
interactive WebGL viewer (orbit, pan, zoom, layer toggles, instance-id
labels; no dependencies, works offline); `out=*.ply` writes the flattened
geometry for any external viewer. It draws the scene's point cloud
(`dataset_extra.pcd_path`), every tenth camera of `transforms_full.json` and
their trajectory, each instance's box labelled `obj <id>`, and `mesh=` (a PLY
of `python -m object_nerf_torch.tools.extract_mesh`). Needs numpy only.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np


def main(argv) -> None:
    from ..config import load_config
    from ..data.ply_io import read_ply
    from ..edit.bbox import BBoxRayHelper
    from .visualize import SceneVisualizer

    cfg = load_config(cli_args=argv)
    vis = SceneVisualizer()
    extra = cfg.dataset_extra

    pcd_path = extra.get("pcd_path")
    if pcd_path and os.path.exists(pcd_path):
        m = read_ply(pcd_path)
        vis.add_points(m["points"], colors=m["colors"])

    if cfg.get("draw_poses", True):
        tf = os.path.join(extra["root_dir"], "transforms_full.json")
        if os.path.exists(tf):
            with open(tf) as f:
                frames = json.load(f)["frames"]
            poses = [np.array(fr["transform_matrix"]) for fr in frames[::10]]
            for p in poses:
                vis.add_camera(p, scale=0.2)
            vis.add_trajectory(poses)

    if cfg.get("draw_bbox", True):
        for inst_id in extra.get("instance_id", []):
            try:
                h = BBoxRayHelper(cfg, inst_id)
                T = np.linalg.inv(h.axis_align_mat)
                vis.add_bbox(h.bbox_bounds, transform=T, color=(1, 0.2, 0.2))
                center = np.asarray(h.bbox_bounds).mean(0)
                vis.add_label(T[:3, :3] @ center + T[:3, 3], f"obj {inst_id}")
            except Exception as e:
                print(f"bbox for instance {inst_id} skipped: {e}")

    mesh_path = cfg.get("mesh")
    if mesh_path:
        m = read_ply(mesh_path)
        if m.get("faces") is not None:
            vis.add_mesh(m["points"], m["faces"], colors=m.get("colors"))
        else:
            vis.add_points(m["points"], colors=m.get("colors"))

    out = cfg.get("out", "scene_vis.html")
    vis.save(out)
    print(f"wrote {out}")


if __name__ == "__main__":
    main(sys.argv[1:])
