"""Editable-render demo CLI.

    python -m object_nerf_torch.edit config=config/edit_synthetic_desk.yaml \\
        ckpt_path=logs/<run>/last.ckpt [device=cuda] [prefix=my_run]

Counterpart of `scripts/demo_editable_render.py` (the reference demo
contract, test/demo_editable_render.py:16-108). Per frame it sets per-object
(and per-duplication) pose transforms along a spiral camera path, renders the
edited scene with `EditableRenderer` on `device` (default `cuda`;
`device=cpu` runs the kernels' plain versions) and writes
`debug/rendered_view/render_<time>_<prefix>/render_%04d.png` (through the
port's own PNG codec, `data/png_io.py`). `edit_type`:
"duplication" (offset copies) or "pure_rotation" (z spin). The checkpoint's
`run_config_snapshot.yaml` must lie beside it, as the training CLI leaves it.
With `tpu.distributed=true` under `torchrun` the ranks share each frame's
chunks (`parallel/mesh.py`) and rank 0 writes the PNGs.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np


def _rot_z(deg: float) -> np.ndarray:
    t = np.deg2rad(deg)
    m = np.eye(4)
    m[0, 0] = m[1, 1] = np.cos(t)
    m[0, 1] = -np.sin(t)
    m[1, 0] = np.sin(t)
    return m


def move_camera_pose(pose, progress):
    """Spiral camera motion (demo_editable_render.py:16-22)."""
    t = progress * np.pi * 4
    radii = 0.01
    center = np.array([np.cos(t), -np.sin(t), -np.sin(0.5 * t)]) * radii
    pose = pose.copy()
    pose[:3, 3] += pose[:3, :3] @ center
    return pose


def get_pure_rotation(progress_11: float, max_angle: float = 180):
    return _rot_z(progress_11 * max_angle)


def get_transformation_with_duplication_offset(progress, duplication_id: int):
    trans_pose = get_pure_rotation(np.sin(progress * np.pi * 2), max_angle=10)
    offset = 0.05
    if duplication_id > 0:
        trans_pose[0, 3] -= np.sin(progress * np.pi * 2) * offset
        trans_pose[1, 3] -= 0.2
    else:
        trans_pose[0, 3] += np.sin(progress * np.pi * 2) * offset
        trans_pose[1, 3] += 0.55
    return trans_pose


def main(argv) -> str:
    """Render the demo frames; returns the directory they were written to."""
    from ..data.png_io import write_png
    from ..parallel import mesh
    from .editable_renderer import EditableRenderer, read_testing_config

    config = read_testing_config(cli_args=argv)
    mesh.initialize_from_config(config)
    lead = mesh.rank() == 0
    stamp = time.strftime("%Y-%m-%d_%H-%M-%S")
    render_path = f"debug/rendered_view/render_{stamp}_{config.get('prefix', 'demo')}/"
    if lead:
        os.makedirs(render_path, exist_ok=True)

    renderer = EditableRenderer(config=config, device=config.get("device", "cuda"))
    renderer.load_frame_meta()
    obj_id_list = list(config.obj_id_list)
    for obj_id in obj_id_list:
        renderer.initialize_object_bbox(obj_id)
    renderer.remove_scene_object_by_ids(obj_id_list)

    W, H = config.img_wh
    total_frames = int(config.total_frames)
    pose_frame_idx = int(config.test_frame)
    chunk = int(config.get("chunk", 4096))

    for idx in range(total_frames):
        processed = []
        progress = idx / total_frames
        for obj_id in obj_id_list:
            dup_cnt = int(np.sum(np.array(processed) == obj_id))
            if config.edit_type == "duplication":
                trans_pose = get_transformation_with_duplication_offset(progress, dup_cnt)
            elif config.edit_type == "pure_rotation":
                trans_pose = get_pure_rotation(progress_11=(progress * 2 - 1))
            else:
                raise ValueError(f"unknown edit_type {config.edit_type!r}")
            renderer.set_object_pose_transform(obj_id, trans_pose, dup_cnt)
            processed.append(obj_id)

        results = renderer.render_edit(
            h=H, w=W,
            camera_pose_Twc=move_camera_pose(
                renderer.get_camera_pose_by_frame_idx(pose_frame_idx), progress),
            fovx_deg=getattr(renderer, "fov_x_deg_dataset", 60), chunk=chunk)
        typ = "fine" if renderer.settings.N_importance > 0 else "coarse"
        img = np.asarray(results[f"rgb_{typ}"]).reshape(H, W, 3)
        if lead:
            write_png(f"{render_path}/render_{idx:04d}.png",
                      (np.clip(img, 0, 1) * 255).astype(np.uint8))
            print(f"frame {idx + 1}/{total_frames} -> {render_path}")
        renderer.reset_active_object_ids()
    mesh.barrier()
    mesh.destroy()
    return render_path


if __name__ == "__main__":
    main(sys.argv[1:])
