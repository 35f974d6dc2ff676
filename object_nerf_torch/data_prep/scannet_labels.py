"""ScanNet label and box export (VoteNet-style).

Own copy of `object_nerf_tpu/data_prep/scannet_labels.py` (numpy and the
port's `ply_io`). Output parity with the reference scannet_preprocess
(data_preparation/scannet_preprocess/load_scannet_data.py:27-149,
batch_load_scannet_data.py:32-96, scannet_utils.py:35-76):

* per-scene `{scene}_vert.npy` (XYZ+RGB, axis-aligned),
  `{scene}_sem_label.npy` (nyu40 ids), `{scene}_ins_label.npy`
  (1-indexed instances), `{scene}_bbox.npy`
  ((cx,cy,cz,dx,dy,dz,obj_id) rows);
* aggregation json -> objectId+1 -> segment lists; segmentation json ->
  segment -> vertex lists; TSV label mapping raw_category -> nyu40id.

Numpy-vectorised: the reference's per-vertex Python loops become
`np.isin` / scatter assignments.

    python -m object_nerf_torch.data_prep.scannet_labels --scannet_dir scans \
        --label_map_file scannetv2-labels.combined.tsv --output_dir out [--scans ...]
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from pathlib import Path

import numpy as np

from ..data.ply_io import read_ply


def read_label_mapping(filename, label_from="raw_category", label_to="nyu40id"):
    mapping = {}
    with open(filename) as f:
        reader = csv.DictReader(f, delimiter="\t")
        for row in reader:
            mapping[row[label_from]] = int(row[label_to])
    return mapping


def read_mesh_vertices_rgb(filename) -> np.ndarray:
    """(N, 6) xyz + rgb(0-255)."""
    mesh = read_ply(filename)
    pts = mesh["points"]
    colors = mesh["colors"]
    if colors is None:
        colors = np.zeros_like(pts)
    return np.concatenate([pts, colors * 255.0], axis=-1)


def read_aggregation(filename):
    """objectId+1 → segments; label → segments (load_scannet_data.py:27-45)."""
    with open(filename) as f:
        data = json.load(f)
    object_id_to_segs, label_to_segs = {}, {}
    for group in data["segGroups"]:
        object_id = group["objectId"] + 1  # 1-indexed instances
        object_id_to_segs[object_id] = group["segments"]
        label_to_segs.setdefault(group["label"], []).extend(group["segments"])
    return object_id_to_segs, label_to_segs


def read_segmentation(filename):
    """vertex → segment id array (vectorized)."""
    with open(filename) as f:
        seg_indices = np.asarray(json.load(f)["segIndices"], np.int64)
    return seg_indices


def export(mesh_file, agg_file, seg_file, meta_file, label_map_file,
           output_file=None):
    """Returns (mesh_vertices, label_ids, instance_ids, instance_bboxes,
    object_id_to_label_id) — the reference `export` contract."""
    label_map = read_label_mapping(label_map_file)
    mesh_vertices = read_mesh_vertices_rgb(mesh_file)

    axis_align_matrix = np.eye(4)
    for line in open(meta_file):
        if "axisAlignment" in line:
            vals = [
                float(x) for x in line.rstrip().strip("axisAlignment = ").split(" ")
            ]
            axis_align_matrix = np.array(vals).reshape(4, 4)
            break
    pts = np.concatenate(
        [mesh_vertices[:, :3], np.ones((len(mesh_vertices), 1))], axis=1
    )
    mesh_vertices[:, :3] = (pts @ axis_align_matrix.T)[:, :3]

    object_id_to_segs, label_to_segs = read_aggregation(agg_file)
    seg_of_vertex = read_segmentation(seg_file)
    num_verts = len(seg_of_vertex)

    label_ids = np.zeros(num_verts, np.uint32)
    for label, segs in label_to_segs.items():
        label_ids[np.isin(seg_of_vertex, segs)] = label_map[label]

    instance_ids = np.zeros(num_verts, np.uint32)
    object_id_to_label_id = {}
    for object_id, segs in object_id_to_segs.items():
        mask = np.isin(seg_of_vertex, segs)
        instance_ids[mask] = object_id
        if mask.any():
            object_id_to_label_id[object_id] = int(label_ids[mask][0])

    num_instances = len(object_id_to_segs)
    instance_bboxes = np.zeros((num_instances, 7))
    for obj_id in object_id_to_segs:
        pc = mesh_vertices[instance_ids == obj_id, :3]
        if len(pc) == 0:
            continue
        mn, mx = pc.min(0), pc.max(0)
        instance_bboxes[obj_id - 1] = np.concatenate(
            [(mn + mx) / 2, mx - mn, [obj_id]]
        )

    if output_file is not None:
        np.save(output_file + "_vert.npy", mesh_vertices)
        np.save(output_file + "_sem_label.npy", label_ids)
        np.save(output_file + "_ins_label.npy", instance_ids)
        np.save(output_file + "_bbox.npy", instance_bboxes)
    return (mesh_vertices, label_ids, instance_ids, instance_bboxes,
            object_id_to_label_id)


def export_one_scan(scannet_dir, scan_name, label_map_file, output_prefix):
    """batch driver unit (batch_load_scannet_data.py:32-60)."""
    base = Path(scannet_dir) / scan_name
    return export(
        mesh_file=str(base / f"{scan_name}_vh_clean_2.ply"),
        agg_file=str(base / f"{scan_name}.aggregation.json"),
        seg_file=str(base / f"{scan_name}_vh_clean_2.0.010000.segs.json"),
        meta_file=str(base / f"{scan_name}.txt"),
        label_map_file=label_map_file,
        output_file=str(output_prefix),
    )


def main(argv=None):
    p = argparse.ArgumentParser(description="Batch-export ScanNet scan labels")
    p.add_argument("--scannet_dir", required=True)
    p.add_argument("--label_map_file", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--scans", nargs="*", default=None,
                   help="scan names; default: all under scannet_dir")
    args = p.parse_args(argv)

    scans = args.scans or sorted(os.listdir(args.scannet_dir))
    os.makedirs(args.output_dir, exist_ok=True)
    for scan in scans:
        out = Path(args.output_dir) / scan
        try:
            export_one_scan(args.scannet_dir, scan, args.label_map_file, out)
            print(f"exported {scan}")
        except Exception as e:  # per-scan robustness (batch_load:88-91)
            print(f"FAILED {scan}: {e}")


if __name__ == "__main__":
    main()
