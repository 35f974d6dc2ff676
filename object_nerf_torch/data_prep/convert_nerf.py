"""ScanNet export dir -> NeRF-style dataset.

Own copy of `object_nerf_tpu/data_prep/convert_nerf.py`. Output parity with
the reference converter
(data_preparation/scannet_sens_reader/convert_to_nerf_style_data.py:25-124):

* `transforms_{train,test,val,full}.json` with `camera_angle_x` (from the
  colour intrinsics) and frames of `{file_path: "./full/<i>", transform_matrix
  (OpenCV-convention c2w), idx}`;
* split rule: every 100th frame -> test, frames exactly +-10 around a
  multiple of 100 -> val, frames > +-20 away -> train;
* 640x480 `full/<i>.png` colour, copied `<i>.depth.png`, optional copied
  instance / instance-filt masks.

The colour frames are JPEG: cv2 decodes them and resizes them (its default
INTER_LINEAR), imported when `convert` runs, so the pixels are the JAX
package's; an error names cv2 where it is missing. The PNGs are written by
the port's `png_io`, in RGB order, and the width of `camera_angle_x` is the
decoded first frame's.

    python -m object_nerf_torch.data_prep.convert_nerf --input unpacked --output nerf \
        [--instance_dir DIR] [--instance_filt_dir DIR]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
from pathlib import Path

import numpy as np

from ..data.png_io import write_png


def split_tags(i: int, test_step=100, test_bound=20, val_bound=10):
    """Which split lists frame `i` belongs to (besides 'full')."""
    tags = []
    if i % test_step == 0:
        tags.append("test")
    elif abs(i - round(i / test_step) * test_step) == val_bound:
        tags.append("val")
    elif abs(i - round(i / test_step) * test_step) > test_bound:
        tags.append("train")
    return tags


def convert(input_dir, output_dir, instance_dir=None, instance_filt_dir=None,
            img_wh=(640, 480)):
    try:
        import cv2
    except ImportError as e:
        raise ImportError("convert decodes and resizes the JPEG colour frames with cv2: "
                          "it needs the opencv-python package") from e

    input_dir, output_dir = Path(input_dir), Path(output_dir)
    k_color = np.loadtxt(input_dir / "intrinsic" / "intrinsic_color.txt")

    first = cv2.imread(str(input_dir / "color" / "0.jpg"), -1)
    if first is None:
        raise FileNotFoundError(input_dir / "color" / "0.jpg")
    w = first.shape[1]
    focal = (k_color[0, 0] + k_color[1, 1]) / 2
    fov_x = float(np.arctan(w / 2 / focal) * 2)

    (output_dir / "full").mkdir(parents=True, exist_ok=True)
    infos = {
        t: {"camera_angle_x": fov_x, "frames": []}
        for t in ("train", "test", "val", "full")
    }

    n = len(list((input_dir / "color").glob("*.jpg")))
    for i in range(n):
        color_file = input_dir / "color" / f"{i}.jpg"
        if not color_file.exists():
            break
        image = cv2.resize(cv2.imread(str(color_file), -1), img_wh)
        if image.ndim == 3:  # cv2's BGR
            image = image[..., [2, 1, 0]]
        write_png(output_dir / "full" / f"{i}.png", image)
        depth_file = input_dir / "depth" / f"{i}.png"
        if depth_file.exists():
            shutil.copy2(depth_file, output_dir / "full" / f"{i}.depth.png")
        if instance_dir:
            shutil.copy2(
                Path(instance_dir) / f"{i}.png",
                output_dir / "full" / f"{i}.instance.png",
            )
        if instance_filt_dir:
            shutil.copy2(
                Path(instance_filt_dir) / f"{i}.png",
                output_dir / "full" / f"{i}.instance-filt.png",
            )

        pose = np.loadtxt(input_dir / "pose" / f"{i}.txt")
        meta = {
            "file_path": f"./full/{i}",
            "transform_matrix": pose.tolist(),
            "idx": i,
        }
        for tag in ["full"] + split_tags(i):
            infos[tag]["frames"].append(copy.deepcopy(meta))

    for tag, info in infos.items():
        with open(output_dir / f"transforms_{tag}.json", "w") as f:
            json.dump(info, f, indent=4)
    return infos


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input", required=True, help="ScanNet sens unpack dir")
    p.add_argument("--output", required=True)
    p.add_argument("--instance_dir", default=None)
    p.add_argument("--instance_filt_dir", default=None)
    args = p.parse_args(argv)
    convert(args.input, args.output, args.instance_dir, args.instance_filt_dir)


if __name__ == "__main__":
    main()
