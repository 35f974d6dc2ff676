"""ScanNet `.sens` binary capture parser and exporter.

Own copy of `object_nerf_tpu/data_prep/sens_reader.py`. Format parity with
the reference SensorData
(data_preparation/scannet_sens_reader/SensorData.py:16-163): version-4
header (sensor name, 4x4 colour/depth intrinsics and extrinsics, compression
types, sizes, depth shift), then per-frame records of (4x4 c2w pose, two
timestamps, compressed colour (jpeg) and depth (zlib'd uint16)).

Frames parse through one buffered reader (`struct.unpack_from` on a
memoryview); decompression is lazy per frame. Depth, poses and intrinsics
need numpy only: depth PNGs are 16-bit grey through the port's `png_io`,
resized as cv2's INTER_NEAREST by `image_utils.resize_nearest`. Colour is
JPEG: `imageio` decodes and writes it, imported only by the colour functions
(an error names it where it is missing), and `resize_nearest` resizes it.

    python -m object_nerf_torch.data_prep.sens_reader --filename scan.sens \
        --output_path out [--export_depth_images] [--export_color_images] \
        [--export_poses] [--export_intrinsics] [--frame_skip N]
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..data.image_utils import resize_nearest
from ..data.png_io import write_png

COMPRESSION_TYPE_COLOR = {-1: "unknown", 0: "raw", 1: "png", 2: "jpeg"}
COMPRESSION_TYPE_DEPTH = {
    -1: "unknown", 0: "raw_ushort", 1: "zlib_ushort", 2: "occi_ushort",
}


def _imageio():
    """imageio's v2 API, which decodes and writes the JPEG colour frames."""
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise ImportError("colour frames of a .sens capture are JPEG: decoding and writing "
                          "them needs the imageio package (depth, poses and intrinsics do "
                          "not)") from e
    return imageio


@dataclass
class RGBDFrame:
    camera_to_world: np.ndarray
    timestamp_color: int
    timestamp_depth: int
    color_data: bytes
    depth_data: bytes

    def decompress_depth(self, compression_type: str) -> bytes:
        if compression_type != "zlib_ushort":
            raise ValueError(f"unsupported depth compression {compression_type}")
        return zlib.decompress(self.depth_data)

    def decompress_color(self, compression_type: str) -> np.ndarray:
        if compression_type != "jpeg":
            raise ValueError(f"unsupported color compression {compression_type}")
        return _imageio().imread(self.color_data)


@dataclass
class SensorData:
    sensor_name: str = ""
    intrinsic_color: np.ndarray = None
    extrinsic_color: np.ndarray = None
    intrinsic_depth: np.ndarray = None
    extrinsic_depth: np.ndarray = None
    color_compression_type: str = "jpeg"
    depth_compression_type: str = "zlib_ushort"
    color_width: int = 0
    color_height: int = 0
    depth_width: int = 0
    depth_height: int = 0
    depth_shift: float = 1000.0
    frames: List[RGBDFrame] = field(default_factory=list)

    VERSION = 4

    @classmethod
    def load(cls, filename) -> "SensorData":
        buf = memoryview(open(filename, "rb").read())
        ofs = 0

        def take(fmt):
            nonlocal ofs
            vals = struct.unpack_from(fmt, buf, ofs)
            ofs += struct.calcsize(fmt)
            return vals

        def take_mat():
            return np.array(take("16f"), np.float32).reshape(4, 4)

        sd = cls()
        (version,) = take("I")
        if version != cls.VERSION:
            raise ValueError(f".sens version {version}, expected {cls.VERSION}")
        (strlen,) = take("Q")
        sd.sensor_name = bytes(buf[ofs : ofs + strlen]).decode(
            "ascii", errors="replace"
        )
        ofs += strlen
        sd.intrinsic_color = take_mat()
        sd.extrinsic_color = take_mat()
        sd.intrinsic_depth = take_mat()
        sd.extrinsic_depth = take_mat()
        sd.color_compression_type = COMPRESSION_TYPE_COLOR[take("i")[0]]
        sd.depth_compression_type = COMPRESSION_TYPE_DEPTH[take("i")[0]]
        sd.color_width, sd.color_height = take("2I")
        sd.depth_width, sd.depth_height = take("2I")
        (sd.depth_shift,) = take("f")
        (num_frames,) = take("Q")
        for _ in range(num_frames):
            pose = np.array(take("16f"), np.float32).reshape(4, 4)
            ts_c, ts_d, n_color, n_depth = take("4Q")
            color = bytes(buf[ofs : ofs + n_color])
            ofs += n_color
            depth = bytes(buf[ofs : ofs + n_depth])
            ofs += n_depth
            sd.frames.append(RGBDFrame(pose, ts_c, ts_d, color, depth))
        return sd

    # -- export (reader.py CLI parity) ---------------------------------------
    def export_depth_images(self, output_path, image_size=None, frame_skip=1):
        """16-bit grey `<i>.png` of every `frame_skip`-th frame; `image_size`
        is (H, W)."""
        os.makedirs(output_path, exist_ok=True)
        for i in range(0, len(self.frames), frame_skip):
            raw = self.frames[i].decompress_depth(self.depth_compression_type)
            depth = np.frombuffer(raw, np.uint16).reshape(
                self.depth_height, self.depth_width
            )
            if image_size is not None:
                depth = resize_nearest(depth, (image_size[1], image_size[0]))
            write_png(os.path.join(output_path, f"{i}.png"), depth)

    def export_color_images(self, output_path, image_size=None, frame_skip=1):
        """`<i>.jpg` of every `frame_skip`-th frame (imageio); `image_size` is
        (H, W)."""
        imageio = _imageio()
        os.makedirs(output_path, exist_ok=True)
        for i in range(0, len(self.frames), frame_skip):
            color = self.frames[i].decompress_color(self.color_compression_type)
            if image_size is not None:
                color = resize_nearest(color, (image_size[1], image_size[0]))
            imageio.imwrite(os.path.join(output_path, f"{i}.jpg"), color)

    def export_poses(self, output_path, frame_skip=1):
        os.makedirs(output_path, exist_ok=True)
        for i in range(0, len(self.frames), frame_skip):
            np.savetxt(
                os.path.join(output_path, f"{i}.txt"),
                self.frames[i].camera_to_world, fmt="%f",
            )

    def export_intrinsics(self, output_path):
        os.makedirs(output_path, exist_ok=True)
        for name, mat in (
            ("intrinsic_color", self.intrinsic_color),
            ("extrinsic_color", self.extrinsic_color),
            ("intrinsic_depth", self.intrinsic_depth),
            ("extrinsic_depth", self.extrinsic_depth),
        ):
            np.savetxt(os.path.join(output_path, f"{name}.txt"), mat, fmt="%f")


def write_sens(filename, sd: SensorData) -> None:
    """Serialise a SensorData back to `.sens` (round trips and fixtures)."""
    with open(filename, "wb") as f:
        f.write(struct.pack("I", SensorData.VERSION))
        name = sd.sensor_name.encode("ascii")
        f.write(struct.pack("Q", len(name)))
        f.write(name)
        for mat in (sd.intrinsic_color, sd.extrinsic_color,
                    sd.intrinsic_depth, sd.extrinsic_depth):
            f.write(struct.pack("16f", *np.asarray(mat, np.float32).reshape(-1)))
        inv_c = {v: k for k, v in COMPRESSION_TYPE_COLOR.items()}
        inv_d = {v: k for k, v in COMPRESSION_TYPE_DEPTH.items()}
        f.write(struct.pack("i", inv_c[sd.color_compression_type]))
        f.write(struct.pack("i", inv_d[sd.depth_compression_type]))
        f.write(struct.pack("2I", sd.color_width, sd.color_height))
        f.write(struct.pack("2I", sd.depth_width, sd.depth_height))
        f.write(struct.pack("f", sd.depth_shift))
        f.write(struct.pack("Q", len(sd.frames)))
        for fr in sd.frames:
            f.write(struct.pack("16f", *fr.camera_to_world.reshape(-1)))
            f.write(struct.pack("4Q", fr.timestamp_color, fr.timestamp_depth,
                                len(fr.color_data), len(fr.depth_data)))
            f.write(fr.color_data)
            f.write(fr.depth_data)


def main(argv=None):
    """CLI parity with data_preparation/scannet_sens_reader/reader.py."""
    import argparse

    p = argparse.ArgumentParser(description="Export a ScanNet .sens capture")
    p.add_argument("--filename", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--export_depth_images", action="store_true")
    p.add_argument("--export_color_images", action="store_true")
    p.add_argument("--export_poses", action="store_true")
    p.add_argument("--export_intrinsics", action="store_true")
    p.add_argument("--frame_skip", type=int, default=1)
    args = p.parse_args(argv)

    sd = SensorData.load(args.filename)
    print(f"loaded {args.filename}: {len(sd.frames)} frames")
    if args.export_depth_images:
        sd.export_depth_images(
            os.path.join(args.output_path, "depth"), frame_skip=args.frame_skip
        )
    if args.export_color_images:
        sd.export_color_images(
            os.path.join(args.output_path, "color"), frame_skip=args.frame_skip
        )
    if args.export_poses:
        sd.export_poses(
            os.path.join(args.output_path, "pose"), frame_skip=args.frame_skip
        )
    if args.export_intrinsics:
        sd.export_intrinsics(os.path.join(args.output_path, "intrinsic"))


if __name__ == "__main__":
    main()
