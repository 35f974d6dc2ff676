"""The port's data preparation (`object_nerf_torch/data_prep/`) against the
JAX package's (`object_nerf_tpu/data_prep/`): the same `.sens` capture, scan
and export directory go through both. Every comparison is bit-equal: bytes of
the `.sens` files, text files and JSON, decoded pixels of the PNGs and JPEGs
(the JAX side writes them with cv2 and imageio, the port's depth with its own
PNG codec), and every array and `.npy` file of the label export."""

import io
import json
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest

from object_nerf_tpu.data_prep import convert_nerf as jcn
from object_nerf_tpu.data_prep import scannet_labels as jsl
from object_nerf_tpu.data_prep import sens_reader as jsr
from object_nerf_torch.data.png_io import read_png
from object_nerf_torch.data.ply_io import write_ply
from object_nerf_torch.data_prep import convert_nerf as tcn
from object_nerf_torch.data_prep import scannet_labels as tsl
from object_nerf_torch.data_prep import sens_reader as tsr

DW, DH, CW, CH = 20, 14, 24, 18  # depth and colour sizes of the capture


def _frames(n_frames, seed=0):
    """(pose, ts_c, ts_d, jpeg bytes, zlib'd depth) of each frame, from a seed."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n_frames):
        y, x = np.mgrid[0:CH, 0:CW]
        img = np.clip(np.stack([x * 9, y * 13, (x + y) * 5], -1) + rng.randint(0, 40, (CH, CW, 3)),
                      0, 255).astype(np.uint8)
        buf = io.BytesIO()
        imageio.imwrite(buf, img, format="jpeg")
        depth = (rng.rand(DH, DW) * 4000).astype(np.uint16)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
        pose[:3, 3] = rng.randn(3) * 2
        out.append((pose, 1000 * i, 1000 * i + 7, buf.getvalue(),
                    zlib.compress(depth.tobytes())))
    return out


def _sensor_data(mod, frames):
    sd = mod.SensorData()
    sd.sensor_name = "StructureSensor"
    sd.intrinsic_color = np.array([[580.5, 0, 319.5, 0], [0, 581, 239.5, 0], [0, 0, 1, 0],
                                   [0, 0, 0, 1]], np.float32)
    sd.extrinsic_color = np.eye(4, dtype=np.float32)
    sd.intrinsic_depth = np.diag([290.25, 290.5, 1, 1]).astype(np.float32)
    sd.extrinsic_depth = np.eye(4, dtype=np.float32) * 1.5
    sd.color_width, sd.color_height = CW, CH
    sd.depth_width, sd.depth_height = DW, DH
    for f in frames:
        sd.frames.append(mod.RGBDFrame(*f))
    return sd


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """One `.sens` file written by each package from the same frames."""
    root = tmp_path_factory.mktemp("sens")
    frames = _frames(5)
    for name, mod in (("jax", jsr), ("port", tsr)):
        mod.write_sens(root / f"{name}.sens", _sensor_data(mod, frames))
    return root


def test_write_sens_bytes_equal(capture):
    data = (capture / "port.sens").read_bytes()
    assert data == (capture / "jax.sens").read_bytes() and len(data) > 1000


def test_load_sens_equal(capture):
    a, b = tsr.SensorData.load(capture / "jax.sens"), jsr.SensorData.load(capture / "jax.sens")
    for k in ("sensor_name", "color_compression_type", "depth_compression_type",
              "color_width", "color_height", "depth_width", "depth_height", "depth_shift"):
        assert getattr(a, k) == getattr(b, k), k
    for k in ("intrinsic_color", "extrinsic_color", "intrinsic_depth", "extrinsic_depth"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert getattr(a, k).dtype == getattr(b, k).dtype == np.float32
    assert len(a.frames) == len(b.frames) == 5
    for fa, fb in zip(a.frames, b.frames):
        np.testing.assert_array_equal(fa.camera_to_world, fb.camera_to_world)
        assert (fa.timestamp_color, fa.timestamp_depth, fa.color_data, fa.depth_data) == \
               (fb.timestamp_color, fb.timestamp_depth, fb.color_data, fb.depth_data)
    with pytest.raises(ValueError, match="version"):
        bad = capture / "bad.sens"
        bad.write_bytes(b"\x03\x00\x00\x00" + (capture / "jax.sens").read_bytes()[4:])
        tsr.SensorData.load(bad)


@pytest.mark.parametrize("image_size", [None, (9, 31)], ids=["native", "resized"])
def test_depth_export_decodes_equal(capture, tmp_path, image_size):
    """16-bit depth PNGs (the port's codec; JAX: imageio, and cv2 to resize)
    decode to the same arrays, every second frame; `image_size` is (H, W)."""
    for name, mod in (("jax", jsr), ("port", tsr)):
        mod.SensorData.load(capture / "jax.sens").export_depth_images(
            tmp_path / name, image_size=image_size, frame_skip=2)
    files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "jax").iterdir()) == \
        ["0.png", "2.png", "4.png"]
    for f in files:
        a = read_png(tmp_path / "port" / f)
        b = cv2.imread(str(tmp_path / "jax" / f), cv2.IMREAD_UNCHANGED)
        assert a.dtype == b.dtype == np.uint16
        assert a.shape == (image_size or (DH, DW))
        np.testing.assert_array_equal(a, b)


def test_pose_and_intrinsics_text_equal(capture, tmp_path):
    for name, mod in (("jax", jsr), ("port", tsr)):
        sd = mod.SensorData.load(capture / "jax.sens")
        sd.export_poses(tmp_path / name / "pose")
        sd.export_intrinsics(tmp_path / name / "intrinsic")
    for sub, n in (("pose", 5), ("intrinsic", 4)):
        files = sorted((tmp_path / "port" / sub).iterdir())
        assert len(files) == n
        for f in files:
            assert f.read_bytes() == (tmp_path / "jax" / sub / f.name).read_bytes(), f


@pytest.mark.parametrize("image_size", [None, (11, 13)], ids=["native", "resized"])
def test_colour_export_pixel_equal(capture, tmp_path, image_size):
    """JPEG frames through imageio on both sides, resized by the port's
    nearest (JAX: cv2's INTER_NEAREST): the files decode equal."""
    for name, mod in (("jax", jsr), ("port", tsr)):
        mod.SensorData.load(capture / "jax.sens").export_color_images(
            tmp_path / name, image_size=image_size)
    for i in range(5):
        a = imageio.imread(tmp_path / "port" / f"{i}.jpg")
        b = imageio.imread(tmp_path / "jax" / f"{i}.jpg")
        assert a.shape == (image_size or (CH, CW)) + (3,)
        np.testing.assert_array_equal(a, b)


def test_split_tags_equal():
    assert [tcn.split_tags(i) for i in range(400)] == [jcn.split_tags(i) for i in range(400)]
    assert tcn.split_tags(0) == ["test"] and tcn.split_tags(110) == ["val"]
    assert tcn.split_tags(15) == [] and tcn.split_tags(121) == ["train"]


@pytest.fixture(scope="module")
def unpacked(capture, tmp_path_factory):
    """The capture exported as the reader's CLI does (by the JAX package),
    with instance and instance-filt masks beside it."""
    root = tmp_path_factory.mktemp("unpacked")
    jsr.main(["--filename", str(capture / "jax.sens"), "--output_path", str(root),
              "--export_depth_images", "--export_color_images", "--export_poses",
              "--export_intrinsics"])
    rng = np.random.RandomState(3)
    for sub in ("instance", "instance_filt"):
        (root / sub).mkdir()
        for i in range(5):
            cv2.imwrite(str(root / sub / f"{i}.png"), rng.randint(0, 9, (DH, DW)).astype(np.uint8))
    return root


def test_convert_equal(unpacked, tmp_path):
    """The four transforms files byte-equal, full/*.png pixel-equal (cv2's
    decode and INTER_LINEAR on both sides; the port writes through png_io),
    depth and masks copied."""
    kw = dict(instance_dir=unpacked / "instance", instance_filt_dir=unpacked / "instance_filt",
              img_wh=(32, 24))
    infos_p = tcn.convert(unpacked, tmp_path / "port", **kw)
    infos_j = jcn.convert(unpacked, tmp_path / "jax", **kw)
    assert infos_p == infos_j
    for tag in ("train", "test", "val", "full"):
        f = f"transforms_{tag}.json"
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    assert len(json.loads((tmp_path / "port" / "transforms_full.json").read_text())["frames"]) \
        == 5
    names = sorted(p.name for p in (tmp_path / "port" / "full").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax" / "full").iterdir())
    assert len(names) == 5 * 4
    for f in names:
        a, b = tmp_path / "port" / "full" / f, tmp_path / "jax" / "full" / f
        if f.count(".") == 1:  # the colour frame
            got = read_png(a)
            assert got.shape == (24, 32, 3)
            np.testing.assert_array_equal(got, cv2.imread(str(b))[..., ::-1])
        else:
            assert a.read_bytes() == b.read_bytes(), f


def test_convert_main_argv(unpacked, tmp_path):
    tcn.main(["--input", str(unpacked), "--output", str(tmp_path / "out")])
    assert (tmp_path / "out" / "full" / "4.png").exists()
    assert read_png(tmp_path / "out" / "full" / "0.png").shape == (480, 640, 3)


def _scan(root, name, n_objects, seed):
    """A labelled scan in ScanNet's layout: vertices with colours, segments,
    aggregation, an axisAlignment and its files' names."""
    rng = np.random.RandomState(seed)
    base = root / name
    base.mkdir(parents=True)
    n = 60
    verts = rng.randn(n, 3).astype(np.float32) * 2
    write_ply(base / f"{name}_vh_clean_2.ply", verts, colors=rng.rand(n, 3))
    seg = rng.randint(0, 8, n) * 10 + 3
    (base / f"{name}_vh_clean_2.0.010000.segs.json").write_text(
        json.dumps({"segIndices": seg.tolist()}))
    labels = ("chair", "table")
    groups = [{"objectId": k, "label": labels[k % 2],
               "segments": [int(10 * s + 3) for s in (2 * k, 2 * k + 1)]}
              for k in range(n_objects)]
    (base / f"{name}.aggregation.json").write_text(json.dumps({"segGroups": groups}))
    rot = np.linalg.qr(rng.randn(3, 3))[0]
    align = np.eye(4)
    align[:3, :3], align[:3, 3] = rot, rng.randn(3)
    (base / f"{name}.txt").write_text(
        "sceneType = Bedroom\naxisAlignment = " + " ".join(repr(float(v)) for v in align.reshape(-1))
        + "\n")


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    root = tmp_path_factory.mktemp("scans")
    _scan(root / "scans", "scene0000_00", 3, 0)
    _scan(root / "scans", "scene0002_00", 4, 2)
    (root / "scans" / "scene0001_00").mkdir()  # broken: no files
    (root / "labels.tsv").write_text("raw_category\tnyu40id\tcategory\n"
                                     "chair\t5\tchair\ntable\t7\ttable\n")
    return root


def test_label_export_equal(scans, tmp_path):
    args = [str(scans / "scans" / "scene0002_00" / f) for f in (
        "scene0002_00_vh_clean_2.ply", "scene0002_00.aggregation.json",
        "scene0002_00_vh_clean_2.0.010000.segs.json", "scene0002_00.txt")]
    got = tsl.export(*args, str(scans / "labels.tsv"), output_file=str(tmp_path / "port"))
    want = jsl.export(*args, str(scans / "labels.tsv"), output_file=str(tmp_path / "jax"))
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[4] == want[4] and len(got[3]) == 4
    assert not np.array_equal(got[0][:, :3], tsl.read_mesh_vertices_rgb(args[0])[:, :3])
    for k in ("vert", "sem_label", "ins_label", "bbox"):
        assert (tmp_path / f"port_{k}.npy").read_bytes() == (tmp_path / f"jax_{k}.npy").read_bytes()


def test_label_main_equal_with_a_broken_scan(scans, tmp_path, capsys):
    """`main` over three scans, the middle one broken: it prints FAILED for
    that one, as the JAX package does, and still exports the next; the
    same lines and `.npy` files on both sides."""
    common = ["--scannet_dir", str(scans / "scans"), "--label_map_file", str(scans / "labels.tsv")]
    tsl.main(common + ["--output_dir", str(tmp_path / "port")])
    port_log = capsys.readouterr().out
    jsl.main(common + ["--output_dir", str(tmp_path / "jax")])
    assert capsys.readouterr().out == port_log
    lines = port_log.splitlines()
    assert lines[0] == "exported scene0000_00" and lines[1].startswith("FAILED scene0001_00: ")
    assert lines[2] == "exported scene0002_00"
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir()) and len(names) == 8
    for f in names:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
