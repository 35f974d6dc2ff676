"""The port's scene viewer tools (`object_nerf_torch/tools/{visualize,
html_viewer,scene_visualizer,visualize_instance_2d}.py`) against the JAX
package's (`object_nerf_tpu/tools/visualize.py`, `html_viewer.py` and the
top-level `tools/scene_visualizer.py`). Every comparison is bit-equal: the
same calls write the same PLY and HTML bytes, and the instance inspector finds
the same ids and counts; its overlay is the port's own drawing, held against
matplotlib's tab20 outside the label boxes."""

import base64
import importlib.util
import json
import re
from pathlib import Path

import cv2
import numpy as np
import pytest

from object_nerf_tpu.data.ply_io import read_ply as jax_read_ply
from object_nerf_tpu.tools import visualize as jv
from object_nerf_torch.data.png_io import PNGError, read_png, write_png
from object_nerf_torch.data.ply_io import read_ply, write_ply
from object_nerf_torch.scripts.make_synthetic_dataset import make_dataset
from object_nerf_torch.tools import scene_visualizer, visualize as tv
from object_nerf_torch.tools.visualize_instance_2d import main as inspector_main

ROOT = Path(__file__).resolve().parents[1]


def _cube_mesh():
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    faces = np.array([[0, 1, 2], [0, 1, 3]])
    return verts, faces


# the calls of tests/test_visualize.py's cases, one scene each, and all at once
CASES = {
    "points": lambda v: v.add_points(np.random.RandomState(0).rand(100, 3).astype(np.float32),
                                     colors=np.ones((100, 3), np.float32) * 0.5),
    "bbox": lambda v: v.add_bbox(np.array([[0, 0, 0], [1, 1, 1]], np.float32),
                                 color=(1, 0, 0)),
    "bbox_transform": lambda v: v.add_bbox(np.array([[-0.2, -0.1, 0], [0.3, 0.2, 0.4]]),
                                           transform=np.array([[0, -1, 0, 0.5], [1, 0, 0, 0.1],
                                                               [0, 0, 1, -0.2], [0, 0, 0, 1.0]])),
    "camera": lambda v: v.add_camera(np.eye(4)[:3], scale=0.2),
    "trajectory": lambda v: v.add_trajectory([np.eye(4)[:3], np.eye(4)[:3] + 0.1,
                                              np.eye(4)[:3] - 0.3]),
    "mesh": lambda v: v.add_mesh(*_cube_mesh()),
    "mesh_colors": lambda v: v.add_mesh(*_cube_mesh(), colors=np.eye(4, 3) * 0.9 + 0.05),
    "line_label": lambda v: (v.add_points(np.zeros((10, 3), np.float32)),
                             v.add_line([0, 0, 0], [1, 1, 1]),
                             v.add_label([0.5, 0.5, 0.5], "obj 4 </script>")),
    "empty": lambda v: None,
}
_EACH = dict(CASES)
CASES["all"] = lambda v: [f(v) for f in _EACH.values()]


def _both(case):
    vis_jax, vis_port = jv.SceneVisualizer(), tv.SceneVisualizer()
    CASES[case](vis_jax)
    CASES[case](vis_port)
    return vis_jax, vis_port


@pytest.mark.parametrize("case", sorted(CASES))
def test_scene_visualizer_html_and_ply_bit_equal(tmp_path, case):
    """The six cases of tests/test_visualize.py (points, box, camera,
    trajectory, mesh, label) and a few more: the HTML and the PLY are
    byte-equal to the JAX package's."""
    vis_jax, vis_port = _both(case)
    jax_html = vis_jax.save(str(tmp_path / "jax.html"))
    port_html = vis_port.save(str(tmp_path / "port.html"))
    assert port_html == str(tmp_path / "port.html")
    assert open(port_html, "rb").read() == open(jax_html, "rb").read()
    vis_jax.save(tmp_path / "jax.ply")
    vis_port.save(tmp_path / "port.ply")
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    a, b = read_ply(tmp_path / "port.ply"), jax_read_ply(tmp_path / "jax.ply")
    for k in ("points", "colors"):
        np.testing.assert_array_equal(a[k], b[k])


def _html_data(path):
    html = open(path).read()
    data = json.loads(re.search(r"const DATA=(\[.*?\]), LABELS", html).group(1))
    labels = json.loads(re.search(r"LABELS=(\[.*?\]), CENTER", html).group(1))
    return {d["name"]: d for d in data}, labels


def test_html_layers_decode_as_test_visualize_reads_them(tmp_path):
    """The point, line and mesh layers of tests/test_visualize.py's HTML
    case, decoded from the port's file."""
    vis = tv.SceneVisualizer()
    CASES["points"](vis)
    vis.add_bbox(np.array([[0, 0, 0], [1, 1, 1]], np.float32))
    vis.add_camera(np.eye(4))
    CASES["mesh"](vis)
    vis.add_label([0.5, 0.5, 0.5], "obj 4")
    layers, labels = _html_data(vis.save(str(tmp_path / "scene.html")))
    assert layers["points"]["n"] == 100 and layers["lines"]["n"] == 32
    assert layers["mesh_0"]["n"] == 6 and labels == [{"p": [0.5, 0.5, 0.5], "t": "obj 4"}]
    for d in layers.values():
        assert len(base64.b64decode(d["pos"])) == d["n"] * 3 * 4


@pytest.mark.parametrize("out", ["scene.ply", "scene.html"])
def test_visualize_scene_matches_jax(tmp_path, out):
    pcd = tmp_path / "pcd.ply"
    rng = np.random.RandomState(1)
    write_ply(pcd, rng.rand(40, 3), colors=rng.rand(40, 3))
    poses = [np.eye(4) + 0.05 * k for k in range(3)]
    boxes = [np.array([[0, 0, 0], [1, 1, 1.0]]),
             {"bounds": np.array([[0, 0, 0], [0.5, 0.5, 0.5]]), "color": (0, 1, 0)}]
    a = tv.visualize_scene(str(pcd), poses, boxes, out=str(tmp_path / f"port_{out}"))
    b = jv.visualize_scene(str(pcd), poses, boxes, out=str(tmp_path / f"jax_{out}"))
    assert open(a, "rb").read() == open(b, "rb").read()


def _load_jax_cli():
    spec = importlib.util.spec_from_file_location("jax_scene_visualizer",
                                                  ROOT / "tools" / "scene_visualizer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def desk(tmp_path_factory):
    """A desk of the port's dataset writer (12 frames at 32 x 24) and a mesh
    PLY with faces."""
    root = tmp_path_factory.mktemp("desk")
    make_dataset(root / "desk", (32, 24), 12)
    verts, faces = _cube_mesh()
    write_ply(root / "mesh.ply", verts, colors=np.full((4, 3), 0.4), faces=faces)
    return root


@pytest.mark.parametrize("out", ["desk.html", "desk.ply"])
def test_scene_viewer_cli_matches_jax_cli(desk, tmp_path, capsys, out):
    """`python -m object_nerf_torch.tools.scene_visualizer` and the JAX
    package's `tools/scene_visualizer.py` on the same desk, mesh and
    instances (id 9 has no box: both print that it is skipped): the same file,
    byte for byte, and in the HTML the same DATA and LABELS."""
    scene = desk / "desk"
    args = [f"dataset_config={ROOT / 'config' / 'synthetic_desk.yml'}",
            f"dataset_extra.root_dir={scene}", f"dataset_extra.bbox_dir={scene}/bbox.json",
            f"dataset_extra.pcd_path={scene}/pcd.ply", "dataset_extra.instance_id=[1,2,3,9]",
            f"mesh={desk / 'mesh.ply'}"]
    scene_visualizer.main(args + [f"out={tmp_path / ('port_' + out)}"])
    port_log = capsys.readouterr().out
    _load_jax_cli().main(args + [f"out={tmp_path / ('jax_' + out)}"])
    jax_log = capsys.readouterr().out
    assert port_log.replace("port_", "") == jax_log.replace("jax_", "")
    assert "bbox for instance 9 skipped" in port_log
    port, jax_file = tmp_path / f"port_{out}", tmp_path / f"jax_{out}"
    assert port.read_bytes() == jax_file.read_bytes()
    if out.endswith(".html"):
        layers, labels = _html_data(port)
        assert (layers, labels) == _html_data(jax_file)
        # 3 boxes x 12 edges + 2 cameras (frames[::10]) x 4 edges + 1 trajectory segment
        assert layers["points"]["n"] == len(read_ply(scene / "pcd.ply")["points"])
        assert layers["lines"]["n"] == 2 * (12 * 3 + 4 * 2 + 1)
        assert layers["mesh_0"]["n"] == 3 * 2
        assert [l["t"] for l in labels] == ["obj 1", "obj 2", "obj 3"]


def _instance_map(dtype):
    inst = np.zeros((24, 32), dtype)
    inst[5:15, 5:15] = 3
    inst[2:6, 20:30] = 7
    inst[17:23, 1:31] = 300 if dtype == np.uint16 else 200
    inst[20:22, 26:30] = 12
    return inst


@pytest.mark.parametrize("img_wh", [None, (45, 17)], ids=["native", "resized"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=["8bit", "16bit"])
def test_instance_inspector_ids_match_jax(tmp_path, capsys, dtype, img_wh):
    """Ids and pixel counts equal to JAX's (cv2's IMREAD_ANYDEPTH and
    INTER_NEAREST) on 8- and 16-bit maps, with and without `img_wh`, and the
    same printed line."""
    p = tmp_path / "0.instance.png"
    cv2.imwrite(str(p), _instance_map(dtype))
    out, ids = tv.visualize_instance_2d(p, str(tmp_path / "port.png"), img_wh=img_wh)
    port_log = capsys.readouterr().out
    _, want = jv.visualize_instance_2d(p, tmp_path / "jax.png", img_wh=img_wh)
    assert ids == want and capsys.readouterr().out == port_log
    img = read_png(out)
    want_hw = (img_wh[1], img_wh[0]) if img_wh else (24, 32)
    assert img.shape == want_hw + (3,) and img.dtype == np.uint8


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=["8bit", "16bit"])
def test_instance_overlay_is_tab20_outside_the_labels(tmp_path, dtype):
    """Outside the label boxes every pixel is matplotlib's tab20 of the
    normalised id, as imshow colours it; inside them the id's digits are
    white. Ids that span the range unevenly, so that several tab20 bins and
    the top one are hit."""
    import matplotlib

    inst = _instance_map(dtype)
    inst[0, :6] = [1, 2, 4, 5, 6, 8]
    p = tmp_path / "map.png"
    write_png(p, inst)
    out, _ = tv.visualize_instance_2d(p)
    assert out == str(p) + ".vis.png"
    img = read_png(out)
    norm = matplotlib.colors.Normalize(vmin=inst.min(), vmax=inst.max())
    want = np.round(matplotlib.colormaps["tab20"](norm(inst))[..., :3] * 255).astype(np.uint8)
    outside = np.ones(inst.shape, bool)
    boxes = tv.label_boxes(inst)
    assert [b[0] for b in boxes] == sorted(np.unique(inst).tolist())
    for _, y0, y1, x0, x1 in boxes:
        outside[y0:y1, x0:x1] = False
        assert (img[y0:y1, x0:x1] == 255).all(-1).any()  # the digits
    assert outside.mean() > 0.3
    np.testing.assert_array_equal(img[outside], want[outside])
    # one id only: matplotlib's Normalize maps it to 0, the first colour
    flat = np.full((8, 8), 5, dtype)
    np.testing.assert_array_equal(tv.TAB20[tv.tab20_index(flat)], np.round(
        matplotlib.colormaps["tab20"](matplotlib.colors.Normalize(5, 5)(flat))[..., :3]
        * 255).astype(np.uint8))


def test_instance_inspector_refuses_colour_maps_and_cli_writes(tmp_path, capsys):
    """A colour PNG is refused with an error that names the file (cv2 would
    convert it to grey: ROADMAP's known disagreements); the CLI prints the
    ids and the file it wrote."""
    p = tmp_path / "colour.png"
    write_png(p, np.zeros((4, 5, 3), np.uint8))
    with pytest.raises(PNGError, match="colour.png"):
        tv.visualize_instance_2d(p)
    with pytest.raises(FileNotFoundError):
        tv.visualize_instance_2d(tmp_path / "missing.png")
    q = tmp_path / "grey.png"
    write_png(q, _instance_map(np.uint16))
    inspector_main([str(q), str(tmp_path / "o.png")])
    log = capsys.readouterr().out
    assert "instance ids: {0: " in log and f"wrote {tmp_path / 'o.png'}" in log
    with pytest.raises(SystemExit, match="usage"):
        inspector_main([])
