"""The port imports nothing of JAX, of the JAX package or of its `scripts/`
(its training, edit, mesh, voxel and data-parallel modules, its probe scripts,
`python -m object_nerf_torch.train`, `.edit` and `.tools.extract_mesh`, and
the rank processes of `python -m object_nerf_torch.parallel.dryrun`
included), `chip_smoke.py` refuses to run without a card, and so do the probe
scripts. The scene viewer tools and the data preparation also run without
cv2, imageio, PIL and matplotlib, which the card's machine lacks, except for
the JPEG colour paths, which say which package they need."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "object_nerf_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "object_nerf_tpu", "scripts"):
    sys.modules[name] = None  # any import of these now raises
import object_nerf_torch
mods = [m.name for m in pkgutil.walk_packages(object_nerf_torch.__path__,
                                              "object_nerf_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke  # its main() runs only as a script
print(len(mods))
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_every_port_module_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 46  # every module was walked
    walked = {p.relative_to(ROOT).with_suffix("").as_posix().replace("/", ".")
              for p in PORT.rglob("*.py") if p.name != "__init__.py"}
    assert {"object_nerf_torch.ops.fused_mlp_vjp", "object_nerf_torch.train.losses",
            "object_nerf_torch.train.optim", "object_nerf_torch.train.checkpoint",
            "object_nerf_torch.train.__main__", "object_nerf_torch.ops.fused_sigma",
            "object_nerf_torch.render.multi", "object_nerf_torch.data.geo_utils",
            "object_nerf_torch.data.ply_io", "object_nerf_torch.edit.bbox",
            "object_nerf_torch.edit.editable_renderer", "object_nerf_torch.edit.__main__",
            "object_nerf_torch.tools.marching", "object_nerf_torch.tools.extract_mesh",
            "object_nerf_torch.models.voxel_grid", "object_nerf_torch.ops.gather",
            "object_nerf_torch.ops.probes", "object_nerf_torch.scripts._fixtures",
            "object_nerf_torch.scripts.profile_dma_gather",
            "object_nerf_torch.scripts.profile_pe_micro",
            "object_nerf_torch.scripts.profile_voxel_split",
            "object_nerf_torch.parallel.mesh", "object_nerf_torch.parallel.dryrun",
            "object_nerf_torch.tools.html_viewer", "object_nerf_torch.tools.visualize",
            "object_nerf_torch.tools.scene_visualizer",
            "object_nerf_torch.tools.visualize_instance_2d",
            "object_nerf_torch.data_prep.scannet_labels",
            "object_nerf_torch.data_prep.sens_reader",
            "object_nerf_torch.data_prep.convert_nerf"} <= walked
    assert (PORT / "native" / "__init__.py").exists() and (PORT / "tools" / "__init__.py").exists()
    assert (PORT / "data_prep" / "__init__.py").exists()


_NO_IMAGE_LIBS = r"""
import importlib, json, runpy, sys, zlib
from pathlib import Path
for name in ("jax", "jaxlib", "object_nerf_tpu", "scripts", "cv2", "imageio", "PIL",
             "matplotlib"):
    sys.modules[name] = None  # any import of these now raises
import numpy as np
for m in ("tools.html_viewer", "tools.visualize", "tools.scene_visualizer",
          "tools.visualize_instance_2d", "data_prep", "data_prep.scannet_labels",
          "data_prep.sens_reader", "data_prep.convert_nerf"):
    importlib.import_module("object_nerf_torch." + m)
from object_nerf_torch.data.png_io import read_png, write_png
from object_nerf_torch.data.ply_io import read_ply, write_ply
from object_nerf_torch.data_prep import convert_nerf, scannet_labels, sens_reader
from object_nerf_torch.scripts.make_synthetic_dataset import make_dataset

def cli(module, *args):
    sys.argv = [module, *args]
    runpy.run_module(module, run_name="__main__")

# the instance inspector and the scene viewer, as a user runs them
inst = np.zeros((24, 32), np.uint16)
inst[5:15, 5:15] = 3
write_png("inst.png", inst)
cli("object_nerf_torch.tools.visualize_instance_2d", "inst.png", "inst_vis.png")
assert read_png("inst_vis.png").shape == (24, 32, 3)
make_dataset("desk", (32, 24), 12)
cli("object_nerf_torch.tools.scene_visualizer", "dataset_config=config/synthetic_desk.yml",
    "dataset_extra.root_dir=desk", "dataset_extra.bbox_dir=desk/bbox.json",
    "dataset_extra.pcd_path=desk/pcd.ply", "out=desk.html")
html = Path("desk.html").read_text()
assert all(f'"t": "obj {i}"' in html for i in (1, 2, 3))

# a .sens capture: depth, poses and intrinsics export; colour needs imageio
sd = sens_reader.SensorData(sensor_name="s", intrinsic_color=np.eye(4),
                            extrinsic_color=np.eye(4), intrinsic_depth=np.eye(4),
                            extrinsic_depth=np.eye(4), color_width=4, color_height=3,
                            depth_width=8, depth_height=6)
depth = np.arange(48, dtype=np.uint16).reshape(6, 8)
for i in range(3):
    sd.frames.append(sens_reader.RGBDFrame(np.eye(4, dtype=np.float32), i, i, b"not a jpeg",
                                           zlib.compress(depth.tobytes())))
sens_reader.write_sens("scan.sens", sd)
cli("object_nerf_torch.data_prep.sens_reader", "--filename", "scan.sens", "--output_path",
    "unpacked", "--export_depth_images", "--export_poses", "--export_intrinsics")
assert (read_png("unpacked/depth/2.png") == depth).all()
assert np.loadtxt("unpacked/pose/1.txt").shape == (4, 4)
assert len(list(Path("unpacked/intrinsic").iterdir())) == 4
for fn in (lambda: sens_reader.SensorData.load("scan.sens").export_color_images("colour"),
           lambda: convert_nerf.convert("unpacked", "nerf")):
    try:
        fn()
    except ImportError as e:
        print("refused:", e)
    else:
        raise AssertionError("a colour path ran without its image library")

# a labelled scan
scan = Path("scans/scene0000_00")
scan.mkdir(parents=True)
write_ply(scan / "scene0000_00_vh_clean_2.ply", np.random.RandomState(0).rand(30, 3))
(scan / "scene0000_00_vh_clean_2.0.010000.segs.json").write_text(
    json.dumps({"segIndices": [k % 3 for k in range(30)]}))
(scan / "scene0000_00.aggregation.json").write_text(json.dumps({"segGroups": [
    {"objectId": 0, "label": "chair", "segments": [0]},
    {"objectId": 1, "label": "chair", "segments": [2]}]}))
(scan / "scene0000_00.txt").write_text("axisAlignment = 1 0 0 0 0 1 0 0 0 0 1 0 0 0 0 1\n")
Path("labels.tsv").write_text("raw_category\tnyu40id\nchair\t5\n")
cli("object_nerf_torch.data_prep.scannet_labels", "--scannet_dir", "scans",
    "--label_map_file", "labels.tsv", "--output_dir", "labels")
assert np.load("labels/scene0000_00_bbox.npy").shape == (2, 7)
print("NO IMAGE LIBS OK")
"""


def test_viewer_and_data_prep_run_without_image_libraries(tmp_path):
    """With cv2, imageio, PIL, matplotlib and JAX unimportable: every new
    module imports; the instance inspector, the scene viewer CLI, the `.sens`
    depth, pose and intrinsics exports and the label export run; the colour
    export and `convert` raise an error that names the package they need."""
    env = _env()
    env["PYTHONPATH"] = str(ROOT)
    (tmp_path / "config").symlink_to(ROOT / "config")
    out = subprocess.run([sys.executable, "-c", _NO_IMAGE_LIBS], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO IMAGE LIBS OK" in out.stdout and "instance ids: {0: 668, 3: 100}" in out.stdout
    refused = [line for line in out.stdout.splitlines() if line.startswith("refused:")]
    assert len(refused) == 2 and "imageio" in refused[0] and "cv2" in refused[1], refused
    assert "exported scene0000_00" in out.stdout and "wrote desk.html" in out.stdout


_TRAIN_CLI = r"""
import runpy, sys
for name in ("jax", "jaxlib", "object_nerf_tpu"):
    sys.modules[name] = None  # any import of these now raises
sys.argv = ["object_nerf_torch.train", "dataset_config=config/synthetic.yml",
            "img_wh=[8,6]", "device=cpu", "model.D=2", "model.W=32", "model.skips=[1]",
            "model.inst_D=2", "model.inst_W=16", "model.inst_skips=[1]",
            "model.N_samples=8", "model.N_importance=4", "train.num_epochs=1",
            "train.batch_size=32", "train.limit_train_batches=2"]
runpy.run_module("object_nerf_torch.train", run_name="__main__")
"""


def test_train_cli_runs_without_jax(tmp_path):
    """`python -m object_nerf_torch.train` takes two steps with JAX and the JAX
    package made unimportable."""
    env = _env()
    env["PYTHONPATH"] = str(ROOT)
    (tmp_path / "config").symlink_to(ROOT / "config")
    out = subprocess.run([sys.executable, "-c", _TRAIN_CLI], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Done." in out.stdout and list(tmp_path.glob("logs/*/last.ckpt"))


_MESH_CLI = r"""
import runpy, sys
for name in ("jax", "jaxlib", "object_nerf_tpu"):
    sys.modules[name] = None  # any import of these now raises
import torch
from object_nerf_torch.models.mlp import ObjectNeRFConfig
from object_nerf_torch.train.system import ObjectNeRFModels
cfg = ObjectNeRFConfig(D=2, W=32, skips=(1,), inst_D=2, inst_W=16, inst_skips=(1,),
                       use_voxel_embedding=False, N_obj_code_length=8)
models = ObjectNeRFModels(cfg, n_importance=1, n_max_objs=8)
torch.save({"state_dict": models.state_dict()}, "model.ckpt")
sys.argv = ["object_nerf_torch.tools.extract_mesh", "dataset_config=config/synthetic.yml",
            "ckpt_path=model.ckpt", "device=cpu", "model.use_voxel_embedding=false",
            "model.D=2", "model.W=32", "model.skips=[1]", "model.inst_D=2",
            "model.inst_W=16", "model.inst_skips=[1]", "model.N_max_objs=8",
            "model.N_obj_code_length=8", "N_grid=8", "sigma_threshold=-1", "out_dir=out"]
runpy.run_module("object_nerf_torch.tools.extract_mesh", run_name="__main__")
"""


def test_mesh_cli_runs_without_jax(tmp_path):
    """`python -m object_nerf_torch.tools.extract_mesh` sweeps a small grid
    with JAX and the JAX package made unimportable."""
    env = _env()
    env["PYTHONPATH"] = str(ROOT)
    (tmp_path / "config").symlink_to(ROOT / "config")
    out = subprocess.run([sys.executable, "-c", _MESH_CLI], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "sigma grid" in out.stdout and "marching backend" in out.stdout


def test_dryrun_ranks_run_without_jax(tmp_path):
    """`python -m object_nerf_torch.parallel.dryrun` and the rank processes it
    starts run with JAX, the JAX package and `scripts` unimportable: modules
    of those names that raise on import come first on their PYTHONPATH."""
    blocked = tmp_path / "blocked"
    blocked.mkdir()
    for name in ("jax", "jaxlib", "object_nerf_tpu", "scripts"):
        (blocked / f"{name}.py").write_text(f"raise ImportError('{name} is blocked')\n")
    env = _env()
    env["PYTHONPATH"] = os.pathsep.join([str(blocked), str(ROOT)])
    out = subprocess.run([sys.executable, "-m", "object_nerf_torch.parallel.dryrun",
                          "--nprocs", "2", "--scenarios", "eval_render,indivisible_batch",
                          "--timeout", "240"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1].startswith("dryrun(2): OK, eval_render ")
    probe = subprocess.run([sys.executable, "-c", "import jax"], cwd=tmp_path, env=env,
                           capture_output=True, text=True, timeout=60)
    assert probe.returncode != 0 and "jax is blocked" in probe.stderr


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|object_nerf_tpu|scripts)\b", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 35
    for f in files:
        assert not pattern.search(f.read_text()), f


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    if torch.cuda.is_available():
        return  # with a card, the script's own run is the check
    run = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         env=_env(), capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout and '"kernels"' not in run.stdout
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    run = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout


def test_probe_scripts_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        return  # with a card they measure it
    for name in ("profile_dma_gather", "profile_pe_micro", "profile_voxel_split", "profile_mlp",
                 "profile_fwd_chain", "profile_bwd_sweep", "profile_route_step"):
        run = subprocess.run([sys.executable, "-m", f"object_nerf_torch.scripts.{name}"],
                             cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
        assert run.returncode != 0 and "CUDA is not available" in run.stderr, name
        assert " ms" not in run.stdout
