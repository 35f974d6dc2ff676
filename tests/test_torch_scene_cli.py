"""The shipped scene configs through the port's CLIs on a scene written to
disk by `object_nerf_torch.scripts.make_synthetic_dataset` (the ToyDesk
layout, plus ScanNet's box files), on the CPU: the validation images against
the JAX package's, the train CLI's artefacts, the eval CLI against JAX
`scripts/eval.py` on one reference checkpoint (the `rays_in_bbox` route of
`config/scannet_base_0113_multi.yml`), and the whole path with cv2, PIL,
imageio, matplotlib and tensorboardX made unimportable."""

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from object_nerf_torch.data.png_io import read_png
from object_nerf_torch.scripts.make_synthetic_dataset import make_dataset, write_scannet_boxes
from object_nerf_torch.train import __main__ as train_cli
from object_nerf_torch.train.convert import from_jax_params
from object_nerf_torch.utils import train_helper

from _torch_port import to_numpy

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
SCENE_ID = "scene0002_00"
W, H = 80, 60  # the 20-pixel border leaves a 40 x 20 valid window
TINY = ["model.D=2", "model.W=32", "model.skips=[1]", "model.inst_D=2", "model.inst_W=16",
        "model.inst_skips=[1]", "model.N_samples=8", "model.N_importance=4",
        "model.N_max_objs=8", "model.N_obj_code_length=8"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("desk")
    make_dataset(root, img_wh=(W, H), n_frames=6, filters=[0, 1, 2, 3, 4])
    write_scannet_boxes(root, SCENE_ID)
    return root


def desk_args(scene):
    """config/synthetic_desk.yml (toydesk) pointed at the written scene."""
    return [f"dataset_config={ROOT / 'config/synthetic_desk.yml'}", f"img_wh=[{W},{H}]",
            f"dataset_extra.root_dir={scene}", f"dataset_extra.split={scene}/split",
            f"dataset_extra.pcd_path={scene}/pcd.ply",
            f"dataset_extra.bbox_dir={scene}/bbox.json", "dataset_extra.validate_idx=4"]


def scannet_args(scene):
    """config/scannet_base_0113_multi.yml's keys (use_bbox, ScanNet boxes)
    pointed at the written scene."""
    return [f"dataset_config={ROOT / 'config/scannet_base_0113_multi.yml'}",
            f"img_wh=[{W},{H}]", f"dataset_extra.root_dir={scene}",
            f"dataset_extra.split={scene}/split", f"dataset_extra.scans_dir={scene}/scans",
            f"dataset_extra.bbox_dir={scene}", f"dataset_extra.scene_id={SCENE_ID}",
            f"dataset_extra.pcd_path={scene}/pcd.ply", "dataset_extra.instance_id=[1,2]",
            "dataset_extra.val_instance_id=1", "dataset_extra.bg_instance_id=[0]",
            "dataset_extra.inst_seg_tag=instance", "dataset_extra.scene_center=[0,0,0]",
            "dataset_extra.validate_idx=4"]


def test_visualize_matches_jax():
    from object_nerf_tpu.utils import train_helper as jax_helper

    rng = np.random.RandomState(0)
    depth = rng.rand(H, W).astype(np.float32) * 3
    depth[:5] = 0  # invalid rows stay dark
    x = np.linspace(0, 1, 1001, dtype=np.float32).reshape(7, 143)
    for d in (depth, x, np.zeros((4, 5), np.float32)):
        np.testing.assert_allclose(train_helper.visualize_depth(d),
                                   jax_helper.visualize_depth(d), atol=1 / 255, rtol=0)
    n = W * H
    batch = {"rgbs": rng.rand(n, 3), "depths": rng.rand(n) * 2}
    results = {k: rng.rand(n, 3) if k.startswith("rgb") else rng.rand(n) * 2
               for k in ("rgb_fine", "depth_fine", "rgb_instance_fine", "depth_instance_fine",
                         "opacity_instance_fine")}
    for res in (results, {k: v for k, v in results.items() if "instance" not in k}):
        got = train_helper.visualize_val_image((W, H), batch, res)
        want = jax_helper.visualize_val_image((W, H), batch, res)
        assert got.shape == want.shape and got.shape[0] == (7 if len(res) == 5 else 4)
        np.testing.assert_allclose(got, want, atol=1 / 255, rtol=0)


def test_train_cli_on_the_desk_scene(scene, tmp_path, monkeypatch, capsys):
    """config/synthetic_desk.yml: the voxel model from the scene's point
    cloud; checkpoints, the config and source snapshots, TensorBoard events,
    a profiler trace; the last validation's 7-panel image."""
    monkeypatch.chdir(tmp_path)
    train_cli.main(desk_args(scene) + TINY + [
        "exp_name=desk", "device=cpu", "model.N_freq_voxel=2", "train.num_epochs=1",
        "train.batch_size=64", "train.limit_train_batches=6", "train.val_check_interval=0.5",
        "tpu.profile_dir=prof", "tpu.profile_steps=1"])
    out = capsys.readouterr().out
    assert "[val]" in out and "Done." in out and "profiler trace written" in out
    run = next((tmp_path / "logs").iterdir())
    assert (run / "last.ckpt").is_file() and (run / "run_config_snapshot.yaml").is_file()
    snap = run / "source_snapshot"
    assert (snap / "object_nerf_torch/data/png_io.py").is_file()
    assert not (snap / "logs").exists() and not (snap / ".git").exists()
    assert list(run.glob("events.out.tfevents.*"))
    assert (tmp_path / "prof/trace.json").stat().st_size > 0
    ckpt = torch.load(run / "last.ckpt", map_location="cpu", weights_only=False)
    assert ckpt["step"] == 6 and ckpt["voxel_static"] is not None


def test_val_image_panel_of_a_system(scene):
    from object_nerf_torch.config import load_config
    from object_nerf_torch.data import dataset_dict
    from object_nerf_torch.train.system import ObjectNeRFSystem

    cfg = load_config(cli_args=scannet_args(scene) + TINY + [
        "device=cpu", "model.use_voxel_embedding=false"])
    kw = dict(img_wh=(W, H), dataset_extra=cfg.dataset_extra)
    ds, val = (dataset_dict[cfg.dataset_name](split, **kw) for split in ("train", "val"))
    system = ObjectNeRFSystem(cfg, dataset=ds, val_dataset=val, device="cpu")
    assert not system.settings.rays_in_bbox and system.eval_settings.rays_in_bbox
    assert system.val_image_panel() is None
    metrics, out = system.validation(chunk=1024)
    assert np.isfinite(metrics["val/psnr"]) and out["rgb_fine"].shape == (W * H, 3)
    panel = system.val_image_panel()
    assert panel.shape == (7, H, W, 3)
    assert np.isfinite(panel).all() and panel.min() >= 0 and panel.max() <= 1


def _jax_eval_main():
    spec = importlib.util.spec_from_file_location("jax_eval_script", ROOT / "scripts/eval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _metrics(text):
    m = re.search(r"^frame 0: psnr (\S+)  ssim (\S+)$", text, re.M)
    assert m, text
    return float(m.group(1)), float(m.group(2))


def test_eval_cli_on_the_route_matches_jax_eval_script(scene, tmp_path, capsys):
    """One reference checkpoint, the scannet-keyed config (its validation
    frame on the rays_in_bbox route), f32: the port's eval CLI against JAX
    scripts/eval.py, to 1e-3 dB and 1e-4 (both print 3 and 4 decimals);
    save_images re-read."""
    from object_nerf_tpu.models.code_library import init_code_library
    from object_nerf_tpu.models.mlp import ObjectNeRFConfig as JaxConfig, init_object_nerf
    import jax

    cfg = JaxConfig(D=2, W=32, skips=(1,), inst_D=2, inst_W=16, inst_skips=(1,),
                    use_voxel_embedding=False, N_obj_code_length=8)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(4), 3)
    params = {"coarse": init_object_nerf(k1, cfg), "fine": init_object_nerf(k2, cfg),
              "code_library": init_code_library(k3, 8, 8)}
    ckpt = tmp_path / "ref.ckpt"
    torch.save({"state_dict": from_jax_params(to_numpy(params)), "epoch": 0}, ckpt)
    args = scannet_args(scene) + TINY + ["model.use_voxel_embedding=false",
                                         f"ckpt_path={ckpt}", "chunk=1024"]
    from object_nerf_torch import eval as port_eval

    port_eval.main(args + ["device=cpu", "dtype=float32", f"save_images={tmp_path}/imgs"])
    got = _metrics(capsys.readouterr().out)
    _jax_eval_main()(args)
    want = _metrics(capsys.readouterr().out)
    assert np.isfinite(got[0])
    assert abs(got[0] - want[0]) <= 1e-3 + 1e-9 and abs(got[1] - want[1]) <= 1e-4 + 1e-9
    img = read_png(tmp_path / "imgs/eval_0000.png")
    assert img.shape == (H, W, 3) and img.dtype == np.uint8 and img.std() > 0


_BLOCKED = r"""
import runpy, sys
for name in ("jax", "jaxlib", "object_nerf_tpu", "cv2", "PIL", "imageio", "matplotlib",
             "tensorboardX"):
    sys.modules[name] = None  # any import of these now raises
import glob, os
scene, root = sys.argv[1], sys.argv[2]
from object_nerf_torch.scripts.make_synthetic_dataset import make_dataset, write_scannet_boxes
make_dataset(scene, img_wh=(48, 44), n_frames=4, filters=[0, 1, 2, 3, 4])
write_scannet_boxes(scene, "scene0003_00")
tiny = %r
desk = [f"dataset_config={root}/config/synthetic_desk.yml", "img_wh=[48,44]",
        f"dataset_extra.root_dir={scene}", f"dataset_extra.split={scene}/split",
        f"dataset_extra.pcd_path={scene}/pcd.ply", f"dataset_extra.bbox_dir={scene}/bbox.json",
        "dataset_extra.validate_idx=3", "device=cpu", "model.N_freq_voxel=2"]
from object_nerf_torch.config import load_config
from object_nerf_torch.data import dataset_dict
cfg = load_config(cli_args=desk + tiny)
ds = dataset_dict[cfg.dataset_name]("train", img_wh=(48, 44), dataset_extra=cfg.dataset_extra)
assert ds.rays.shape == (2 * 48 * 44, 8)
sys.argv = ["object_nerf_torch.train", *desk, *tiny, "train.num_epochs=1",
            "train.batch_size=32", "train.limit_train_batches=2", "exp_name=blocked"]
runpy.run_module("object_nerf_torch.train", run_name="__main__")
run = glob.glob("logs/*blocked")[0]
sys.argv = ["object_nerf_torch.eval", f"dataset_config={run}/run_config_snapshot.yaml",
            f"ckpt_path={run}/last.ckpt", "save_images=imgs"]
runpy.run_module("object_nerf_torch.eval", run_name="__main__")
sys.argv = ["object_nerf_torch.edit", f"config={root}/config/edit_synthetic_desk.yaml",
            f"ckpt_path={run}/last.ckpt", "device=cpu", "total_frames=2", "img_wh=[24,18]",
            "test_frame=1", "chunk=128", "prefix=blocked"]
runpy.run_module("object_nerf_torch.edit", run_name="__main__")
from object_nerf_torch.data.png_io import read_png
assert read_png("imgs/eval_0000.png").shape == (44, 48, 3)
pngs = sorted(glob.glob("debug/rendered_view/*blocked/render_*.png"))
assert len(pngs) == 2 and read_png(pngs[1]).shape == (18, 24, 3), pngs
print("BLOCKED OK")
"""


def test_scene_path_runs_without_image_or_logging_packages(tmp_path):
    """The card's machine has none of cv2, PIL, imageio, matplotlib and
    tensorboardX: with all five (and JAX) unimportable, the dataset, the
    train CLI (which says once that TensorBoard is off), the eval CLI and the
    edit CLI still run the written scene on the CPU and write their PNGs."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _BLOCKED % (TINY,), str(tmp_path / "scene"),
                          str(ROOT)], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BLOCKED OK" in out.stdout
    assert out.stdout.count("TensorBoard logging off") == 1


@pytest.mark.parametrize("filters", ["up", [0, 1, 2, 3, 4]])
def test_make_synthetic_dataset_matches_the_jax_script(tmp_path, filters):
    """The port's scene writer against JAX scripts/make_synthetic_dataset.py
    (which writes through cv2): the same poses, boxes, split and point cloud,
    and PNGs that decode to the same arrays."""
    import json

    from object_nerf_torch.data.ply_io import read_ply

    spec = importlib.util.spec_from_file_location(
        "jax_make_synthetic_dataset", ROOT / "scripts/make_synthetic_dataset.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    want = Path(mod.make_dataset(str(tmp_path / "jax"), img_wh=(32, 24), n_frames=4))
    got = Path(make_dataset(tmp_path / "port", img_wh=(32, 24), n_frames=4, filters=filters))
    for name in ("transforms_full.json", "bbox.json"):
        assert json.loads((got / name).read_text()) == json.loads((want / name).read_text())
    assert (got / "split/train.txt").read_text() == (want / "split/train.txt").read_text()
    np.testing.assert_array_equal(read_ply(got / "pcd.ply")["points"],
                                  read_ply(want / "pcd.ply")["points"])
    pngs = sorted(p.name for p in (want / "full").iterdir())
    assert pngs == sorted(p.name for p in (got / "full").iterdir()) and len(pngs) == 12
    for name in pngs:
        a, b = read_png(got / "full" / name), read_png(want / "full" / name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
