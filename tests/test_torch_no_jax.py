"""The port imports nothing of JAX, of the JAX package or of its `scripts/`
(its training, edit, mesh, voxel and data-parallel modules, its probe scripts,
`python -m object_nerf_torch.train`, `.edit` and `.tools.extract_mesh`, and
the rank processes of `python -m object_nerf_torch.parallel.dryrun`
included), `chip_smoke.py` refuses to run without a card, and so do the probe
scripts."""

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
            "object_nerf_torch.parallel.mesh", "object_nerf_torch.parallel.dryrun"} <= walked
    assert (PORT / "native" / "__init__.py").exists() and (PORT / "tools" / "__init__.py").exists()


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
                 "profile_fwd_chain", "profile_route_step"):
        run = subprocess.run([sys.executable, "-m", f"object_nerf_torch.scripts.{name}"],
                             cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
        assert run.returncode != 0 and "CUDA is not available" in run.stderr, name
        assert " ms" not in run.stdout
