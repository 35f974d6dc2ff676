"""The voxel-conditioned slice as a whole against the JAX package, on the CPU.

`render_image`, `render_rays` (plain route) and `extract_sigma_grid` of a
voxel model against JAX `make_render_fn`, `render_rays` and the JAX mesh tool,
the weights through `from_jax_params` and the grid through `voxel_from_jax`;
a reference-style state dict with `embedding_xyz.*` buffers through
`load_reference_ckpt`; the port's checkpoint round trip with its topology;
the eval and mesh CLIs on `device=cpu`.
"""

import dataclasses
import os
import re
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_nerf_tpu.config import Config as JaxConfig
from object_nerf_tpu.models import voxel_grid as jvg
from object_nerf_tpu.render.renderer import RenderSettings as JaxSettings
from object_nerf_tpu.render.renderer import render_rays as jax_render_rays
from object_nerf_tpu.train.system import make_render_fn as jax_make_render_fn

from object_nerf_torch.config import Config, load_config
from object_nerf_torch.data import dataset_dict
from object_nerf_torch.data.ply_io import read_ply, write_ply
from object_nerf_torch.models import voxel_grid as vg
from object_nerf_torch.models.mlp import ObjectNeRFConfig
from object_nerf_torch.render.renderer import RenderSettings, render_rays
from object_nerf_torch.tools import extract_mesh as tx
from object_nerf_torch.train.checkpoint import save_checkpoint
from object_nerf_torch.train.convert import (
    from_jax_params, load_reference_ckpt, voxel_from_jax, voxel_grid_from_ckpt,
)
from object_nerf_torch.train.system import (
    ObjectNeRFModels, ObjectNeRFSystem, make_render_fn, render_image,
)

from _torch_port import CFG_JAX, N_OBJS, SMALL, jax_params, to_numpy

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import extract_mesh as jx  # noqa: E402  (the JAX package's tool, tools/extract_mesh.py)

torch.set_num_threads(2)

VCFG_JAX = dataclasses.replace(CFG_JAX, use_voxel_embedding=True, N_freq_voxel=3)
VCFG = ObjectNeRFConfig(**{**SMALL, "use_voxel_embedding": True, "N_freq_voxel": 3})
N_RAYS, CHUNK = 40, 16
# f32 on both sides, identical formulas
ATOL, RTOL = 1e-5, 1e-4
# the fine maps: inverse-CDF sampling scales a last-bit difference of the cdf
# by (bin width) / (bin mass) (tests/test_torch_render.py); the voxel inputs
# add sines of up to 2^2 x N(0, 1) features from two libraries
FINE_ATOL = 1e-3
MAPS = ("rgb_fine", "depth_fine", "opacity_fine", "rgb_instance_fine",
        "depth_instance_fine", "opacity_instance_fine")


def _grid(seed=0):
    pcd = np.random.RandomState(seed).rand(400, 3) * [1.6, 1.2, 1.0] - [0.8, 0.6, 0.5]
    jgrid = jvg.build_voxel_grid(pcd, [0, 0, 0], 1.0, 0.25, 3, 24, 3, 20000,
                                 key=jax.random.PRNGKey(seed))
    return jgrid


def _port(params, jgrid):
    jf, jt, js = jgrid
    features, topo, static = voxel_from_jax(
        np.asarray(jf), {k: np.asarray(v) for k, v in jt._asdict().items()},
        dataclasses.asdict(js))
    models = ObjectNeRFModels(VCFG, n_importance=1, n_max_objs=N_OBJS,
                              voxel_features=features)
    sd = from_jax_params({**to_numpy(params), "voxel_features": np.asarray(jf)})
    models.load_state_dict(sd)
    return models.eval(), topo, static


def _rays(n=N_RAYS, seed=3):
    """Rays that start inside the grid and leave it."""
    rng = np.random.RandomState(seed)
    o = (rng.rand(n, 3) - 0.5).astype(np.float32) * 0.6
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d, np.full((n, 1), 0.05, np.float32),
                           np.full((n, 1), 1.5, np.float32)], -1)


def _settings(**over):
    kw = dict(mlp=VCFG, N_samples=16, N_importance=8, perturb=0.0, noise_std=0.0,
              forward_instance=True, is_eval=True, matmul_dtype=torch.float32)
    kw.update(over)
    return RenderSettings(**kw)


def _jax_settings(**over):
    kw = dict(mlp=VCFG_JAX, N_samples=16, N_importance=8, perturb=0.0, noise_std=0.0,
              forward_instance=True, is_eval=True)
    kw.update(over)
    return JaxSettings(**kw)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_voxel_render_image_matches_jax_make_render_fn(use_pallas):
    params, jgrid = jax_params(seed=11, cfg_jax=VCFG_JAX), _grid()
    jf, jt, js = jgrid
    r = _rays()
    ids = np.random.RandomState(4).randint(0, N_OBJS, N_RAYS).astype(np.int64)
    jset = _jax_settings(use_pallas=use_pallas, pallas_interpret=use_pallas,
                         pallas_dtype="float32")
    want = jax_make_render_fn(jset, js, chunk=CHUNK)(
        {**params, "voxel_features": jf}, jnp.asarray(r), jax.random.PRNGKey(0),
        jnp.asarray(ids), jt)
    models, topo, static = _port(params, jgrid)
    before = vg.build_counts["corner_table"]
    got = render_image(models, _settings(), {"rays": r, "instance_ids": ids}, chunk=CHUNK,
                       device="cpu", voxel_topo=topo, voxel_static=static)
    assert vg.build_counts["corner_table"] == before + 1  # once per frame, not per chunk
    assert set(got) == set(MAPS)
    for k in MAPS:
        assert got[k].shape[0] == N_RAYS
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=FINE_ATOL, rtol=RTOL,
                                   err_msg=k)
    assert np.abs(got["rgb_fine"] - 0.5).max() > 0.01


def test_voxel_coarse_only_and_no_instance():
    params, jgrid = jax_params(seed=12, cfg_jax=VCFG_JAX), _grid(1)
    jf, jt, js = jgrid
    r, ids = _rays(16, seed=5), np.zeros(16, np.int64)
    jset = _jax_settings(N_importance=0, forward_instance=False)
    want = jax_make_render_fn(jset, js, chunk=8)(
        {**params, "voxel_features": jf}, jnp.asarray(r), jax.random.PRNGKey(0),
        jnp.asarray(ids), jt)
    models, topo, static = _port(params, jgrid)
    got = render_image(models, _settings(N_importance=0, forward_instance=False),
                       {"rays": r, "instance_ids": ids}, chunk=8, device="cpu",
                       voxel_topo=topo, voxel_static=static)
    assert set(got) == {"rgb_coarse", "depth_coarse", "opacity_coarse"}
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=ATOL, rtol=RTOL,
                                   err_msg=k)


def test_voxel_render_rays_plain_route_matches_jax_render_rays():
    """The differentiable render shares `_embed_points`; its kernel route
    raises until the training kernels take the voxel operand."""
    params, jgrid = jax_params(seed=13, cfg_jax=VCFG_JAX), _grid(2)
    jf, jt, js = jgrid
    r = _rays(12, seed=6)
    ids = np.random.RandomState(7).randint(0, N_OBJS, 12)
    want = jax_render_rays(params, jnp.asarray(r), jax.random.PRNGKey(0), _jax_settings(),
                           voxel_ctx=(jf, jt, js),
                           embedding_instance=params["code_library"][jnp.asarray(ids)])
    models, topo, static = _port(params, jgrid)
    ctx = (models.voxel_features, topo, static)
    codes = models.code_library(torch.from_numpy(ids))
    got = render_rays(models, torch.from_numpy(r), _settings(), embedding_instance=codes,
                      plain=True, voxel_ctx=ctx)
    for k in ("rgb_coarse", "depth_coarse", "opacity_instance_coarse", "weights_coarse"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), atol=ATOL,
                                   rtol=RTOL, err_msg=k)
    for k in MAPS:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                                   atol=FINE_ATOL, rtol=RTOL, err_msg=k)
    # autograd reaches the feature table through the plain lookup
    got["rgb_fine"].sum().backward()
    grad = models.embedding_xyz.embedding_space_ftr.weight.grad
    assert grad is not None and float(grad.abs().max()) > 0
    with pytest.raises(NotImplementedError, match="voxel operand"):
        render_rays(models, torch.from_numpy(r), _settings(), embedding_instance=codes,
                    voxel_ctx=ctx)


def test_render_fn_warns_and_takes_per_corner_route_above_the_table_limit(monkeypatch):
    params, jgrid = jax_params(seed=14, cfg_jax=VCFG_JAX), _grid(3)
    models, topo, static = _port(params, jgrid)
    r = torch.from_numpy(_rays(16, seed=8))
    ids = torch.zeros(16, dtype=torch.long)
    dense = make_render_fn(_settings(), static, chunk=8)(models, r, ids, topo)
    monkeypatch.setattr(vg, "DENSE_CELL_TABLE_LIMIT_BYTES", 0)
    before = vg.build_counts["corner_table"]
    with pytest.warns(UserWarning, match="per-corner"):
        render = make_render_fn(_settings(), static, chunk=8)
    corner = render(models, r, ids, topo)
    assert vg.build_counts["corner_table"] == before  # no table on this route
    for k in dense:
        np.testing.assert_allclose(corner[k].numpy(), dense[k].numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)
    with pytest.raises(ValueError, match="voxel_static"):
        make_render_fn(_settings(), None, chunk=8)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        monkeypatch.undo()
        make_render_fn(_settings(), static, chunk=8)  # no warning below the limit


GRID = {"N_grid": 10, "chunk": 192,  # 1000 = 5 * 192 + 40: a short last chunk
        "x_range": [-0.9, 0.9], "y_range": [-0.7, 0.7], "z_range": [-0.6, 0.6]}


@pytest.mark.parametrize("obj_id", [0, 3])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_voxel_extract_sigma_grid_matches_jax(obj_id, use_pallas):
    params, jgrid = jax_params(seed=15, cfg_jax=VCFG_JAX), _grid(4)
    jf, jt, js = jgrid
    jset = _jax_settings(use_pallas=use_pallas, pallas_interpret=use_pallas,
                         pallas_dtype="float32")
    want = jx.extract_sigma_grid({**params, "voxel_features": jf}, jset, (jf, jt, js),
                                 JaxConfig(GRID), obj_id=obj_id)
    models, topo, static = _port(params, jgrid)
    ctx = (models.voxel_features.detach(), topo, static)
    before = vg.build_counts["corner_table"]
    got = tx.extract_sigma_grid(models, _settings(), Config(GRID), obj_id=obj_id,
                                device="cpu", voxel_ctx=ctx)
    assert vg.build_counts["corner_table"] == before + 1  # once per sweep
    assert got.shape == (10, 10, 10) and got.dtype == np.float32
    # the kernel's encodings are sin(x @ S + phase): ~1e-4 off at the top octave
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 if use_pallas else ATOL)
    plain = tx.extract_sigma_grid(models, _settings(), Config(GRID), obj_id=obj_id,
                                  device="cpu", plain=True, voxel_ctx=ctx)
    np.testing.assert_array_equal(plain, got)
    assert got.max() > 0


def _reference_state_dict(params, jgrid):
    """A reference Lightning state dict of a voxel model: the table and the
    registered buffers of EmbeddingVoxel under `embedding_xyz.*`."""
    jf, jt, js = jgrid
    sd = from_jax_params({**to_numpy(params), "voxel_features": np.asarray(jf)})
    sd.update({
        "embedding_xyz.voxel_size": torch.tensor(float(jt.voxel_size)),
        "embedding_xyz.voxel_offset": torch.from_numpy(np.array(jt.voxel_offset)),
        "embedding_xyz.voxel_shape": torch.tensor(js.shape),
        "embedding_xyz.voxel_occupancy":
            torch.from_numpy(np.array(jt.occupancy).reshape(js.shape)),
        "embedding_xyz.voxel_idx_map":
            torch.from_numpy(np.array(jt.idx_map).reshape(js.shape)).long(),
        "embedding_xyz.bounds": torch.zeros(2, 3),
        "loss.some_buffer": torch.zeros(1),
    })
    return sd


def test_reference_voxel_checkpoint_loads_with_its_grid(tmp_path):
    params, jgrid = jax_params(seed=16, cfg_jax=VCFG_JAX), _grid(5)
    path = tmp_path / "ref.ckpt"
    torch.save({"state_dict": _reference_state_dict(params, jgrid), "epoch": 1}, path)
    with pytest.raises(ValueError, match="voxel"):
        load_reference_ckpt(path)
    sd, voxel = load_reference_ckpt(path, with_voxel=True)
    assert not any(k.startswith("embedding_xyz.voxel_") or k.startswith("loss") for k in sd)
    features, topo, static = voxel_grid_from_ckpt(voxel, VCFG.N_freq_voxel)
    _, want_topo, want_static = _port(params, jgrid)
    assert static == want_static
    for name in topo._fields:
        assert torch.equal(getattr(topo, name), getattr(want_topo, name)), name
    models = ObjectNeRFModels(VCFG, n_importance=1, n_max_objs=N_OBJS,
                              voxel_features=torch.zeros_like(features))
    models.load_state_dict(sd)
    assert torch.equal(models.voxel_features, features)


def _voxel_config(tmp_path, extra=()):
    write_ply(str(tmp_path / "pcd.ply"),
              np.random.RandomState(0).rand(400, 3) * [2.4, 2.4, 1.2] - [1.2, 1.2, 0.2])
    return [
        f"dataset_config={ROOT / 'config/synthetic.yml'}", "img_wh=[8,6]", "device=cpu",
        "model.use_voxel_embedding=true", "model.N_freq_voxel=2", "model.N_max_voxels=20000",
        f"dataset_extra.pcd_path={tmp_path / 'pcd.ply'}", "dataset_extra.voxel_size=0.3",
        "dataset_extra.neighbor_marks=3", "model.D=2", "model.W=32", "model.skips=[1]",
        "model.inst_D=2", "model.inst_W=16", "model.inst_skips=[1]", "model.N_max_objs=8",
        "model.N_obj_code_length=8", "model.N_samples=8", "model.N_importance=4",
        "train.batch_size=32", *extra]


def _voxel_system(tmp_path, **cfg_over):
    cfg = load_config(cli_args=_voxel_config(tmp_path))
    for k, v in cfg_over.items():
        cfg[k] = v
    kw = dict(img_wh=(8, 6), dataset_extra=cfg.dataset_extra)
    return ObjectNeRFSystem(cfg, dataset=dataset_dict["synthetic"]("train", n_frames=2, **kw),
                            val_dataset=dataset_dict["synthetic"]("val", **kw), device="cpu")


def test_voxel_system_renders_validates_and_round_trips_its_checkpoint(tmp_path):
    system = _voxel_system(tmp_path)
    assert system.use_voxel and system.voxel_static.channels == 24
    assert system.models.voxel_features.shape == (system.voxel_static.n_max_voxels, 24)
    metrics, maps = system.validation(chunk=16)
    assert np.isfinite(metrics["val/psnr"]) and np.isfinite(maps["rgb_fine"]).all()
    with pytest.raises(NotImplementedError, match="training a voxel-conditioned model"):
        system.training_step(system.train_dataset.sample_batch(32, system.batch_rng))

    path = save_checkpoint(tmp_path / "ckpts", system, "voxel")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    assert set(ckpt["voxel_topo"]) == set(vg.VoxelTopology._fields)
    assert tuple(ckpt["voxel_static"]["shape"]) == system.voxel_static.shape
    assert "embedding_xyz.embedding_space_ftr.weight" in ckpt["state_dict"]

    # a system with another seed (other weights, other features) takes all of it
    other = _voxel_system(tmp_path, ckpt_path=str(path),
                          train={**system.config.train.to_dict(), "seed": 7})
    assert other.voxel_static == system.voxel_static
    for name in system.voxel_topo._fields:
        assert torch.equal(getattr(other.voxel_topo, name), getattr(system.voxel_topo, name))
    assert torch.equal(other.models.voxel_features, system.models.voxel_features)
    _, maps2 = other.validation(chunk=16)
    np.testing.assert_array_equal(maps2["rgb_fine"], maps["rgb_fine"])

    # a classical checkpoint is refused by a voxel system, and the reverse
    classical = load_config(cli_args=[a for a in _voxel_config(tmp_path)
                                      if "use_voxel" not in a]
                            + ["model.use_voxel_embedding=false", f"ckpt_path={path}"])
    with pytest.raises(ValueError, match="voxel grid"):
        ObjectNeRFSystem(classical, device="cpu")


def test_voxel_system_adopts_a_reference_checkpoints_grid(tmp_path):
    """A reference checkpoint's table has its own capacity and topology: the
    system takes both (its table rows are indexed by that topology)."""
    donor = _voxel_system(tmp_path)
    sd = {k: v.detach().clone() for k, v in donor.models.state_dict().items()}
    table = "embedding_xyz.embedding_space_ftr.weight"
    sd[table] = torch.cat([sd[table], torch.zeros(100, 24)])  # another capacity
    topo, static = donor.voxel_topo, donor.voxel_static
    sd.update({
        "embedding_xyz.voxel_size": topo.voxel_size.clone(),
        "embedding_xyz.voxel_offset": topo.voxel_offset.clone(),
        "embedding_xyz.voxel_shape": torch.tensor(static.shape),
        "embedding_xyz.voxel_occupancy": topo.occupancy.reshape(static.shape).clone(),
        "embedding_xyz.voxel_idx_map": topo.idx_map.reshape(static.shape).long(),
    })
    path = tmp_path / "ref.ckpt"
    torch.save({"state_dict": sd, "epoch": 0}, path)
    system = _voxel_system(tmp_path, ckpt_path=str(path),
                           train={**donor.config.train.to_dict(), "seed": 7})
    assert system.models.voxel_features.shape == (static.n_max_voxels + 100, 24)
    assert system.voxel_static.n_max_voxels == static.n_max_voxels + 100
    assert system.voxel_topo.row_to_cell.shape[0] == static.n_max_voxels + 100
    assert torch.equal(system.voxel_topo.idx_map, topo.idx_map)
    # the optimizer was rebuilt over the adopted table
    held = {id(p) for g in system.optimizer.param_groups for p in g["params"]}
    assert id(system.models.voxel_features) in held
    batch = donor.val_dataset.whole_image_batch(0)
    np.testing.assert_array_equal(system.render_image(batch, chunk=16)["rgb_fine"],
                                  donor.render_image(batch, chunk=16)["rgb_fine"])


def test_voxel_eval_and_mesh_clis_on_cpu(tmp_path):
    system = _voxel_system(tmp_path)
    with torch.no_grad():  # densities clear of 0, so that the field has a level set
        system.models.nerf_fine.sigma.bias += 1.0
    path = save_checkpoint(tmp_path / "ckpts", system, "voxel")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    args = [a for a in _voxel_config(tmp_path) if not a.startswith("train.")]
    run = subprocess.run(
        [sys.executable, "-m", "object_nerf_torch.eval", *args, f"ckpt_path={path}",
         "chunk=16"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    frame = re.search(r"^frame 0: psnr (\S+)  ssim (\S+)$", run.stdout, re.M)
    assert frame and np.isfinite(float(frame.group(1))), run.stdout
    # the CLI's bf16 plain render of the same weights and grid
    settings16 = dataclasses.replace(system.eval_settings, matmul_dtype=torch.bfloat16)
    want = render_image(system.models, settings16, system.val_dataset.whole_image_batch(0),
                        chunk=16, device="cpu", voxel_topo=system.voxel_topo,
                        voxel_static=system.voxel_static)
    assert np.isfinite(want["rgb_fine"]).all()

    out_dir = tmp_path / "mesh"
    box = {"x_range": [-1.2, 1.2], "y_range": [-1.2, 1.2], "z_range": [-0.2, 1.0]}
    field = tx.extract_sigma_grid(
        system.models, system.eval_settings, Config({"N_grid": 8, "chunk": 100, **box}),
        device="cpu",
        voxel_ctx=(system.models.voxel_features.detach(), system.voxel_topo,
                   system.voxel_static))
    assert field.min() > 0 and field.max() > field.min()
    tx.main(args + [f"ckpt_path={path}", "N_grid=8", f"sigma_threshold={np.median(field)}",
                    "predict_color=true", f"out_dir={out_dir}", "prefix=vox",
                    "keep_largest_component=false"]
            + [f"{k}=[{v[0]},{v[1]}]" for k, v in box.items()])
    mesh = read_ply(str(out_dir / "extracted_mesh_vox.ply"))
    assert len(mesh["points"]) > 0 and len(mesh["faces"]) > 0 and mesh["colors"] is not None
    # a voxel checkpoint under a classical model config is refused
    with pytest.raises(SystemExit, match="voxel grid"):
        tx.main([a for a in args if "use_voxel" not in a]
                + ["model.use_voxel_embedding=false", f"ckpt_path={path}", "N_grid=8"])
