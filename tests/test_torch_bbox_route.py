"""The `rays_in_bbox` route (the importance samples follow the instance
weights; reference rendering.py:228-229) of the port against the JAX
package's: the whole-image eval render (JAX `make_render_fn`, through its XLA
path and through its split Pallas stages in interpret mode, f32), the
stochastic training render, the property tests of JAX `tests/test_render.py`
and `tests/test_train_system.py`, and which kernels the eval chunk calls."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_nerf_tpu.render.renderer import RenderSettings as JaxSettings
from object_nerf_tpu.render.renderer import render_rays as jax_render_rays
from object_nerf_tpu.train.system import make_render_fn as jax_make_render_fn

from object_nerf_torch.config import load_config
from object_nerf_torch.data import dataset_dict
from object_nerf_torch.render import renderer
from object_nerf_torch.render.renderer import (
    bbox_route, render_rays, render_rays_fused_eval, render_rays_plain,
)
from object_nerf_torch.train.system import ObjectNeRFSystem, render_image

from _torch_port import CFG_JAX, N_OBJS, jax_params, port_models, rays, settings
from test_torch_train_render import jax_draws, port_draws

torch.set_num_threads(2)

N_RAYS, CHUNK = 40, 16  # chunks of 16, 16 and 8 (+8 padding in the port)
NS, NI = 16, 8
# f32 on both sides; the fine maps carry the sampling's amplification of a
# last-bit cdf difference (tests/test_torch_render.py FINE_ATOL)
COARSE_ATOL = 2e-5
FINE_ATOL = 1e-3
MAPS = ("rgb_fine", "depth_fine", "opacity_fine", "rgb_instance_fine",
        "depth_instance_fine", "opacity_instance_fine")


def _inputs(seed=11):
    params = jax_params(seed=seed)
    r = rays(N_RAYS, seed=3)
    ids = np.random.RandomState(4).randint(0, N_OBJS, N_RAYS).astype(np.int64)
    return params, r, ids


@pytest.mark.parametrize("use_pallas", [False, True])
def test_render_image_on_the_route_matches_jax(use_pallas):
    params, r, ids = _inputs()
    jset = JaxSettings(mlp=CFG_JAX, N_samples=NS, N_importance=NI, perturb=0.0,
                       noise_std=0.0, forward_instance=True, is_eval=True,
                       rays_in_bbox=True, frustum_bound_th=0.05, use_pallas=use_pallas,
                       pallas_interpret=use_pallas, pallas_dtype="float32")
    want = jax_make_render_fn(jset, None, chunk=CHUNK)(
        params, jnp.asarray(r), jax.random.PRNGKey(0), jnp.asarray(ids), None)
    st = settings(rays_in_bbox=True, frustum_bound_th=0.05)
    got = render_image(port_models(params), st, {"rays": r, "instance_ids": ids},
                       chunk=CHUNK, device="cpu")
    assert set(got) == set(MAPS)
    off = render_image(port_models(params), settings(frustum_bound_th=0.05),
                       {"rays": r, "instance_ids": ids}, chunk=CHUNK, device="cpu")
    for k in MAPS:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=FINE_ATOL, rtol=1e-4,
                                   err_msg=k)
    # the route moved the fine samples: the maps differ from the scene-pdf render
    assert np.abs(got["depth_fine"] - off["depth_fine"]).max() > 1e-3


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("perturb,noise_std", [(1.0, 1.0), (0.0, 0.0)])
def test_render_rays_on_the_route_matches_jax(plain, perturb, noise_std):
    params = jax_params(seed=3)
    models = port_models(params)
    r = rays(12, seed=2)
    rng = np.random.RandomState(5)
    ids = rng.randint(0, N_OBJS, 12)
    pass_through = rng.rand(12) < 0.5
    key = jax.random.PRNGKey(11)
    kw = dict(N_samples=NS, N_importance=NI, perturb=perturb, noise_std=noise_std,
              forward_instance=True, frustum_bound_th=0.05, is_eval=False,
              rays_in_bbox=True)
    want = jax_render_rays(params, jnp.asarray(r), key, JaxSettings(mlp=CFG_JAX, **kw),
                           embedding_instance=params["code_library"][ids],
                           pass_through_mask=jnp.asarray(pass_through))
    with torch.no_grad():
        got = render_rays(models, torch.from_numpy(r), settings(**kw),
                          embedding_instance=models.code_library(torch.from_numpy(ids)),
                          pass_through_mask=torch.from_numpy(pass_through),
                          draws=port_draws(jax_draws(key, 12, NS, NI)), plain=plain)
    assert set(got) == set(want)
    for k in want:
        atol = FINE_ATOL if k.endswith("_fine") else COARSE_ATOL
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=atol, rtol=0,
                                   err_msg=k)


def test_rays_in_bbox_fine_sampling_follows_instance_weights():
    """JAX tests/test_render.py:84 on the port, with its model and rays:
    flipping only the flag leaves the coarse scene maps alone and moves the
    emitted coarse weights and the fine samples."""
    from object_nerf_tpu.models.code_library import init_code_library
    from object_nerf_tpu.models.mlp import ObjectNeRFConfig as JaxConfig, init_object_nerf

    from object_nerf_torch.models.mlp import ObjectNeRFConfig
    from object_nerf_torch.train.convert import from_jax_params
    from object_nerf_torch.train.system import ObjectNeRFModels

    from _torch_port import to_numpy

    small = dict(D=2, W=32, skips=(1,), inst_D=2, inst_W=16, inst_skips=(1,),
                 use_voxel_embedding=False, N_obj_code_length=8)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    params = {"coarse": init_object_nerf(k1, JaxConfig(**small)),
              "fine": init_object_nerf(k2, JaxConfig(**small)),
              "code_library": init_code_library(k3, 16, 8)}
    models = ObjectNeRFModels(ObjectNeRFConfig(**small), n_importance=1, n_max_objs=16)
    models.load_state_dict(from_jax_params(to_numpy(params)))
    n = 12
    r = torch.from_numpy(rays(n, seed=0))
    codes = models.code_library(torch.zeros(n, dtype=torch.long))
    kw = dict(mlp=ObjectNeRFConfig(**small), N_samples=NS, N_importance=NI, perturb=0.0,
              noise_std=0.0, forward_instance=True, frustum_bound_th=0.01, is_eval=False)
    ptm = torch.zeros(n, dtype=torch.bool)
    with torch.no_grad():
        out0 = render_rays(models, r, settings(**kw, rays_in_bbox=False), codes,
                           pass_through_mask=ptm)
        out1 = render_rays(models, r, settings(**kw, rays_in_bbox=True), codes,
                           pass_through_mask=ptm)
    torch.testing.assert_close(out0["rgb_coarse"], out1["rgb_coarse"], atol=1e-6, rtol=0)
    assert (out0["weights_coarse"] - out1["weights_coarse"]).abs().max() > 1e-6
    assert (out0["z_vals_fine"] - out1["z_vals_fine"]).abs().max() > 1e-6


def test_rays_in_bbox_reaches_render_settings():
    """JAX tests/test_train_system.py:72 on the port: the dataset's predicate
    reaches both render settings."""
    cfg = load_config(cli_args=[
        f"dataset_config={Path(__file__).resolve().parents[1] / 'config/synthetic.yml'}",
        "device=cpu", "model.D=2", "model.W=32",
        "model.skips=[1]", "model.inst_D=2", "model.inst_W=16", "model.inst_skips=[1]",
        "model.N_samples=8", "model.N_importance=4", "model.use_voxel_embedding=false"])
    ds = dataset_dict["synthetic"]("train", img_wh=(16, 12), n_frames=2,
                                   dataset_extra=cfg.dataset_extra)

    class BBoxDataset:
        def __init__(self, base):
            self._base = base

        def __getattr__(self, name):
            return getattr(self._base, name)

        def __len__(self):
            return len(self._base)

        def is_rays_in_bbox(self):
            return True

    system = ObjectNeRFSystem(cfg, dataset=BBoxDataset(ds), val_dataset=None, device="cpu")
    assert system.settings.rays_in_bbox is True
    assert system.eval_settings.rays_in_bbox is True
    plain = ObjectNeRFSystem(cfg, dataset=ds, val_dataset=None, device="cpu")
    assert plain.settings.rays_in_bbox is False and plain.eval_settings.rays_in_bbox is False


def _count_calls(monkeypatch):
    calls = {"fused_coarse_weights": 0, "fused_mlp_eval": 0, "fused_render_tiles": 0}
    for name in calls:
        fn = getattr(renderer, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(renderer, name, counted)
    return calls


def test_eval_chunk_calls_fused_mlp_eval_on_the_route(monkeypatch):
    """The route's coarse pass is `fused_mlp_eval` on both branches, not
    `fused_coarse_weights`; without an instance branch the route is the plain
    path (JAX renderer.py:346); the plain render equals the fused one."""
    calls = _count_calls(monkeypatch)
    models = port_models(jax_params(seed=5))
    r = torch.from_numpy(rays(16, seed=7))
    codes = models.code_library(torch.arange(16) % N_OBJS)
    st = settings(rays_in_bbox=True)
    assert bbox_route(st) and not bbox_route(settings(rays_in_bbox=True,
                                                      forward_instance=False))
    with torch.no_grad():
        got = render_rays_fused_eval(models, r, st, codes)
        ref = render_rays_plain(models, r, st, codes)
    assert calls == {"fused_coarse_weights": 0, "fused_mlp_eval": 1, "fused_render_tiles": 1}
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], atol=1e-6, rtol=0)
    with torch.no_grad():
        a = render_rays_fused_eval(models, r, settings(rays_in_bbox=True,
                                                       forward_instance=False))
        b = render_rays_fused_eval(models, r, settings(forward_instance=False))
    assert calls["fused_mlp_eval"] == 1 and calls["fused_coarse_weights"] == 2
    for k in a:
        assert torch.equal(a[k], b[k]), k
