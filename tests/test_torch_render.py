"""The port's eval render as a whole against the JAX package's.

`render_image(device="cpu")` (plain versions of the two kernels, f32)
against JAX `make_render_fn` on the same settings, weights and rays: through
its XLA path (`use_pallas=False`) and through its Pallas kernels in
interpret mode (`use_pallas=True, pallas_interpret=True`, f32). The ray
count leaves a padded last chunk.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_nerf_tpu.render.renderer import RenderSettings as JaxSettings
from object_nerf_tpu.train.system import make_render_fn as jax_make_render_fn

from object_nerf_torch.render.renderer import render_rays_fused_eval, render_rays_plain
from object_nerf_torch.train.system import init_params, make_render_fn, render_image

from _torch_port import CFG_JAX, N_OBJS, jax_params, port_models, rays, settings

torch.set_num_threads(2)
N_RAYS, CHUNK = 40, 16  # chunks of 16, 16 and 8 (+8 padding in the port)
# f32 on both sides, identical formulas
ATOL, RTOL = 1e-5, 1e-4
# the fine maps: inverse-CDF sampling inside a bin of small mass p scales a
# last-bit difference of the cdf by (bin width) / p, about 200 for the
# sharpest rays here, and XLA's cumsum rounds otherwise than torch's
# sequential one (measured: one ray of 40 moves depth_instance by 3.1e-4)
FINE_ATOL = 1e-3
MAPS = ("rgb_fine", "depth_fine", "opacity_fine", "rgb_instance_fine",
        "depth_instance_fine", "opacity_instance_fine")


@pytest.mark.parametrize("white_back", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_render_image_matches_jax_make_render_fn(white_back, use_pallas):
    params = jax_params(seed=11)
    r = rays(N_RAYS, seed=3)
    ids = np.random.RandomState(4).randint(0, N_OBJS, N_RAYS).astype(np.int64)

    jset = JaxSettings(mlp=CFG_JAX, N_samples=16, N_importance=8, perturb=0.0,
                       noise_std=0.0, forward_instance=True, is_eval=True,
                       white_back=white_back, use_pallas=use_pallas,
                       pallas_interpret=use_pallas, pallas_dtype="float32")
    want = jax_make_render_fn(jset, None, chunk=CHUNK)(
        params, jnp.asarray(r), jax.random.PRNGKey(0), jnp.asarray(ids), None)

    got = render_image(port_models(params), settings(white_back=white_back),
                       {"rays": r, "instance_ids": ids}, chunk=CHUNK, device="cpu")
    assert set(got) == set(MAPS)
    for k in MAPS:
        assert got[k].shape[0] == N_RAYS
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=FINE_ATOL,
                                   rtol=RTOL, err_msg=k)


def test_coarse_only_and_no_instance():
    params = jax_params(seed=12)
    r = rays(16, seed=5)
    ids = np.zeros(16, np.int64)
    jset = JaxSettings(mlp=CFG_JAX, N_samples=16, N_importance=0, perturb=0.0,
                       noise_std=0.0, forward_instance=False, is_eval=True)
    want = jax_make_render_fn(jset, None, chunk=8)(
        params, jnp.asarray(r), jax.random.PRNGKey(0), jnp.asarray(ids), None)
    got = render_image(port_models(params),
                       settings(N_importance=0, forward_instance=False),
                       {"rays": r, "instance_ids": ids}, chunk=8, device="cpu")
    assert set(got) == {"rgb_coarse", "depth_coarse", "opacity_coarse"}
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=ATOL, rtol=RTOL,
                                   err_msg=k)


def test_render_fn_equals_plain_reference_on_cpu():
    models = port_models(jax_params(seed=13))
    st = settings()
    r = torch.from_numpy(rays(24, seed=6))
    ids = torch.arange(24) % N_OBJS
    out = make_render_fn(st, chunk=8)(models, r, ids)
    ref = render_rays_plain(models, r, st, models.code_library(ids).detach())
    for k in ref:
        torch.testing.assert_close(out[k], ref[k], atol=0, rtol=0)


def test_eval_render_rejects_what_is_not_ported():
    """The eval render is deterministic and refuses a perturbed setting; the
    rays_in_bbox route, ported now, renders a chunk as the JAX package's XLA
    eval path does (instance-weight pdf, reference rendering.py:228-229)."""
    params = jax_params()
    models = port_models(params)
    r = rays(8)
    with pytest.raises(ValueError, match="deterministic"):
        render_rays_fused_eval(models, torch.from_numpy(r), settings(perturb=1.0))
    ids = np.arange(8) % N_OBJS
    jset = JaxSettings(mlp=CFG_JAX, N_samples=16, N_importance=8, perturb=0.0,
                       noise_std=0.0, forward_instance=True, is_eval=True, rays_in_bbox=True)
    want = jax_make_render_fn(jset, None, chunk=8)(
        params, jnp.asarray(r), jax.random.PRNGKey(0), jnp.asarray(ids), None)
    with torch.no_grad():
        got = render_rays_fused_eval(models, torch.from_numpy(r), settings(rays_in_bbox=True),
                                     models.code_library(torch.from_numpy(ids)))
    for k in MAPS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=FINE_ATOL,
                                   rtol=RTOL, err_msg=k)


def test_no_hidden_cpu_fallback():
    """Without CUDA, asking for the card (explicitly or by default) raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing falls back here")
    st = settings()
    models = port_models(jax_params())
    batch = {"rays": rays(8), "instance_ids": np.zeros(8, np.int64)}
    with pytest.raises(RuntimeError, match="CUDA"):
        render_image(models, st, batch, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        render_image(models, st, batch)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(torch.Generator().manual_seed(0), st, {})
    with pytest.raises(ValueError, match="unsupported device"):
        render_image(models, st, batch, device="meta")
