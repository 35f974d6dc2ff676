"""The stochastic training render (object_nerf_torch/render/renderer.py:
`render_rays`) against the JAX package's `render_rays`.

The two frameworks' generators give different numbers from one seed, so the
six draws of the JAX key split are made with `jax.random` and handed to the
port as a `RenderDraws` record. Everything runs in f32 on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_nerf_tpu.render.renderer import RenderSettings as JaxSettings
from object_nerf_tpu.render.renderer import render_rays as jax_render_rays

from object_nerf_torch.ops import fused_mlp as fm
from object_nerf_torch.render.renderer import RenderDraws, render_rays

from _torch_port import CFG_JAX, N_OBJS, jax_params, port_models, rays, settings

torch.set_num_threads(2)

N_RAYS, NS, NI = 12, 16, 8
# coarse pass: the same f32 formulas in two frameworks
COARSE_ATOL = 2e-5
# fine pass: inverse-CDF sampling scales a last-bit difference of the cdf by
# (bin width) / (bin mass), and XLA's cumsum rounds otherwise than torch's
# (ROADMAP "Faults", tests/test_torch_render.py FINE_ATOL)
FINE_ATOL = 1e-3


def jax_draws(key, n=N_RAYS, ns=NS, ni=NI):
    """The draws `render_rays` makes from `key` (renderer.py:479), as numpy."""
    k_perturb, k_nc, k_nic, k_pdf, k_nf, k_nif = jax.random.split(key, 6)
    return dict(
        perturb=np.asarray(jax.random.uniform(k_perturb, (n, ns), jnp.float32)),
        noise_coarse=np.asarray(jax.random.normal(k_nc, (n, ns), jnp.float32)),
        noise_inst_coarse=np.asarray(jax.random.normal(k_nic, (n, ns), jnp.float32)),
        pdf=np.asarray(jax.random.uniform(k_pdf, (n, ni), jnp.float32)),
        noise_fine=np.asarray(jax.random.normal(k_nf, (n, ns + ni), jnp.float32)),
        noise_inst_fine=np.asarray(jax.random.normal(k_nif, (n, ns + ni), jnp.float32)),
    )


def port_draws(d) -> RenderDraws:
    return RenderDraws(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()})


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("perturb,noise_std,frustum,white_back,forward_instance", [
    (1.0, 1.0, 0.05, False, True),   # the training configuration
    (1.0, 0.0, 0.0, True, True),
    (0.0, 1.0, 0.05, False, True),   # deterministic z, noisy densities
    (1.0, 1.0, 0.0, False, False),
])
def test_render_rays_matches_jax(plain, perturb, noise_std, frustum, white_back,
                                 forward_instance):
    params = jax_params(seed=3)
    models = port_models(params)
    r = rays(N_RAYS, seed=2)
    rng = np.random.RandomState(5)
    ids = rng.randint(0, N_OBJS, N_RAYS)
    pass_through = rng.rand(N_RAYS) < 0.5
    key = jax.random.PRNGKey(11)
    kw = dict(N_samples=NS, N_importance=NI, perturb=perturb, noise_std=noise_std,
              white_back=white_back, forward_instance=forward_instance,
              frustum_bound_th=frustum, is_eval=False)
    want = jax_render_rays(
        params, jnp.asarray(r), key, JaxSettings(mlp=CFG_JAX, **kw),
        embedding_instance=params["code_library"][ids] if forward_instance else None,
        pass_through_mask=jnp.asarray(pass_through))
    fm.reset_launch_counts()
    with torch.no_grad():
        got = render_rays(
            models, torch.from_numpy(r), settings(**kw),
            embedding_instance=models.code_library(torch.from_numpy(ids)),
            pass_through_mask=torch.from_numpy(pass_through),
            draws=port_draws(jax_draws(key)), plain=plain)
    assert sum(fm.launch_counts.values()) == 0
    assert set(got) == set(want)
    per_pass = 8 if forward_instance else 5
    assert len(got) == 2 * per_pass
    for k in want:
        atol = FINE_ATOL if k.endswith("_fine") else COARSE_ATOL
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=atol, rtol=0,
                                   err_msg=k)


def test_render_rays_randomness_sources():
    """`draws` wins over `generator`; a generator reproduces itself; with
    neither, no density noise is added (as with no key in the JAX package)."""
    models = port_models(jax_params(seed=1))
    r = torch.from_numpy(rays(N_RAYS, seed=4))
    st = settings(N_samples=NS, N_importance=NI, perturb=1.0, noise_std=1.0, is_eval=False)
    codes = models.code_library(torch.zeros(N_RAYS, dtype=torch.long))
    with torch.no_grad():
        a = render_rays(models, r, st, codes, generator=torch.Generator().manual_seed(3))
        b = render_rays(models, r, st, codes, generator=torch.Generator().manual_seed(3))
        c = render_rays(models, r, st, codes, generator=torch.Generator().manual_seed(4))
        d = RenderDraws.sample(st, N_RAYS, r.device, torch.Generator().manual_seed(3))
        e = render_rays(models, r, st, codes, draws=d,
                        generator=torch.Generator().manual_seed(9))
        zero = RenderDraws(*(torch.zeros_like(t) for t in
                             (d.perturb, d.noise_coarse, d.noise_inst_coarse, d.pdf,
                              d.noise_fine, d.noise_inst_fine)))
        zero.perturb, zero.pdf = d.perturb, d.pdf
        quiet = render_rays(models, r, st, codes, draws=zero)
        torch.manual_seed(0)
        none = render_rays(models, r, st, codes)
    for k in a:
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], e[k]), k
    assert not torch.equal(a["rgb_fine"], c["rgb_fine"])
    assert not torch.equal(a["rgb_coarse"], quiet["rgb_coarse"])  # the noise matters
    assert none["z_vals_coarse"].shape == (N_RAYS, NS)
    # the rays_in_bbox route on the same draws: the scene maps of the coarse
    # pass stay, its emitted weights and the fine samples follow the object
    with torch.no_grad():
        bbox = render_rays(models, r, dataclasses.replace(st, rays_in_bbox=True), codes,
                           draws=d)
    for k in ("rgb_coarse", "depth_coarse", "opacity_coarse", "z_vals_coarse"):
        assert torch.equal(bbox[k], e[k]), k
    assert not torch.equal(bbox["weights_coarse"], e["weights_coarse"])
    assert not torch.equal(bbox["z_vals_fine"], e["z_vals_fine"])


def test_render_rays_is_differentiable_and_detaches_the_pdf():
    """Gradients reach both models and the codes; xyz of the fine pass does
    not depend on the coarse weights (they are detached before the pdf)."""
    models = port_models(jax_params(seed=2))
    r = torch.from_numpy(rays(N_RAYS, seed=6))
    st = settings(N_samples=NS, N_importance=NI, perturb=1.0, noise_std=1.0, is_eval=False)
    ids = torch.arange(N_RAYS) % N_OBJS
    out = render_rays(models, r, st, models.code_library(ids),
                      generator=torch.Generator().manual_seed(0))
    assert not out["z_vals_fine"].requires_grad
    loss = sum(out[k].sum() for k in ("rgb_coarse", "rgb_fine", "depth_instance_fine",
                                      "opacity_instance_coarse"))
    loss.backward()
    for name, p in models.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    assert float(models.nerf_coarse.sigma.weight.grad.abs().max()) > 0
    assert float(models.nerf_fine.instance_sigma.weight.grad.abs().max()) > 0
    assert float(models.code_library.embedding_instance.weight.grad.abs().max()) > 0


def test_explicit_draws_in_sampling_and_compositing():
    """`u=` and `noise=` take precedence over the generator and reproduce the
    JAX functions fed the same numbers; without a generator or draws,
    `noise_std > 0` adds no noise (object_nerf_tpu/ops/compositing.py:50)."""
    from object_nerf_tpu.ops import compositing as jc
    from object_nerf_torch.ops import compositing as tc
    from object_nerf_torch.ops import sampling as ts

    rng = np.random.RandomState(0)
    near, far = np.full((5, 1), 0.5, np.float32), np.full((5, 1), 4.0, np.float32)
    u = rng.rand(5, 12).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    z = ts.stratified_sample(torch.from_numpy(near), torch.from_numpy(far), 12, perturb=0.7,
                             generator=gen, u=torch.from_numpy(u))
    z_mid = 0.5 * (z[:, :-1] + z[:, 1:])
    lower = torch.cat([z[:, :1] * 0 + 0.5, z_mid], -1)  # every sample stays in its bin
    assert bool((z >= lower - 1e-6).all()) and bool((z[:, 1:] > z[:, :-1]).all())
    # the JAX function, with its uniform draw replaced by u
    steps = jnp.linspace(0.0, 1.0, 12)
    zj = jnp.asarray(near) * (1 - steps) + jnp.asarray(far) * steps
    mid = 0.5 * (zj[:, :-1] + zj[:, 1:])
    up, lo = jnp.concatenate([mid, zj[:, -1:]], -1), jnp.concatenate([zj[:, :1], mid], -1)
    np.testing.assert_allclose(z.numpy(), np.asarray(lo + (up - lo) * (0.7 * u)), atol=1e-6)
    assert gen.get_state().equal(torch.Generator().manual_seed(0).get_state())  # untouched

    sig = rng.randn(5, 12).astype(np.float32)
    deltas = np.abs(rng.randn(5, 12)).astype(np.float32)
    noise = rng.randn(5, 12).astype(np.float32)
    quiet = tc.alphas_from_sigmas(torch.from_numpy(sig), torch.from_numpy(deltas), noise_std=1.0)
    np.testing.assert_allclose(
        quiet.numpy(), np.asarray(jc.alphas_from_sigmas(jnp.asarray(sig), jnp.asarray(deltas),
                                                        None, 1.0)), atol=1e-6)
    loud = tc.alphas_from_sigmas(torch.from_numpy(sig), torch.from_numpy(deltas), noise_std=0.5,
                                 noise=torch.from_numpy(noise))
    np.testing.assert_allclose(
        loud.numpy(), np.asarray(jc.alphas_from_sigmas(jnp.asarray(sig + 0.5 * noise),
                                                       jnp.asarray(deltas))), atol=1e-6)
    # sample_pdf with explicit u against the JAX function's inverse-cdf on the same u
    bins = np.sort(rng.rand(5, 9).astype(np.float32), -1)
    w = rng.rand(5, 8).astype(np.float32)
    u2 = rng.rand(5, 6).astype(np.float32)
    got = ts.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), 6, u=torch.from_numpy(u2))
    assert got.shape == (5, 6)
    assert bool((got >= torch.from_numpy(bins[:, :1])).all())
    assert bool((got <= torch.from_numpy(bins[:, -1:])).all())
