"""The port's multi-object render (object_nerf_torch/render/multi.py) against
the JAX package's (object_nerf_tpu/render/multi.py).

`render_rays_multi` against the JAX `render_rays_multi` under eval settings,
every output entry by entry (the per-sample weights and z included, which
holds the stable sort over the tied z of muted ray sets); the deterministic
kernel path `render_multi_fused_eval` on CPU tensors (plain versions, f32)
against `make_multi_eval_stages` with its Pallas kernels in interpret mode;
the chunk planner `compact_hit_order` against the JAX planner. The same
seeded numpy rays and the same weights (`from_jax_params`) go through both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_nerf_tpu.render import multi as jm
from object_nerf_tpu.render.renderer import RenderSettings as JaxSettings

from object_nerf_torch.models.mlp import ObjectNeRFConfig
from object_nerf_torch.ops import fused_mlp as fm
from object_nerf_torch.render import multi as tm
from object_nerf_torch.train.system import init_params

from _torch_port import CFG_JAX, jax_params, port_models, rays, settings

torch.set_num_threads(2)
N = 12
# f32 on both sides, identical formulas: the coarse pass
ATOL, RTOL = 1e-5, 1e-4
# the fine pass: inverse-CDF sampling inside a bin of small mass p scales a
# last-bit difference of the cdf by (bin width) / p, and XLA's cumsum rounds
# otherwise than torch's (tests/test_torch_render.py measured 7e-5 on a
# sample and 3e-4 on a map); it applies to each of the K resamplings
FINE_ATOL = 1e-3
# the Pallas kernels in interpret mode build the PE as sin(x @ S + phase),
# ~1e-4 off at the top frequency: as tests/test_multi_split.py holds the
# staged path to the monolithic one
SPLIT_TOL = dict(rtol=1e-3, atol=5e-4)
JSET = JaxSettings(mlp=CFG_JAX, N_samples=16, N_importance=8, perturb=0.0, noise_std=0.0,
                   is_eval=True)
JSET_SPLIT = dataclasses.replace(JSET, use_pallas=True, pallas_interpret=True,
                                 pallas_dtype="float32")
BIG_BOX = (np.eye(4, dtype=np.float32)[None],
           np.array([[[-100.0] * 3, [100.0] * 3]], np.float32), 1.0)
# a box that some samples of the rays fall in and others do not
SMALL_BOX = (np.eye(4, dtype=np.float32)[None],
             np.array([[[-0.8, -0.8, -0.8], [0.9, 0.7, 0.8]]], np.float32), 1.0)


def _muted(r, rows):
    r = r.copy()
    r[rows, 6:8] = 0.0  # the object's box was missed
    return r


def _ten(r, near_m, far_m):
    n = r.shape[0]
    return np.concatenate([r, np.full((n, 1), near_m, np.float32),
                           np.full((n, 1), far_m, np.float32)], -1)


def _case(name):
    """(ray sets, object ids, skip boxes, settings overrides)."""
    bg, ob, ob2 = rays(N, seed=1), rays(N, seed=2), rays(N, seed=3)
    # bounds that share no sample depth with another set's: where two sets
    # tie, a last-bit difference of the linspace decides the order
    ob[:, 6], ob[:, 7] = 0.83, 2.11
    ob2[:, 6], ob2[:, 7] = 1.47, 2.53
    half = np.arange(N) % 2 == 0
    return {
        "background": ([bg], (0,), None, {}),
        "object_alone": ([ob], (5,), None, {}),
        "two_sets": ([bg, ob], (0, 5), None, {}),
        "duplicated_id": ([bg, ob, ob2], (0, 3, 3), None, {}),
        "half_muted": ([bg, _muted(ob, half)], (0, 5), None, {}),
        "all_muted_object": ([bg, _muted(ob, slice(None))], (0, 2), None, {}),
        "muted_background_rays": ([_muted(bg, slice(0, 4))], (0,), None, {}),
        "removal_everything": ([bg, _muted(ob, slice(None))], (0, 5), BIG_BOX, {}),
        "removal_small_box": ([bg, _muted(ob, half)], (0, 7), SMALL_BOX, {}),
        "ten_channels": ([_ten(bg, 1.0, 2.0), _ten(_muted(ob, half), 1.0, 1.4)], (0, 5),
                         None, {}),
        "coarse_only": ([bg, _muted(ob, half)], (0, 5), None, dict(N_importance=0)),
        "white_back": ([bg, ob], (0, 4), None, dict(white_back=True)),
    }[name]


def _jax_boxes(boxes):
    return None if boxes is None else (jnp.asarray(boxes[0]), jnp.asarray(boxes[1]), boxes[2])


def _torch_boxes(boxes):
    return None if boxes is None else (torch.from_numpy(boxes[0]), torch.from_numpy(boxes[1]),
                                       boxes[2])


def _assert_close(got, want, fine_atol=FINE_ATOL):
    assert set(got) == set(want)
    for k, v in want.items():
        atol = fine_atol if k.endswith("_fine") else ATOL
        assert tuple(got[k].shape) == tuple(v.shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), atol=atol, rtol=RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", [
    "background", "object_alone", "two_sets", "duplicated_id", "half_muted",
    "all_muted_object", "muted_background_rays", "removal_everything", "removal_small_box",
    "ten_channels", "coarse_only", "white_back"])
def test_render_rays_multi_matches_jax(name):
    rays_list, ids, boxes, over = _case(name)
    params = jax_params(seed=21)
    want = jm.render_rays_multi(params, [jnp.asarray(r) for r in rays_list], ids,
                                jax.random.PRNGKey(0), dataclasses.replace(JSET, **over),
                                skip_boxes=_jax_boxes(boxes))
    fm.reset_launch_counts()
    got = tm.render_rays_multi(port_models(params), [torch.from_numpy(r) for r in rays_list],
                               ids, settings(**over), skip_boxes=_torch_boxes(boxes))
    assert sum(fm.launch_counts.values()) == 0  # CPU tensors: the plain versions
    _assert_close(got, want)
    typ = "coarse" if over.get("N_importance") == 0 else "fine"
    z = got[f"z_vals_{typ}"].numpy()
    assert (np.diff(z, axis=-1) >= 0).all()
    if name in ("removal_everything", "muted_background_rays"):
        rows = slice(None) if name == "removal_everything" else slice(0, 4)
        assert got[f"opacity_{typ}"][rows].max() < 1e-5
    if name == "ten_channels":
        assert not ((z > 1.0) & (z < 1.4)).any()  # both sets' intervals emptied


def test_plain_path_equals_wrapper_path_on_cpu():
    rays_list, ids, boxes, _ = _case("removal_small_box")
    models = port_models(jax_params(seed=22))
    sets = [torch.from_numpy(r) for r in rays_list]
    a = tm.render_rays_multi(models, sets, ids, settings(), skip_boxes=_torch_boxes(boxes))
    b = tm.render_rays_multi(models, sets, ids, settings(), skip_boxes=_torch_boxes(boxes),
                             plain=True)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", ["background", "two_sets", "duplicated_id", "half_muted",
                                  "removal_small_box", "ten_channels", "coarse_only",
                                  "white_back"])
def test_render_multi_fused_eval_matches_jax_stages(name):
    rays_list, ids, boxes, over = _case(name)
    params = jax_params(seed=23)
    chunk_fn = jm.make_multi_eval_stages(dataclasses.replace(JSET_SPLIT, **over), ids)
    want = chunk_fn(params, jnp.stack([jnp.asarray(r) for r in rays_list]),
                    skip_boxes=_jax_boxes(boxes))
    fm.reset_launch_counts()
    models = port_models(params)
    sets = [torch.from_numpy(r) for r in rays_list]
    got = tm.render_multi_fused_eval(models, sets, ids, settings(**over),
                                     skip_boxes=_torch_boxes(boxes))
    assert sum(fm.launch_counts.values()) == 0
    typ = "coarse" if over.get("N_importance") == 0 else "fine"
    assert set(got) == set(want) == {f"rgb_{typ}", f"depth_{typ}", f"opacity_{typ}"}
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), err_msg=k, **SPLIT_TOL)
    # and it is the general entry point's final pass (same helpers, f32)
    ref = tm.render_rays_multi(models, sets, ids, settings(**over),
                               skip_boxes=_torch_boxes(boxes))
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=1e-6, rtol=0,
                                   err_msg=k)


def test_fused_eval_is_the_deterministic_path():
    models = port_models(jax_params(seed=24))
    sets = [torch.from_numpy(rays(N, seed=1))]
    for over in (dict(perturb=1.0), dict(noise_std=1.0)):
        with pytest.raises(ValueError, match="deterministic eval path"):
            tm.render_multi_fused_eval(models, sets, (0,), settings(**over))
    with pytest.raises(ValueError, match="ray sets"):
        tm.render_multi_fused_eval(models, sets, (0, 1), settings())
    with pytest.raises(ValueError, match="ray sets"):
        tm.render_rays_multi(models, sets, (0, 1), settings())


def test_stochastic_draws_come_from_the_generator():
    """Perturbation and density noise: the same generator seed gives the
    same render, another seed another one, and explicit draws are used as
    given (the draws' shapes follow the JAX key split)."""
    rays_list, ids, _, _ = _case("half_muted")
    models = port_models(jax_params(seed=25))
    sets = [torch.from_numpy(r) for r in rays_list]
    st = settings(perturb=1.0, noise_std=1.0)

    def run(seed):
        return tm.render_rays_multi(models, sets, ids, st,
                                    generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    for k in a:
        assert torch.isfinite(a[k]).all(), k
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["rgb_fine"], c["rgb_fine"])
    assert not torch.equal(a["z_vals_coarse"], c["z_vals_coarse"])

    draws = tm.MultiDraws.sample(st, N, len(ids), "cpu", torch.Generator().manual_seed(0))
    assert draws.perturb.shape == (N, 16) and draws.pdf.shape == (N, 8)
    assert draws.noise_coarse.shape == (N, 2 * 16) and draws.noise_fine.shape == (N, 2 * 24)
    d = tm.render_rays_multi(models, sets, ids, st, draws=draws)
    for k in a:
        assert torch.equal(a[k], d[k]), k
    # zero noise draws and mid-bin perturbation reproduce nothing random
    still = tm.MultiDraws(torch.full_like(draws.perturb, 0.5),
                          torch.zeros_like(draws.noise_coarse),
                          torch.full_like(draws.pdf, 0.5), torch.zeros_like(draws.noise_fine))
    e = tm.render_rays_multi(models, sets, ids, st, draws=still)
    f = tm.render_rays_multi(models, sets, ids, st, draws=still)
    assert torch.equal(e["rgb_fine"], f["rgb_fine"])


def _hit_cases():
    n = 20
    bg, ob = rays(n, seed=1), rays(n, seed=3)
    miss = np.ones(n, bool)
    miss[[2, 7, 8, 15, 16]] = False
    some = _muted(ob, miss)
    none = _muted(ob, slice(None))
    other = _muted(rays(n, seed=4), np.arange(n) < 12)
    return {
        "five_hits": ([bg, some], (0, 5), 4),
        "two_objects": ([bg, some, other], (0, 5, 6), 4),
        "duplicated": ([bg, some, other], (0, 5, 5), 8),
        "no_hit": ([bg, none], (0, 5), 4),
        "every_ray_hits": ([bg, ob], (0, 5), 4),
        "single_set": ([bg], (0,), 4),
        "background_not_leading": ([some, bg], (5, 0), 4),
        "second_background": ([bg, some, bg], (0, 5, 0), 4),
        "chunk_larger_than_frame": ([bg, some], (0, 5), 64),
    }


@pytest.mark.parametrize("name", list(_hit_cases()))
@pytest.mark.parametrize("as_tensor", [False, True])
def test_compact_hit_order_matches_jax_planner(name, as_tensor):
    rays_list, ids, chunk = _hit_cases()[name]
    want = jm.compact_hit_order(rays_list, ids, chunk)
    got = tm.compact_hit_order([torch.from_numpy(r) for r in rays_list] if as_tensor
                               else rays_list, ids, chunk)
    if want is None:
        assert got is None
        return
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    if name == "five_hits":
        assert got[1] == 2 and got[0][:5].tolist() == [2, 7, 8, 15, 16]


def test_pack_multi_weights_layouts():
    """What the frame packs once: a density-only coarse model and a full
    fine model, with the object branch only when an object id is active."""
    flagship = dataclasses.replace(settings(), mlp=ObjectNeRFConfig(
        use_voxel_embedding=False))
    big = init_params(torch.Generator().manual_seed(0), flagship, {}, device="cpu")
    with torch.no_grad():
        both = tm.pack_multi_weights(big, flagship, (0, 3))
        assert both["coarse"].sigma_only and both["coarse"].obj is not None
        assert not both["fine"].sigma_only and both["fine"].obj is not None
        bg = tm.pack_multi_weights(big, flagship, (0,))
        assert bg["coarse"].obj is None and bg["fine"].obj is None
        one = tm.pack_multi_weights(big, dataclasses.replace(flagship, N_importance=0), (0, 3))
        assert set(one) == {"coarse"} and not one["coarse"].sigma_only
