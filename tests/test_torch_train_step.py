"""The port's train step (object_nerf_torch/train/system.py: `make_train_step`)
against the JAX package's monolithic `make_train_step`: one step from
identical weights, batch and draws (loss, every gradient, every updated
parameter), and a 30-step loss curve over identical batches and draws.
Everything runs in f32 on the CPU; the JAX side is the XLA path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_nerf_tpu.models.code_library import lookup_codes
from object_nerf_tpu.render.renderer import RenderSettings as JaxSettings
from object_nerf_tpu.render.renderer import render_rays as jax_render_rays
from object_nerf_tpu.train import optim as jo
from object_nerf_tpu.train.losses import total_loss as jax_total_loss
from object_nerf_tpu.train.system import TrainState
from object_nerf_tpu.train.system import make_train_step as jax_make_train_step

from object_nerf_torch.data import dataset_dict
from object_nerf_torch.train import optim as to
from object_nerf_torch.train.convert import from_jax_grads, from_jax_params
from object_nerf_torch.train.system import graph_engages, make_train_step

from _torch_port import CFG_JAX, jax_params, port_models, settings, to_numpy
from test_torch_train_render import jax_draws, port_draws

torch.set_num_threads(2)

NS, NI, BATCH = 16, 8, 48
RENDER = dict(N_samples=NS, N_importance=NI, perturb=1.0, noise_std=1.0, white_back=False,
              forward_instance=True, frustum_bound_th=0.05, is_eval=False)
LOSS_W = {"color_loss_weight": 1.0, "depth_loss_weight": 0.1, "opacity_loss_weight": 10.0,
          "instance_color_loss_weight": 1.0, "instance_depth_loss_weight": 0.1}
TRAIN = {"optimizer": "adam", "lr": 1e-3, "weight_decay": 0.0, "lr_scheduler": "poly",
         "poly_exp": 2.0, "warmup_epochs": 0, "num_epochs": 3}
STEPS_PER_EPOCH = 10


def _dataset():
    return dataset_dict["synthetic"]("train", img_wh=(20, 15), n_frames=3,
                                     dataset_extra={"near": 0.5, "far": 5.0})


def _batches(n, seed=7):
    ds, rng = _dataset(), np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = ds.sample_batch(BATCH, rng)
        b["instance_ids"] = b["instance_ids"] % 8  # the small code library has 8 rows
        out.append(b)
    return out


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jax_loss(params, batch, key, st):
    codes = lookup_codes(params["code_library"], batch["instance_ids"])
    results = jax_render_rays(params, batch["rays"], key, st, embedding_instance=codes,
                              pass_through_mask=batch.get("pass_through_mask"))
    return jax_total_loss(results, batch, LOSS_W, True)[0]


def test_one_step_matches_jax():
    """Loss, gradients and Adam-updated parameters of one step. The fine pass
    inherits the documented last-bit amplification of `sample_pdf` (ROADMAP
    "Faults"), so gradients are held to 2e-3 of each tensor's largest entry
    and the loss to 1e-4 relative. The first Adam step moves an entry by
    lr * g / (|g| + 1e-8): about lr = 1e-3 whatever the gradient's size, so
    an entry whose gradient is itself of the order of the last-bit differences
    (below ~1e-8) may move by up to a quarter of lr more or less. Hence:
    99.5 % of each tensor's entries within 2e-6, and every entry within
    2.5e-4."""
    params = jax_params(seed=5)
    models = port_models(params).train()
    batch = _batches(1)[0]
    key = jax.random.PRNGKey(21)
    jst = JaxSettings(mlp=CFG_JAX, **RENDER)

    want_loss, want_grads = jax.value_and_grad(_jax_loss)(params, _jnp(batch), key, jst)
    opt = jo.make_optimizer(TRAIN, STEPS_PER_EPOCH)
    step_fn = jax_make_train_step(jst, LOSS_W, opt, None,
                                  jo.make_lr_schedule(TRAIN, STEPS_PER_EPOCH), donate=False)
    state, want_metrics = step_fn(TrainState(params, opt.init(params), jnp.int32(0)),
                                  _jnp(batch), key, None)

    topt = to.make_optimizer(TRAIN, models.parameters())
    step = make_train_step(settings(**RENDER), LOSS_W, topt,
                           to.make_lr_schedule(TRAIN, STEPS_PER_EPOCH))
    draws = port_draws(jax_draws(key, BATCH, NS, NI))
    grads = {}
    for name, p in models.named_parameters():  # the step clears .grad at its start only
        p.register_hook(lambda g, name=name: grads.__setitem__(name, g.clone()))
    metrics = step(models, _torch(batch), draws=draws)

    assert set(metrics) == set(want_metrics)
    np.testing.assert_allclose(float(metrics["train/loss"]), float(want_loss), rtol=1e-4)
    for k in want_metrics:
        np.testing.assert_allclose(float(metrics[k]), float(want_metrics[k]), rtol=2e-4,
                                   atol=1e-7, err_msg=k)
    want_g = from_jax_grads(to_numpy(want_grads))
    assert set(grads) == set(want_g)
    for k, w in want_g.items():
        err = (grads[k] - w).abs().max() / (w.abs().max() + 1e-12)
        assert float(err) < 2e-3, (k, float(err))
    want_p = from_jax_params(to_numpy(state.params))
    for k, p in models.state_dict().items():
        diff = (p - want_p[k]).abs()
        assert float((diff > 2e-6).float().mean()) < 5e-3, k
        assert float(diff.max()) < 2.5e-4, k
        assert float((p - from_jax_params(to_numpy(params))[k]).abs().max()) > 0, k  # it moved
    assert step.global_step == 1 and int(state.step) == 1


def test_plain_route_equals_fused_route_on_cpu():
    """On CPU tensors the fused op runs the hand-derived backward, the plain
    route autograd: one f32 step of each from the same state agrees to
    rounding."""
    batch = _torch(_batches(1, seed=3)[0])
    draws = port_draws(jax_draws(jax.random.PRNGKey(2), BATCH, NS, NI))
    out = []
    for plain in (False, True):
        models = port_models(jax_params(seed=8)).train()
        step = make_train_step(settings(**RENDER), LOSS_W,
                               to.make_optimizer(TRAIN, models.parameters()),
                               to.make_lr_schedule(TRAIN, STEPS_PER_EPOCH), plain=plain)
        m = step(models, batch, draws=draws)
        out.append((float(m["train/loss"]), {k: v.clone() for k, v in
                                             models.state_dict().items()}))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    for k in out[0][1]:
        np.testing.assert_allclose(out[0][1][k].numpy(), out[1][1][k].numpy(), atol=2e-6,
                                   rtol=0, err_msg=k)


def test_loss_curve_tracks_jax():
    """30 steps (three epochs of the poly schedule) over identical batches and
    per-step draws. The two f32 trajectories drift apart as rounding
    compounds (measured: at most 5.7e-5 relative over these 30 steps): every
    step's loss within 2e-3 of the JAX curve's, and the mean of the last
    five within 1e-3."""
    n_steps = 30
    params = jax_params(seed=6)
    models = port_models(params).train()
    batches = _batches(n_steps, seed=11)
    keys = jax.random.split(jax.random.PRNGKey(4), n_steps)
    jst = JaxSettings(mlp=CFG_JAX, **RENDER)
    opt = jo.make_optimizer(TRAIN, STEPS_PER_EPOCH)
    sched = jo.make_lr_schedule(TRAIN, STEPS_PER_EPOCH)
    step_fn = jax_make_train_step(jst, LOSS_W, opt, None, sched, donate=False)
    state = TrainState(params, opt.init(params), jnp.int32(0))
    want, want_lr = [], []
    for b, k in zip(batches, keys):
        state, m = step_fn(state, _jnp(b), k, None)
        want.append(float(m["train/loss"]))
        want_lr.append(float(m["lr"]))

    step = make_train_step(settings(**RENDER), LOSS_W,
                           to.make_optimizer(TRAIN, models.parameters()),
                           to.make_lr_schedule(TRAIN, STEPS_PER_EPOCH))
    got, got_lr = [], []
    for b, k in zip(batches, keys):
        m = step(models, _torch(b), draws=port_draws(jax_draws(k, BATCH, NS, NI)))
        got.append(float(m["train/loss"]))
        got_lr.append(m["lr"])
    np.testing.assert_allclose(got_lr, want_lr, rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=2e-3)
    assert np.mean(got[-5:]) == pytest.approx(np.mean(want[-5:]), rel=1e-3)
    assert np.mean(want[-5:]) < np.mean(want[:5])  # and it trains


@pytest.mark.parametrize("case", ["cuda_adam", "cpu", "plain", "distributed", "float_rate",
                                  "radam", "ranger", "sgd"])
def test_the_graph_engages_only_where_the_step_keeps_everything_on_the_device(case):
    """The rule, a pure function of what a step observes: a CUDA batch, no
    process group, the kernel route and an optimizer whose step count and
    rate live on the device (Adam as `make_optimizer` builds it over CUDA
    parameters: capturable, a tensor rate). RAdam, ranger and SGD count
    their steps on the host, and so does Adam with a float rate."""
    params = [torch.nn.Parameter(torch.zeros(3))]
    if case in ("radam", "ranger", "sgd", "float_rate"):
        opt = to.make_optimizer({**TRAIN, "optimizer": "adam" if case == "float_rate" else case},
                                params)
    else:
        opt = torch.optim.Adam(params, lr=torch.tensor(1e-3), capturable=True)
    device = torch.device("cpu" if case == "cpu" else "cuda")
    assert graph_engages(device, case == "distributed", case == "plain", opt) == (
        case == "cuda_adam")
