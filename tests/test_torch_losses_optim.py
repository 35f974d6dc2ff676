"""The port's losses and optimizers (object_nerf_torch/train/{losses,optim}.py)
against the JAX package's (object_nerf_tpu/train/{losses,optim}.py, optax)."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from object_nerf_tpu.train import losses as jl
from object_nerf_tpu.train import optim as jo

from object_nerf_torch.train import losses as tl
from object_nerf_torch.train import optim as to

WEIGHTS = {"color_loss_weight": 1.0, "depth_loss_weight": 0.1, "opacity_loss_weight": 10.0,
           "instance_color_loss_weight": 1.0, "instance_depth_loss_weight": 0.1}
N = 40


def _case(seed, empty=()):
    """A rendered batch: results of both passes and the dataset's keys.
    `empty` names masks to empty: 'valid', 'instance', 'depth'."""
    rng = np.random.RandomState(seed)
    results = {}
    for typ in ("coarse", "fine"):
        results[f"rgb_{typ}"] = rng.rand(N, 3)
        results[f"depth_{typ}"] = rng.rand(N) * 3
        results[f"rgb_instance_{typ}"] = rng.rand(N, 3)
        results[f"depth_instance_{typ}"] = rng.rand(N) * 3
        results[f"opacity_instance_{typ}"] = rng.rand(N) * 1.4 - 0.2  # clamped in the loss
    batch = {
        "rgbs": rng.rand(N, 3),
        "depths": np.where(rng.rand(N) < 0.3, 0.0, rng.rand(N) * 3),
        "valid_mask": rng.rand(N) < 0.8,
        "instance_mask": rng.rand(N) < 0.4,
        "instance_mask_weight": rng.rand(N) + 0.05,
    }
    if "valid" in empty:
        batch["valid_mask"][:] = False
    if "instance" in empty:
        batch["instance_mask"][:] = False
    if "depth" in empty:
        batch["depths"][:] = 0.0
    f32 = lambda d: {k: (v if v.dtype == bool else v.astype(np.float32))  # noqa: E731
                     for k, v in d.items()}
    return f32(results), f32(batch)


def _both(results, batch):
    return (({k: jnp.asarray(v) for k, v in results.items()},
             {k: jnp.asarray(v) for k, v in batch.items()}),
            ({k: torch.from_numpy(v) for k, v in results.items()},
             {k: torch.from_numpy(v) for k, v in batch.items()}))


@pytest.mark.parametrize("term", ["color_loss", "depth_loss", "opacity_loss",
                                  "instance_color_loss", "instance_depth_loss"])
@pytest.mark.parametrize("empty", [(), ("valid",), ("instance",), ("depth",)])
def test_loss_term_matches_jax(term, empty):
    (jr, jb), (tr, tb) = _both(*_case(seed=len(term) + len(empty), empty=empty))
    want = float(getattr(jl, term)(jr, jb))
    got = float(getattr(tl, term)(tr, tb))
    # the same f32 sums in two frameworks
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-8)
    if "valid" in empty:
        assert got == 0.0  # an empty mask contributes exactly 0


@pytest.mark.parametrize("use_instance,drop", [(True, ()), (False, ()),
                                               (True, ("depths",)),
                                               (True, ("instance_mask",))])
def test_total_loss_matches_jax(use_instance, drop):
    results, batch = _case(seed=9)
    for k in drop:
        del batch[k]
    (jr, jb), (tr, tb) = _both(results, batch)
    want, want_logs = jl.total_loss(jr, jb, WEIGHTS, use_instance)
    got, got_logs = tl.total_loss(tr, tb, WEIGHTS, use_instance)
    np.testing.assert_allclose(float(got), float(want), rtol=2e-6)
    assert set(got_logs) == set(want_logs)
    for k in want_logs:  # de-weighted terms
        np.testing.assert_allclose(float(got_logs[k]), float(want_logs[k]), rtol=2e-6,
                                   atol=1e-8, err_msg=k)


# -- optimizers and schedules ---------------------------------------------------

STEPS_PER_EPOCH, N_STEPS = 3, 14  # four epoch boundaries, two lookahead syncs


def _train_cfg(optimizer, scheduler, **over):
    cfg = {"optimizer": optimizer, "lr_scheduler": scheduler, "lr": 3e-3, "num_epochs": 6,
           "momentum": 0.9, "weight_decay": 0.0, "poly_exp": 2, "decay_step": [2, 4],
           "decay_gamma": 0.5, "warmup_epochs": 0, "warmup_multiplier": 1.0}
    cfg.update(over)
    return cfg


def _run_both(cfg):
    """N_STEPS updates of two small tensors from seeded gradients: the
    parameters after every step, (optax, port)."""
    rng = np.random.RandomState(0)
    p0 = {"w": rng.randn(5, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 10.0 ** rng.uniform(-3, 0)).astype(np.float32)
              for k, v in p0.items()} for _ in range(N_STEPS)]

    opt = jo.make_optimizer(cfg, STEPS_PER_EPOCH)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    want = []
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        want.append({k: np.asarray(v) for k, v in jp.items()})

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    topt = to.make_optimizer(cfg, tp.values())
    sched = to.make_lr_schedule(cfg, STEPS_PER_EPOCH)
    got = []
    for step, g in enumerate(grads):
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        to.set_lr(topt, sched(step))
        topt.step()
        got.append({k: p.detach().numpy().copy() for k, p in tp.items()})
    return want, got


@pytest.mark.parametrize("optimizer", ["sgd", "adam", "radam", "ranger"])
@pytest.mark.parametrize("scheduler", ["poly", "steplr", "cosine"])
def test_optimizer_and_schedule_match_optax(optimizer, scheduler):
    want, got = _run_both(_train_cfg(optimizer, scheduler))
    for step, (w, g) in enumerate(zip(want, got)):
        for k in w:
            # the same arithmetic; optax computes the learning rate in f32, the
            # port in f64 before it meets the f32 parameters
            np.testing.assert_allclose(g[k], w[k], rtol=2e-5, atol=2e-7,
                                       err_msg=f"{k} after step {step}")
    assert np.abs(want[-1]["w"] - want[0]["w"]).max() > 1e-4  # it moved


@pytest.mark.parametrize("optimizer,over", [
    ("adam", dict(warmup_epochs=2, warmup_multiplier=1.0)),
    ("adam", dict(warmup_epochs=2, warmup_multiplier=4.0)),
    ("sgd", dict(warmup_epochs=3, warmup_multiplier=2.0, weight_decay=1e-2)),
    ("adam", dict(weight_decay=1e-2)),
    ("radam", dict(warmup_epochs=2, warmup_multiplier=4.0)),  # warmup is off for radam
    ("ranger", dict(weight_decay=1e-2)),
])
def test_warmup_and_weight_decay_match_optax(optimizer, over):
    want, got = _run_both(_train_cfg(optimizer, "poly", **over))
    for step, (w, g) in enumerate(zip(want, got)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=2e-5, atol=2e-7,
                                       err_msg=f"{k} after step {step}")


@pytest.mark.parametrize("scheduler", ["poly", "steplr", "cosine"])
@pytest.mark.parametrize("warmup", [0, 2])
def test_lr_schedule_matches_jax(scheduler, warmup):
    cfg = _train_cfg("adam", scheduler, warmup_epochs=warmup, warmup_multiplier=3.0)
    want = jo.make_lr_schedule(cfg, STEPS_PER_EPOCH)
    got = to.make_lr_schedule(cfg, STEPS_PER_EPOCH)
    lrs = [got(s) for s in range(6 * STEPS_PER_EPOCH)]
    np.testing.assert_allclose(lrs, [float(want(jnp.int32(s))) for s in range(len(lrs))],
                               rtol=1e-6, atol=1e-12)
    if warmup == 0:  # the per-epoch staircase
        assert lrs[0] == lrs[STEPS_PER_EPOCH - 1] != lrs[2 * STEPS_PER_EPOCH]
    with pytest.raises(ValueError, match="scheduler"):
        to.make_lr_schedule(_train_cfg("adam", "linear"), 3)
    with pytest.raises(ValueError, match="optimizer"):
        to.make_optimizer(_train_cfg("lamb", "poly"), [torch.nn.Parameter(torch.zeros(1))])


@pytest.mark.parametrize("tensor_lr", [False, True])
def test_set_lr_writes_a_tensor_rate_in_place_and_assigns_a_float(tensor_lr):
    """A capturable Adam's rate is a 0-d tensor that a replayed CUDA graph
    reads: `set_lr` writes it in place. A float rate (the CPU path, SGD,
    RAdam, ranger) is assigned."""
    params = [torch.nn.Parameter(torch.zeros(2))]
    if tensor_lr:  # what `make_optimizer` builds over CUDA parameters
        opt = torch.optim.Adam(params, lr=torch.tensor(1e-3), capturable=True)
    else:
        opt = to.make_optimizer(_train_cfg("adam", "poly"), params)
    before = opt.param_groups[0]["lr"]
    to.set_lr(opt, 0.25)
    lr = opt.param_groups[0]["lr"]
    if tensor_lr:
        assert lr is before and lr.dtype == torch.float32 and float(lr) == 0.25
    else:
        assert isinstance(lr, float) and lr == 0.25
    assert to.keeps_step_on_device(opt) == tensor_lr


@pytest.mark.parametrize("optimizer", ["sgd", "adam", "radam", "ranger"])
def test_make_optimizer_keeps_host_rates_on_cpu_parameters(optimizer):
    """Over CPU parameters every optimizer keeps a float rate and its step
    count on the host, so the JAX-parity arithmetic above is unchanged and
    no step is graphed."""
    opt = to.make_optimizer(_train_cfg(optimizer, "poly"), [torch.nn.Parameter(torch.zeros(2))])
    assert all(isinstance(g["lr"], float) and not g.get("capturable") for g in opt.param_groups)
    assert not to.keeps_step_on_device(opt)


@pytest.mark.parametrize("saved", ["float_rate", "tensor_rate"])
def test_a_restored_capturable_adam_gets_its_rate_tensor_back(saved):
    """`load_state_dict` replaces the groups whole: the post hook of a
    capturable Adam gives it back a tensor rate on the parameters' device, a
    capturable group and f32 step counts, from a checkpoint saved before the
    rate was a tensor or one whose tensor rate was read onto the host."""
    def adam(params, tensor):
        if not tensor:
            return torch.optim.Adam(params, lr=1e-3)
        opt = torch.optim.Adam(params, lr=torch.tensor(1e-3), capturable=True)
        opt.register_load_state_dict_post_hook(to._steps_on_device)
        return opt

    src = [torch.nn.Parameter(torch.ones(3))]
    old = adam(src, False)
    src[0].grad = torch.ones(3)
    old.step()
    state = old.state_dict()
    if saved == "tensor_rate":
        state["param_groups"][0]["lr"] = torch.tensor(4e-4, dtype=torch.float64)
    dst = [torch.nn.Parameter(torch.ones(3))]
    opt = adam(dst, True)
    opt.load_state_dict(state)
    g = opt.param_groups[0]
    assert g["capturable"] and torch.is_tensor(g["lr"]) and g["lr"].dtype == torch.float32
    assert float(g["lr"]) == pytest.approx(1e-3 if saved == "float_rate" else 4e-4)
    step = opt.state[dst[0]]["step"]
    assert torch.is_tensor(step) and step.dtype == torch.float32 and float(step) == 1.0
    assert to.keeps_step_on_device(opt)
