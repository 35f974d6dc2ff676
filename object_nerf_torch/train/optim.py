"""Optimizer and learning-rate schedule factory.

Counterpart of `object_nerf_tpu/train/optim.py:56-131` (reference
utils/__init__.py:25-77): optimizers sgd / adam / radam / ranger (RAdam +
Lookahead), schedulers steplr / cosine / poly with optional gradual warmup.
The reference steps its scheduler once per epoch; here a schedule is a
function of the global step with `steps_per_epoch` baked in, which gives
the same per-epoch staircase. The train step sets every parameter group's
`lr` from the schedule before each `optimizer.step()`.

The arithmetic is that of the JAX package's optax chain. `torch.optim.SGD`
and `torch.optim.Adam` already compute it (coupled L2 decay added to the
gradient, eps outside the square root of the bias-corrected second moment).
`torch.optim.RAdam` does not (it scales eps by the bias correction and
rectifies from rho > 5 instead of >= 5), so `RAdam` below is written out,
with the Lookahead of `ranger` (period 6, slow step 0.5) as an option.

Over CUDA parameters Adam keeps every per-step quantity on the device: its
step counts (`capturable=True`) and its learning rate, a 0-d tensor that
`set_lr` writes in place. Its update is the same; a CUDA graph of the train
step can then replay it (`keeps_step_on_device`). RAdam, ranger and SGD
count their steps on the host.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch


def make_lr_schedule(train_cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """step (0-based global step) -> learning rate."""
    lr = float(train_cfg["lr"])
    num_epochs = int(train_cfg["num_epochs"])
    kind = train_cfg.get("lr_scheduler", "poly")

    if kind == "poly":
        exp = float(train_cfg.get("poly_exp", 2))

        def sched(step: int) -> float:
            return lr * (1.0 - (step // steps_per_epoch) / num_epochs) ** exp

    elif kind == "steplr":
        milestones = [int(m) for m in train_cfg.get("decay_step", [20])]
        gamma = float(train_cfg.get("decay_gamma", 0.1))

        def sched(step: int) -> float:
            e = step // steps_per_epoch
            return lr * gamma ** sum(e >= m for m in milestones)

    elif kind == "cosine":

        def sched(step: int) -> float:
            e = step // steps_per_epoch
            eps = 1e-8
            return eps + 0.5 * (lr - eps) * (1 + math.cos(math.pi * e / num_epochs))

    else:
        raise ValueError(f"scheduler {kind!r} not recognized")

    warmup_epochs = int(train_cfg.get("warmup_epochs", 0))
    if warmup_epochs > 0 and train_cfg.get("optimizer", "adam") not in ("radam", "ranger"):
        multiplier = float(train_cfg.get("warmup_multiplier", 1.0))
        base = sched

        def sched(step: int) -> float:  # noqa: F811 (GradualWarmupScheduler semantics)
            e = step / steps_per_epoch
            if e >= warmup_epochs:
                return base(step)
            frac = min(e / warmup_epochs, 1.0)
            return lr * ((multiplier - 1.0) * frac + 1.0) / multiplier

    return sched


class RAdam(torch.optim.Optimizer):
    """Rectified Adam as `optax.scale_by_radam` computes it (threshold 5,
    eps outside the root), with coupled L2 weight decay and, when
    `lookahead_period > 0`, Lookahead: slow weights kept in the state, and
    every `lookahead_period` steps the parameters snap onto `slow +
    slow_step * (fast - slow)`."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 lookahead_period: int = 0, slow_step: float = 0.5):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                      lookahead_period=lookahead_period,
                                      slow_step=slow_step))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("RAdam.step takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            ro_inf = 2.0 / (1.0 - b2) - 1.0
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                    if group["lookahead_period"] > 0:
                        st["slow"] = p.detach().clone()
                g = p.grad
                if group["weight_decay"] > 0:
                    g = g + group["weight_decay"] * p
                st["step"] += 1
                t = st["step"]
                st["mu"].mul_(b1).add_(g, alpha=1.0 - b1)
                st["nu"].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                mu_hat = st["mu"] / (1.0 - b1 ** t)
                b2t = b2 ** t
                ro = ro_inf - 2.0 * t * b2t / (1.0 - b2t)
                if ro >= 5.0:
                    r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                                  / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
                    nu_hat = st["nu"] / (1.0 - b2t)
                    upd = r * mu_hat / (nu_hat.sqrt() + group["eps"])
                else:
                    upd = mu_hat
                p.add_(upd, alpha=-group["lr"])
                k = group["lookahead_period"]
                if k > 0 and t % k == 0:
                    st["slow"].add_(p - st["slow"], alpha=group["slow_step"])
                    p.copy_(st["slow"])


def make_optimizer(train_cfg, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """The configured optimizer over `params`. Its `lr` is a placeholder:
    `set_lr` installs the schedule's value before every step. Adam over CUDA
    parameters is capturable, with its `lr` a 0-d f32 tensor on their device."""
    kind = train_cfg.get("optimizer", "adam")
    wd = float(train_cfg.get("weight_decay", 0))
    lr = float(train_cfg["lr"])
    eps = 1e-8
    params = list(params)
    if kind == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=float(train_cfg.get("momentum", 0.9)),
                               weight_decay=wd)
    if kind == "adam":
        if params and all(p.device.type == "cuda" for p in params):
            opt = torch.optim.Adam(params, lr=torch.tensor(lr, device=params[0].device),
                                   eps=eps, weight_decay=wd, capturable=True)
            opt.register_load_state_dict_post_hook(_steps_on_device)
            return opt
        return torch.optim.Adam(params, lr=lr, eps=eps, weight_decay=wd)
    if kind in ("radam", "ranger"):
        return RAdam(params, lr=lr, eps=eps, weight_decay=wd,
                     lookahead_period=6 if kind == "ranger" else 0, slow_step=0.5)
    raise ValueError(f"optimizer {kind!r} not recognized")


def _steps_on_device(optimizer: torch.optim.Optimizer) -> None:
    """`load_state_dict`'s post hook of a capturable Adam: the saved groups
    replace the live ones whole, and a checkpoint is read onto the host. Put
    the learning rate and the step counts back on the parameters' device, and
    the group back to capturable (a checkpoint may predate both)."""
    for group in optimizer.param_groups:
        device = group["params"][0].device
        group["capturable"] = True
        group["lr"] = torch.as_tensor(group["lr"], dtype=torch.float32, device=device)
        for p in group["params"]:
            st = optimizer.state.get(p)
            if st and torch.is_tensor(st.get("step")):
                st["step"] = st["step"].to(device=device, dtype=torch.float32)


def keeps_step_on_device(optimizer: torch.optim.Optimizer) -> bool:
    """Whether every per-step quantity of `optimizer` lives on the device:
    every group capturable with a tensor learning rate. A CUDA graph can
    replay such an optimizer's step."""
    return all(g.get("capturable") and torch.is_tensor(g["lr"])
               for g in optimizer.param_groups)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Install `lr` in every group: written in place into a tensor learning
    rate (where a replayed graph reads it), assigned otherwise."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr
