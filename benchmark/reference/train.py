"""The reference's training step, repeated: TotalLoss on both passes,
gradients by autograd, then Adam (beta 0.9 / 0.999, eps 1e-8, bias
corrected, eps outside the root) at the step's learning rate. The voxel
model's feature table is one leaf: the lattice's rows at the occupied
cells, in C order of the cells."""

from __future__ import annotations

from typing import Dict, List

import torch

from ..model_spec import LATTICE, TABLE, Spec
from . import render

BETAS, EPS = (0.9, 0.999), 1e-8


def leaves(weights: Dict[str, torch.Tensor], grid) -> Dict[str, torch.Tensor]:
    """The trainable leaves, under the reference's names, from the
    benchmark's weights (the lattice becomes the occupied cells' table)."""
    out = {k: v.detach().clone() for k, v in weights.items() if k != LATTICE}
    if grid is not None:
        out[TABLE] = weights[LATTICE][grid.occupied].detach().clone()
    return out


def run(weights, spec: Spec, grid, batches: List[dict], draws: List[dict], lrs: List[float],
        loss_weights: dict, frustum_th: float, rnd) -> dict:
    """`len(batches)` steps from `weights`. Returns the loss of each step,
    the norm of each leaf's first gradient, and the norm of each leaf's
    change over all the steps."""
    p0 = leaves(weights, grid)
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, grad_norms = [], None
    for t, (batch, d, lr) in enumerate(zip(batches, draws, lrs), start=1):
        ctx = render.grid_context(grid, p)
        out = render.train_forward(p, spec, ctx, batch, d, rnd, frustum_th)
        loss = render.loss(out, batch, loss_weights)
        names = list(p)
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        del out, ctx
        losses.append(float(loss.detach()))
        if grad_norms is None:
            grad_norms = {k: float(g.norm()) for k, g in zip(names, grads)}
        with torch.no_grad():
            for k, g in zip(names, grads):
                m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                mhat = m[k] / (1 - BETAS[0] ** t)
                vhat = v2[k] / (1 - BETAS[1] ** t)
                p[k].sub_(lr * mhat / (vhat.sqrt() + EPS))
        del grads
    change = {k: float((p[k].detach() - p0[k]).norm()) for k in p}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
