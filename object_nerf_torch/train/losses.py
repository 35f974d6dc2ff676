"""Training losses.

Counterpart of `object_nerf_tpu/train/losses.py:26-123` (reference
models/losses.py:1-139):

* scene color: masked MSE over valid pixels (coarse + fine summed);
* scene depth: MSE where the ground-truth depth is > 0 and valid;
* opacity: MSE of the clamped instance opacity against the 2D instance
  mask, weighted by the per-pixel rebalance weights;
* instance color and depth: masked to the instance and weighted;
* a term whose mask is empty contributes exactly 0 (the reference returns
  None): the masked mean divides by max(count, 1);
* the returned log dict divides each term by its weight again.

Batches are dicts of tensors with the dataset's keys (`rgbs`, `depths`,
`valid_mask`, `instance_mask`, `instance_mask_weight`).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch


def _masked_mean(err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of err over the mask's elements; 0 when the mask is empty."""
    mask = mask.to(err.dtype)
    return (err * mask).sum() / mask.sum().clamp(min=1.0)


def color_loss(results, batch, typ_keys=("rgb_coarse", "rgb_fine")) -> torch.Tensor:
    targets = batch["rgbs"].reshape(-1, 3)
    mask = batch["valid_mask"].reshape(-1, 1)
    loss = 0.0
    for k in typ_keys:
        if k in results:
            err = (results[k] - targets) ** 2
            loss = loss + _masked_mean(err, mask.expand(err.shape))
    return loss


def depth_loss(results, batch) -> torch.Tensor:
    targets = batch["depths"].reshape(-1)
    mask = batch["valid_mask"].reshape(-1) * (targets > 0)
    loss = 0.0
    for k in ("depth_coarse", "depth_fine"):
        if k in results:
            loss = loss + _masked_mean((results[k] - targets) ** 2, mask)
    return loss


def opacity_loss(results, batch) -> torch.Tensor:
    valid = batch["valid_mask"].reshape(-1)
    inst = batch["instance_mask"].reshape(-1).float()
    w = batch["instance_mask_weight"].reshape(-1)
    loss = 0.0
    for k in ("opacity_instance_coarse", "opacity_instance_fine"):
        if k in results:
            err = (results[k].clamp(0.0, 1.0) - inst) ** 2 * w
            loss = loss + _masked_mean(err, valid)
    return loss


def instance_color_loss(results, batch) -> torch.Tensor:
    targets = batch["rgbs"].reshape(-1, 3)
    mask = (batch["valid_mask"] * batch["instance_mask"]).reshape(-1, 1)
    w = batch["instance_mask_weight"].reshape(-1, 1)
    loss = 0.0
    for k in ("rgb_instance_coarse", "rgb_instance_fine"):
        if k in results:
            err = (results[k] - targets) ** 2 * w
            loss = loss + _masked_mean(err, mask.expand(err.shape))
    return loss


def instance_depth_loss(results, batch) -> torch.Tensor:
    targets = batch["depths"].reshape(-1)
    mask = (batch["valid_mask"].reshape(-1) * (targets > 0)
            * batch["instance_mask"].reshape(-1))
    w = batch["instance_mask_weight"].reshape(-1)
    loss = 0.0
    for k in ("depth_instance_coarse", "depth_instance_fine"):
        if k in results:
            loss = loss + _masked_mean((results[k] - targets) ** 2 * w, mask)
    return loss


def total_loss(results: Mapping[str, torch.Tensor], batch: Mapping[str, torch.Tensor],
               weights: Mapping[str, float], use_instance: bool = True,
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted sum of every applicable term, and the de-weighted log dict.
    `weights` is the `loss:` config block (`color_loss_weight`, ...)."""
    terms: Dict[str, torch.Tensor] = {}
    terms["color_loss"] = weights["color_loss_weight"] * color_loss(results, batch)
    if "depths" in batch:
        terms["depth_loss"] = weights["depth_loss_weight"] * depth_loss(results, batch)
    if use_instance and "instance_mask" in batch:
        terms["opacity_loss"] = weights["opacity_loss_weight"] * opacity_loss(results, batch)
        terms["instance_color_loss"] = (weights["instance_color_loss_weight"]
                                        * instance_color_loss(results, batch))
        if "depths" in batch:
            terms["instance_depth_loss"] = (weights["instance_depth_loss_weight"]
                                            * instance_depth_loss(results, batch))
    loss_sum = sum(terms.values())
    log_dict = {k: v.detach() / weights[f"{k}_weight"] for k, v in terms.items()}
    return loss_sum, log_dict
