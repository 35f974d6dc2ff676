"""Training losses.

Counterpart of `object_nerf_tpu/train/losses.py:26-123` (reference
models/losses.py:1-139):

* scene color: masked MSE over valid pixels (coarse + fine summed);
* scene depth: MSE where the ground-truth depth is > 0 and valid;
* opacity: MSE of the clamped instance opacity against the 2D instance
  mask, weighted by the per-pixel rebalance weights;
* instance color and depth: masked to the instance and weighted;
* a term whose mask is empty contributes exactly 0 (the reference returns
  None): the masked mean divides by max(count, 1); in a data-parallel step
  the count is the global batch's (`term_counts`, summed over the ranks), as
  the JAX package's one loss over the sharded batch divides by it;
* the returned log dict divides each term by its weight again.

Batches are dicts of tensors with the dataset's keys (`rgbs`, `depths`,
`valid_mask`, `instance_mask`, `instance_mask_weight`).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch


def _masked_mean(err: torch.Tensor, mask: torch.Tensor,
                 count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum of err over the mask's elements over `count` (default: the mask's
    own count); 0 when the count is 0."""
    mask = mask.to(err.dtype)
    return (err * mask).sum() / (mask.sum() if count is None else count).clamp(min=1.0)


# each term's mask, shaped as its error
def _color_mask(batch):
    return batch["valid_mask"].reshape(-1, 1).expand(-1, 3)


def _depth_mask(batch):
    return batch["valid_mask"].reshape(-1) * (batch["depths"].reshape(-1) > 0)


def _opacity_mask(batch):
    return batch["valid_mask"].reshape(-1)


def _instance_color_mask(batch):
    return (batch["valid_mask"] * batch["instance_mask"]).reshape(-1, 1).expand(-1, 3)


def _instance_depth_mask(batch):
    return _depth_mask(batch) * batch["instance_mask"].reshape(-1)


_MASKS = {"color_loss": _color_mask, "depth_loss": _depth_mask,
          "opacity_loss": _opacity_mask, "instance_color_loss": _instance_color_mask,
          "instance_depth_loss": _instance_depth_mask}


def loss_terms(batch, use_instance: bool = True) -> List[str]:
    """The names of the terms `total_loss` computes for this batch."""
    names = ["color_loss"]
    if "depths" in batch:
        names.append("depth_loss")
    if use_instance and "instance_mask" in batch:
        names += ["opacity_loss", "instance_color_loss"]
        if "depths" in batch:
            names.append("instance_depth_loss")
    return names


def term_counts(batch, use_instance: bool = True) -> torch.Tensor:
    """The mask count of every term of `loss_terms`, in that order (f32):
    the divisors of the masked means. A data-parallel step sums them over
    the ranks and passes the global counts to `total_loss`."""
    return torch.stack([_MASKS[k](batch).float().sum() for k in loss_terms(batch, use_instance)])


def color_loss(results, batch, typ_keys=("rgb_coarse", "rgb_fine"), count=None) -> torch.Tensor:
    targets = batch["rgbs"].reshape(-1, 3)
    mask = _color_mask(batch)
    loss = 0.0
    for k in typ_keys:
        if k in results:
            err = (results[k] - targets) ** 2
            loss = loss + _masked_mean(err, mask, count)
    return loss


def depth_loss(results, batch, count=None) -> torch.Tensor:
    targets = batch["depths"].reshape(-1)
    mask = _depth_mask(batch)
    loss = 0.0
    for k in ("depth_coarse", "depth_fine"):
        if k in results:
            loss = loss + _masked_mean((results[k] - targets) ** 2, mask, count)
    return loss


def opacity_loss(results, batch, count=None) -> torch.Tensor:
    valid = _opacity_mask(batch)
    inst = batch["instance_mask"].reshape(-1).float()
    w = batch["instance_mask_weight"].reshape(-1)
    loss = 0.0
    for k in ("opacity_instance_coarse", "opacity_instance_fine"):
        if k in results:
            err = (results[k].clamp(0.0, 1.0) - inst) ** 2 * w
            loss = loss + _masked_mean(err, valid, count)
    return loss


def instance_color_loss(results, batch, count=None) -> torch.Tensor:
    targets = batch["rgbs"].reshape(-1, 3)
    mask = _instance_color_mask(batch)
    w = batch["instance_mask_weight"].reshape(-1, 1)
    loss = 0.0
    for k in ("rgb_instance_coarse", "rgb_instance_fine"):
        if k in results:
            err = (results[k] - targets) ** 2 * w
            loss = loss + _masked_mean(err, mask, count)
    return loss


def instance_depth_loss(results, batch, count=None) -> torch.Tensor:
    targets = batch["depths"].reshape(-1)
    mask = _instance_depth_mask(batch)
    w = batch["instance_mask_weight"].reshape(-1)
    loss = 0.0
    for k in ("depth_instance_coarse", "depth_instance_fine"):
        if k in results:
            loss = loss + _masked_mean((results[k] - targets) ** 2 * w, mask, count)
    return loss


_TERMS = {"color_loss": color_loss, "depth_loss": depth_loss, "opacity_loss": opacity_loss,
          "instance_color_loss": instance_color_loss,
          "instance_depth_loss": instance_depth_loss}


def total_loss(results: Mapping[str, torch.Tensor], batch: Mapping[str, torch.Tensor],
               weights: Mapping[str, float], use_instance: bool = True,
               counts: Optional[torch.Tensor] = None,
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted sum of every applicable term, and the de-weighted log dict.
    `weights` is the `loss:` config block (`color_loss_weight`, ...).
    `counts` (`term_counts` order) replaces each term's own mask count as its
    divisor: a data-parallel step passes the counts of the global batch."""
    terms: Dict[str, torch.Tensor] = {}
    for i, k in enumerate(loss_terms(batch, use_instance)):
        count = None if counts is None else counts[i]
        terms[k] = weights[f"{k}_weight"] * _TERMS[k](results, batch, count=count)
    loss_sum = sum(terms.values())
    log_dict = {k: v.detach() / weights[f"{k}_weight"] for k, v in terms.items()}
    return loss_sum, log_dict
