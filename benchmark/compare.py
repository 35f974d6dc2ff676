"""The comparison that decides `correct`: numbers computed from what the
program produced and what the reference produced, each held to its limit
(`limits/<cell>.json`, with the readings each limit was set from)."""

from __future__ import annotations

import json
import math
import os
import statistics
from typing import Dict

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def load_limits(cell: str) -> Dict[str, float]:
    with open(os.path.join(HERE, "limits", f"{cell}.json")) as f:
        return {k: float(v["limit"]) for k, v in json.load(f)["numbers"].items()}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep=lambda k: True):
    """[(gap, leaf, program's norm, reference's norm)] of every kept leaf,
    largest first: the gap between the two norms of a leaf over the larger
    of the reference's norm of that leaf and of the median leaf."""
    names = [k for k in ref if keep(k)]
    med = statistics.median(ref[k] for k in names)
    out = []
    for k in names:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        out.append((gap if math.isfinite(gap) else math.inf, k, prog[k], ref[k]))
    return sorted(out, reverse=True)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """loss_gap: the largest relative gap of a checked step's loss;
    loss1_gap: the first step's (the later steps' losses drift apart
    between two correct bf16 trajectories, see PERF.md); grad1_gap: the
    worst leaf's gap of the first gradient's norm; change_gap: the worst
    leaf's gap of the norm of its change over the steps, leaving out the
    leaves whose reference gradient is under a thousandth of the median
    leaf's (Adam moves those by round-off alone)."""
    names = ("loss_gap", "loss1_gap", "grad1_gap", "change_gap")
    if (not prog["losses"] or len(prog["losses"]) != len(ref["losses"])
            or set(prog["grad_norms"]) != set(ref["grad_norms"])
            or set(prog["change_norms"]) != set(ref["change_norms"])):
        return dict.fromkeys(names, math.inf)  # a step or a leaf is missing on one side
    losses = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"])]
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    grads = leaf_gaps(prog["grad_norms"], g)
    change = leaf_gaps(prog["change_norms"], ref["change_norms"], lambda k: g[k] >= 1e-3 * med)
    out = dict(zip(names, (max(losses), losses[0], grads[0][0], change[0][0])))
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


# the colour of an eval frame's scene composite and object composite (the
# latter on a white background: it holds the object's opacity too)
EVAL_MAPS = {"rgb_rmse": "rgb_fine", "inst_rgb_rmse": "rgb_instance_fine"}


def render_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """For each number of `EVAL_MAPS`, over the checked frames, the root
    mean square gap of its map between the program and the reference."""
    maps = EVAL_MAPS
    sq, n = dict.fromkeys(maps, 0.0), dict.fromkeys(maps, 0)
    bad = {k: math.inf for k in maps}
    if not prog["frames"] or len(prog["frames"]) != len(ref["frames"]):
        return bad
    for p, r in zip(prog["frames"], ref["frames"]):
        for k, key in maps.items():
            if key not in p:
                return bad
            want = torch.as_tensor(r[key]).double().cpu()
            d = torch.as_tensor(p[key]).double().cpu() - want
            if d.shape != want.shape or not torch.isfinite(d).all():
                return bad
            sq[k] += float((d ** 2).sum())
            n[k] += d.numel()
    return {k: math.sqrt(sq[k] / n[k]) for k in maps}


def edit_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """Over the checked edit frames: rgb_rmse, the root mean square gap of
    the composite's colour (`rgb_fine`); obj_rgb_rmse, the same over the
    pixels whose ray hits the moved object's box (`object_hit`, from the
    reference's ray sets), where a wrong pose, code or object pass shows."""
    bad = {"rgb_rmse": math.inf, "obj_rgb_rmse": math.inf}
    if not prog["frames"] or len(prog["frames"]) != len(ref["frames"]):
        return bad
    gaps, hits = [], []
    for p, r in zip(prog["frames"], ref["frames"]):
        if "rgb_fine" not in p:
            return bad
        want = torch.as_tensor(r["rgb_fine"]).double().cpu()
        d = torch.as_tensor(p["rgb_fine"]).double().cpu() - want
        if d.shape != want.shape or not torch.isfinite(d).all():
            return bad
        gaps.append(d)
        hits.append(d[torch.as_tensor(r["object_hit"]).cpu()])
    gaps, hits = torch.cat(gaps), torch.cat(hits)
    if not len(hits):
        return bad  # the checked frames show no moved object
    return {"rgb_rmse": float((gaps ** 2).mean().sqrt()),
            "obj_rgb_rmse": float((hits ** 2).mean().sqrt())}


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, number, limit)] of the numbers the cell compares):
    every number that has a limit at or under it, and none missing."""
    rows = [(k, numbers.get(k, math.inf), lim) for k, lim in limits.items()]
    return all(v <= lim for _, v, lim in rows), rows
