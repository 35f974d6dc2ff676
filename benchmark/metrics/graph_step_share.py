"""The share of the train steps that replayed the step's CUDA graph, in %:
the program's counter `train.graph_replays` over the window's steps, the
count of its span `train.step` in both buckets (`train/system.py:
TrainStep`; a traced run's slices replay too). None where the program
keeps no such counter."""

from benchmark.metrics.step_host_ms import totals


def read(r):
    t = totals()
    if t is None or "train.graph_replays" not in t["counters"]:
        return None
    steps = sum(b.get("train.step", {}).get("count", 0) for b in t["spans"].values())
    if not steps:
        return None
    return 100.0 * t["counters"]["train.graph_replays"] / steps
