"""Discovery and bookkeeping of the benchmark: the cell, its configuration,
traffic, driver and per-layer metric readers, found by the names in
`BENCHMARK.json`; the spans the benchmark records around its calls; the
reduction of a `torch.profiler` trace to busy time, kernel time and idle
gaps; and the result line.

A cell is an entry of `workloads` in `BENCHMARK.json`. Its `config` names
`configs/<config>.json` (sizes, scene, precision), its `traffic` names
`traffic/<traffic>.json` (a `kind` and its parameters), the kind names the
driver `drivers/<kind>.py`, and a per-layer metric `<family>[.<part>]` is
read by its family's reader, `metrics/<family>.py`. Adding a cell, a
configuration, a traffic mix or a metric adds files and entries; no file
here changes."""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "object_nerf_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "object_nerf_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(root, "BENCHMARK.json")


def cell(name: str, bench: dict) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"({', '.join(w['name'] for w in bench['workloads'])})")


def config(name: str) -> dict:
    return load_json(HERE, "configs", f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE, "traffic", f"{name}.json")


def _module(folder: str, name: str):
    """`benchmark.<folder>.<name>`, the file `<folder>/<name>.py` of this package."""
    if not os.path.isfile(os.path.join(HERE, folder, f"{name}.py")):
        raise KeyError(f"no {folder}/{name}.py in {HERE}")
    return importlib.import_module(f"benchmark.{folder}.{name}")


def driver(kind: str):
    """The driver module of a traffic kind (`drivers/<kind>.py`)."""
    return _module("drivers", kind)


def metric_reader(name: str):
    """`read(reading) -> float | None` of a per-layer metric: the reader of
    its family, the name before the first dot (`metrics/<family>.py`)."""
    return _module("metrics", name.split(".")[0]).read


def cell_metrics(bench: dict, cell_name: str, traced: bool) -> List[dict]:
    """The cell's metrics of one kind of run: its end-to-end metrics (those
    without a `workloads` list, or whose list names it), or its per-layer
    metrics."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


# -- spans --------------------------------------------------------------------------


SPAN_S: Dict[str, float] = {}  # host seconds spent in each span since it was cleared


@contextlib.contextmanager
def span(name: str):
    """A span around a call into the program: a `record_function` range,
    which a traced run's timeline keeps, and its host time in `SPAN_S`."""
    import torch

    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    SPAN_S[name] = SPAN_S.get(name, 0.0) + time.perf_counter() - t0


# -- trace reduction -------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    window_s: float  # the device slice on the host clock, first launch to the last sync
    busy_s: float  # union of the device's kernel, copy and set intervals in it
    units: int  # steps or frames the device slice ran
    kernel_s: Dict[str, float]  # device seconds by kernel or copy name in it
    idle: Dict[str, float]  # idle device seconds of the host slice by what the host did

    def kernel_seconds(self, pieces) -> float:
        return sum(s for n, s in self.kernel_s.items() if any(p in n for p in pieces))


def _events(path: str):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _device_intervals(events, lo=-math.inf, hi=math.inf):
    """[(start, end, name)] in microseconds of the device's kernels, copies
    and sets, clipped to [lo, hi], in order of their start."""
    out = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
            if a < b:
                out.append((a, b, e["name"]))
    return sorted(out)


def _union(intervals):
    """Merged [start, end] runs of ordered intervals."""
    merged = []
    for a, b, _ in intervals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def device_time(path: str):
    """(busy seconds, seconds by kernel or copy name) of a trace of CUDA
    activity: the union of the device's intervals, and their sums by name."""
    dev = _device_intervals(_events(path))
    kernel_s: Dict[str, float] = {}
    for a, b, name in dev:
        kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) * 1e-6
    return sum(b - a for a, b in _union(dev)) * 1e-6, kernel_s


def idle_gaps(path: str, window_span: str) -> Dict[str, float]:
    """Idle device seconds inside the user annotation `window_span` of a
    trace of host and CUDA activity, by what the host was doing when each gap
    began."""
    events = _events(path)
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == window_span]
    if not win:
        raise RuntimeError(f"the trace has no span {window_span!r}")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    gaps, cur_end = [], w0
    for a, b in _union(_device_intervals(events, w0, w1)):
        if a > cur_end:
            gaps.append((cur_end, a))
        cur_end = max(cur_end, b)
    if w1 > cur_end:
        gaps.append((cur_end, w1))
    host = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
                  if e.get("cat") in ("cpu_op", "user_annotation")
                  and e.get("name") != window_span)
    idle: Dict[str, float] = {}
    for (a, b), name in zip(gaps, _host_at(host, [a for a, _ in gaps])):
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    return idle


def _host_at(host, times) -> List[str]:
    """What the host ran at each of the ascending `times` when the device
    fell idle: the benchmark's span and the innermost operation open then
    (the one that began last), by a sweep over the host events in order of
    their start with a heap of the open ones by their end."""
    import heapq

    out, open_, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            a, b, name = host[i]
            heapq.heappush(open_, (b, a, name))
            i += 1
        while open_ and open_[0][0] < t:
            heapq.heappop(open_)
        spans = [(a, n) for _, a, n in open_ if n.startswith("bench.")]
        ops = [(a, n) for _, a, n in open_ if not n.startswith("bench.")]
        outer = max(spans)[1] if spans else "host"
        out.append(f"{outer}/{max(ops)[1]}" if ops else outer)
    return out


def top(d: Dict[str, float], n: int = 10):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


# -- the reading of a run, which the per-layer metric readers take ---------------------


@dataclasses.dataclass
class Reading:
    kind: str
    spec: object  # model_spec.Spec
    traffic: dict
    units: int  # steps or frames in the window
    window_s: float
    unit_flops: float  # model FLOPs of one step or frame
    peak_flops: float
    peak_bytes: float
    counters: Dict[str, int]  # the program's launch counters over the window
    untraced: Optional[tuple] = None  # (units, seconds) of the window before the slice
    trace: Optional[Trace] = None


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, tuple],
                device: dict, compared: list, breakdown: Optional[dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": {k: {"value": v, "unit": u} for k, (v, u) in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = {k: {"value": _finite(v), "limit": lim} for k, v, lim in compared}
    return json.dumps(out, allow_nan=False)


def _finite(v: float):
    """A compared number, or null where it is not finite (never correct)."""
    return v if v == v and abs(v) != float("inf") else None
