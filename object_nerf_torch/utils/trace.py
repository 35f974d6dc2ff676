"""The port's tracing registry: counters and spans, read back as totals.

Counters. The kernel wrappers' launch counters (`ops/fused_mlp.py`'s,
shared with `fused_mlp_vjp.py` and `fused_sigma.py`; `ops/gather.py`'s;
`ops/probes.py`'s), `models/voxel_grid.py`'s corner-table builds and
`train/system.py`'s graph captures and replays are plain dicts that the
registry owns (`counter_dict`); every other counter lives here under its
own name (`count`).

Spans. `with span(name):` adds one to the name's count and its host
seconds to the name's host and self totals (self: less the spans opened
inside it on the same thread; every thread keeps its own stack, since
autograd runs a CUDA backward on a thread of its own). The totals go into
one of two buckets, fixed when the span opens:

* "off", while no torch profiler records: two `perf_counter` reads and a
  dict update, and no other torch call than the profiler flag's read;
* "on", while one records: the same, inside a `record_function(name)`
  range, which puts the span on the profiler's timeline on the clock of
  the device's kernels (the benchmark's traced slices, `fit`'s
  `tpu.profile_dir` trace). A `stream=True` span also records a CUDA event
  pair on the current stream, unless that stream is being captured into a
  CUDA graph; `totals()` reads their elapsed times after a synchronise.

`reset()` zeroes every counter and span total (each kernel module's
`reset_launch_counts` is this function), `totals()` reads them. The
registry keeps aggregates only: the profiler's trace is the record of
single spans. Span names never start with `bench.`, the prefix of
`benchmark/run.py`'s own spans.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List

import torch

BUCKETS = ("off", "on")
# unread CUDA event pairs above which a closing span reads the finished ones
PENDING_EVENTS = 4096

_profiler_on = torch._C._autograd._profiler_enabled
_clock = time.perf_counter
_lock = threading.Lock()  # guards the lists below and the named counters
_local = threading.local()
_dicts: List[Dict[str, int]] = []
_counts: Dict[str, int] = {}
_events: list = []  # (thread's totals, name, start, end) of "on" stream spans not read


class _Thread:
    """A thread's open spans and its span totals: bucket -> name -> [count,
    host s, self s, stream s, event pairs read]. Only its own thread adds to
    them, so a span takes no lock; `reset` and `totals` clear and read them,
    and a span that closes while another thread resets may land on either
    side of the reset."""

    __slots__ = ("stack", "spans")

    def __init__(self):
        self.stack: list = []
        self.spans: Dict[str, Dict[str, list]] = {b: {} for b in BUCKETS}


_threads: List[_Thread] = []


def counter_dict(keys: Iterable[str]) -> Dict[str, int]:
    """A dict of counters at 0 by `keys`, owned by the registry: `reset`
    zeroes it in place and `totals` reports it."""
    d = dict.fromkeys(keys, 0)
    with _lock:
        _dicts.append(d)
    return d


def count(name: str, n: int = 1) -> None:
    """Add `n` to the registry's counter `name`."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


class span:
    """`with span(name, stream=False):` a span of the program (module
    docstring)."""

    __slots__ = ("name", "stream", "_th", "_t0", "_inner", "_rf", "_ev")

    def __init__(self, name: str, stream: bool = False):
        self.name, self.stream = name, stream

    def __enter__(self):
        try:
            th = _local.totals
        except AttributeError:
            th = _local.totals = _Thread()
            with _lock:
                _threads.append(th)
        self._th = th
        th.stack.append(self)
        self._inner = 0.0
        self._rf = self._ev = None
        if _profiler_on():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
            if (self.stream and torch.cuda.is_initialized()
                    and not torch.cuda.is_current_stream_capturing()):
                self._ev = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                self._ev[0].record()
        self._t0 = _clock()
        return self

    def __exit__(self, *exc):
        dt = _clock() - self._t0
        th = self._th
        stack = th.stack
        stack.pop()
        if stack:
            stack[-1]._inner += dt
        spans = th.spans["off" if self._rf is None else "on"]
        rec = spans.get(self.name)
        if rec is None:
            rec = spans[self.name] = [0, 0.0, 0.0, 0.0, 0]
        rec[0] += 1
        rec[1] += dt
        rec[2] += dt - self._inner
        if self._rf is not None:
            if self._ev is not None:
                self._ev[1].record()
                with _lock:
                    _events.append((th, self.name) + self._ev)
                    if len(_events) > PENDING_EVENTS:
                        _read_events()
            self._rf.__exit__(*exc)
        return False


def _read_events() -> None:
    """Add the elapsed time of every finished event pair to its span's "on"
    totals; keep the others. Called under `_lock`."""
    keep = []
    for ev in _events:
        th, name, a, b = ev
        if not (a.query() and b.query()):
            keep.append(ev)
            continue
        rec = th.spans["on"].get(name)
        if rec is not None:
            rec[3] += a.elapsed_time(b) * 1e-3
            rec[4] += 1
    _events[:] = keep


def reset() -> None:
    """Zero every counter (keeping the counter dicts' keys) and every span
    total."""
    with _lock:
        for d in _dicts:
            for k in d:
                d[k] = 0
        _counts.clear()
        for th in _threads:
            for spans in th.spans.values():
                spans.clear()
        _events.clear()


def totals() -> dict:
    """{"spans": {bucket: {name: {"count", "host_s", "self_s", "stream_s"}}},
    "counters": {name: n}}. `stream_s` is None where no CUDA event pair of
    the name was read; with pairs pending, the device is synchronised first."""
    if _events and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    with _lock:
        _read_events()
        merged: Dict[str, Dict[str, list]] = {b: {} for b in BUCKETS}
        for th in _threads:
            for b, spans in th.spans.items():
                for name, r in list(spans.items()):
                    m = merged[b].setdefault(name, [0, 0.0, 0.0, 0.0, 0])
                    for i, v in enumerate(r):
                        m[i] += v
        spans = {b: {n: {"count": r[0], "host_s": r[1], "self_s": r[2],
                         "stream_s": r[3] if r[4] else None} for n, r in d.items()}
                 for b, d in merged.items()}
        counters: Dict[str, int] = {}
        for d in _dicts:
            counters.update(d)
        counters.update(_counts)
    return {"spans": spans, "counters": counters}
