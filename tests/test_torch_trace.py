"""The port's tracing registry (`object_nerf_torch/utils/trace.py`): spans
and their buckets, the counters it owns, the spans' places on the train,
render and edit paths, and the benchmark's readers of them, on the CPU."""

import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from benchmark import harness
from object_nerf_torch.models import voxel_grid as vg
from object_nerf_torch.ops import fused_mlp, gather, probes
from object_nerf_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTER_DICTS = (fused_mlp.launch_counts, gather.launch_counts, probes.launch_counts,
                 vg.build_counts)


def _spans(bucket="off"):
    return trace.totals()["spans"][bucket]


def _cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _fresh():
    trace.reset()
    yield
    trace.reset()


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_nested_spans_keep_host_and_self_time(depth):
    """A chain of `depth` nested spans: each counts once, holds its inner
    spans' time in its host time and not in its self time."""

    def nest(level):
        with trace.span(f"t.{level}"):
            torch.ones(64).sum()
            if level + 1 < depth:
                nest(level + 1)

    nest(0)
    spans = _spans()
    assert sorted(spans) == [f"t.{i}" for i in range(depth)]
    for i in range(depth):
        s = spans[f"t.{i}"]
        inner = spans[f"t.{i + 1}"]["host_s"] if i + 1 < depth else 0.0
        assert s["count"] == 1 and s["stream_s"] is None
        assert s["host_s"] >= inner and s["self_s"] == pytest.approx(s["host_s"] - inner)


def test_spans_of_other_threads_keep_their_own_stack():
    """Spans opened on other threads, while a span is open here, count in the
    totals and take nothing from this thread's self time; the updates of
    threads switching every few microseconds lose none."""
    interval = sys.getswitchinterval()
    n_threads, n_spans = 16, 500

    def work():
        for _ in range(n_spans):
            with trace.span("t.worker"):
                with trace.span("t.inner"):
                    pass

    sys.setswitchinterval(1e-6)
    try:
        with trace.span("t.main"):
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    spans = _spans()
    assert spans["t.worker"]["count"] == spans["t.inner"]["count"] == n_threads * n_spans
    assert spans["t.main"]["self_s"] == spans["t.main"]["host_s"]
    assert spans["t.worker"]["self_s"] < spans["t.worker"]["host_s"]


@pytest.mark.parametrize("profiled", [False, True])
def test_a_span_goes_into_the_bucket_of_its_opening(profiled):
    """"off" without a profiler, "on" under one: the profiler's state when
    the span opens decides, not when it closes; no CUDA event pair without
    a card."""
    if profiled:
        with _cpu_profile():
            span = trace.span("t.a")
            span.__enter__()
        span.__exit__(None, None, None)
    else:
        span = trace.span("t.a")
        span.__enter__()
        with _cpu_profile():
            span.__exit__(None, None, None)
    totals = trace.totals()["spans"]
    bucket, other = ("on", "off") if profiled else ("off", "on")
    assert totals[bucket]["t.a"]["count"] == 1 and "t.a" not in totals[other]
    assert totals[bucket]["t.a"]["stream_s"] is None


def test_without_a_profiler_a_span_opens_no_range_and_no_event(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    for _ in range(3):
        with trace.span("t.a", stream=True):
            pass
    assert _spans()["t.a"]["count"] == 3


@pytest.mark.parametrize("reset", [fused_mlp.reset_launch_counts, gather.reset_launch_counts,
                                   probes.reset_launch_counts, trace.reset])
def test_any_reset_zeroes_every_counter_and_span(reset):
    keys = [sorted(d) for d in COUNTER_DICTS]
    for d in COUNTER_DICTS:
        for k in d:
            d[k] += 3
    trace.count("t.count", 2)
    with trace.span("t.a"):
        pass
    with _cpu_profile():
        with trace.span("t.b"):
            pass
    totals = trace.totals()
    assert totals["counters"]["t.count"] == 2 and totals["counters"]["gather_rows"] >= 3
    reset()
    assert [sorted(d) for d in COUNTER_DICTS] == keys
    assert all(v == 0 for d in COUNTER_DICTS for v in d.values())
    totals = trace.totals()
    assert totals["spans"] == {"off": {}, "on": {}}
    assert {k: v for k, v in totals["counters"].items() if v} == {}
    assert totals["counters"]["fused_sigma_eval"] == 0 and "t.count" not in totals["counters"]


def test_program_spans_nest_in_the_benchmark_range_of_a_profile(tmp_path):
    """In a CPU profile the program's spans are `user_annotation` ranges
    inside the benchmark's `bench.*` range, and the harness's reduction of
    idle gaps still reads the trace."""
    path = str(tmp_path / "trace.json")
    with _cpu_profile() as prof:
        with torch.profiler.record_function("bench.window"):
            with harness.span("bench.step"):
                with trace.span("t.outer"):
                    with trace.span("t.inner"):
                        torch.ones(256).cumsum(0)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = {e["name"]: e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"}
    bench, outer, inner = events["bench.step"], events["t.outer"], events["t.inner"]
    for a, b in ((bench, outer), (outer, inner)):
        assert a["ts"] <= b["ts"] and b["ts"] + b["dur"] <= a["ts"] + a["dur"]
    idle = harness.idle_gaps(path, "bench.window")
    assert idle and all(k.split("/")[0] in ("bench.step", "host") for k in idle)
    assert _spans("on")["t.outer"]["count"] == 1


# -- the spans on the program's paths and the benchmark's readers, one traced CPU run a cell

BENCH = harness.benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
NEW_METRICS = {m["name"] for m in BENCH["per_layer"]
               if m["source"] in ("program_span", "program_counter")}
# program spans a unit of each cell on the CPU (its kernels' plain versions
# pack no weights; 32 x 24 pixels in chunks of 256: 3 chunks a frame)
PER_UNIT = {
    "voxel-train": {"train.step": 1, "train.backward": 1, "train.optim": 2,
                    "voxel.table": 1, "voxel.lookup": 2, "voxel.table_grad": 1},
    "pe-train": {"train.step": 1, "train.backward": 1, "train.optim": 2},
    "voxel-render": {"render.frame": 1, "voxel.table": 1, "voxel.lookup": 6},
    "pe-edit": {"edit.frame": 1, "edit.rays": 1, "edit.compact": 1, "edit.upload": 1,
                "edit.fetch": 1},
}
UNIT = {"voxel-train": "train.step", "pe-train": "train.step", "voxel-render": "render.frame",
        "pe-edit": "edit.frame"}
RUN = """
import json, sys
sys.path.insert(0, sys.argv[1])
from benchmark import run
from benchmark.tests.conftest import SMALL
from object_nerf_torch.utils import trace
run.TRACE_SECONDS = 0.25
out = {}
for cell in sys.argv[2:]:
    rc, line = run.run_cell(cell, 2**31 + 7, 0.3, True, device="cpu", overrides=SMALL)
    t = trace.totals()
    out[cell] = {"rc": rc, "line": json.loads(line), "counters": t["counters"],
                 "counts": {b: {n: s["count"] for n, s in v.items()}
                            for b, v in t["spans"].items()}}
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def traced_runs():
    """A traced run of every cell at the benchmark tests' small size, in a
    fresh process (the benchmark refuses to run beside JAX)."""
    out = subprocess.run([sys.executable, "-c", RUN, ROOT] + CELLS, capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.split("RESULT ", 1)[1])


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_cpu_run_gives_every_new_host_metric(traced_runs, cell):
    run = traced_runs[cell]
    assert run["rc"] == 0 and run["line"]["correct"]
    got = run["line"]["metrics"]
    want = {m["name"] for m in harness.cell_metrics(BENCH, cell, traced=True)} & NEW_METRICS
    # a CPU run has no CUDA events: the stream reader stays silent there
    silent = want & {"voxel_stream_ms.render"}
    want -= silent
    assert want <= set(got), sorted(want - set(got))
    assert not silent & set(got)
    for name in want:
        v = got[name]["value"]
        assert v == v and abs(v) != float("inf") and v >= 0, (name, v)


@pytest.mark.parametrize("cell", CELLS)
def test_each_span_opens_its_count_a_unit(traced_runs, cell):
    """Over the window outside the traced slices ("off"), each of the cell's
    spans opened its count a unit, and no other program span opened."""
    counts = traced_runs[cell]["counts"]["off"]
    units = counts[UNIT[cell]]
    assert units >= 1
    assert {n: c / units for n, c in counts.items()} == PER_UNIT[cell]
    assert traced_runs[cell]["counts"]["on"][UNIT[cell]] >= 2  # both slices
    if cell == "pe-edit":  # 3 chunks a frame, the object's hits in the first
        c = traced_runs[cell]["counters"]
        assert c["edit.chunks"] == 3 * (units + traced_runs[cell]["counts"]["on"]["edit.frame"])
        assert 0 < c["edit.chunks_mixed"] < c["edit.chunks"]
