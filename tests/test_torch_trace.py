"""The port's tracing registry (`object_nerf_torch/utils/trace.py`): spans
and their buckets, the counters it owns, the spans' places on the train,
render and edit paths, and the benchmark's readers of them, on the CPU."""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from benchmark import harness
from object_nerf_torch.models import voxel_grid as vg
from object_nerf_torch.ops import fused_mlp, gather, probes
from object_nerf_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTER_DICTS = (fused_mlp.launch_counts, gather.launch_counts, probes.launch_counts,
                 vg.build_counts, vg.table_counts)


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
                "edit.fetch": 1, "render.multi_joint": 6},
    "voxel-route-render": {"render.frame": 1, "voxel.table": 1, "voxel.lookup": 6,
                           "render.route_coarse": 3},
    "pe-render": {"render.frame": 1},
    # and 2 lookups a set and chunk: their count follows the mixed chunks (below)
    "voxel-edit": {"edit.frame": 1, "edit.rays": 1, "edit.compact": 1, "edit.upload": 1,
                   "edit.fetch": 1, "render.multi_joint": 6, "voxel.table": 1},
    # the epoch hooks ran in set-up, before the window's reset
    "voxel-train-subdivided": {"train.step": 1, "train.backward": 1, "train.optim": 2,
                               "voxel.table": 1, "voxel.lookup": 2, "voxel.table_grad": 1},
}
UNIT = {"voxel-train": "train.step", "pe-train": "train.step", "voxel-render": "render.frame",
        "pe-edit": "edit.frame", "voxel-route-render": "render.frame",
        "pe-render": "render.frame", "voxel-edit": "edit.frame",
        "voxel-train-subdivided": "train.step"}
# a CPU run has no CUDA events: the stream readers stay silent there
STREAM_READERS = {"voxel_stream_ms.render", "route_coarse_ms.route", "voxel_stream_ms.edit",
                  "multi_joint_ms.edit"}
# the subdivided room's 887,095-cell table and three prunes cost the CPU several
# times a `voxel-train` run: its traced run takes a room of 0.2 m voxels (the
# spans a step opens are the same) and 8 prune samples a voxel
COARSE = {"voxel-train-subdivided": {"scene": {"voxel_size": 0.2},
                                     "train": {"prune_samples_per_voxel": 8}}}
RUN = """
import json, sys
sys.path.insert(0, sys.argv[1])
from benchmark import run
from benchmark.tests.conftest import SMALL
from object_nerf_torch.utils import trace
run.TRACE_SECONDS = 0.25
coarse = json.loads(sys.argv[2])
out = {}
for cell in sys.argv[3:]:
    over = {"config": {**SMALL["config"], **coarse.get(cell, {})}, "traffic": SMALL["traffic"]}
    rc, line = run.run_cell(cell, 2**31 + 7, 0.3, True, device="cpu", overrides=over)
    t = trace.totals()
    out[cell] = {"rc": rc, "line": json.loads(line), "counters": t["counters"],
                 "counts": {b: {n: s["count"] for n, s in v.items()}
                            for b, v in t["spans"].items()}}
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def traced_runs():
    """A traced run of every cell at the benchmark tests' small size, in a
    fresh process (the benchmark refuses to run beside JAX) on one thread:
    beside the suite's other workers, threads that wait on each other's
    barriers made the runs several times slower."""
    out = subprocess.run([sys.executable, "-c", RUN, ROOT, json.dumps(COARSE)] + CELLS,
                         capture_output=True, text=True, timeout=600, cwd=ROOT,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.split("RESULT ", 1)[1])


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_cpu_run_gives_every_new_host_metric(traced_runs, cell):
    run = traced_runs[cell]
    assert run["rc"] == 0 and run["line"]["correct"]
    got = run["line"]["metrics"]
    want = {m["name"] for m in harness.cell_metrics(BENCH, cell, traced=True)} & NEW_METRICS
    silent = want & STREAM_READERS
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
    counts = dict(traced_runs[cell]["counts"]["off"])
    units = counts[UNIT[cell]]
    assert units >= 1
    c = traced_runs[cell]["counters"]
    frames = units + traced_runs[cell]["counts"]["on"][UNIT[cell]]
    if cell == "voxel-edit":  # 5 ray sets in a mixed chunk, the background's alone in another
        lookups = counts.pop("voxel.lookup") + traced_runs[cell]["counts"]["on"]["voxel.lookup"]
        assert lookups == 2 * (c["edit.chunks"] + 4 * c["edit.chunks_mixed"])
    assert {n: k / units for n, k in counts.items()} == PER_UNIT[cell]
    assert traced_runs[cell]["counts"]["on"][UNIT[cell]] >= 2  # both slices
    if cell in ("pe-edit", "voxel-edit"):  # 3 chunks a frame, the objects' hits first
        assert c["edit.chunks"] == 3 * frames
        assert 0 < c["edit.chunks_mixed"] < c["edit.chunks"]
        sets = 2 if cell == "pe-edit" else 5
        assert c["edit.sets"] == sets * frames
        assert 0 < c["edit.object_hits"] < (sets - 1) * frames * 32 * 24
    # the route's chunks, 3 a frame; the plain route opens neither its span nor its counter
    assert c.get("render.route_chunks", 0) == (3 * frames if cell == "voxel-route-render" else 0)
    for bucket in ("off", "on"):
        assert ("render.route_coarse" in traced_runs[cell]["counts"][bucket]) == \
            (cell == "voxel-route-render")


# -- the edit path's new span and counters ------------------------------------------


@pytest.mark.parametrize("n_importance", [0, 8])
def test_multi_joint_opens_twice_a_chunk_with_a_fine_pass(n_importance):
    """`render.multi_joint` wraps the cross-set glue of one
    `render_multi_fused_eval` call: the joint coarse weights and the
    importance draws, then the final composite; the composite alone without
    a fine pass."""
    from object_nerf_torch.models.mlp import ObjectNeRFConfig
    from object_nerf_torch.render.multi import render_multi_fused_eval
    from object_nerf_torch.render.renderer import RenderSettings
    from object_nerf_torch.train.system import init_params

    cfg = ObjectNeRFConfig(D=2, W=32, skips=(1,), inst_D=2, inst_W=16, inst_skips=(1,),
                           use_voxel_embedding=False, N_obj_code_length=8)
    st = RenderSettings(mlp=cfg, N_samples=8, N_importance=n_importance, perturb=0.0,
                        noise_std=0.0, is_eval=True)
    models = init_params(torch.Generator().manual_seed(0), st, {"N_max_objs": 4}, device="cpu")
    g = torch.Generator().manual_seed(1)
    d = torch.nn.functional.normalize(torch.randn(16, 3, generator=g), dim=-1)
    rays = torch.cat([torch.zeros(16, 3), d, torch.full((16, 1), 0.5),
                      torch.full((16, 1), 2.0)], -1)
    obj = rays.clone()
    obj[:8, 6:8] = 0.0  # half the object's rays miss its box
    trace.reset()
    for _ in range(3):
        render_multi_fused_eval(models, [rays, obj], [0, 1], st)
    assert _spans()["render.multi_joint"]["count"] == 3 * (2 if n_importance else 1)


def test_the_new_edit_span_and_counters_change_no_map(monkeypatch):
    """`pe-edit`'s frames at the benchmark tests' small size, bit for bit the
    same with `render.multi_joint`, `edit.sets` and `edit.object_hits` as
    without them."""
    import contextlib
    import types

    from benchmark.drivers import edit as edit_driver
    from benchmark.tests.conftest import SMALL
    from object_nerf_torch.edit import editable_renderer
    from object_nerf_torch.render import multi

    w = harness.cell("pe-edit", BENCH)
    cfg, tr = harness.config(w["config"]), harness.traffic(w["traffic"])
    for target, extra in ((cfg, SMALL["config"]), (tr, SMALL["traffic"])):
        for k, v in extra.items():
            target[k] = {**target.get(k, {}), **v} if isinstance(v, dict) else v
    drv = edit_driver.Driver(cfg, tr, 2 ** 31 + 3, torch.device("cpu"))
    drv.setup()
    trace.reset()
    for i in range(2):
        drv._frame(i)
    assert trace.totals()["counters"]["edit.sets"] == 2 * 2
    assert _spans()["render.multi_joint"]["count"] == 2 * 3 * 2  # 3 chunks a frame
    without = types.SimpleNamespace(
        span=lambda name, stream=False: (contextlib.nullcontext() if name == "render.multi_joint"
                                         else trace.span(name, stream)),
        count=lambda name, n=1: (None if name in ("edit.sets", "edit.object_hits")
                                 else trace.count(name, n)))
    monkeypatch.setattr(multi, "trace", without)
    monkeypatch.setattr(editable_renderer, "trace", without)
    trace.reset()
    for i in range(2):
        drv._frame(i)
    assert "edit.sets" not in trace.totals()["counters"]
    assert "render.multi_joint" not in _spans()
    for (v, p, with_), (v2, p2, without_) in zip(drv.done[:2], drv.done[2:]):
        assert (v, p) == (v2, p2) and set(with_) == set(without_)
        for k in with_:
            assert np.array_equal(with_[k], without_[k]), k


# -- the graph's counter and its reader ----------------------------------------------


@pytest.mark.parametrize("replays", [None, 0, 5])
def test_graph_step_share_reads_the_replays_over_the_steps(monkeypatch, replays):
    """`graph_step_share`: None where the program keeps no replay counter (a
    program without the graph), else 100 x replays over the steps of both
    buckets (a traced run's slices replay too)."""
    from benchmark.metrics import graph_step_share

    counters = {} if replays is None else {"train.graph_replays": replays}
    stub = {"counters": counters, "spans": {"off": {"train.step": {"count": 4}},
                                            "on": {"train.step": {"count": 1}}}}
    monkeypatch.setattr(graph_step_share, "totals", lambda: stub)
    assert graph_step_share.read(None) == (None if replays is None else 20.0 * replays)
    monkeypatch.setattr(graph_step_share, "totals", lambda: None)
    assert graph_step_share.read(None) is None


def test_the_graph_counters_are_kept_at_zero_where_no_step_replays():
    """The program declares both graph counters, so a CPU run (which never
    replays) reads a share of 0, and a reset keeps them."""
    from object_nerf_torch.train import system

    system.graph_counts["train.graph_replays"] += 2
    trace.reset()
    counters = trace.totals()["counters"]
    assert counters["train.graph_replays"] == 0 and counters["train.graph_captures"] == 0


# -- the epoch hooks' spans and the corner table's cells ------------------------------


def _voxel_system(tmp_path):
    """A small voxel system on the CPU under the progressive schedule: a
    seeded cloud of 400 points at 0.4 m voxels, narrow MLPs, 8 prune samples,
    the fine sigma bias raised so that a prune keeps some voxels and drops
    most."""
    from object_nerf_torch.config import load_config
    from object_nerf_torch.data import dataset_dict
    from object_nerf_torch.data.ply_io import write_ply
    from object_nerf_torch.train.system import ObjectNeRFSystem

    write_ply(str(tmp_path / "pcd.ply"),
              np.random.RandomState(0).rand(400, 3) * [2.4, 2.4, 1.2] - [1.2, 1.2, 0.2])
    cfg = load_config(cli_args=[
        f"dataset_config={os.path.join(ROOT, 'config/synthetic.yml')}", "img_wh=[8,6]",
        "device=cpu", "model.use_voxel_embedding=true", "model.N_freq_voxel=2",
        "model.N_max_voxels=20000", f"dataset_extra.pcd_path={tmp_path / 'pcd.ply'}",
        "dataset_extra.voxel_size=0.4", "dataset_extra.neighbor_marks=3", "model.D=2",
        "model.W=32", "model.skips=[1]", "model.inst_D=2", "model.inst_W=16",
        "model.inst_skips=[1]", "model.N_max_objs=8", "model.N_obj_code_length=8",
        "model.N_samples=8", "model.N_importance=4", "train.batch_size=32",
        "train.progressive_train=true", "train.prune_samples_per_voxel=8",
        "train.prune_voxel_batch=64"])
    system = ObjectNeRFSystem(cfg, dataset=dataset_dict["synthetic"](
        "train", n_frames=2, img_wh=(8, 6), dataset_extra=cfg.dataset_extra), device="cpu")
    with torch.no_grad():
        system.models.nerf_fine.sigma.bias += 0.5
    return system


def test_the_epoch_hooks_open_their_spans_and_count_the_pruned(tmp_path):
    """`voxel.prune` at every epoch > 2, `voxel.subdivide` at epoch 5, and
    `voxel.pruned` the voxels the prunes dropped."""
    system = _voxel_system(tmp_path)
    n0 = int(system.voxel_topo.n_occupied)
    trace.reset()
    for epoch in range(3):
        system.on_epoch_start(epoch)
    assert _spans() == {} and "voxel.pruned" not in trace.totals()["counters"]
    for epoch in (3, 4):
        system.on_epoch_start(epoch)
    n1 = int(system.voxel_topo.n_occupied)
    assert 0 < n1 < n0
    assert trace.totals()["counters"]["voxel.pruned"] == n0 - n1
    system.on_epoch_start(5)
    spans = _spans()
    assert spans["voxel.prune"]["count"] == 3 and spans["voxel.subdivide"]["count"] == 1
    dropped = n0 - n1 + (n1 - int(system.voxel_topo.n_occupied) // 8)
    assert trace.totals()["counters"]["voxel.pruned"] == dropped
    assert spans["voxel.subdivide"]["host_s"] > 0


def test_a_step_counts_its_corner_tables_cells_before_and_after_a_subdivision(tmp_path):
    """`voxel.table_cells` adds (X+1)(Y+1)(Z+1) for each eager step's table,
    on the coarse grid and on the subdivided one, and stays out of the
    launch counters that `launches_per_step.train` sums."""
    from benchmark import common
    from benchmark.metrics import launches_per_step

    system = _voxel_system(tmp_path)
    X, Y, Z = system.voxel_static.shape
    sums = []
    for epoch, cells in ((None, (X + 1) * (Y + 1) * (Z + 1)),
                         (5, (2 * X + 1) * (2 * Y + 1) * (2 * Z + 1))):
        if epoch is not None:
            system.on_epoch_start(epoch)
        trace.reset()
        for _ in range(2):
            system.training_step(system.train_dataset.sample_batch(32, system.batch_rng))
        assert trace.totals()["counters"]["voxel.table_cells"] == 2 * cells
        counters = common.program_counters()
        assert "voxel.table_cells" not in counters
        sums.append(launches_per_step.read(harness.Reading(
            "train", None, {}, 2, 1.0, 1.0, 1.0, 1.0, counters)))
    # on the CPU the kernels' plain versions launch nothing: one table build a step
    assert sums == [1.0, 1.0]


@pytest.mark.parametrize("cells", [None, 0, 887095])
def test_table_cells_reads_the_counter_over_the_steps(monkeypatch, cells):
    """`table_cells`: None where the program keeps no such counter, else the
    counter over the steps of both buckets."""
    from benchmark.metrics import table_cells

    counters = {} if cells is None else {"voxel.table_cells": 5 * cells}
    stub = {"counters": counters, "spans": {"off": {"train.step": {"count": 4}},
                                            "on": {"train.step": {"count": 1}}}}
    monkeypatch.setattr(table_cells, "totals", lambda: stub)
    assert table_cells.read(None) == (None if cells is None else cells)


def test_voxel_table_ms_reads_the_table_kernels_a_step():
    """`voxel_table_ms`: the device seconds of the listed kernels and of any
    kernel named for the table, in ms a step of the traced slice; None
    without a trace."""
    from benchmark.metrics import voxel_table_ms

    listed = voxel_table_ms.KERNELS[0] if voxel_table_ms.KERNELS else "corner_table_kernel"
    kernel_s = {listed: 0.004, "my_table_scatter": 0.002, "mlp_bwd_kernel": 0.5}
    tr = harness.Trace(window_s=2.0, busy_s=1.5, units=4, kernel_s=kernel_s, idle={})
    r = harness.Reading("train", None, {}, 4, 2.0, 1.0, 1.0, 1.0, {}, trace=tr)
    assert voxel_table_ms.read(r) == pytest.approx(1e3 * 0.006 / 4)
    r.trace = None
    assert voxel_table_ms.read(r) is None
