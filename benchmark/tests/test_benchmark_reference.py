"""The reference agrees with the program's plain path (float32 on the CPU)
at a small size, through a whole run of each cell."""

import json

import pytest

from benchmark import harness, run
from benchmark.tests.conftest import SMALL

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_plain_program(cell):
    rc, line = run.run_cell(cell, 2 ** 31 + 5, 0.2, False, device="cpu", overrides=SMALL)
    res = json.loads(line)
    assert rc == 0 and res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    for k, v in res["compared"].items():
        assert v["value"] <= 1e-5, (k, v)
    assert set(res["metrics"]) == {m["name"] for m in harness.cell_metrics(
        harness.benchmark(), cell, traced=False)}


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_its_layers(cell, monkeypatch):
    monkeypatch.setattr(run, "TRACE_SECONDS", 0.2)
    rc, line = run.run_cell(cell, 3, 0.5, True, device="cpu", overrides=SMALL)
    res = json.loads(line)
    assert rc == 0 and res["correct"]
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    assert res["metrics"]  # what the CPU can read: the counters and the idle share
