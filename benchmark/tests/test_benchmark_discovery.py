"""The harness finds every configuration, cell, traffic mix, driver and
metric by its name, picks up added files with no edit, and BENCHMARK.json
keeps to the contract's names and units."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = harness.ROOT
BENCH = harness.benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    w = harness.cell(cell, BENCH)
    cfg = harness.config(w["config"])
    tr = harness.traffic(w["traffic"])
    assert cfg["name"] == w["config"]
    assert hasattr(harness.driver(tr["kind"]), "Driver")
    e2e = [m["name"] for m in harness.cell_metrics(BENCH, cell, traced=False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.cell_metrics(BENCH, cell, traced=True)
    assert layer
    for m in layer:
        assert callable(harness.metric_reader(m["name"]))
    assert set(harness.load_json(harness.HERE, "limits", f"{cell}.json")["numbers"])


def test_every_config_file_is_named():
    for c in BENCH["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert harness.config(c["name"])["name"] == c["name"]
        used = [w for w in BENCH["workloads"] if w["config"] == c["name"]]
        assert used, f"configuration {c['name']} has no cell"


def test_added_files_are_picked_up_with_no_edit(tmp_path):
    """A copy of the benchmark with a configuration, a traffic mix, a cell
    and a metric of a new family added as files and entries: in a fresh
    process the copy's harness finds each by its name."""
    here = tmp_path / "benchmark"
    shutil.copytree(harness.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = harness.config("objnerf-pe-synthetic")
    cfg["name"] = "objnerf-pe-wide"
    (here / "configs" / "objnerf-pe-wide.json").write_text(json.dumps(cfg))
    tr = harness.traffic("train")
    tr["batch"] = 4096
    (here / "traffic" / "train-b4096.json").write_text(json.dumps(tr))
    (here / "metrics" / "steps_seen.py").write_text(
        "def read(r):\n    return float(r.units)\n")
    bench["configs"].append({"name": "objnerf-pe-wide", "source": "https://example.org",
                             "file": "benchmark/configs/objnerf-pe-wide.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "pe-train-b4096", "config": "objnerf-pe-wide",
                               "traffic": "train-b4096", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "train_rays_per_s", "workloads": ["pe-train-b4096"]})
    bench["end_to_end"][1]["workloads"].append("pe-train-b4096")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from benchmark import harness\n"
        "assert harness.HERE == sys.argv[1] + '/benchmark', harness.HERE\n"
        "b = harness.benchmark()\n"
        "w = harness.cell('pe-train-b4096', b)\n"
        "assert harness.config(w['config'])['name'] == 'objnerf-pe-wide'\n"
        "tr = harness.traffic(w['traffic'])\n"
        "assert tr['batch'] == 4096 and harness.driver(tr['kind']).Driver\n"
        "layer = [m['name'] for m in harness.cell_metrics(b, 'pe-train-b4096', traced=True)]\n"
        "assert 'steps_seen.train' in layer, layer\n"
        "r = harness.Reading('train', None, {}, 7, 1.0, 1.0, 1.0, 1.0, {})\n"
        "assert harness.metric_reader('steps_seen.train')(r) == 7.0\n"
        "e2e = [m['name'] for m in harness.cell_metrics(b, 'pe-train-b4096', traced=False)]\n"
        "assert e2e == ['setup_s', 'train_rays_per_s'], e2e\n"
        "print('FOUND')\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, timeout=120, cwd=str(tmp_path))
    assert out.returncode == 0 and "FOUND" in out.stdout, out.stderr[-2000:]


def test_names_and_units_keep_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in seen
            seen.add(e["name"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) - {"workloads"} <= {"name", "unit", "better", "bound", "source", "layer",
                                          "moves"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_the_command_names_only_the_benchmark():
    assert BENCH["paths"] == ["benchmark"]
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert BENCH["command"][1].startswith("benchmark/")


def test_nothing_reached_from_run_loads_jax():
    """A small CPU run of every cell, in a fresh process, then the loaded
    modules by top-level name."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from benchmark import run, harness\n"
        "from benchmark.tests.conftest import SMALL\n"
        "for c in [w['name'] for w in harness.benchmark()['workloads']]:\n"
        "    rc, line = run.run_cell(c, 7, 0.2, False, device='cpu', overrides=SMALL)\n"
        "    assert rc == 0 and line, c\n"
        "print('FOUND', harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND []" in out.stdout
