"""The benchmark's progressive-schedule cell (`voxel-train-subdivided`:
`benchmark/drivers/train_subdivided.py`, `benchmark/reference/subdivide.py`)
on the CPU at the benchmark tests' small widths: a whole run reads correct,
planted faults read not correct, the port's subdivision against the plain
reference's, and the prune on the cell's seeded weights."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import common, compare, harness
from benchmark.drivers import train_subdivided
from benchmark.model_spec import LATTICE, Spec
from benchmark.reference import subdivide as ref_subdivide
from benchmark.reference import voxel
from benchmark.tests.conftest import SMALL
from object_nerf_torch.models import voxel_grid as vg
from object_nerf_torch.train import system as program
from object_nerf_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "voxel-train-subdivided"
SEED = 2 ** 31 + 29
SMALLER = {"config": SMALL["config"],
           "traffic": {**SMALL["traffic"], "pool_rays": 256, "views": 1}}
# whole runs take the room at 0.2 m voxels (6,214 of them; a 139,159-cell table
# after the subdivision): the room's own 887,095-cell table and three prunes
# cost the CPU several times a `voxel-train` run. The room's grid is held by
# the subdivision and prune tests below.
COARSE = {"config": {**SMALL["config"], "scene": {"voxel_size": 0.2}},
          "traffic": SMALLER["traffic"]}
# the fault runs: besides, fewer prune samples in larger batches (a prune drops
# nothing on the seeded weights at any count), no warm-up
FAULT = {"config": {**COARSE["config"],
                    "train": {"prune_samples_per_voxel": 8, "prune_voxel_batch": 4096}},
         "traffic": {**SMALLER["traffic"], "warmup_steps": 0}}
# float32 on both sides, the same trilinear sums but for positions one float32
# rounding apart: the subdivided features agree to a millionth of the largest
SUBDIV_REL = 1e-6


def _cell(overrides):
    w = harness.cell(CELL, harness.benchmark(ROOT))
    cfg, tr = harness.config(w["config"]), harness.traffic(w["traffic"])
    for target, extra in ((cfg, overrides["config"]), (tr, overrides["traffic"])):
        for k, v in extra.items():
            target[k] = {**target.get(k, {}), **v} if isinstance(v, dict) else v
    return cfg, tr


def _judge(drv):
    nums = drv.compare(drv.program_readings(), drv.reference())
    return compare.judge(nums, compare.load_limits(CELL))


RUN = """
import json, sys
sys.path.insert(0, sys.argv[1])
from benchmark import run
rc, line = run.run_cell(sys.argv[2], int(sys.argv[3]), 0.2, False, device="cpu",
                        overrides=json.loads(sys.argv[4]))
print("RESULT " + json.dumps({"rc": rc, "line": line}))
"""


@pytest.fixture(autouse=True)
def _few_threads():
    """Two threads in this process (beside the suite's other workers, more
    wait on each other's barriers); one in a subprocess."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_the_cell_runs_end_to_end_and_reads_correct():
    """`run.run_cell` in a fresh process (the benchmark refuses to run beside
    JAX): the published prune count, the small widths, a smaller pool, the
    coarser room."""
    out = subprocess.run([sys.executable, "-c", RUN, ROOT, CELL, str(SEED),
                          json.dumps(COARSE)], capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.split("RESULT ", 1)[1])
    res = json.loads(got["line"])
    assert got["rc"] == 0 and res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["compared"]) == {"loss1_gap", "grad1_gap", "change_gap", "subdiv_gap"}
    for k, v in res["compared"].items():
        assert v["value"] <= 1e-5, (k, v)
    assert set(res["metrics"]) == {"setup_s", "train_rays_per_s"}


def _fault_run(monkeypatch, fault):
    if fault == "unresampled":
        subdivide = vg.subdivide_voxels

        def unresampled(features, topo, static, **kw):
            _, new_topo, new_static = subdivide(features, topo, static, **kw)
            return features.clone(), new_topo, new_static

        monkeypatch.setattr(vg, "subdivide_voxels", unresampled)
    elif fault == "prune_drops":
        prune = vg.prune_empty_voxels

        def dropping(features, topo, static, sigma_fn, **kw):
            # no density on the room's x <= 0 half: its voxels read empty
            return prune(features, topo, static,
                         lambda pts, raw: sigma_fn(pts, raw) * (pts[:, 0] > 0), **kw)

        monkeypatch.setattr(vg, "prune_empty_voxels", dropping)
    else:
        call = program.TrainStep.__call__

        def half(self, models, batch, draws=None, **kw):
            n = batch["rays"].shape[0] // 2
            batch = {k: v[:n] for k, v in batch.items()}
            if draws is not None:
                draws = draws.rows(slice(0, n))
            return call(self, models, batch, draws=draws, **kw)

        monkeypatch.setattr(program.TrainStep, "__call__", half)
    cfg, tr = _cell(FAULT)
    drv = train_subdivided.Driver(cfg, tr, SEED, torch.device("cpu"))
    drv.setup()
    return drv


@pytest.mark.parametrize("fault", ["unresampled", "prune_drops", "half_batch"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    """The table left as it was before the subdivision, a prune that drops
    the voxels of half the room, or half of every batch left out."""
    drv = _fault_run(monkeypatch, fault)
    ok, rows = _judge(drv)
    assert not ok, rows
    got = {k: v for k, v, _ in rows}
    if fault == "unresampled":  # the grid is right, its features are not
        assert 0.1 < got["subdiv_gap"] < float("inf"), got
    elif fault == "prune_drops":
        assert int(drv.system.voxel_topo.n_occupied) < 8 * int(drv.grid.occupied.sum())
        assert all(v == float("inf") for v in got.values()), got
    else:
        assert got["subdiv_gap"] <= 1e-5, got


def _room(seed):
    """The cell's room: the reference's grid and seeded lattice, and the
    program's grid with its table holding the lattice's occupied rows."""
    cfg, _ = _cell(SMALLER)
    spec = Spec.from_config(cfg["model"])
    pcd, grid = common.grid_inputs(cfg, torch.device("cpu"))
    lattice = common.make_weights(spec, cfg, seed, torch.device("cpu"), grid.n_cells)[LATTICE]
    sc, m = cfg["scene"], cfg["model"]
    _, topo, static = vg.build_voxel_grid(
        pcd, scene_center=sc["scene_center"], scale_factor=sc["scale_factor"],
        voxel_size_world=sc["voxel_size"], neighbor_marks=sc["neighbor_marks"],
        channels=spec.voxel_channels, n_freq_voxel=spec.N_freq_voxel,
        n_max_voxels=m["N_max_voxels"], device="cpu")
    return grid, lattice, topo, static


def _small_grid(seed):
    """A grid of a few dozen seeded points, 0.1 m voxels, and a random lattice."""
    rng = np.random.default_rng(seed)
    pcd = rng.uniform(-0.4, 0.4, (40, 3))
    scene = {"scene_center": [0.0, 0.0, 0.0], "scale_factor": 1.0, "voxel_size": 0.1,
             "neighbor_marks": 3}
    grid = voxel.build(pcd, scene, "cpu")
    lattice = torch.from_numpy(rng.normal(size=(grid.n_cells, 24)).astype(np.float32))
    _, topo, static = vg.build_voxel_grid(
        pcd, scene_center=scene["scene_center"], scale_factor=1.0, voxel_size_world=0.1,
        neighbor_marks=3, channels=24, n_freq_voxel=6, n_max_voxels=20000, device="cpu")
    return grid, lattice, topo, static


@pytest.mark.parametrize("where", ["room", "small"])
def test_the_ports_subdivision_matches_the_reference(where):
    grid, lattice, topo, static = _room(SEED) if where == "room" else _small_grid(5)
    assert tuple(static.shape) == grid.shape
    assert torch.equal(topo.occupancy, grid.occupied)
    table = torch.cat([lattice, lattice.new_zeros(1, lattice.shape[1])])[
        topo.row_to_cell.long().clamp(max=lattice.shape[0])]
    features, topo2, static2 = vg.subdivide_voxels(table, topo, static)
    fine, fine_lattice = ref_subdivide.subdivide(grid, lattice)
    assert tuple(static2.shape) == fine.shape == tuple(2 * s for s in grid.shape)
    assert torch.equal(topo2.occupancy, fine.occupied)
    assert int(topo2.n_occupied) == 8 * int(grid.occupied.sum())
    if where == "room":
        assert fine.shape == (126, 126, 54) and int(topo2.n_occupied) == 201744
    assert float(topo2.voxel_size) == fine.voxel_size
    assert torch.equal(topo2.voxel_offset, fine.offset)
    cells = torch.nonzero(topo2.occupancy).squeeze(1)
    got, want = features[topo2.idx_map[cells].long()], fine_lattice[cells]
    assert float((got - want).abs().max()) <= SUBDIV_REL * float(want.abs().max())


def _prune_count(density_bias):
    """The voxels the program's epoch-3 prune drops on the cell's seeded
    weights at the small widths (64 samples a voxel), the sigma biases
    raised by `density_bias`."""
    cfg, tr = _cell(SMALLER)
    cfg["density_bias"] = density_bias
    drv = train_subdivided.Driver(cfg, tr, SEED, torch.device("cpu"))
    pcd, grid = common.grid_inputs(cfg, drv.device)
    weights = common.make_weights(drv.spec, cfg, SEED, drv.device, grid.n_cells)
    system = drv._system(pcd)
    common.load_weights(system.models, weights, system.voxel_topo.row_to_cell)
    trace.reset()
    system.on_epoch_start(3)
    return trace.totals()["counters"]["voxel.pruned"], int(system.voxel_topo.n_occupied)


def test_the_prune_drops_nothing_on_the_seeded_weights_and_is_live():
    dropped, kept = _prune_count(1.0)
    assert dropped == 0 and kept == 25218
    dropped, kept = _prune_count(0.69)  # densities about 0.69: alpha 0.498 at the mean
    assert 0 < dropped and kept == 25218 - dropped


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, sys.argv[1])\n"
            "import benchmark.reference.subdivide\n"
            "print('LOADED', sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = json.loads(out.stdout.split("LOADED ", 1)[1].replace("'", '"'))
    for name in ("object_nerf_torch", "object_nerf_tpu", "jax", "jaxlib", "flax"):
        assert name not in loaded
