"""The benchmark's route cell (`voxel-route-render`: `benchmark/drivers/route.py`
and `benchmark/reference/route.py`) on the CPU at the benchmark tests'
small size, with seeded random weights: the port's route render against
the plain reference on frames with hits and misses, the box-bounded rays
against the dataset's rule, the reference's imports, and the comparison's
reading of planted faults."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import compare, harness, scenes
from benchmark.drivers import route
from benchmark.tests.conftest import SMALL
from object_nerf_torch.data.geo_utils import ray_aabb_intersect

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "voxel-route-render"
MAPS = ("rgb_fine", "depth_fine", "opacity_fine", "rgb_instance_fine",
        "depth_instance_fine", "opacity_instance_fine")
SEED = 2 ** 31 + 11
# f32 on both sides, the same operations in the same order but for the
# matrix products' and sums' blocking: the maps agree to round-off
ATOL = 1e-5


def _cell():
    w = harness.cell(CELL, harness.benchmark(ROOT))
    cfg, tr = harness.config(w["config"]), harness.traffic(w["traffic"])
    for target, extra in ((cfg, SMALL["config"]), (tr, SMALL["traffic"])):
        for k, v in extra.items():
            target[k] = {**target.get(k, {}), **v} if isinstance(v, dict) else v
    return cfg, tr


@pytest.fixture(scope="module")
def rendered():
    """A small route cell's driver after two frames (both views), with the
    program's maps and the reference's of both."""
    torch.set_num_threads(2)
    cfg, tr = _cell()
    drv = route.Driver(cfg, tr, SEED, torch.device("cpu"))
    drv.setup()
    for _ in range(2):
        drv.run_unit(None)
    prog, ref = drv.program_readings(), drv.reference()
    assert [drv.done[i][0] for i in drv._checked()] == [0, 1]
    return drv, prog, ref


@pytest.mark.parametrize("view", [0, 1])
def test_route_render_matches_the_reference(rendered, view):
    """All six maps of the port's route render (`make_render_fn`, the plain
    CPU path) against the reference, on a frame with hits and misses."""
    drv, prog, ref = rendered
    hit = drv.hits[view]
    assert 0 < hit.sum() < len(hit)
    got, want = prog["frames"][view], ref["frames"][view]
    assert set(MAPS) <= set(got)
    for k in MAPS:
        np.testing.assert_allclose(got[k], want[k].numpy(), atol=ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("view", [0, 1])
def test_a_miss_keeps_its_defined_output(rendered, view):
    """A ray that misses the box (near = far = 0) renders every sample at
    its origin: an empty object composite, white, in the port and the
    reference alike."""
    drv, prog, ref = rendered
    miss = ~drv.hits[view]
    for maps in (prog["frames"][view], {k: v.numpy() for k, v in ref["frames"][view].items()}):
        assert np.all(maps["opacity_instance_fine"][miss] == 0)
        assert np.all(maps["depth_instance_fine"][miss] == 0)
        assert np.all(maps["rgb_instance_fine"][miss] == 1)
    rays = drv.frames[view][0]
    assert np.all(rays[miss, 6:8] == 0) and np.all(rays[~miss, 7] >= rays[~miss, 6])


@pytest.mark.parametrize("case", ["views", "inside", "grazing"])
def test_box_rays_follow_the_dataset_rule(case):
    """The route traffic's box-bounded rays against the port's slab test
    (`geo_utils.ray_aabb_intersect`) and `generic_dataset.py`'s rule under
    `use_bbox_only_for_test`: near = tmin / scale_factor, far = tmax /
    scale_factor, both 0 on a miss (a ray from inside the box misses)."""
    cfg, tr = _cell()
    sc = cfg["scene"]
    bounds = route.box_bounds(sc, tr["box_object"])
    rng = np.random.default_rng(5)
    if case == "views":
        frames = route.route_frames(sc, SEED, 3, (24, 18), tr["box_object"])
        centre = bounds.mean(0)
        for rays, ids, hit in frames:
            o = rays[:, :3].astype(np.float64) * sc["scale_factor"] + sc["scene_center"]
            dist = np.linalg.norm(o[0] - centre)
            assert route.EYE_DIST[0] - 1e-5 <= dist <= route.EYE_DIST[1] + 1e-5
            assert np.all(ids == tr["box_object"]) and hit.any() and not hit.all()
        c2w = scenes.look_at(np.array([2.0, -1.0, 1.5]), centre)
        o, d = scenes.pixel_rays(sc, (24, 18), c2w, np.arange(24 * 18))
    elif case == "inside":
        o = np.broadcast_to(bounds.mean(0), (64, 3)).copy()
        d = rng.normal(size=(64, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
    else:  # rays along a face, and axis-parallel directions
        o = np.stack([np.full(64, bounds[0, 0]), rng.uniform(-2, 2, 64), np.full(64, 2.0)], -1)
        d = np.zeros((64, 3))
        d[:, 2] = -1.0
    rays, hit = route.box_rays(sc, bounds, o, d)
    want_hit, tmin, tmax = ray_aabb_intersect(bounds, o, d)
    np.testing.assert_array_equal(hit, want_hit)
    scale = sc["scale_factor"]
    np.testing.assert_array_equal(rays[:, 6], (tmin / scale).astype(np.float32))
    np.testing.assert_array_equal(rays[:, 7], (tmax / scale).astype(np.float32))
    assert np.all(rays[~hit, 6:8] == 0)
    if case == "inside":
        assert not hit.any()


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, sys.argv[1])\n"
            "import benchmark.reference.route\n"
            "print('LOADED', sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = json.loads(out.stdout.split("LOADED ", 1)[1].replace("'", '"'))
    for name in ("object_nerf_torch", "object_nerf_tpu", "jax", "jaxlib", "flax"):
        assert name not in loaded


@pytest.mark.parametrize("fault", ["code", "hit_pixel", "miss_pixel"])
def test_a_planted_fault_is_not_correct(rendered, fault):
    """The comparison, by the cell's limits: the frames rendered with the
    other object's code (only the hits change), one hit pixel of the
    object's colour altered, or one missed pixel of the scene's colour
    altered (read by the numbers over all pixels alone)."""
    drv, prog, ref = rendered
    frames = [dict(f) for f in prog["frames"]]
    if fault == "code":
        for v, f in enumerate(frames):
            rays, ids = drv.frames[v]
            out = drv.render(drv.models, torch.from_numpy(rays),
                             torch.from_numpy(np.full_like(ids, 2)), drv.topo)
            f.update({k: t.numpy() for k, t in out.items()})
    else:
        key, rows = (("rgb_instance_fine", drv.hits[0]) if fault == "hit_pixel"
                     else ("rgb_fine", ~drv.hits[0]))
        f = frames[0][key].copy()
        f[np.flatnonzero(rows)[3]] += 0.5
        frames[0][key] = f
    nums = drv.compare({"frames": frames}, ref)
    ok, rows = compare.judge(nums, compare.load_limits(CELL))
    assert not ok, rows
    if fault == "code":
        assert nums["hit_inst_rgb_rmse"] > nums["inst_rgb_rmse"] > 0
        assert nums["rgb_rmse"] <= ATOL
    if fault == "miss_pixel":
        assert nums["hit_rgb_rmse"] <= ATOL and nums["hit_inst_rgb_rmse"] <= ATOL
    sound = drv.compare(prog, ref)
    assert compare.judge(sound, compare.load_limits(CELL))[0], sound
