"""The benchmark's ToyDesk 2 edit cell (`voxel-edit`: `benchmark/desk.py`,
`benchmark/drivers/desk_edit.py`, `benchmark/reference/voxel_edit.py`) on the
CPU at the benchmark tests' small size, with seeded random weights: the
port's voxel edit frame at K = 5 against the plain reference, the desk's ray
sets against the port's, the reference's imports, the comparison's reading
of planted faults, the edit counters; and `pe-render` against its
reference."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import compare, desk, harness
from benchmark.drivers import desk_edit, render
from benchmark.reference import voxel_edit as ref_voxel_edit
from benchmark.tests.conftest import SMALL
from object_nerf_torch.render import multi
from object_nerf_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "voxel-edit"
MAPS = ("rgb_fine", "depth_fine", "opacity_fine")
SEED = 2 ** 31 + 23
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
    """A small voxel-edit driver after two frames (both views, two
    progresses), with the program's maps and the reference's of both."""
    torch.set_num_threads(2)
    cfg, tr = _cell()
    drv = desk_edit.Driver(cfg, tr, SEED, torch.device("cpu"))
    drv.setup()
    for _ in range(2):
        drv.run_unit(None)
    prog, ref = drv.program_readings(), drv.reference()
    assert [drv.done[i][0] for i in drv._checked()] == [0, 1]
    # turns well away from 0 and from +-180 degrees, where a flipped sign is no fault
    for _, p, _ in drv.done:
        assert 0.05 < abs(2 * p - 1) < 0.95, p
    return drv, prog, ref


def _rerender(drv, edits=None):
    """The driver's frames rendered again by the program, the edits of each
    object given by `edits(p)` where given."""
    out = []
    for v, p, _ in drv.done:
        twc = np.eye(4)
        twc[:3] = drv.poses[v]
        r = drv.renderer
        r.reset_active_object_ids()
        for oid, pose in (edits or drv._edits)(p).items():
            r.set_object_pose_transform(oid, pose, 0)
        w, h = drv.wh
        out.append(r.render_edit(h, w, twc, drv.fovx, chunk=int(drv.traffic["chunk"])))
    return {"frames": out}


@pytest.mark.parametrize("frame", [0, 1])
def test_voxel_edit_frame_matches_the_reference(rendered, frame):
    """Every map of the port's K = 5 voxel edit frame (the plain CPU path of
    `render_multi_fused_eval`, hit compaction on) against the reference."""
    drv, prog, ref = rendered
    hit = ref["frames"][frame]["object_hit"].numpy()
    assert 0 < hit.sum() < len(hit)
    assert drv.renderer.active_object_ids == [0, 1, 2, 3, 5]
    got, want = prog["frames"][frame], ref["frames"][frame]
    for k in MAPS:
        np.testing.assert_allclose(got[k], want[k].numpy(), atol=ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("view", [0, 1])
def test_desk_ray_sets_match_the_ports(rendered, view):
    """The reference's five ray sets against `EditableRenderer.edit_ray_sets`
    under the same edit: origins, directions, near and far, and the same
    muted rays (near = far = 0)."""
    drv, _, _ = rendered
    p = drv.done[view][1]
    r = drv.renderer
    r.reset_active_object_ids()
    for oid, pose in drv._edits(p).items():
        r.set_object_pose_transform(oid, pose, 0)
    twc = np.eye(4)
    twc[:3] = drv.poses[view]
    got, ids = r.edit_ray_sets(drv.wh[1], drv.wh[0], twc, drv.fovx)
    want, hit = ref_voxel_edit.ray_sets(drv.cfg["scene"], drv.boxes, drv.wh, drv.poses[view],
                                        drv.fovx, drv.moved, drv._edits(p))
    assert ids == [oid for _, oid in want] == [0, 1, 2, 3, 5]
    union = np.zeros(len(hit), bool)
    for g, (w, oid) in zip(got, want):
        np.testing.assert_allclose(g[:, :6], w[:, :6], atol=2e-6, rtol=0, err_msg=str(oid))
        np.testing.assert_allclose(g[:, 6:8], w[:, 6:8], atol=2e-6, rtol=0, err_msg=str(oid))
        np.testing.assert_array_equal(g[:, 7] > 0, w[:, 7] > 0, err_msg=str(oid))
        if oid:
            assert 0 < (w[:, 7] > 0).sum() < len(w)
            union |= w[:, 7] > 0
    np.testing.assert_array_equal(union, hit)


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, sys.argv[1])\n"
            "import benchmark.reference.voxel_edit, benchmark.desk\n"
            "print('LOADED', sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = json.loads(out.stdout.split("LOADED ", 1)[1].replace("'", '"'))
    for name in ("object_nerf_torch", "object_nerf_tpu", "jax", "jaxlib", "flax"):
        assert name not in loaded


@pytest.mark.parametrize("fault", ["rotation_sign", "code_row", "set_features"])
def test_a_planted_fault_is_not_correct(rendered, fault, monkeypatch):
    """The comparison, by the cell's limits: object 2 turned the other way,
    object 3 drawn with object 4's code row, or the raw voxel features of
    object 1's ray set zeroed in every mixed chunk. Each is wrong on the
    objects' pixels."""
    drv, prog, ref = rendered
    edits = None
    if fault == "rotation_sign":
        def edits(p):
            out = drv._edits(p)
            out[2] = desk.pure_rotation(1.0 - p)
            return out
    elif fault == "code_row":
        codes = drv.renderer.models.code_library.embedding_instance.weight
        monkeypatch.setattr(codes, "data", codes.data[[0, 1, 2, 4, 3] + list(
            range(5, codes.shape[0]))].clone())
    else:
        lookup, fused = multi.lookup_voxel_raw, multi.render_multi_fused_eval
        chunk = {"sets": 0, "lookups": 0}

        def counted(models, rays_list, *a, **kw):
            chunk.update(sets=len(rays_list), lookups=0)
            return fused(models, rays_list, *a, **kw)

        def zeroed(settings, voxel_ctx, xyz):  # a chunk looks up set 0..K-1, coarse then fine
            raw = lookup(settings, voxel_ctx, xyz)
            first_object = chunk["sets"] == 5 and chunk["lookups"] % 5 == 1
            chunk["lookups"] += 1
            return torch.zeros_like(raw) if first_object else raw

        monkeypatch.setattr(multi, "lookup_voxel_raw", zeroed)
        from object_nerf_torch.edit import editable_renderer
        monkeypatch.setattr(editable_renderer, "render_multi_fused_eval", counted)
    nums = drv.compare(_rerender(drv, edits), ref)
    ok, rows = compare.judge(nums, compare.load_limits(CELL))
    assert not ok, rows
    assert nums["obj_rgb_rmse"] > nums["rgb_rmse"] > 0
    sound = drv.compare(prog, ref)
    assert compare.judge(sound, compare.load_limits(CELL))[0], sound


def test_edit_counters_count_the_sets_and_their_hits(rendered):
    """A frame counts its 5 ray sets in `edit.sets` and the object sets' rays
    with near < far in `edit.object_hits`, as numpy counts them."""
    drv, _, _ = rendered
    v, p, _ = drv.done[0]
    r = drv.renderer
    r.reset_active_object_ids()
    for oid, pose in drv._edits(p).items():
        r.set_object_pose_transform(oid, pose, 0)
    twc = np.eye(4)
    twc[:3] = drv.poses[v]
    sets, ids = r.edit_ray_sets(drv.wh[1], drv.wh[0], twc, drv.fovx)
    want = sum(int((s[:, 6] < s[:, 7]).sum()) for s, oid in zip(sets, ids) if oid)
    trace.reset()
    try:
        r.render_edit(drv.wh[1], drv.wh[0], twc, drv.fovx, chunk=int(drv.traffic["chunk"]))
        c = trace.totals()["counters"]
    finally:
        trace.reset()
    assert c["edit.sets"] == 5 and 0 < c["edit.object_hits"] == want


def test_pe_render_is_correct_against_its_reference():
    """The classical model's eval render (`drivers/render.py` on the
    `objnerf-pe-synthetic` configuration, the plain CPU path) against the
    reference, by `pe-render`'s limits."""
    w = harness.cell("pe-render", harness.benchmark(ROOT))
    cfg, tr = harness.config(w["config"]), harness.traffic(w["traffic"])
    for target, extra in ((cfg, SMALL["config"]), (tr, SMALL["traffic"])):
        for k, v in extra.items():
            target[k] = {**target.get(k, {}), **v} if isinstance(v, dict) else v
    assert not cfg["model"]["use_voxel_embedding"]
    drv = render.Driver(cfg, tr, 2 ** 31 + 29, torch.device("cpu"))
    drv.setup()
    for _ in range(2):
        drv.run_unit(None)
    nums = drv.compare(drv.program_readings(), drv.reference())
    ok, rows = compare.judge(nums, compare.load_limits("pe-render"))
    assert ok and {k for k, _, _ in rows} == {"rgb_rmse", "inst_rgb_rmse"}, rows
    for k, v, _ in rows:
        assert v <= 1e-5, (k, v)
