"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped, the rest of the run as it is, each fault
the cell can have planted in the program."""

import json

import pytest
import torch

from benchmark import run
from benchmark.tests.conftest import SMALL


def _run(cell, seed=11):
    rc, line = run.run_cell(cell, seed, 0.2, False, device="cpu", overrides=SMALL)
    assert rc == 0
    return json.loads(line)


def test_a_step_that_leaves_the_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    for cell in ("voxel-train", "pe-train"):
        res = _run(cell)
        assert not res["correct"], res["compared"]
        assert res["compared"]["change_gap"]["value"] >= 0.99


def test_half_the_batch_left_out(monkeypatch):
    from object_nerf_torch.train import system

    call = system.TrainStep.__call__

    def half(self, models, batch, draws=None, **kw):
        n = batch["rays"].shape[0] // 2
        batch = {k: v[:n] for k, v in batch.items()}
        if draws is not None:
            draws = draws.rows(slice(0, n))
        return call(self, models, batch, draws=draws, **kw)

    monkeypatch.setattr(system.TrainStep, "__call__", half)
    for cell in ("voxel-train", "pe-train"):
        res = _run(cell)
        assert not res["correct"], res["compared"]


@pytest.mark.parametrize("key", ["rgb_fine", "rgb_instance_fine"])
def test_an_answer_altered_where_it_is_produced(monkeypatch, key):
    """One pixel of the scene composite, or of the object composite, altered
    in every frame the render returns."""
    from object_nerf_torch.train import system

    make = system.make_render_fn

    def altered(*a, **kw):
        render = make(*a, **kw)

        def wrapped(*ra, **rkw):
            out = render(*ra, **rkw)
            out[key][7] += 0.5
            return out
        return wrapped

    monkeypatch.setattr(system, "make_render_fn", altered)
    res = _run("voxel-render")
    assert not res["correct"], res["compared"]


def test_an_edit_frame_altered_where_it_is_produced(monkeypatch):
    from object_nerf_torch.edit.editable_renderer import EditableRenderer

    render = EditableRenderer.render_edit

    def altered(self, *a, **kw):
        out = render(self, *a, **kw)
        out["rgb_fine"][7] += 0.5
        return out

    monkeypatch.setattr(EditableRenderer, "render_edit", altered)
    res = _run("pe-edit")
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("fault", ["pose", "code"])
def test_the_moved_objects_pass_altered(monkeypatch, fault):
    """The moved object drawn where it stood, its edit's transform left out,
    or drawn with another object's code: the object pass is wrong and the
    background's is not."""
    import numpy as np

    from object_nerf_torch.edit.editable_renderer import EditableRenderer

    ray_sets = EditableRenderer.edit_ray_sets

    def altered(self, *a, **kw):
        if fault == "pose":
            self.object_pose_transform = {k: np.eye(4) for k in self.object_pose_transform}
        rays_list, obj_ids = ray_sets(self, *a, **kw)
        assert obj_ids[0] == 0 and len(obj_ids) == 2
        if fault == "code":
            obj_ids = [0, obj_ids[1] + 1]
        return rays_list, obj_ids

    monkeypatch.setattr(EditableRenderer, "edit_ray_sets", altered)
    res = _run("pe-edit")
    assert not res["correct"], res["compared"]
