"""The port's edit path (object_nerf_torch/edit, data/geo_utils.py) against
the JAX package's.

Host geometry (`ray_aabb_intersect`, the pose helpers) and `BBoxRayHelper`
for both box formats, on files the test writes, are numpy on both sides and
must agree exactly. `EditableRenderer.render_edit` / `render_origin` with
injected weights (`from_jax_params`) run on `device="cpu"` (plain versions,
f32) against the JAX renderer on the desk set-up of
tests/test_editable_renderer.py. Hit compaction is held against the dense
composite, and the demo CLI runs end to end on a tiny config.
"""

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from object_nerf_tpu.config import Config as JaxConfig
from object_nerf_tpu.data import geo_utils as jgeo
from object_nerf_tpu.edit import bbox as jbbox
from object_nerf_tpu.edit.editable_renderer import EditableRenderer as JaxEditableRenderer
from object_nerf_tpu.models.code_library import init_code_library
from object_nerf_tpu.models.mlp import ObjectNeRFConfig as JaxMLPConfig, init_object_nerf

from object_nerf_torch.config import Config
from object_nerf_torch.data import geo_utils as tgeo
from object_nerf_torch.data.synthetic import _default_spheres
from object_nerf_torch.edit import bbox as tbbox
from object_nerf_torch.edit.__main__ import (
    get_pure_rotation, get_transformation_with_duplication_offset, main as edit_main,
    move_camera_pose,
)
from object_nerf_torch.edit.editable_renderer import EditableRenderer, read_testing_config
from object_nerf_torch.models.mlp import ObjectNeRFConfig
from object_nerf_torch.ops import fused_mlp as fm
from object_nerf_torch.train.convert import from_jax_params
from object_nerf_torch.train.system import ObjectNeRFModels

from _torch_port import to_numpy

torch.set_num_threads(2)
TINY = dict(D=2, W=32, skips=(1,), inst_D=2, inst_W=16, inst_skips=(1,),
            use_voxel_embedding=False, N_obj_code_length=8)
MODEL = {
    "use_voxel_embedding": False, "D": 2, "W": 32, "skips": [1],
    "inst_D": 2, "inst_W": 16, "inst_skips": [1],
    "N_freq_xyz": 10, "N_freq_dir": 4, "N_freq_voxel": 6,
    "N_scn_voxel_size": 16, "N_obj_voxel_size": 8, "N_samples": 8, "N_importance": 4,
    "frustum_bound": -1, "use_disp": False, "perturb": 0, "noise_std": 0,
    "N_max_objs": 16, "N_obj_code_length": 8,
}
MAPS = ("rgb_fine", "depth_fine", "opacity_fine")
# f32 on both sides, identical formulas and identical rays: a render without
# importance samples. The per-sample weights agree to 1e-5 (measured 8.7e-6,
# as in tests/test_torch_multi_render.py); a depth sums them times z up to 5
# (measured 5.5e-5)
ATOL, RTOL = 1e-4, 1e-4
# With importance samples a last-bit difference of the coarse cdf (XLA's cumsum
# rounds otherwise than torch's) is scaled by (bin width) / (bin mass) when
# the cdf is inverted. This set-up is the ill-conditioned end of that: 8 coarse
# samples over 4.5 units, and many bins empty but for the 1e-5 the sampler adds
# (muted and carved-out samples), so the sample drawn at u = 1 moves by up to
# 1.9e-3, a weight by 4.7e-3, a colour by 2.9e-3, an opacity by 5.6e-3 and a
# depth (weights times z up to 5) by 2.6e-2; 5 to 11 % of the entries move by
# more than 1e-4 (measured). A float64 run of the port is as far from the port's f32 maps
# (2.19e-2 on depth) as from the JAX package's (2.22e-2). So the fine maps are
# held to FINE_ATOL (depth: DEPTH_ATOL) with the median entry within ATOL / 2,
# and the coarse-only renders of the same frames to ATOL throughout;
# tests/test_torch_multi_render.py holds the fine pass to 1e-3 on
# well-conditioned rays.
FINE_ATOL, DEPTH_ATOL = 1e-2, 5e-2
# compacted vs dense: a muted sample still contributes the +1e-10
# transmittance epsilon of the composite (tests/test_multi_split.py)
COMPACT_TOL = dict(rtol=1e-6, atol=1e-6)


# -- host geometry -------------------------------------------------------------------


@pytest.mark.parametrize("miss_when_inside", [True, False])
def test_ray_aabb_intersect_equals_jax_package(miss_when_inside):
    rng = np.random.RandomState(0)
    o = rng.randn(400, 3) * 1.5
    d = rng.randn(400, 3)
    d[::7, 1] = 0.0  # axis-parallel rays take the 1e-14 branch
    o[:40] *= 0.1  # origins inside the box
    bounds = np.array([[-0.5, -0.4, -0.3], [0.6, 0.5, 0.7]])
    want = jgeo.ray_aabb_intersect(bounds, o, d, miss_when_inside)
    got = tgeo.ray_aabb_intersect(bounds, o, d, miss_when_inside)
    assert want[0].any() and not want[0].all()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_pose_helpers_equal_jax_package():
    rng = np.random.RandomState(1)
    poses = rng.randn(5, 3, 4)
    np.testing.assert_array_equal(tgeo.normalize(poses[0, :, 0]), jgeo.normalize(poses[0, :, 0]))
    np.testing.assert_array_equal(tgeo.average_poses(poses), jgeo.average_poses(poses))
    for a, b in zip(tgeo.center_poses(poses), jgeo.center_poses(poses)):
        np.testing.assert_array_equal(a, b)
    avg = jgeo.average_poses(poses)
    pose = np.eye(4)
    pose[:3] = poses[1]
    np.testing.assert_array_equal(tgeo.center_pose_from_avg(avg, pose),
                                  jgeo.center_pose_from_avg(avg, pose))


def _desk_files(tmp_path):
    labels = [
        {"id": 1, "data": {"position": [0.3, 0.0, 0.25], "quaternion": [0, 0, 0, 1],
                           "scale": [0.5, 0.5, 0.5]}},
        {"id": 2, "data": {"position": [-0.35, 0.2, 0.2],
                           "quaternion": [0.1, -0.2, 0.3, 0.9],  # not normalised
                           "scale": [0.4, 0.3, 0.5]}},
        {"id": 3, "data": {}},  # a label without a box is passed over
    ]
    path = tmp_path / "bbox.json"
    path.write_text(json.dumps({"labels": labels}))
    return {"dataset_name": "toydesk",
            "dataset_extra": {"scale_factor": 2.0, "scene_center": [0.1, -0.2, 0.05],
                              "bbox_dir": str(path)}}


def _scannet_files(tmp_path):
    scene = "scene0001_00"
    (tmp_path / "scans" / scene).mkdir(parents=True)
    t = np.deg2rad(25.0)
    align = np.eye(4)
    align[:2, :2] = [[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]]
    align[:3, 3] = [0.4, -0.3, 0.1]
    (tmp_path / "scans" / scene / f"{scene}.txt").write_text(
        "colorHeight = 968\naxisAlignment = " + " ".join(f"{v:.6f}" for v in align.ravel())
        + "\nnumDepthFrames = 10\n")
    (tmp_path / "bbox").mkdir()
    np.save(tmp_path / "bbox" / f"{scene}_bbox.npy", np.array([
        [0.5, 0.2, 0.4, 0.6, 0.8, 0.7, 4, 0.0],
        [-0.6, 0.1, 0.3, 0.5, 0.4, 0.6, 9, 0.0],
    ]))
    return {"dataset_name": "scannet_base",
            "dataset_extra": {"scale_factor": 4.0, "scene_center": [0.2, 0.1, -0.1],
                              "scene_id": scene, "scans_dir": str(tmp_path / "scans"),
                              "bbox_dir": str(tmp_path / "bbox")}}


@pytest.mark.parametrize("dataset,ids", [("toydesk", (1, 2)), ("scannet_base", (4, 9))])
def test_bbox_ray_helper_equals_jax_package(tmp_path, dataset, ids):
    conf = _desk_files(tmp_path) if dataset == "toydesk" else _scannet_files(tmp_path)
    rng = np.random.RandomState(2)
    o = rng.randn(300, 3) * 0.4
    d = rng.randn(300, 3)
    xyz = rng.randn(500, 3) * 0.15
    got_boxes, want_boxes = {}, {}
    for i in ids:
        got, want = tbbox.BBoxRayHelper(Config(conf), i), jbbox.BBoxRayHelper(JaxConfig(conf), i)
        got_boxes[str(i)], want_boxes[str(i)] = got, want
        np.testing.assert_array_equal(got.bbox_bounds, want.bbox_bounds)
        np.testing.assert_array_equal(got.get_world_to_object_transform(),
                                      want.get_world_to_object_transform())
        np.testing.assert_array_equal(got.get_axis_align_mat(rescaled=True),
                                      want.get_axis_align_mat(rescaled=True))
        for enlarge in (0.0, 0.1):
            a = got.get_ray_bbox_intersections(o, d, bbox_enlarge=enlarge)
            b = want.get_ray_bbox_intersections(o, d, bbox_enlarge=enlarge)
            assert b[0].any() and not b[0].all()
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        for enlarge in (0.0, 0.05, -0.05):
            np.testing.assert_array_equal(got.check_xyz_in_bounds(xyz, bbox_enlarge=enlarge),
                                          want.check_xyz_in_bounds(xyz, bbox_enlarge=enlarge))
    scale = conf["dataset_extra"]["scale_factor"]
    for a, b in zip(tbbox.boxes_to_arrays(got_boxes, scale),
                    jbbox.boxes_to_arrays(want_boxes, scale)):
        np.testing.assert_array_equal(a, b)
    inb = tbbox.check_in_any_boxes_np(got_boxes, xyz.reshape(50, 10, 3))
    assert inb.shape == (50, 10) and inb.any() and not inb.all()
    np.testing.assert_array_equal(
        inb, jbbox.check_in_any_boxes_np(want_boxes, xyz.reshape(50, 10, 3)))
    # the device test of the renderer is the same test
    from object_nerf_torch.render.multi import _in_any_box

    aff, bnd, s = tbbox.boxes_to_arrays(got_boxes, scale)
    dev = _in_any_box(torch.from_numpy(xyz.astype(np.float32)), torch.from_numpy(aff),
                      torch.from_numpy(bnd), s).numpy()
    assert (dev != inb.reshape(-1)).mean() < 0.01  # f32 against f64 at the faces


def test_bbox_ray_helper_takes_a_yaml_path_and_rejects_unknowns(tmp_path):
    conf = _desk_files(tmp_path)
    snap = tmp_path / "run_config_snapshot.yaml"
    Config(conf).save(snap)
    a, b = tbbox.BBoxRayHelper(str(snap), 2), tbbox.BBoxRayHelper(Config(conf), 2)
    np.testing.assert_array_equal(a.axis_align_mat, b.axis_align_mat)
    with pytest.raises(ValueError, match="not in bbox json"):
        tbbox.BBoxRayHelper(Config(conf), 7)
    with pytest.raises(ValueError, match="not in bbox json"):
        tbbox.BBoxRayHelper(Config(conf), 3)
    with pytest.raises(ValueError, match="unsupported dataset"):
        tbbox.BBoxRayHelper(Config({**conf, "dataset_name": "blender"}), 1)


# -- the renderer -------------------------------------------------------------------------


@pytest.fixture
def desk_setup(tmp_path):
    bbox = {"labels": [
        {"id": 1, "data": {"position": [0.3, 0.0, 0.25], "quaternion": [0, 0, 0, 1],
                           "scale": [0.5, 0.5, 0.5]}},
        {"id": 2, "data": {"position": [-0.35, 0.2, 0.2], "quaternion": [0, 0, 0, 1],
                           "scale": [0.4, 0.4, 0.4]}}]}
    bbox_path = tmp_path / "bbox.json"
    bbox_path.write_text(json.dumps(bbox))
    conf = {"ckpt_config": {
        "dataset_name": "toydesk", "model": dict(MODEL),
        "dataset_extra": {"near": 0.5, "far": 5.0, "scale_factor": 1.0,
                          "scene_center": [0.0, 0.0, 0.0], "bbox_dir": str(bbox_path)}},
        "chunk": 512}
    jcfg = JaxMLPConfig(**TINY)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    params = {"coarse": init_object_nerf(k1, jcfg), "fine": init_object_nerf(k2, jcfg),
              "code_library": init_code_library(k3, 16, 8)}
    return conf, params


def _port_models(params):
    models = ObjectNeRFModels(ObjectNeRFConfig(**TINY), n_importance=1, n_max_objs=16)
    models.load_state_dict(from_jax_params(to_numpy(params)))
    return models


def _renderers(desk_setup, extra=None, n_importance=4):
    conf, params = desk_setup
    conf["ckpt_config"]["model"]["N_importance"] = n_importance
    mesh1 = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    jconf, tconf = JaxConfig(conf), Config(conf)
    if extra:
        jconf.merge(extra)
        tconf.merge(extra)
    return (EditableRenderer(tconf, models=_port_models(params), device="cpu"),
            JaxEditableRenderer(jconf, params=params, mesh=mesh1))


def _rot_z(deg):
    t = np.deg2rad(deg)
    m = np.eye(4)
    m[0, 0] = m[1, 1] = np.cos(t)
    m[0, 1], m[1, 0] = -np.sin(t), np.sin(t)
    return m


def _camera():
    Twc = np.eye(4)
    Twc[:3, 3] = [0.3, -2.0, 0.25]
    # camera -z (the view direction) points along world +y, at object 1
    Twc[:3, :3] = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], float)
    return Twc


def _assert_maps(got, want, shape_n, typ="fine", **tol):
    maps = [k.replace("fine", typ) for k in MAPS]
    assert set(got) == set(want) == set(maps)
    for k in maps:
        assert got[k].shape[0] == shape_n and np.isfinite(got[k]).all(), k
        if tol or typ == "coarse":
            np.testing.assert_allclose(got[k], np.asarray(want[k]), err_msg=k,
                                       **(tol or dict(atol=ATOL, rtol=RTOL)))
            continue
        np.testing.assert_allclose(got[k], np.asarray(want[k]), err_msg=k, rtol=RTOL,
                                   atol=DEPTH_ATOL if k.startswith("depth") else FINE_ATOL)
        diff = np.abs(got[k] - np.asarray(want[k]))
        assert np.median(diff) < ATOL / 2, k


@pytest.mark.parametrize("n_importance,typ", [(4, "fine"), (0, "coarse")])
@pytest.mark.parametrize("compact", [False, True])
def test_render_edit_matches_jax_renderer(desk_setup, compact, n_importance, typ):
    """Rotation, a shifted duplicate and a removal at once (K = 3 ray sets, a
    repeated id, muted rays, a skip box); 12 x 16 pixels in chunks of 64."""
    got_r, want_r = _renderers(desk_setup, {"tpu": {"compact_edit_rays": compact}},
                               n_importance)
    assert got_r.compact_rays is compact and want_r.compact_rays is compact
    assert got_r.settings.matmul_dtype == torch.float32
    dup = np.eye(4)
    dup[:3, 3] = [0.0, 0.4, 0.0]
    for r in (got_r, want_r):
        r.remove_scene_object_by_ids([1])
        r.set_object_pose_transform(1, _rot_z(30), 0)
        r.set_object_pose_transform(1, dup, 1)
    fm.reset_launch_counts()
    got = got_r.render_edit(h=12, w=16, camera_pose_Twc=_camera(), fovx_deg=70, chunk=64)
    want = want_r.render_edit(h=12, w=16, camera_pose_Twc=_camera(), fovx_deg=70, chunk=64)
    assert sum(fm.launch_counts.values()) == 0  # device="cpu": the plain versions
    assert got_r.active_object_ids == want_r.active_object_ids == [0, 1, 1]
    _assert_maps(got, want, 12 * 16, typ)
    # object pixels differ from the unedited scene, so the edit did something
    origin = got_r.render_origin(h=12, w=16, camera_pose_Twc=_camera(), fovx_deg=70, chunk=64)
    assert np.abs(origin[f"rgb_{typ}"] - got[f"rgb_{typ}"]).max() > 1e-3


@pytest.mark.parametrize("n_importance,typ", [(4, "fine"), (0, "coarse")])
def test_render_origin_and_background_only_match_jax_renderer(desk_setup, n_importance, typ):
    got_r, want_r = _renderers(desk_setup, n_importance=n_importance)
    Twc = np.eye(4)
    Twc[:3, 3] = [0.0, -2.0, 0.5]
    # 9 x 7 = 63 pixels: a ragged tail chunk, which the JAX renderer pads
    got = got_r.render_origin(h=9, w=7, camera_pose_Twc=Twc, chunk=16)
    want = want_r.render_origin(h=9, w=7, camera_pose_Twc=Twc, chunk=16)
    _assert_maps(got, want, 63, typ)
    for r in (got_r, want_r):
        r.remove_scene_object_by_ids([2])
        r.set_object_pose_transform(1, np.eye(4), 0)
    kw = dict(h=9, w=7, camera_pose_Twc=Twc, render_bg_only=True, white_back=True, chunk=16)
    got, want = got_r.render_edit(**kw), want_r.render_edit(**kw)
    assert got_r.active_object_ids == [0]
    _assert_maps(got, want, 63, typ)
    for r in (got_r, want_r):
        r.reset_active_object_ids()
        r.set_object_pose_transform(2, _rot_z(-20), 0)
    kw = dict(h=9, w=7, camera_pose_Twc=Twc, render_obj_only=True, chunk=16)
    got, want = got_r.render_edit(**kw), want_r.render_edit(**kw)
    assert got_r.active_object_ids == [2]
    _assert_maps(got, want, 63, typ)


def test_compaction_matches_dense_and_skips_object_sets(desk_setup, monkeypatch):
    """Hit compaction renders the all-miss chunks with the background set
    alone, the rest with every set, and agrees with the dense composite."""
    from object_nerf_torch.edit import editable_renderer as er

    calls = []
    real = er.render_multi_fused_eval

    def spy(models, rays_list, ids, *a, **k):
        calls.append((tuple(ids), rays_list[0].shape[0], k.get("skip_boxes") is not None))
        return real(models, rays_list, ids, *a, **k)

    monkeypatch.setattr(er, "render_multi_fused_eval", spy)
    r, _ = _renderers(desk_setup)
    assert r.compact_rays  # the default
    r.remove_scene_object_by_ids([1])
    r.set_object_pose_transform(1, np.eye(4), 0)
    kw = dict(h=8, w=12, camera_pose_Twc=_camera(), fovx_deg=70, chunk=16)
    compacted = r.render_edit(**kw)
    plan_calls, calls[:] = list(calls), []
    r.compact_rays = False  # what tpu.compact_edit_rays=false sets
    dense = r.render_edit(**kw)
    n_hit = int((r.generate_rays(1, *_frame_rays(r, 8, 12))[:, 7] > 0).sum())
    n_mixed = -(-n_hit // 16)
    assert 0 < n_mixed < 6
    assert [c[0] for c in plan_calls] == [(0, 1)] * n_mixed + [(0,)] * (6 - n_mixed)
    assert [c[0] for c in calls] == [(0, 1)] * 6
    assert all(c[2] for c in plan_calls + calls)  # every chunk sees the skip boxes
    _assert_maps(compacted, dense, 96, **COMPACT_TOL)
    # rays that never touch a box are bit-identical under the dense composite
    # whatever the object's pose (tests/test_editable_renderer.py)
    r.reset_active_object_ids()
    r.set_object_pose_transform(1, get_pure_rotation(120 / 180.0), 0)
    turned = r.render_edit(**kw)
    diff = np.abs(turned["rgb_fine"] - dense["rgb_fine"]).max(-1)
    assert diff.max() > 1e-4 and (diff == 0).sum() > 10


def _frame_rays(r, h, w):
    from object_nerf_torch.data.ray_utils import get_ray_directions, get_rays

    focal = (w / 2) / np.tan(np.deg2rad(70) / 2)
    Twc = tgeo.center_pose_from_avg(r.pose_avg, _camera())
    Twc[:, 3] /= r.scale_factor
    return get_rays(get_ray_directions(h, w, focal), Twc[:3, :4].astype(np.float32))


def test_renderer_refuses_voxel_models_and_absent_cuda(desk_setup):
    conf, params = desk_setup
    voxel = Config(conf)
    voxel.ckpt_config.model.use_voxel_embedding = True
    with pytest.raises(NotImplementedError, match="voxel"):
        EditableRenderer(voxel, models=_port_models(params), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            EditableRenderer(Config(conf), models=_port_models(params))  # default: cuda


def test_demo_pose_helpers_equal_the_jax_demo_script():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "demo_editable_render.py"
    spec = importlib.util.spec_from_file_location("jax_demo_editable_render", path)
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    pose = np.eye(4)
    pose[:3, 3] = [0.2, -1.0, 0.4]
    for p in (0.0, 0.3, 0.77):
        np.testing.assert_array_equal(move_camera_pose(pose, p), demo.move_camera_pose(pose, p))
        np.testing.assert_array_equal(get_pure_rotation(p * 2 - 1),
                                      demo.get_pure_rotation(p * 2 - 1))
        for dup in (0, 1):
            np.testing.assert_array_equal(
                get_transformation_with_duplication_offset(p, dup),
                demo.get_transformation_with_duplication_offset(p, dup))


# -- the demo CLI -----------------------------------------------------------------------------


def _write_scene_and_run(tmp_path):
    """A ToyDesk-layout scene directory (camera poses and boxes only, from
    the synthetic scene's spheres) and a run directory with a checkpoint and
    its config snapshot."""
    from object_nerf_torch.data import dataset_dict
    from object_nerf_torch.train.checkpoint import save_config_snapshot

    scene = tmp_path / "scene"
    scene.mkdir()
    ds = dataset_dict["synthetic"]("train", img_wh=(8, 6))
    fix_rot = np.diag([1.0, -1.0, -1.0])
    frames = []
    for i, c2w in enumerate(ds.poses[:4]):
        pose = np.eye(4)
        pose[:3, :3], pose[:3, 3] = c2w[:3, :3] @ fix_rot, c2w[:3, 3]
        frames.append({"file_path": f"./full/{i}", "transform_matrix": pose.tolist(), "idx": i})
    (scene / "transforms_full.json").write_text(json.dumps(
        {"camera_angle_x": float(2 * np.arctan(0.5 / 0.7)), "frames": frames}))
    (scene / "bbox.json").write_text(json.dumps({"labels": [
        {"id": int(s.instance_id), "data": {"position": [float(x) for x in s.center],
                                            "quaternion": [0.0, 0.0, 0.0, 1.0],
                                            "scale": [float(2.2 * s.radius)] * 3}}
        for s in _default_spheres()]}))
    run = tmp_path / "logs" / "run"
    save_config_snapshot(run, Config({
        "dataset_name": "toydesk", "model": dict(MODEL),
        "dataset_extra": {"root_dir": str(scene), "bbox_dir": str(scene / "bbox.json"),
                          "near": 0.4, "far": 6.0, "scale_factor": 1.0,
                          "scene_center": [0.0, 0.0, 0.0]}}))
    models = ObjectNeRFModels(ObjectNeRFConfig(**TINY), n_importance=1, n_max_objs=16)
    torch.save({"state_dict": models.state_dict()}, run / "last.ckpt")
    edit_yaml = tmp_path / "edit.yaml"
    edit_yaml.write_text("prefix: tiny\nchunk: 32\nimg_wh: [8, 6]\nckpt_path: null\n"
                         "total_frames: 2\ntest_frame: 1\nedit_type: duplication\n"
                         "obj_id_list: [1, 1]\n")
    return edit_yaml, run / "last.ckpt"


@pytest.mark.parametrize("edit_type", ["duplication", "pure_rotation"])
def test_edit_demo_cli_end_to_end(tmp_path, monkeypatch, capsys, edit_type):
    import imageio.v2 as imageio

    edit_yaml, ckpt = _write_scene_and_run(tmp_path)
    monkeypatch.chdir(tmp_path)
    config = read_testing_config([f"config={edit_yaml}", f"ckpt_path={ckpt}"])
    assert config.ckpt_config.dataset_name == "toydesk"
    assert config.ckpt_config_path.endswith("run_config_snapshot.yaml")
    out_dir = edit_main([f"config={edit_yaml}", f"ckpt_path={ckpt}", "device=cpu",
                         f"edit_type={edit_type}", "prefix=clitest"])
    out = capsys.readouterr().out
    assert "frame 2/2" in out, out
    dirs = list((tmp_path / "debug/rendered_view").glob("*clitest*"))
    assert len(dirs) == 1 and str(dirs[0]).endswith(out_dir.rstrip("/"))
    pngs = sorted(dirs[0].glob("render_*.png"))
    assert len(pngs) == 2
    img = imageio.imread(pngs[0])
    assert img.shape == (6, 8, 3) and img.std() > 0
