"""The edit render of a voxel-conditioned model against the JAX package, on
the CPU.

`EditableRenderer.render_edit` with injected weights and grid runs on
`device="cpu"` (the kernels' plain versions, f32, one corner table per frame)
against the JAX `EditableRenderer` routed through `make_multi_eval_stages`
with the voxel route (Pallas kernels in interpret mode, f32; as
tests/test_multi_split.py:118-200), compacted and dense; the renderer loads a
voxel model with its grid from the port's checkpoint and from a reference
`.ckpt`'s buffers.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from object_nerf_tpu.config import Config as JaxConfig
from object_nerf_tpu.edit.editable_renderer import EditableRenderer as JaxEditableRenderer
from object_nerf_tpu.models import voxel_grid as jvg
from object_nerf_tpu.models.code_library import init_code_library
from object_nerf_tpu.models.mlp import ObjectNeRFConfig as JaxMLPConfig, init_object_nerf

from object_nerf_torch.config import Config
from object_nerf_torch.edit.editable_renderer import EditableRenderer
from object_nerf_torch.models import voxel_grid as vg
from object_nerf_torch.models.mlp import ObjectNeRFConfig
from object_nerf_torch.ops import fused_mlp as fm
from object_nerf_torch.ops import gather
from object_nerf_torch.train.checkpoint import FORMAT
from object_nerf_torch.train.convert import from_jax_params, voxel_from_jax
from object_nerf_torch.train.system import ObjectNeRFModels

from _torch_port import to_numpy

torch.set_num_threads(2)

TINY = dict(D=2, W=32, skips=(1,), inst_D=2, inst_W=16, inst_skips=(1,),
            use_voxel_embedding=True, N_obj_code_length=8, N_freq_voxel=2)
MODEL = {
    "use_voxel_embedding": True, "D": 2, "W": 32, "skips": [1],
    "inst_D": 2, "inst_W": 16, "inst_skips": [1],
    "N_freq_xyz": 10, "N_freq_dir": 4, "N_freq_voxel": 2,
    "N_scn_voxel_size": 16, "N_obj_voxel_size": 8, "N_samples": 8, "N_importance": 4,
    "frustum_bound": -1, "use_disp": False, "perturb": 0, "noise_std": 0,
    "N_max_objs": 16, "N_obj_code_length": 8,
}
H, W, CHUNK = 8, 10, 40
# the tolerances of tests/test_torch_edit.py: f32 on both sides; with
# importance samples the ill-conditioned inversion of the coarse cdf (muted and
# carved-out samples leave bins empty) scales a last-bit difference
ATOL, RTOL = 1e-4, 1e-4
FINE_ATOL, DEPTH_ATOL = 1e-2, 5e-2


@pytest.fixture
def voxel_desk(tmp_path):
    bbox = {"labels": [
        {"id": 1, "data": {"position": [0.3, 0.0, 0.25], "quaternion": [0, 0, 0, 1],
                           "scale": [0.5, 0.5, 0.5]}},
        {"id": 2, "data": {"position": [-0.35, 0.2, 0.2], "quaternion": [0, 0, 0, 1],
                           "scale": [0.4, 0.4, 0.4]}}]}
    (tmp_path / "bbox.json").write_text(json.dumps(bbox))
    conf = {"ckpt_config": {
        "dataset_name": "toydesk", "model": dict(MODEL),
        "dataset_extra": {"near": 0.5, "far": 3.0, "scale_factor": 1.0,
                          "scene_center": [0.0, 0.0, 0.0],
                          "bbox_dir": str(tmp_path / "bbox.json")}},
        "chunk": CHUNK}
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    jcfg = JaxMLPConfig(**TINY)
    params = {"coarse": init_object_nerf(k1, jcfg), "fine": init_object_nerf(k2, jcfg),
              "code_library": init_code_library(k3, 16, 8)}
    pts = np.random.RandomState(1).rand(400, 3) * 3 - 1.5
    grid = jvg.build_voxel_grid(pts, [0, 0, 0], 1.0, 0.4, 3, 24, 2, 20000,
                                key=jax.random.PRNGKey(7))
    params["voxel_features"] = grid[0]
    return conf, params, grid


def _port(params, grid):
    jf, jt, js = grid
    features, topo, static = voxel_from_jax(
        np.asarray(jf), {k: np.asarray(v) for k, v in jt._asdict().items()},
        dataclasses.asdict(js))
    models = ObjectNeRFModels(ObjectNeRFConfig(**TINY), n_importance=1, n_max_objs=16,
                              voxel_features=features)
    models.load_state_dict(from_jax_params(to_numpy(params)))
    return models, topo, static


def _camera():
    Twc = np.eye(4)
    Twc[:3, 3] = [0.3, -2.0, 0.25]
    Twc[:3, :3] = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], float)
    return Twc


def _edit(r):
    r.remove_scene_object_by_ids([1])
    t = np.eye(4)
    t[:3, 3] = [0.0, 0.3, 0.0]
    r.set_object_pose_transform(1, t, 0)
    return r.render_edit(h=H, w=W, camera_pose_Twc=_camera(), fovx_deg=70, chunk=CHUNK)


def _assert_maps(got, want, typ):
    keys = [f"{m}_{typ}" for m in ("rgb", "depth", "opacity")]
    assert set(got) == set(want) == set(keys)
    for k in keys:
        assert got[k].shape[0] == H * W and np.isfinite(got[k]).all(), k
        if typ == "coarse":
            np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=ATOL, rtol=RTOL,
                                       err_msg=k)
            continue
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=RTOL, err_msg=k,
                                   atol=DEPTH_ATOL if k.startswith("depth") else FINE_ATOL)
        assert np.median(np.abs(got[k] - np.asarray(want[k]))) < ATOL / 2, k


@pytest.mark.parametrize("n_importance,typ", [(4, "fine"), (0, "coarse")])
@pytest.mark.parametrize("compact", [False, True])
def test_voxel_render_edit_matches_jax_split_stages(voxel_desk, compact, n_importance, typ):
    """Object 1 moved and carved out of the background (K = 2 ray sets, muted
    rays, a skip box): the port's frame against the JAX renderer's staged
    voxel route with its prebuilt corner table."""
    conf, params, grid = voxel_desk
    conf["ckpt_config"]["model"]["N_importance"] = n_importance
    extra = {"tpu": {"compact_edit_rays": compact}}
    jconf = JaxConfig(conf)
    jconf.merge({"tpu": {"compact_edit_rays": compact, "use_pallas": True,
                         "pallas_interpret": True}})
    want_r = JaxEditableRenderer(jconf, params=params, voxel=grid,
                                 mesh=Mesh(np.asarray(jax.devices()[:1]), ("data",)))
    assert want_r.settings.use_pallas and want_r.settings.pallas_dtype == "float32"
    models, topo, static = _port(params, grid)
    tconf = Config(conf)
    tconf.merge(extra)
    got_r = EditableRenderer(tconf, models=models, device="cpu", voxel_grid=(topo, static))
    assert got_r.use_voxel and got_r.compact_rays is compact
    fm.reset_launch_counts()
    gather.reset_launch_counts()
    vg.build_counts["corner_table"] = 0
    got = _edit(got_r)
    assert sum(fm.launch_counts.values()) == 0 and gather.launch_counts["gather_rows"] == 0
    assert vg.build_counts["corner_table"] == 1  # one table for the whole frame
    want = _edit(want_r)
    _assert_maps(got, want, typ)
    plan = got_r.last_chunk_plan
    assert plan["chunks"] == -(-H * W // CHUNK)
    assert (plan["mixed"] < plan["chunks"]) is compact


def test_voxel_renderer_loads_its_grid_from_checkpoints(voxel_desk, tmp_path):
    """A port checkpoint's `voxel_topo` / `voxel_static`, or a reference
    `.ckpt`'s `embedding_xyz.*` buffers: the renderer takes the grid the
    table rows are indexed by and renders what the injected model renders; a
    voxel model without its grid is refused."""
    conf, params, grid = voxel_desk
    models, topo, static = _port(params, grid)
    injected = _edit(EditableRenderer(Config(conf), models=models, device="cpu",
                                      voxel_grid=(topo, static)))
    own = tmp_path / "own.ckpt"
    torch.save({"format": FORMAT, "state_dict": models.state_dict(),
                "voxel_topo": vg.topology_to_dict(topo),
                "voxel_static": dataclasses.asdict(static), "step": 0}, own)
    sd = dict(models.state_dict())
    sd.update({
        "embedding_xyz.voxel_size": topo.voxel_size.clone(),
        "embedding_xyz.voxel_offset": topo.voxel_offset.clone(),
        "embedding_xyz.voxel_shape": torch.tensor(static.shape),
        "embedding_xyz.voxel_occupancy": topo.occupancy.reshape(static.shape).clone(),
        "embedding_xyz.voxel_idx_map": topo.idx_map.reshape(static.shape).long(),
    })
    ref = tmp_path / "ref.ckpt"
    torch.save({"state_dict": sd}, ref)
    for path in (own, ref):
        c = Config({**conf, "ckpt_path": str(path)})
        r = EditableRenderer(c, device="cpu")
        assert r.voxel_static == static
        assert torch.equal(r.voxel_topo.idx_map, topo.idx_map)
        got = _edit(r)
        for k in injected:
            np.testing.assert_array_equal(got[k], injected[k], err_msg=f"{path.name} {k}")
    with pytest.raises(ValueError, match="voxel_grid"):
        EditableRenderer(Config(conf), models=models, device="cpu")
