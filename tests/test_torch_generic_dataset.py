"""The port's `GenericDataset` (its own PNG codec and resamplers, no PIL or
cv2) against the JAX package's on the scene of JAX
`tests/test_generic_dataset.py`'s fixture, which that module writes through
cv2: train and val buffers, both mask rebalance strategies, the frame
filters, the `.npz` cache, the `use_bbox` near/far of a ScanNet layout, and
`sample_batch` from one `RandomState`."""

import json

import numpy as np
import pytest

from object_nerf_tpu.data.generic_dataset import GenericDataset as JaxGenericDataset

from object_nerf_torch.config import Config
from object_nerf_torch.data import dataset_dict
from object_nerf_torch.data.generic_dataset import GenericDataset

from test_generic_dataset import H, N_FRAMES, W, _conf, disk_dataset  # noqa: F401

SCENE_ID = "scene0001_00"
# ScanNet's axisAlignment: a turn about z and a shift (world -> aligned box frame)
ALIGN = np.array([[0.0, -1.0, 0.0, 0.5], [1.0, 0.0, 0.0, -0.2], [0.0, 0.0, 1.0, 0.1],
                  [0.0, 0.0, 0.0, 1.0]])
BUFFERS = ("rays", "rgbs", "depths", "valid_mask", "frame_indices", "instance_masks",
           "instance_weights", "pass_through", "inst_ids")


def _both(split, conf, **kw):
    conf = Config(conf)
    return (GenericDataset(split, img_wh=(W, H), dataset_extra=conf, **kw),
            JaxGenericDataset(split, img_wh=(W, H), dataset_extra=conf, **kw))


def _assert_sample_equal(got, want, weight_atol=0.0):
    assert set(got) == set(want)
    for k in want:
        if k == "rays":
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=k)
        elif k in ("instance_mask_weight", "instance_weights"):
            np.testing.assert_allclose(got[k], want[k], atol=weight_atol, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("strategy", ["fg_bg_reweight", "distance_transform"])
def test_train_and_val_buffers_equal_jax(disk_dataset, strategy):  # noqa: F811
    conf = _conf(disk_dataset, mask_rebalance_strategy=strategy)
    atol = 0.0 if strategy == "fg_bg_reweight" else 1e-4
    got, want = _both("train", conf)
    assert len(got) == len(want) == (N_FRAMES - 1) * W * H
    _assert_sample_equal({k: getattr(got, k) for k in BUFFERS},
                         {k: getattr(want, k) for k in BUFFERS}, atol)
    assert got.instance_masks[:, 0].any() and not got.instance_masks[:, 0].all()
    got_v, want_v = _both("val", conf)
    assert [f["idx"] for f in got_v.frames] == [f["idx"] for f in want_v.frames] == [3]
    _assert_sample_equal(got_v.whole_image_batch(), want_v.whole_image_batch(), atol)


def test_registered_names_and_sample_batch(disk_dataset):  # noqa: F811
    for name in ("generic_dataset", "scannet_base", "toydesk"):
        assert dataset_dict[name] is GenericDataset
    got, want = _both("train", _conf(disk_dataset))
    for seed in (0, 7):
        _assert_sample_equal(got.sample_batch(128, np.random.RandomState(seed)),
                             want.sample_batch(128, rng=np.random.RandomState(seed)))
    # the default draws from the dataset's own seeded generator
    a = GenericDataset("train", img_wh=(W, H), dataset_extra=Config(_conf(disk_dataset)))
    b = GenericDataset("train", img_wh=(W, H), dataset_extra=Config(_conf(disk_dataset)))
    np.testing.assert_array_equal(a.sample_batch(64)["rays"], b.sample_batch(64)["rays"])
    assert not np.array_equal(a.sample_batch(64)["rays"], a.sample_batch(64)["rays"])


@pytest.mark.parametrize("over", [
    dict(enable_observation_check=True, max_obs_angle=12.0, max_obs_distance=3.0),
    dict(enable_observation_check=True, max_obs_angle=90.0, max_obs_distance=2.0,
         scene_center=[0.6, 0.0, 0.0]),
    dict(train_skip_step=2, train_start_idx=1),
    dict(train_max_size=2),
    dict(split="SPLIT"),
])
def test_frame_filters_equal_jax(disk_dataset, tmp_path, over):  # noqa: F811
    if over.get("split") == "SPLIT":
        (tmp_path / "train.txt").write_text("0\n2\n3\n4\n")
        over = dict(split=str(tmp_path))
    # one more frame whose pose is NaN: rejected by both
    meta = json.loads((disk_dataset / "transforms_full.json").read_text())
    nan = dict(meta["frames"][0], idx=99)
    nan["transform_matrix"] = (np.full((4, 4), np.nan)).tolist()
    meta["frames"].append(nan)
    root = tmp_path / "scene"
    root.mkdir()
    (root / "full").symlink_to(disk_dataset / "full")
    (root / "transforms_full.json").write_text(json.dumps(meta))
    conf = _conf(root, **over)
    got, want = _both("train", conf)
    idx = [f["idx"] for f in got.frames]
    assert idx == [f["idx"] for f in want.frames] and 99 not in idx
    assert 0 < len(idx) < N_FRAMES
    _assert_sample_equal({k: getattr(got, k) for k in BUFFERS},
                         {k: getattr(want, k) for k in BUFFERS})


def test_npz_cache_roundtrip(disk_dataset, tmp_path):  # noqa: F811
    conf = Config(_conf(disk_dataset))
    first = GenericDataset("train", img_wh=(W, H), dataset_extra=conf, cache_dir=tmp_path)
    again = GenericDataset("train", img_wh=(W, H), dataset_extra=conf, cache_dir=tmp_path)
    fresh = GenericDataset("train", img_wh=(W, H), dataset_extra=conf)
    assert len(list(tmp_path.glob("rays_*.npz"))) == 1
    for k in BUFFERS:
        np.testing.assert_array_equal(getattr(again, k), getattr(fresh, k), err_msg=k)
        np.testing.assert_array_equal(getattr(first, k), getattr(fresh, k), err_msg=k)
    # the JAX package reads the same cache file: one key, one layout
    jax_ds = JaxGenericDataset("train", img_wh=(W, H), dataset_extra=conf, cache_dir=tmp_path)
    np.testing.assert_array_equal(jax_ds.rays, fresh.rays)


@pytest.fixture(scope="module")
def scannet_boxes(disk_dataset):  # noqa: F811
    """The fixture scene's ScanNet box files: axisAlignment and one box per
    sphere, in the aligned frame."""
    from object_nerf_tpu.data.synthetic import _default_spheres

    scans = disk_dataset / "scans" / SCENE_ID
    scans.mkdir(parents=True, exist_ok=True)
    (scans / f"{SCENE_ID}.txt").write_text(
        "sceneType = Bedroom\naxisAlignment = "
        + " ".join(f"{v:g}" for v in ALIGN.reshape(-1)) + "\n")
    rows = [[*(ALIGN[:3, :3] @ s.center + ALIGN[:3, 3]), *([2.2 * s.radius] * 3),
             s.instance_id] for s in _default_spheres()]
    np.save(disk_dataset / f"{SCENE_ID}_bbox.npy", np.asarray(rows))
    return disk_dataset


@pytest.mark.parametrize("only_for_test", [True, False])
def test_use_bbox_near_far_equal_jax(scannet_boxes, only_for_test):
    conf = _conf(scannet_boxes, use_bbox=True, use_bbox_only_for_test=only_for_test,
                 scans_dir=str(scannet_boxes / "scans"), bbox_dir=str(scannet_boxes),
                 scene_id=SCENE_ID, scale_factor=1.5, scene_center=[0.1, -0.1, 0.0])
    got_v, want_v = _both("val", conf)
    np.testing.assert_allclose(got_v.bbox_bounds, want_v.bbox_bounds, atol=0)
    assert got_v.is_rays_in_bbox() and want_v.is_rays_in_bbox()
    g, w = got_v.whole_image_batch(), want_v.whole_image_batch()
    _assert_sample_equal(g, w)
    near, far = g["rays"][:, 6], g["rays"][:, 7]
    # a miss takes 0 / 0 under use_bbox_only_for_test, else the scene's bounds
    miss = (np.float32(0.0), np.float32(0.0)) if only_for_test else \
        (np.float32(0.5 / 1.5), np.float32(5.0 / 1.5))
    hit = ~((near == miss[0]) & (far == miss[1]))
    assert 0 < hit.sum() < len(hit)  # some rays meet the box, some miss it
    assert (far[hit] > near[hit]).all()
    assert not g["instance_mask"][~hit].any()  # instance_mask & hit
    got_t, want_t = _both("train", conf)
    assert got_t.is_rays_in_bbox() == want_t.is_rays_in_bbox() == (not only_for_test)
    _assert_sample_equal({k: getattr(got_t, k) for k in BUFFERS},
                         {k: getattr(want_t, k) for k in BUFFERS})
