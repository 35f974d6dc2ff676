"""The voxel grid module (object_nerf_torch/models/voxel_grid.py) and the row
gather's wrapper (ops/gather.py) against the JAX package, on the CPU.

The same numpy inputs go through `object_nerf_tpu.models.voxel_grid` and its
port; a JAX grid crosses over through `train.convert.voxel_from_jax`. On CPU
tensors the row fetch of `voxel_lookup_dense` is the plain version of
`gather_rows` (the kernel runs only on the card,
tests/test_torch_kernels_cuda.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from object_nerf_tpu.models import voxel_grid as jvg

from object_nerf_torch.models import voxel_grid as vg
from object_nerf_torch.ops import gather
from object_nerf_torch.train.convert import voxel_from_jax

torch.set_num_threads(2)

# f32 lookups: the two packages do the same f32 arithmetic; only the order of
# the 8-corner sum may differ (features are N(0, 1))
LOOKUP_ATOL = 2e-6
# encoded features: sin / cos of up to 2^(n_freq - 1) x from two libraries
EMBED_ATOL = 1e-5


def _pcd(n_pts=500, seed=0):
    return np.random.RandomState(seed).rand(n_pts, 3) * 2.0 - 1.0


def _jax_grid(n_pts=300, voxel_size=0.4, neighbor=3, channels=24, cap=5000, seed=0):
    return jvg.build_voxel_grid(
        _pcd(n_pts, seed), scene_center=[0, 0, 0], scale_factor=1.0,
        voxel_size_world=voxel_size, neighbor_marks=neighbor, channels=channels,
        n_freq_voxel=2, n_max_voxels=cap, key=jax.random.PRNGKey(seed))


def _to_port(features, topo, static):
    return voxel_from_jax(np.asarray(features),
                          {k: np.asarray(v) for k, v in topo._asdict().items()},
                          dataclasses.asdict(static))


def _pair(**kw):
    j = _jax_grid(**kw)
    return j, _to_port(*j)


def _points(static, topo, n=96, seed=1):
    """Points inside the grid, exactly on cell borders and outside it."""
    rng = np.random.RandomState(seed)
    vs, off = float(topo.voxel_size), np.asarray(topo.voxel_offset)
    extent = np.asarray(static.shape) * vs
    inside = rng.rand(n // 2, 3) * extent - off
    border = np.round(rng.rand(n // 4, 3) * np.asarray(static.shape)) * vs - off
    outside = (rng.rand(n // 4, 3) * 3.0 - 1.0) * extent - off
    return np.concatenate([inside, border, outside]).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("neighbor", [1, 2, 3])
def test_build_matches_jax_topology(neighbor):
    (_, jt, js) = _jax_grid(neighbor=neighbor)
    f, t, s = vg.build_voxel_grid(
        _pcd(300), [0, 0, 0], 1.0, 0.4, neighbor, 24, 2, 5000,
        generator=torch.Generator().manual_seed(0))
    assert dataclasses.asdict(s) == dataclasses.asdict(js)
    for name in ("idx_map", "occupancy", "n_occupied", "row_to_cell"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(jt, name)),
                                      err_msg=name)
    np.testing.assert_allclose(t.voxel_size.numpy(), np.asarray(jt.voxel_size), rtol=0, atol=0)
    np.testing.assert_allclose(t.voxel_offset.numpy(), np.asarray(jt.voxel_offset), rtol=0,
                               atol=0)
    assert t.idx_map.dtype == torch.int32 and t.occupancy.dtype == torch.bool
    # N(0, 1) features, reproducible from the generator's seed
    assert f.shape == (s.n_max_voxels, 24) and abs(float(f.std()) - 1.0) < 0.05
    f2, _, _ = vg.build_voxel_grid(_pcd(300), [0, 0, 0], 1.0, 0.4, neighbor, 24, 2, 5000,
                                   generator=torch.Generator().manual_seed(0))
    assert torch.equal(f, f2)


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_dilation_matches_jax(k):
    occ = np.random.RandomState(k).rand(7, 6, 5) > 0.9
    np.testing.assert_array_equal(vg._dilate_occupancy(occ.copy(), k),
                                  jvg._dilate_occupancy(occ.copy(), k))


def test_build_rejects_overflow_and_sizes_capacity():
    with pytest.raises(ValueError, match="exceed capacity"):
        vg.build_voxel_grid(_pcd(300), [0, 0, 0], 1.0, 0.4, 3, 24, 2, 10)
    _, _, s = vg.build_voxel_grid(_pcd(300), [0, 0, 0], 1.0, 0.4, 3, 24, 2, 5000,
                                  auto_capacity=False)
    assert s.n_max_voxels == 5000
    assert vg.dense_table_bytes(s) == jvg.dense_table_bytes(jvg.VoxelStatic(**dataclasses.asdict(s)))


def test_build_from_config_matches_jax():
    from object_nerf_tpu.config import Config as JConfig
    from object_nerf_torch.config import Config

    d = {"dataset_extra": {"scene_center": [0.1, 0.0, -0.1], "scale_factor": 2.0,
                           "voxel_size": 0.5, "neighbor_marks": 3},
         "model": {"N_scn_voxel_size": 16, "N_obj_voxel_size": 8, "N_freq_voxel": 6,
                   "N_max_voxels": 20000}}
    _, jt, js = jvg.build_voxel_grid_from_config(_pcd(400), JConfig(d))
    _, t, s = vg.build_voxel_grid_from_config(_pcd(400), Config(d))
    assert dataclasses.asdict(s) == dataclasses.asdict(js)
    np.testing.assert_array_equal(t.idx_map.numpy(), np.asarray(jt.idx_map))


def test_scannet_scale_pcd_is_the_bench_scene():
    import bench
    from object_nerf_torch.scripts._fixtures import scannet_scale_pcd

    np.testing.assert_array_equal(scannet_scale_pcd(), bench.scannet_scale_pcd())


def test_trilinear_matches_numpy_oracle():
    """tests/test_voxel_grid.py:38-76 on the port."""
    _, (features, topo, static) = _pair(n_pts=200, voxel_size=0.5)
    feats_np = features.numpy()
    idx_map = topo.idx_map.numpy().reshape(static.shape)
    offset, vs = topo.voxel_offset.numpy(), float(topo.voxel_size)
    pts = (np.random.RandomState(1).rand(64, 3) * 1.6 - 0.8).astype(np.float32)
    vg_limit = vg.DENSE_CELL_TABLE_LIMIT_BYTES
    results = {}
    for route, limit in (("dense", vg_limit), ("corner", 0)):
        vg.DENSE_CELL_TABLE_LIMIT_BYTES = limit
        try:
            got, invalid = vg.voxel_lookup_raw(features, topo, static, _t(pts))
        finally:
            vg.DENSE_CELL_TABLE_LIMIT_BYTES = vg_limit
        results[route] = (got.numpy(), invalid.numpy())
    scaled = (pts + offset) / vs
    base = np.floor(scaled).astype(int)
    frac = scaled - base
    expect = np.zeros((64, static.channels), np.float32)
    n_inval = np.zeros(64, int)
    for dx, dy, dz in [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
                       (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1)]:
        q = base + [dx, dy, dz]
        w = ((frac[:, 0] if dx else 1 - frac[:, 0]) * (frac[:, 1] if dy else 1 - frac[:, 1])
             * (frac[:, 2] if dz else 1 - frac[:, 2]))
        for i in range(64):
            inb = np.all((q[i] >= 0) & (q[i] < np.array(static.shape)))
            row = idx_map[tuple(q[i])] if inb else -1
            if row >= 0:
                expect[i] += w[i] * feats_np[row]
            else:
                n_inval[i] += 1
    for route, (got, _) in results.items():
        np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-6, err_msg=route)
    np.testing.assert_array_equal(results["corner"][1], n_inval == 8)


@pytest.mark.parametrize("lowp", [False, True])
@pytest.mark.parametrize("route", ["dense", "prebuilt", "corner", "nearest"])
def test_lookup_matches_jax(route, lowp, monkeypatch):
    """Every route of voxel_lookup_raw, points inside, on the border and
    outside the grid."""
    (jf, jt, js), (f, t, s) = _pair()
    pts = _points(s, t)
    kw, jkw = {}, {}
    if route == "corner":
        monkeypatch.setattr(vg, "DENSE_CELL_TABLE_LIMIT_BYTES", 0)
        monkeypatch.setattr(jvg, "DENSE_CELL_TABLE_LIMIT_BYTES", 0)
    elif route == "nearest":
        kw = jkw = dict(trilinear=False)
    elif route == "prebuilt":
        kw = dict(ct=vg.make_corner_table(f, t, s, lowp=lowp))
        jkw = dict(ct=jvg.make_corner_table(jf, jt, js, lowp=lowp))
    want, want_inv = jvg.voxel_lookup_raw(jf, jt, js, jnp.asarray(pts), lowp=lowp, **jkw)
    gather.reset_launch_counts()
    got, inv = vg.voxel_lookup_raw(f, t, s, _t(pts), lowp=lowp, **kw)
    assert gather.launch_counts == {"gather_rows": 0, "corner_lookup": 0}  # CPU: the plain versions
    assert got.dtype == torch.float32 and got.shape == (len(pts), 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=0,
                               atol=LOOKUP_ATOL)
    np.testing.assert_array_equal(inv.numpy(), np.asarray(want_inv))
    assert 0 < int(inv.sum()) < len(pts)


def test_dense_and_per_corner_routes_agree(monkeypatch):
    _, (f, t, s) = _pair()
    pts = _t(_points(s, t, seed=5))
    dense, _ = vg.voxel_lookup_raw(f, t, s, pts)
    monkeypatch.setattr(vg, "DENSE_CELL_TABLE_LIMIT_BYTES", 0)
    assert not vg.dense_path_ok(s)
    corner, _ = vg.voxel_lookup_raw(f, t, s, pts)
    np.testing.assert_allclose(dense.numpy(), corner.numpy(), rtol=0, atol=LOOKUP_ATOL)


@pytest.mark.parametrize("lowp", [False, True])
def test_corner_table_matches_jax_bit_for_bit(lowp):
    (jf, jt, js), (f, t, s) = _pair()
    want = jvg.make_corner_table(jf, jt, js, lowp=lowp)
    before = vg.build_counts["corner_table"]
    got = vg.make_corner_table(f, t, s, lowp=lowp)
    assert vg.build_counts["corner_table"] == before + 1
    assert got.dtype == (torch.bfloat16 if lowp else torch.float32)
    n_pcells = (s.shape[0] + 1) * (s.shape[1] + 1) * (s.shape[2] + 1)
    assert got.shape == (n_pcells, 8 * 24) and got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_corner_index_weights_match_jax():
    (jf, jt, js), (f, t, s) = _pair()
    pts = _points(s, t, n=200, seed=7)
    jflat, jw, jvalid = jvg.corner_index_weights(jt, js, jnp.asarray(pts))
    flat, w, valid = gather.corner_index_weights(t, s, _t(pts))
    assert flat.dtype == torch.int32
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-7)
    n_rows = (s.shape[0] + 1) * (s.shape[1] + 1) * (s.shape[2] + 1)
    assert int(flat.min()) >= 0 and int(flat.max()) < n_rows  # clipped into the table
    assert (w[~valid] == 0).all() and 0 < int(valid.sum()) < len(pts)


def test_dense_lookup_with_addressing_matches_plain():
    """tests/test_voxel_grid.py:150-171 on the port."""
    _, (f, t, s) = _pair(n_pts=200, voxel_size=0.5)
    pts = _t((np.random.RandomState(4).rand(64, 3) * 1.6 - 0.8).astype(np.float32))
    out, invalid = vg.voxel_lookup_dense(f, t, s, pts)
    ct = vg.make_corner_table(f, t, s)
    out2, invalid2, flat, wts = vg.voxel_lookup_dense(None, t, s, pts, ct=ct,
                                                      with_addressing=True)
    np.testing.assert_allclose(out2.numpy(), out.numpy(), rtol=1e-6, atol=1e-7)
    assert torch.equal(invalid, invalid2)
    manual = (ct[flat.long()].reshape(-1, 8, s.channels) * wts[..., None]).sum(1)
    np.testing.assert_allclose(manual.numpy(), out2.numpy(), rtol=1e-6, atol=1e-7)


def test_prebuilt_ct_rejected_for_nearest_lookup():
    _, (f, t, s) = _pair(n_pts=100)
    ct = vg.make_corner_table(f, t, s)
    with pytest.raises(ValueError, match="trilinear"):
        vg.voxel_lookup_raw(f, t, s, torch.zeros(4, 3), trilinear=False, ct=ct)


def test_voxel_embed_matches_jax_and_channel_layout():
    (jf, jt, js), (f, t, s) = _pair()
    pts = _points(s, t, seed=9)
    jemb, jinst = jvg.voxel_embed(jf, jt, js, jnp.asarray(pts), n_freq_xyz=10)
    emb, inst = vg.voxel_embed(f, t, s, _t(pts), n_freq_xyz=10)
    # scene: 16 * (2 * 2 + 1) = 80 voxel channels + 63 xyz PE; instance 8 * 5
    assert emb.shape == (len(pts), 16 * 5 + 63) and inst.shape == (len(pts), 8 * 5)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), rtol=0, atol=EMBED_ATOL)
    np.testing.assert_allclose(inst.numpy(), np.asarray(jinst), rtol=0, atol=EMBED_ATOL)
    ct = vg.make_corner_table(f, t, s)
    emb2, _ = vg.voxel_embed(None, t, s, _t(pts), ct=ct)
    np.testing.assert_allclose(emb2.numpy(), emb.numpy(), rtol=0, atol=1e-6)


def test_occupancy_and_ray_box_match_jax():
    (jf, jt, js), (f, t, s) = _pair(n_pts=300, voxel_size=0.3)
    pts = _points(s, t, seed=11)
    occ = vg.check_occupancy(t, s, _t(pts))
    np.testing.assert_array_equal(occ.numpy(),
                                  np.asarray(jvg.check_occupancy(jt, js, jnp.asarray(pts))))
    assert vg.check_occupancy(t, s, _t(_pcd(300).astype(np.float32))).float().mean() > 0.99
    assert not vg.check_occupancy(t, s, torch.full((10, 3), 50.0)).any()
    n = 8
    rays_o = np.tile(np.array([[0.0, 0.0, 5.0]], np.float32), (n, 1))
    rays_o[:, 0] = np.linspace(-0.5, 0.5, n)
    rays_d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (n, 1))
    near, far = np.full((n, 1), 0.1, np.float32), np.full((n, 1), 12.0, np.float32)
    jn, jfar = jvg.ray_box_intersection(jt, js, jnp.asarray(rays_o), jnp.asarray(rays_d),
                                        jnp.asarray(near), jnp.asarray(far))
    n2, f2 = vg.ray_box_intersection(t, s, _t(rays_o), _t(rays_d), _t(near), _t(far))
    np.testing.assert_allclose(n2.numpy(), np.asarray(jn), rtol=0, atol=1e-5)
    np.testing.assert_allclose(f2.numpy(), np.asarray(jfar), rtol=0, atol=1e-5)
    assert float(n2.min()) > 0.1 and float(f2.max()) < 12.0  # tightened


def test_grid_sample_variant_matches_torch_and_jax():
    """tests/test_voxel_grid.py:230-262 on the port: both reference quirks."""
    rng = np.random.RandomState(3)
    X, Y, Z, C = 5, 4, 3, 6
    static = vg.VoxelStatic(shape=(X, Y, Z), channels=C, n_freq_voxel=2,
                            n_max_voxels=X * Y * Z + 7)
    table = rng.randn(static.n_max_voxels, C).astype(np.float32)
    bounds = np.asarray([[-1.0, -0.5, 0.0], [1.0, 1.5, 2.0]], np.float32)
    pts = (rng.rand(64, 3) * 3.0 - 1.5).astype(np.float32)
    pts = pts * (bounds[1] - bounds[0]) + bounds[0]
    got = vg.voxel_lookup_grid_sample(_t(table), static, _t(pts), _t(bounds)).numpy()
    inp = torch.from_numpy(table[: X * Y * Z]).reshape(X, Y, Z, C).permute(3, 0, 1, 2)[None]
    u = (pts - bounds[0]) / (bounds[1] - bounds[0])
    g = torch.from_numpy(u * 2.0 - 1.0).reshape(1, 1, 1, -1, 3)
    want = (F.grid_sample(inp, g, padding_mode="border", align_corners=True, mode="bilinear")
            .squeeze().permute(1, 0).numpy())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    jwant = jvg.voxel_lookup_grid_sample(
        jnp.asarray(table), jvg.VoxelStatic(**dataclasses.asdict(static)), jnp.asarray(pts),
        jnp.asarray(bounds))
    np.testing.assert_allclose(got, np.asarray(jwant), rtol=0, atol=LOOKUP_ATOL)


@pytest.mark.parametrize("lowp", [False, True])
def test_table_gradient_matches_jax_grad(lowp):
    """The table gradient of `voxel_lookup_dense` under autograd (the
    hand-written segment-sum and corner-table transpose of `CornerTable`)
    against jax.grad of voxel_lookup_dense (its own hand-written transpose and
    segment-sum backward). With `lowp` the bf16 cast of the table is the
    identity to the gradient, as the JAX split step that trains takes it
    (split_step.py:242-271): the lookup is linear in the table, so the
    gradient is jax.grad of the f32 lookup, held to 1e-5. jax.grad of JAX's
    own bf16 lookup rounds each sample's row cotangent to bf16 (the gathered
    rows' dtype) before its f32 segment-sum: 8.8e-3 from the f32 form here."""
    (jf, jt, js), (f, t, s) = _pair(cap=3000)
    pts = _points(s, t, seed=13)
    g = np.random.RandomState(14).randn(len(pts), 24).astype(np.float32)

    def grad(lowp_jax):
        def loss(feats):
            out, _ = jvg.voxel_lookup_dense(feats, jt, js, jnp.asarray(pts), lowp=lowp_jax)
            return jnp.sum(out * jnp.asarray(g))

        return np.asarray(jax.grad(loss)(jf))

    want = grad(False)
    feats = f.clone().requires_grad_()
    out, _ = vg.voxel_lookup_dense(feats, t, s, _t(pts), lowp=lowp)
    (out * _t(g)).sum().backward()
    assert feats.grad.dtype == torch.float32
    np.testing.assert_allclose(feats.grad.numpy(), want, rtol=0, atol=1e-5)
    assert np.abs(want).max() > 0.5 and (feats.grad[int(t.n_occupied):] == 0).all()
    if lowp:
        np.testing.assert_allclose(feats.grad.numpy(), grad(True), rtol=0, atol=1.5e-2)


def test_from_torch_buffers_and_topology_dicts_match_jax():
    (jf, jt, js), (f, t, s) = _pair()
    vt = {"features": np.asarray(jf), "voxel_shape": np.asarray(js.shape),
          "voxel_idx_map": np.asarray(jt.idx_map).reshape(js.shape),
          "voxel_occupancy": np.asarray(jt.occupancy).reshape(js.shape),
          "voxel_size": np.asarray(jt.voxel_size), "voxel_offset": np.asarray(jt.voxel_offset)}
    _, jt2, js2 = jvg.from_torch_buffers(vt, 2)
    f2, t2, s2 = vg.from_torch_buffers({k: torch.from_numpy(np.array(v)) for k, v in vt.items()},
                                       2)
    assert dataclasses.asdict(s2) == dataclasses.asdict(js2) == dataclasses.asdict(s)
    assert torch.equal(f2, f)
    for name in t._fields:
        np.testing.assert_array_equal(getattr(t2, name).numpy(),
                                      np.asarray(getattr(jt2, name)), err_msg=name)
    # a checkpoint dict without row_to_cell (older checkpoints) derives it
    d = vg.topology_to_dict(t)
    del d["row_to_cell"]
    t3 = vg.topology_from_dict(d, capacity=s.n_max_voxels)
    assert torch.equal(t3.row_to_cell, t.row_to_cell) and torch.equal(t3.idx_map, t.idx_map)
    jd = {k: np.asarray(v) for k, v in jt._asdict().items() if k != "row_to_cell"}
    np.testing.assert_array_equal(
        np.asarray(jvg.topology_from_dict(jd, capacity=js.n_max_voxels).row_to_cell),
        t3.row_to_cell.numpy())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_rows_wrapper_on_cpu(dtype):
    g = torch.Generator().manual_seed(0)
    table = torch.randn(50, 192, generator=g).to(dtype)
    idx = torch.randint(0, 50, (333,), generator=g, dtype=torch.int32)
    gather.reset_launch_counts()
    got = gather.gather_rows(table, idx)
    assert gather.launch_counts == {"gather_rows": 0, "corner_lookup": 0}
    assert torch.equal(got, table[idx.long()]) and got.dtype == dtype
    assert torch.equal(gather.gather_rows_plain(table, idx), got)
    assert gather.gather_rows(table, idx[:0]).shape == (0, 192)
    for bad in (50, -1):
        with pytest.raises(IndexError):
            gather.gather_rows(table, torch.tensor([0, bad], dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        gather.gather_rows(table, idx.long())
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        gather.gather_rows(table.double(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_rows(table.t().contiguous().t(), idx)
    with pytest.raises(ValueError, match=r"\(R, C\)"):
        gather.gather_rows(table[0], idx)
