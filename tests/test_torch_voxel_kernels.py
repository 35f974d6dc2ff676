"""The voxel operand of the eval and density kernels' modules
(object_nerf_torch/ops/fused_mlp.py, fused_sigma.py).

On the CPU the wrappers run their plain versions: with `voxel_raw` these are
held against the JAX package's Pallas kernels in interpret mode, in f32 and in
bf16, as tests/test_pallas_mlp.py:54-93,188-249 runs them. The kernels' weight
layout and input-tile layout at the flagship voxel width (320 / 448 columns)
are held against the plain versions through an emulation of the kernels'
dataflow over the packed buffers. The kernels themselves run only on the card
(tests/test_torch_kernels_cuda.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_nerf_tpu.models.embedding import freq_encode as jfreq_encode
from object_nerf_tpu.ops import pallas_mlp as jk

from object_nerf_torch.models.embedding import freq_encode
from object_nerf_torch.models.mlp import ObjectNeRFConfig, embed_inputs
from object_nerf_torch.ops import fused_mlp as fm
from object_nerf_torch.ops import fused_sigma as fs
from object_nerf_torch.ops.compositing import composite, composite_instance
from object_nerf_torch.render.renderer import RenderSettings
from object_nerf_torch.train.system import init_params

from _torch_port import CFG_JAX, SMALL, jax_params, port_models

torch.set_num_threads(2)

VOX = {**SMALL, "use_voxel_embedding": True, "N_freq_voxel": 3}
VCFG_JAX = dataclasses.replace(CFG_JAX, use_voxel_embedding=True, N_freq_voxel=3)
VCFG = ObjectNeRFConfig(**VOX)
N_VOX = VCFG.N_scn_voxel_size + VCFG.N_obj_voxel_size

# f32: the JAX f32 kernel builds every encoding as sin(x @ S + phase), cos as
# sin(t + pi/2), up to ~1e-4 off cos(t) per channel at the top frequency;
# through these small MLPs that moved the outputs by at most 4e-6 here
F32_ATOL = 2e-5
# bf16: the JAX bf16 kernel evaluates its encodings with a polynomial sine
# (~1e-5 off), which moves some bf16 roundings of the encoded inputs by one
# step; with 120 encoded voxel columns on top of the 60 of xyz, 3e-4 measured
BF16_ATOL = 2e-3
N_RAYS = 24
# emulation vs plain bf16: the same roundings, but a skip layer is two products
# here and one in the model, so an f32 sum now and then lands on the other side
# of a bf16 rounding of one hidden activation (1.9e-5 on one density of 128
# measured); a wrong row or column of the layout is off by ~0.1
LAYOUT_ATOL = 5e-5


def _inputs(s, seed=0, n=N_RAYS):
    rng = np.random.RandomState(seed)
    o = (rng.randn(n, 3) * 0.1).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(0.5 + 2.5 * rng.rand(n, s), axis=-1).astype(np.float32)
    xyz = (o[:, None] + d[:, None] * z[..., None]).astype(np.float32)
    codes = rng.randn(n, VCFG.N_obj_code_length).astype(np.float32)
    dir_pe = np.asarray(jfreq_encode(jnp.asarray(d), VCFG.N_freq_dir))
    # trilinear blends of N(0, 1) features, a fifth of the samples outside (0)
    raw = rng.randn(n, s, N_VOX).astype(np.float32) * (rng.rand(n, s, 1) > 0.2)
    return xyz, z, dir_pe, codes, raw.astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _models(seed):
    params = jax_params(seed=seed, cfg_jax=VCFG_JAX)
    return params, port_models(params, cfg=VCFG)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_voxel_coarse_weights_matches_jax_kernel(dtype):
    params, models = _models(2)
    s = 16
    xyz, z, _, _, raw = _inputs(s)
    want = jk.fused_coarse_weights(params["coarse"], VCFG_JAX, jnp.asarray(xyz),
                                   jnp.asarray(z), voxel_raw=jnp.asarray(raw),
                                   rows_budget=8 * s, interpret=True,
                                   dtype=getattr(jnp, dtype))
    fm.reset_launch_counts()
    got = fm.fused_coarse_weights(models.nerf_coarse, VCFG, _t(xyz), _t(z),
                                  voxel_raw=_t(raw), dtype=getattr(torch, dtype))
    assert sum(fm.launch_counts.values()) == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_ATOL if dtype == "float32" else BF16_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("forward_instance,white_back", [(True, False), (True, True),
                                                         (False, False)])
def test_voxel_render_tiles_matches_jax_kernel(dtype, forward_instance, white_back):
    params, models = _models(4)
    s = 24
    xyz, z, dir_pe, codes, raw = _inputs(s, seed=1)
    want = jk.fused_render_tiles(
        params["fine"], VCFG_JAX, jnp.asarray(xyz), jnp.asarray(z), jnp.asarray(dir_pe),
        obj_codes=jnp.asarray(codes), voxel_raw=jnp.asarray(raw),
        forward_instance=forward_instance, want_weights=True, white_back=white_back,
        rows_budget=8 * s, interpret=True, dtype=getattr(jnp, dtype))
    got = fm.fused_render_tiles(
        models.nerf_fine, VCFG, _t(xyz), _t(z), _t(dir_pe), _t(codes), voxel_raw=_t(raw),
        forward_instance=forward_instance, want_weights=True, white_back=white_back,
        dtype=getattr(torch, dtype))
    assert set(got) == set(want)
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=atol, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("branch", fs.BRANCHES)
def test_voxel_sigma_eval_matches_jax_kernel(dtype, branch):
    params, models = _models(6)
    rng = np.random.RandomState(3)
    n, s = 256, 16
    pts = rng.randn(n, 3).astype(np.float32) * 0.5
    raw = rng.randn(n, N_VOX).astype(np.float32)
    codes = rng.randn(n // s, VCFG.N_obj_code_length).astype(np.float32)
    want = jk.fused_sigma_eval(params["fine"], VCFG_JAX, jnp.asarray(pts),
                               voxel_raw=jnp.asarray(raw), obj_codes=jnp.asarray(codes),
                               branch=branch, samples_per_row=s, dtype=getattr(jnp, dtype),
                               interpret=True)
    got = fs.fused_sigma_eval(models.nerf_fine, VCFG, _t(pts), _t(codes), branch, s,
                              voxel_raw=_t(raw), dtype=getattr(torch, dtype))
    assert got.shape == (n,) and sum(fm.launch_counts.values()) == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_ATOL if dtype == "float32" else BF16_ATOL)


def test_voxel_operand_is_required_and_refused():
    """`voxel_raw` goes with a voxel-conditioned model and with no other; its
    shape is checked."""
    params, models = _models(0)
    classical = port_models(jax_params())
    from _torch_port import CFG

    xyz, z, dir_pe, codes, raw = (_t(a) for a in _inputs(16))
    pts = xyz.reshape(-1, 3).contiguous()
    with pytest.raises(ValueError, match="voxel_raw required"):
        fm.fused_coarse_weights(models.nerf_coarse, VCFG, xyz, z)
    with pytest.raises(ValueError, match="voxel_raw required"):
        fm.fused_render_tiles(models.nerf_fine, VCFG, xyz, z, dir_pe, codes)
    with pytest.raises(ValueError, match="voxel_raw required"):
        fs.fused_sigma_eval(models.nerf_fine, VCFG, pts)
    with pytest.raises(ValueError, match="without voxel embedding"):
        fm.fused_coarse_weights(classical.nerf_coarse, CFG, xyz, z, voxel_raw=raw)
    with pytest.raises(ValueError, match="without voxel embedding"):
        fm.render_tiles_plain(classical.nerf_fine, CFG, xyz, z, dir_pe, codes, voxel_raw=raw)
    with pytest.raises(ValueError, match="shape"):
        fm.fused_coarse_weights(models.nerf_coarse, VCFG, xyz, z,
                                voxel_raw=raw[..., :5].contiguous())
    with pytest.raises(ValueError, match="shape"):
        fs.fused_sigma_eval(models.nerf_fine, VCFG, pts, voxel_raw=raw)
    with pytest.raises(ValueError, match="widths"):
        fm.check_kernel_config(VCFG)
    fm.check_kernel_config(ObjectNeRFConfig())  # the default voxel model is taken
    with pytest.raises(ValueError, match="voxel channels"):
        fm.check_kernel_config(ObjectNeRFConfig(N_scn_voxel_size=40))
    with pytest.raises(ValueError, match="exceed"):
        fm.check_kernel_config(ObjectNeRFConfig(N_freq_voxel=10))


def test_embed_inputs_is_the_model_input_layout():
    """[svox | PE(svox) | xyz | PE(xyz)] and [ivox | PE(ivox)]: the column
    order the kernels build, which is the reference's own."""
    rng = np.random.RandomState(0)
    pts, raw = _t(rng.randn(5, 3)), _t(rng.randn(5, N_VOX))
    emb, inst = embed_inputs(VCFG, pts, raw)
    assert emb.shape == (5, VCFG.in_channels_xyz) and inst.shape == (5, VCFG.obj_voxel_emb_size)
    cs = VCFG.N_scn_voxel_size
    assert torch.equal(emb[:, :cs], raw[:, :cs])
    off = VCFG.scn_voxel_emb_size
    assert torch.equal(emb[:, off:off + 3], pts)
    assert torch.equal(inst[:, :8], raw[:, cs:])
    np.testing.assert_allclose(emb[:, cs:2 * cs].numpy(), np.sin(raw[:, :cs].numpy()),
                               atol=1e-6)
    e2, none = embed_inputs(dataclasses.replace(VCFG, use_voxel_embedding=False), pts)
    assert none is None and torch.equal(e2, freq_encode(pts, VCFG.N_freq_xyz))


# -- the kernels' layouts at the flagship voxel width, emulated on the CPU ----------


def _input_tile(cfg, xyz, raw, codes, s, ncols, inst):
    """The voxel input tile as csrc/fused_mlp_common.cuh builds it, column by
    column: [svox | PE(svox) | xyz | PE(xyz)] then, when `inst`, [ivox |
    PE(ivox) | code]; zero beyond; rounded to bf16."""
    cs = cfg.N_scn_voxel_size
    pieces = [freq_encode(raw[:, :cs], cfg.N_freq_voxel), freq_encode(xyz, cfg.N_freq_xyz)]
    if inst:
        pieces += [freq_encode(raw[:, cs:], cfg.N_freq_voxel), codes.repeat_interleave(s, 0)]
    cat = torch.cat(pieces, dim=-1)
    X = torch.zeros(xyz.shape[0], ncols)
    X[:, :cat.shape[1]] = cat
    return X.bfloat16().float()


def _emulate(packed, cfg, xyz, z, raw, dir_pe=None, codes=None):
    """The kernels' dataflow over the packed buffers: ONE input tile shared by
    both branches (the scene branch reads its first K0 columns, where past its
    own 271 the instance voxel features sit: its weight rows there are zero),
    trunk layers as (K, N) blocks with the skip's input rows padded to K0."""
    n, s, _ = xyz.shape
    w, b = packed.w.float(), packed.b
    inst = packed.obj is not None
    ncols = (packed.obj if inst else packed.scene)[fm.T_K0]
    X = _input_tile(cfg, xyz.reshape(-1, 3), raw.reshape(n * s, -1), codes, s, ncols, inst)

    def mat(off, k, n_):
        return w[off:off + k * n_].reshape(k, n_)

    def lrelu(x):
        return torch.where(x >= 0, x, 0.01 * x)

    def branch(tab, width, heads):
        k0, h = tab[fm.T_K0], None
        for i in range(tab[fm.T_DEPTH]):
            off, bias = tab[fm.T_TW + i], b[tab[fm.T_TB + i]:tab[fm.T_TB + i] + width]
            if i == 0:
                acc = X[:, :k0] @ mat(off, k0, width)
            elif (tab[fm.T_SKIPS] >> i) & 1:
                acc = X[:, :k0] @ mat(off, k0, width) + h @ mat(off + k0 * width, width, width)
            else:
                acc = h @ mat(off, width, width)
            h = lrelu(acc + bias).bfloat16().float()
        sigma = h @ w[tab[fm.T_SIGW]:tab[fm.T_SIGW] + width] + b[tab[fm.T_SIGB]]
        if not heads:
            return sigma.reshape(n, s), None
        hf = (h @ mat(tab[fm.T_FINW], width, width)
              + b[tab[fm.T_FINB]:tab[fm.T_FINB] + width]).bfloat16().float()
        nd = width // 2
        wd = mat(tab[fm.T_DIRWD], fm.MAX_DIR, nd)[:dir_pe.shape[1]]
        dbias = dir_pe.bfloat16().float() @ wd + b[tab[fm.T_DIRB]:tab[fm.T_DIRB] + nd]
        d = lrelu(hf @ mat(tab[fm.T_DIRWH], width, nd)
                  + dbias.repeat_interleave(s, 0)).bfloat16().float()
        rgb = torch.sigmoid(d @ mat(tab[fm.T_RGBW], 3, nd).t()
                            + b[tab[fm.T_RGBB]:tab[fm.T_RGBB] + 3])
        return sigma.reshape(n, s), rgb.reshape(n, s, 3)

    if packed.sigma_only:
        tab, width = (packed.obj, fm.OBJ_W) if inst else (packed.scene, fm.SCENE_W)
        return branch(tab, width, False)[0], X
    sigma, rgb = branch(packed.scene, fm.SCENE_W, True)
    scene = composite(sigma, rgb, z)
    out = {"rgb": scene.rgb, "depth": scene.depth, "opacity": scene.opacity}
    if inst:
        i_sigma, i_rgb = branch(packed.obj, fm.OBJ_W, True)
        comp = composite_instance(i_sigma, i_rgb, z, scene.depth, apply_occlusion=False)
        out.update(rgb_instance=comp.rgb, depth_instance=comp.depth,
                   opacity_instance=comp.opacity)
    return out, X


def _flagship_inputs():
    cfg = ObjectNeRFConfig()
    settings = RenderSettings(mlp=cfg, perturb=0.0, noise_std=0.0)
    models = init_params(torch.Generator().manual_seed(0), settings, {}, device="cpu")
    n, s = 2, 64
    g = torch.Generator().manual_seed(1)
    z = torch.sort(0.5 + 4.0 * torch.rand(n, s, generator=g), -1).values
    o, d = torch.randn(n, 3, generator=g) * 0.2, torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    xyz = (o[:, None] + d[:, None] * z[..., None]).contiguous()
    raw = torch.randn(n, s, 24, generator=g)
    return (cfg, models, xyz, z, raw, freq_encode(d, cfg.N_freq_dir),
            torch.randn(n, cfg.N_obj_code_length, generator=g))


@pytest.mark.parametrize("forward_instance", [True, False])
def test_voxel_packed_layout_reproduces_plain_bf16(forward_instance):
    cfg, models, xyz, z, raw, dir_pe, codes = _flagship_inputs()
    assert (cfg.in_channels_xyz, cfg.inst_channel_in) == (271, 439)
    with torch.no_grad():
        packed = fm.pack_kernel_weights(models.nerf_fine, cfg, forward_instance)
        assert packed.scene[fm.T_K0] == 320
        assert packed.obj is None or packed.obj[fm.T_K0] == 448
        got, X = _emulate(packed, cfg, xyz, z, raw, dir_pe,
                          codes if forward_instance else None)
        if forward_instance:  # the scene branch's pad columns hold live data
            assert X[:, 271:320].abs().min(dim=0).values.max() > 0
            assert (X[:, 439:] == 0).all()
        want = fm.render_tiles_plain(models.nerf_fine, cfg, xyz, z, dir_pe, codes,
                                     voxel_raw=raw, forward_instance=forward_instance)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=LAYOUT_ATOL, rtol=0,
                                       err_msg=k)


@pytest.mark.parametrize("branch", fs.BRANCHES)
def test_voxel_sigma_only_layout_reproduces_plain_bf16(branch):
    cfg, models, xyz, z, raw, _, codes = _flagship_inputs()
    inst = branch == "instance"
    with torch.no_grad():
        packed = fm.pack_kernel_weights(models.nerf_coarse, cfg, forward_instance=inst,
                                        sigma_only=True)
        sigma, _ = _emulate(packed, cfg, xyz, z, raw, codes=codes if inst else None)
        want = fs.sigma_eval_plain(models.nerf_coarse, cfg, xyz.reshape(-1, 3), codes, branch,
                                   64, voxel_raw=raw.reshape(-1, 24))
        np.testing.assert_allclose(sigma.reshape(-1).numpy(), want.numpy(), atol=LAYOUT_ATOL, rtol=0)
        if not inst:
            w = fm.coarse_weights_plain(models.nerf_coarse, cfg, xyz, z, voxel_raw=raw)
            np.testing.assert_allclose(
                composite(sigma, torch.zeros(2, 64, 3), z).weights.numpy(), w.numpy(),
                atol=LAYOUT_ATOL, rtol=0)


def test_classical_packing_is_unchanged_by_the_voxel_layout():
    cfg = ObjectNeRFConfig(use_voxel_embedding=False)
    assert fm.input_tile_columns(cfg) == (64, 128)
    assert fm.input_tile_columns(ObjectNeRFConfig()) == (320, 448)
    models = init_params(torch.Generator().manual_seed(0), RenderSettings(mlp=cfg), {},
                         device="cpu")
    packed = fm.pack_kernel_weights(models.nerf_fine, cfg, True)
    assert packed.scene[fm.T_K0] == 64 and packed.obj[fm.T_K0] == 128
    # a packing of one layout is refused for a model of the other
    with pytest.raises(ValueError, match="another input layout"):
        fm._check_launch(ObjectNeRFConfig(), torch.bfloat16, 64, packed,
                         torch.device("cuda"), True, True)
