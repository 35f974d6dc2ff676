"""The eval kernels' module (object_nerf_torch/ops/fused_mlp.py).

On the CPU the wrappers run their plain versions: these are held against
the JAX package's Pallas kernels in interpret mode, in f32 and in bf16. The
kernels' weight layout is held against the plain version through an
emulation of the kernels' dataflow over the packed buffers. The kernels
themselves run only on the card (tests/test_torch_kernels_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_nerf_tpu.models.embedding import freq_encode as jfreq_encode
from object_nerf_tpu.ops import pallas_mlp as jk

from object_nerf_torch.models.embedding import freq_encode
from object_nerf_torch.models.mlp import ObjectNeRFConfig
from object_nerf_torch.ops import fused_mlp as fm
from object_nerf_torch.ops.compositing import composite, composite_instance
from object_nerf_torch.render.renderer import RenderSettings
from object_nerf_torch.train.system import init_params

from _torch_port import CFG, CFG_JAX, jax_params, port_models

torch.set_num_threads(2)

# f32: the JAX f32 kernel builds its PE as sin(x @ S + phase), cos as
# sin(t + pi/2), which at the top frequency (t = 2^9 x) can be ~1e-4 off
# cos(t) per channel; through these small MLPs the outputs moved by at most
# 3e-7 on these inputs, so 2e-5 still catches any real disagreement
F32_ATOL = 2e-5
# bf16: the JAX bf16 kernel evaluates its PE with a polynomial sine (~1e-5
# off), which moves some bf16 roundings of the PE inputs by one step
# (4.4e-5 measured on these inputs)
BF16_ATOL = 5e-4
N_RAYS = 24  # three 8-ray tiles in the JAX kernels


def _inputs(s, seed=0, n=N_RAYS):
    rng = np.random.RandomState(seed)
    o = (rng.randn(n, 3) * 0.1).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(0.5 + 2.5 * rng.rand(n, s), axis=-1).astype(np.float32)
    xyz = (o[:, None] + d[:, None] * z[..., None]).astype(np.float32)
    codes = rng.randn(n, CFG.N_obj_code_length).astype(np.float32)
    dir_pe = np.asarray(jfreq_encode(jnp.asarray(d), CFG.N_freq_dir))
    return xyz, z, dir_pe, codes


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_coarse_weights_matches_jax_kernel(dtype):
    params = jax_params(seed=2)
    models = port_models(params)
    s = 16
    xyz, z, _, _ = _inputs(s)
    want = jk.fused_coarse_weights(params["coarse"], CFG_JAX, jnp.asarray(xyz),
                                   jnp.asarray(z), rows_budget=8 * s, interpret=True,
                                   dtype=getattr(jnp, dtype))
    fm.reset_launch_counts()
    got = fm.fused_coarse_weights(models.nerf_coarse, CFG, _t(xyz), _t(z),
                                  dtype=getattr(torch, dtype))
    assert fm.launch_counts == {"fused_coarse_weights": 0, "fused_render_tiles": 0,
                                "fused_mlp_eval": 0, "fused_mlp_bwd": 0,
                                "fused_sigma_eval": 0}
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("forward_instance,white_back", [(True, False), (True, True),
                                                         (False, False)])
def test_render_tiles_matches_jax_kernel(dtype, forward_instance, white_back):
    params = jax_params(seed=4)
    models = port_models(params)
    s = 24
    xyz, z, dir_pe, codes = _inputs(s, seed=1)
    want = jk.fused_render_tiles(
        params["fine"], CFG_JAX, jnp.asarray(xyz), jnp.asarray(z), jnp.asarray(dir_pe),
        obj_codes=jnp.asarray(codes), forward_instance=forward_instance,
        want_weights=True, white_back=white_back, rows_budget=8 * s, interpret=True,
        dtype=getattr(jnp, dtype))
    fm.reset_launch_counts()
    got = fm.fused_render_tiles(
        models.nerf_fine, CFG, _t(xyz), _t(z), _t(dir_pe), _t(codes),
        forward_instance=forward_instance, want_weights=True, white_back=white_back,
        dtype=getattr(torch, dtype))
    assert sum(fm.launch_counts.values()) == 0
    assert set(got) == set(want)
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=atol,
                                   rtol=0, err_msg=k)


def test_wrappers_check_their_inputs():
    models = port_models(jax_params())
    xyz, z, dir_pe, codes = (_t(a) for a in _inputs(16))
    with pytest.raises(ValueError, match="float32"):
        fm.fused_coarse_weights(models.nerf_coarse, CFG, xyz.double(), z)
    with pytest.raises(ValueError, match="shape"):
        fm.fused_coarse_weights(models.nerf_coarse, CFG, xyz, z[:, :8].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fm.fused_render_tiles(models.nerf_fine, CFG, xyz, z.t().contiguous().t(), dir_pe)
    with pytest.raises(ValueError, match="shape"):
        fm.fused_render_tiles(models.nerf_fine, CFG, xyz, z, dir_pe, codes[:, :4])
    with pytest.raises(ValueError, match="voxel"):  # a classical model takes none
        fm.fused_coarse_weights(models.nerf_coarse, CFG, xyz, z, voxel_raw=xyz)
    with pytest.raises(ValueError, match="widths"):
        fm.check_kernel_config(CFG)
    fm.check_kernel_config(ObjectNeRFConfig(use_voxel_embedding=False))


# -- the kernels' weight layout, emulated at flagship width on the CPU ----------


def _emulate(packed, cfg, xyz, z, dir_pe=None, codes=None):
    """The kernels' dataflow over the packed buffers (csrc/fused_mlp.cu):
    input tile [PE | code | 0] in bf16, trunk layers as (K, N) blocks with
    the skip's input rows padded to K0, the direction input as a per-ray
    bias, heads stored (out, in)."""
    n, s, _ = xyz.shape
    w, b = packed.w.float(), packed.b
    pe = freq_encode(xyz.reshape(-1, 3), cfg.N_freq_xyz)
    X = torch.zeros(n * s, fm.OBJ_K0)
    X[:, :pe.shape[1]] = pe
    if codes is not None:
        X[:, pe.shape[1]:pe.shape[1] + codes.shape[1]] = codes.repeat_interleave(s, 0)
    X = X.bfloat16().float()

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
        sigma, _ = branch(packed.scene, fm.SCENE_W, False)
        return composite(sigma, torch.zeros(n, s, 3), z).weights
    sigma, rgb = branch(packed.scene, fm.SCENE_W, True)
    scene = composite(sigma, rgb, z)
    out = {"rgb": scene.rgb, "depth": scene.depth, "opacity": scene.opacity}
    if packed.obj is not None:
        i_sigma, i_rgb = branch(packed.obj, fm.OBJ_W, True)
        inst = composite_instance(i_sigma, i_rgb, z, scene.depth, apply_occlusion=False)
        out.update(rgb_instance=inst.rgb, depth_instance=inst.depth,
                   opacity_instance=inst.opacity)
    return out


@pytest.mark.parametrize("forward_instance", [True, False])
def test_packed_layout_reproduces_plain_bf16(forward_instance):
    cfg = ObjectNeRFConfig(use_voxel_embedding=False)
    settings = RenderSettings(mlp=cfg, perturb=0.0, noise_std=0.0)
    models = init_params(torch.Generator().manual_seed(0), settings, {}, device="cpu")
    n, s = 2, 64
    g = torch.Generator().manual_seed(1)
    z = torch.sort(0.5 + 4.0 * torch.rand(n, s, generator=g), -1).values
    o, d = torch.randn(n, 3, generator=g) * 0.2, torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    xyz = (o[:, None] + d[:, None] * z[..., None]).contiguous()
    dir_pe = freq_encode(d, cfg.N_freq_dir)
    codes = torch.randn(n, cfg.N_obj_code_length, generator=g)
    with torch.no_grad():
        packed = fm.pack_kernel_weights(models.nerf_coarse, cfg, sigma_only=True)
        np.testing.assert_allclose(
            _emulate(packed, cfg, xyz, z).numpy(),
            fm.coarse_weights_plain(models.nerf_coarse, cfg, xyz, z).numpy(),
            atol=1e-5, rtol=0)
        packed = fm.pack_kernel_weights(models.nerf_fine, cfg, forward_instance)
        assert packed.w.dtype == torch.bfloat16 and packed.w.numel() % 8 == 0
        got = _emulate(packed, cfg, xyz, z, dir_pe, codes if forward_instance else None)
        want = fm.render_tiles_plain(models.nerf_fine, cfg, xyz, z, dir_pe, codes,
                                     forward_instance=forward_instance)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5,
                                       rtol=0, err_msg=k)
