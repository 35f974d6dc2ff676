"""The point-wise density module (object_nerf_torch/ops/fused_sigma.py).

On the CPU the wrapper runs `sigma_eval_plain`: it is held against the JAX
package's Pallas kernel `fused_sigma_eval` in interpret mode, both branches,
as tests/test_pallas_mlp.py runs it. The packer's density-only layout with
the object branch is held against the plain version through an emulation of
the kernel's dataflow over the packed buffers. The kernel itself runs only
on the card (tests/test_torch_kernels_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_nerf_tpu.ops import pallas_mlp as jk

from object_nerf_torch.models.embedding import freq_encode
from object_nerf_torch.models.mlp import ObjectNeRFConfig
from object_nerf_torch.ops import fused_mlp as fm
from object_nerf_torch.ops import fused_sigma as fs
from object_nerf_torch.render.renderer import RenderSettings
from object_nerf_torch.train.system import init_params

from _torch_port import CFG, CFG_JAX, jax_params, port_models

torch.set_num_threads(2)

# f32, as tests/test_pallas_mlp.py holds the JAX kernel to its XLA forward:
# the JAX kernel builds its PE as sin(x @ S + phase), ~1e-4 off cos at the
# top frequency
F32_ATOL = 2e-4
# bf16: the JAX kernel's polynomial sine moves some bf16 roundings of the PE
# by one step (as in tests/test_torch_fused_mlp.py)
BF16_ATOL = 5e-4


def _points(n, s, seed=3):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(n, 3) * 0.5).astype(np.float32)
    codes = (rng.randn(n // s, CFG.N_obj_code_length) * 0.1).astype(np.float32)
    return pts, codes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("branch", ["scene", "instance"])
def test_sigma_eval_matches_jax_kernel(branch, dtype):
    params = jax_params(seed=5)
    models = port_models(params)
    n, s = 256, 16
    pts, codes = _points(n, s)
    want = jk.fused_sigma_eval(
        params["fine"], CFG_JAX, jnp.asarray(pts),
        obj_codes=jnp.asarray(codes) if branch == "instance" else None, branch=branch,
        samples_per_row=s, dtype=getattr(jnp, dtype), interpret=True)
    fm.reset_launch_counts()
    got = fs.fused_sigma_eval(models.nerf_fine, CFG, torch.from_numpy(pts),
                              torch.from_numpy(codes), branch, s,
                              dtype=getattr(torch, dtype))
    assert sum(fm.launch_counts.values()) == 0  # CPU tensors: the plain version
    assert got.shape == (n,) and got.dtype == torch.float32
    assert (got < 0).any()  # raw head output: no ReLU applied
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("n,s", [(64, 64), (192, 64), (320, 64), (60, 20), (5, 1)])
def test_sigma_eval_takes_any_row_count(n, s):
    """One pseudo-row, and N that is not a multiple of the kernel's 128-point
    tile: the wrapper pads nothing and the rows keep their codes."""
    models = port_models(jax_params(seed=6))
    pts, codes = _points(n, s, seed=7)
    pts, codes = torch.from_numpy(pts), torch.from_numpy(codes)
    got = fs.fused_sigma_eval(models.nerf_coarse, CFG, pts, codes, "instance", s,
                              dtype=torch.float32)
    emb = freq_encode(pts, CFG.N_freq_xyz)
    want, _ = models.nerf_coarse.instance_forward(
        emb, codes.repeat_interleave(s, 0), sigma_only=True)
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(), atol=1e-6, rtol=0)


def test_sigma_wrapper_checks_its_inputs():
    models = port_models(jax_params())
    pts, codes = (torch.from_numpy(a) for a in _points(64, 16))
    with pytest.raises(ValueError, match="divisible"):
        fs.fused_sigma_eval(models.nerf_fine, CFG, pts[:63].contiguous(), samples_per_row=16)
    with pytest.raises(ValueError, match="obj_codes required"):
        fs.fused_sigma_eval(models.nerf_fine, CFG, pts, branch="instance", samples_per_row=16)
    with pytest.raises(ValueError, match="shape"):
        fs.fused_sigma_eval(models.nerf_fine, CFG, pts, codes[:2].contiguous(), "instance", 16)
    with pytest.raises(ValueError, match="branch"):
        fs.fused_sigma_eval(models.nerf_fine, CFG, pts, branch="object")
    with pytest.raises(ValueError, match="float32"):
        fs.fused_sigma_eval(models.nerf_fine, CFG, pts.double())
    with pytest.raises(ValueError, match="voxel"):  # a classical model takes none
        fs.fused_sigma_eval(models.nerf_fine, CFG, pts, voxel_raw=pts)
    assert "fused_sigma_eval" in fm.launch_counts


# -- the packer's density-only layout, emulated at flagship width on the CPU -----


def _emulate_sigma(packed, cfg, pts, codes, branch, s):
    """The kernel's dataflow over the packed buffers (csrc/fused_sigma.cu):
    input tile [PE | code of the point's pseudo-row | 0] in bf16, trunk layers
    as (K, N) blocks with the skip's input rows padded to K0, then the sigma
    head stored (1, width)."""
    instance = branch == "instance"
    tab = packed.obj if instance else packed.scene
    width = fm.OBJ_W if instance else fm.SCENE_W
    w, b = packed.w.float(), packed.b
    pe = freq_encode(pts, cfg.N_freq_xyz)
    X = torch.zeros(pts.shape[0], fm.OBJ_K0)
    X[:, :pe.shape[1]] = pe
    if instance:
        rows = torch.arange(pts.shape[0]) // s  # the kernel's point / per_row
        X[:, pe.shape[1]:pe.shape[1] + codes.shape[1]] = codes[rows]
    X = X.bfloat16().float()
    k0, h = tab[fm.T_K0], None
    for i in range(tab[fm.T_DEPTH]):
        off = tab[fm.T_TW + i]
        bias = b[tab[fm.T_TB + i]:tab[fm.T_TB + i] + width]
        if i == 0:
            acc = X[:, :k0] @ w[off:off + k0 * width].reshape(k0, width)
        elif (tab[fm.T_SKIPS] >> i) & 1:
            acc = (X[:, :k0] @ w[off:off + k0 * width].reshape(k0, width)
                   + h @ w[off + k0 * width:off + (k0 + width) * width].reshape(width, width))
        else:
            acc = h @ w[off:off + width * width].reshape(width, width)
        acc = acc + bias
        h = torch.where(acc >= 0, acc, 0.01 * acc).bfloat16().float()
    return h @ w[tab[fm.T_SIGW]:tab[fm.T_SIGW] + width] + b[tab[fm.T_SIGB]]


@pytest.mark.parametrize("branch", ["scene", "instance"])
def test_packed_sigma_only_layout_reproduces_plain_bf16(branch):
    cfg = ObjectNeRFConfig(use_voxel_embedding=False)
    models = init_params(torch.Generator().manual_seed(0), RenderSettings(mlp=cfg), {},
                         device="cpu")
    model = models.nerf_fine
    g = torch.Generator().manual_seed(1)
    n, s = 192, 64
    pts = torch.rand(n, 3, generator=g) * 3.0 - 1.5
    codes = torch.randn(n // s, cfg.N_obj_code_length, generator=g)
    with torch.no_grad():
        packed = fm.pack_kernel_weights(model, cfg, forward_instance=True, sigma_only=True)
        assert packed.sigma_only and packed.obj is not None
        assert packed.w.dtype == torch.bfloat16 and packed.w.numel() % 8 == 0
        # trunks and sigma heads only: no final / direction / rgb blocks
        n_w = sum(p.numel() for name, p in model.named_parameters()
                  if name.endswith("weight") and ("encoding_" in name or "sigma" in name)
                  and "final" not in name and "dir" not in name)
        pe, code = cfg.xyz_pe_size, cfg.N_obj_code_length
        pad_scene = 2 * (fm.SCENE_K0 - pe) * fm.SCENE_W  # layer 0 and the skip layer
        pad_obj = 2 * (fm.OBJ_K0 - pe - code) * fm.OBJ_W
        assert packed.w.numel() == n_w + pad_scene + pad_obj
        assert packed.obj[fm.T_FINW] == 0 and packed.obj[fm.T_RGBW] == 0
        got = _emulate_sigma(packed, cfg, pts, codes, branch, s)
        want = fs.sigma_eval_plain(model, cfg, pts, codes, branch, s)
        # the skip layer's two partial products are summed in another order
        # than the plain version's one product, which now and then flips the
        # bf16 rounding of one activation (measured 1.2e-5 on one of 192
        # densities of ~0.02); a wrong block or offset is off by the
        # densities' own size
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)
        assert want.abs().max() > 1e-2
        # a scene-only packing cannot serve the object branch
        scene_only = fm.pack_kernel_weights(model, cfg, forward_instance=False,
                                            sigma_only=True)
        assert scene_only.obj is None
        with pytest.raises(ValueError, match="object branch"):
            fm._check_launch(cfg, torch.bfloat16, None, scene_only, torch.device("cuda"),
                             need_obj=True, need_heads=False)
        with pytest.raises(ValueError, match="sigma head only"):
            fm._check_launch(cfg, torch.bfloat16, 64, packed, torch.device("cuda"),
                             need_obj=True, need_heads=True)
