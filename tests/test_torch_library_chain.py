"""The library yardstick of rows 1-5 of PERF.md's kernel table
(`object_nerf_torch/scripts/profile_mlp.py`: each kernel's function as a chain
of torch calls, per layer one bf16 product with f32 sums) against the plain
versions the kernels are held to, and through them the JAX package: the plain
bf16 versions compute the same function with the same rounding points. On the
CPU the chain's product runs through f32 copies of the bf16 operands, so what
is left is the order of the f32 sums: 1e-5 on the forward outputs, and 1e-4
of each gradient's largest entry for the backward (the chain rounds d_h to
bf16 where the plain backward rounds d_pre, and both differ from each other
only where a LeakyReLU slope multiplies a rounded value)."""

import numpy as np
import pytest
import torch

from object_nerf_torch.models.embedding import freq_encode
from object_nerf_torch.models.mlp import ObjectNeRF, ObjectNeRFConfig
from object_nerf_torch.ops import fused_mlp as fm
from object_nerf_torch.ops import fused_mlp_vjp as fv
from object_nerf_torch.ops import fused_sigma as fs
from object_nerf_torch.scripts import profile_mlp as pm

torch.set_num_threads(2)

SMALL = dict(D=3, W=32, skips=(1,), inst_D=2, inst_W=16, inst_skips=(1,),
             use_voxel_embedding=False, N_obj_code_length=8, N_freq_xyz=4, N_freq_dir=2)
CFGS = {"classical": ObjectNeRFConfig(**SMALL),
        "voxel": ObjectNeRFConfig(**{**SMALL, "use_voxel_embedding": True, "N_freq_voxel": 3})}
N, S = 6, 8
FWD_ATOL = 1e-5
GRAD_REL = 1e-4


def _setup(kind, seed=0):
    cfg = CFGS[kind]
    model = ObjectNeRF(cfg).reset_parameters_(torch.Generator().manual_seed(seed))
    with torch.no_grad():  # densities clear of 0, as chip_smoke raises them
        model.sigma.bias += 1.0
        model.instance_sigma.bias += 1.0
    rng = np.random.RandomState(seed + 1)
    z = np.sort(0.5 + 3.0 * rng.rand(N, S), -1).astype(np.float32)
    o, d = rng.randn(N, 3) * 0.3, rng.randn(N, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    xyz = torch.from_numpy((o[:, None] + d[:, None] * z[..., None]).astype(np.float32))
    dir_pe = freq_encode(torch.from_numpy(d.astype(np.float32)), cfg.N_freq_dir)
    codes = torch.from_numpy((rng.randn(N, cfg.N_obj_code_length) * 0.2).astype(np.float32))
    raw = None
    if cfg.use_voxel_embedding:
        raw = torch.from_numpy(rng.randn(N, S, cfg.N_scn_voxel_size + cfg.N_obj_voxel_size)
                               .astype(np.float32) * 0.5)
    g = torch.from_numpy(np.abs(rng.randn(N * S, 8)).astype(np.float32) * 1e-2)
    return cfg, model, xyz, torch.from_numpy(z), dir_pe, codes, raw, g


def _close(got, want, atol=FWD_ATOL):
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_chain_forwards_match_plain_versions(kind):
    """Rows 1, 2, 3 and 5 against `coarse_weights_plain`,
    `render_tiles_plain`, `mlp_eval_plain` and `sigma_eval_plain` (bf16)."""
    cfg, model, xyz, z, dir_pe, codes, raw, _ = _setup(kind)
    layers, leaves = pm.chain_layers(model)
    assert not leaves and layers["scene"]["trunk"][0][0].dtype == torch.bfloat16
    with torch.no_grad():
        _close(pm.torch_coarse_weights(layers, cfg, xyz, z, raw),
               fm.coarse_weights_plain(model, cfg, xyz, z, raw))
        got = pm.torch_render_tiles(layers, cfg, xyz, z, dir_pe, codes, raw)
        want = fm.render_tiles_plain(model, cfg, xyz, z, dir_pe, codes, raw)
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])
        for a, b in zip(pm.torch_mlp_eval(layers, cfg, xyz, dir_pe, codes, raw),
                        fv.mlp_eval_plain(model, cfg, xyz, dir_pe, codes, voxel_raw=raw)):
            _close(a, b)
        pts = xyz.reshape(-1, 3)
        vraw = None if raw is None else raw.reshape(N * S, -1)
        for branch in fs.BRANCHES:
            _close(pm.torch_sigma_eval(layers, cfg, pts, codes, branch, S, vraw),
                   fs.sigma_eval_plain(model, cfg, pts, codes, branch, S, vraw))


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_chain_backward_matches_plain_backward(kind):
    """Row 4: autograd of the chain against `mlp_bwd_plain` (bf16) on the
    same cotangent: every parameter's gradient, d_codes and d_voxel_raw."""
    cfg, model, xyz, _, dir_pe, codes, raw, g = _setup(kind)
    layers, leaves = pm.chain_layers(model, grad=True)
    assert sorted(leaves) == sorted(n for n, _ in model.named_parameters())
    grads, d_codes, d_vox = pm.torch_mlp_bwd(layers, leaves, cfg, xyz, dir_pe, codes, g, raw)
    want, want_codes, want_vox = fv.mlp_bwd_plain(model, cfg, xyz, dir_pe, codes, g,
                                                  voxel_raw=raw)
    pairs = [(grads[k], want[k], k) for k in want] + [(d_codes, want_codes, "d_codes")]
    if raw is not None:
        pairs.append((d_vox, want_vox, "d_voxel_raw"))
    else:
        assert d_vox is None and want_vox is None
    for a, b, name in pairs:
        scale = b.abs().max().item()
        assert scale > 0, name
        assert (a - b).abs().max().item() <= GRAD_REL * scale, name
    # the chain really is rounded to bf16: f32 autograd of the f32 model differs
    outs = fv.mlp_eval_plain(model, cfg, xyz, dir_pe, codes, matmul_dtype=torch.float32,
                             voxel_raw=raw)
    g4 = g.reshape(N, S, 8)
    w = model.xyz_encoding_2[0].weight
    (gw,) = torch.autograd.grad(outs, [w], [g4[..., 0], g4[..., 1:4], g4[..., 4], g4[..., 5:8]])
    assert (gw - grads["xyz_encoding_2.0.weight"]).abs().max().item() > \
        GRAD_REL * gw.abs().max().item()
