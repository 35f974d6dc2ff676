"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`: skipped where CUDA is unavailable. This file imports nothing
of JAX, so it runs on a machine with the card and no JAX:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest
"""

import pytest
import torch

from object_nerf_torch.models.embedding import freq_encode
from object_nerf_torch.models.mlp import ObjectNeRFConfig
from object_nerf_torch.ops import fused_mlp as fm
from object_nerf_torch.ops import fused_mlp_vjp as fv
from object_nerf_torch.ops import fused_sigma as fs
from object_nerf_torch.render.renderer import RenderSettings
from object_nerf_torch.train.system import init_params


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s,n", [(64, 37), (128, 19), (32, 9)])
def test_kernels_match_plain_bf16_on_card(cuda_device, s, n):
    cfg = ObjectNeRFConfig(use_voxel_embedding=False)
    settings = RenderSettings(mlp=cfg, perturb=0.0, noise_std=0.0)
    models = init_params(torch.Generator().manual_seed(0), settings, {}, device=cuda_device)
    with torch.no_grad():
        for m in (models.nerf_coarse, models.nerf_fine):
            m.sigma.bias += 1.0  # densities clear of the last sample's step at 0
    g = torch.Generator().manual_seed(1)
    z = torch.sort(0.5 + 4.0 * torch.rand(n, s, generator=g), -1).values
    o, d = torch.randn(n, 3, generator=g) * 0.3, torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    xyz = (o[:, None] + d[:, None] * z[..., None]).contiguous().to(cuda_device)
    z = z.contiguous().to(cuda_device)
    dir_pe = freq_encode(d, cfg.N_freq_dir).contiguous().to(cuda_device)
    codes = torch.randn(n, cfg.N_obj_code_length, generator=g).to(cuda_device)
    fm.reset_launch_counts()
    with torch.no_grad():
        for last in (True, False):
            got = fm.fused_coarse_weights(models.nerf_coarse, cfg, xyz, z, last_delta_inf=last)
            want = fm.coarse_weights_plain(models.nerf_coarse, cfg, xyz, z, last)
            assert (got - want).abs().max().item() < 1e-4
        for fi, ww in ((True, True), (True, False), (False, True)):
            got = fm.fused_render_tiles(models.nerf_fine, cfg, xyz, z, dir_pe, codes,
                                        forward_instance=fi, want_weights=ww, white_back=ww)
            want = fm.render_tiles_plain(models.nerf_fine, cfg, xyz, z, dir_pe, codes,
                                         forward_instance=fi, want_weights=ww,
                                         white_back=ww)
            assert set(got) == set(want)
            for k in want:
                assert (got[k] - want[k]).abs().max().item() < 1e-3, k
    torch.cuda.synchronize()
    assert fm.launch_counts == {"fused_coarse_weights": 2, "fused_render_tiles": 3,
                                "fused_mlp_eval": 0, "fused_mlp_bwd": 0,
                                "fused_sigma_eval": 0}


# forward: both sides round the same operands to bf16 and differ in the order
# of their f32 sums, which now and then flips one bf16 rounding (2^-8
# relative) of an activation
FWD_TOL = 1e-3
# backward, per tensor, relative to the tensor's largest reference entry. One
# flipped rounding early in the 8-layer chain moves every later activation of
# its row by ~1e-4, which flips more roundings downstream, so the two bf16
# computations drift apart by a fraction of the bf16 quantisation noise
# itself (the bf16 plain version is 1e-1 away from the f32 one). With
# cotangents of one sign, as below, the rows' contributions add up and the
# drift averages out: measured on an H100 at most 1.6e-2 over these shapes
# (1.9e-3 at the training shape); with cotangents of random sign the sums
# cancel and the same drift reaches 9e-2. A wrong layer, term or layout is
# off by O(1).
BWD_REL_TOL = 5e-2


def _train_inputs(device, n, s, seed=1):
    cfg = ObjectNeRFConfig(use_voxel_embedding=False)
    settings = RenderSettings(mlp=cfg)
    models = init_params(torch.Generator().manual_seed(0), settings, {}, device=device)
    g = torch.Generator().manual_seed(seed)
    z = torch.sort(0.5 + 4.0 * torch.rand(n, s, generator=g), -1).values
    o, d = torch.randn(n, 3, generator=g) * 0.3, torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    xyz = (o[:, None] + d[:, None] * z[..., None]).contiguous().to(device)
    dir_pe = freq_encode(d, cfg.N_freq_dir).contiguous().to(device)
    codes = torch.randn(n, cfg.N_obj_code_length, generator=g).to(device)
    # cotangents of the size a mean-reduced loss gives, all of one sign
    cot = (torch.randn(n * s, 8, generator=g).abs() * 1e-4).to(device)
    return cfg, models.nerf_fine, xyz, dir_pe, codes, cot


def _rel(got, want):
    return ((got - want).abs().max() / (want.abs().max() + 1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("s,n", [(64, 5), (128, 3), (32, 9), (64, 2048), (128, 2048)])
def test_train_kernels_match_plain_bf16_on_card(cuda_device, s, n):
    """`fused_mlp_eval` and `fused_mlp_bwd` against their plain versions: small
    shapes with a ragged last tile (5 rays of 64 in tiles of 2), and the
    training shapes."""
    cfg, model, xyz, dir_pe, codes, cot = _train_inputs(cuda_device, n, s)
    fm.reset_launch_counts()
    with torch.no_grad():
        for fi, cs in ((True, True), (False, True), (True, False)):
            got = fv.fused_mlp_eval(model, cfg, xyz, dir_pe, codes, forward_instance=fi,
                                    compute_scene=cs)
            want = fv.mlp_eval_plain(model, cfg, xyz, dir_pe, codes, fi, cs)
            for a, b in zip(got, want):
                assert a.shape == b.shape
                assert (a - b).abs().max().item() < FWD_TOL, (fi, cs)
        for fi in (True, False):
            grads, d_codes = fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, cot, fi)
            want, want_codes = fv.mlp_bwd_plain(model, cfg, xyz, dir_pe, codes, cot, fi)
            torch.cuda.synchronize()
            for k in want:
                if want[k].abs().max() == 0:
                    assert grads[k].abs().max() == 0, k
                else:
                    assert _rel(grads[k], want[k]) < BWD_REL_TOL, (fi, k)
            if fi:
                assert _rel(d_codes, want_codes) < BWD_REL_TOL
            else:
                assert d_codes.abs().max() == 0
    assert fm.launch_counts["fused_mlp_eval"] == 3 and fm.launch_counts["fused_mlp_bwd"] == 2


@pytest.mark.cuda
def test_backward_kernel_is_deterministic_on_card(cuda_device):
    """Per-block partials summed in block order: two launches on the same
    inputs give the same bits."""
    cfg, model, xyz, dir_pe, codes, cot = _train_inputs(cuda_device, 700, 64)
    a, ac = fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, cot)
    b, bc = fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, cot)
    torch.cuda.synchronize()
    assert torch.equal(ac, bc)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
def test_autograd_function_launches_both_kernels_on_card(cuda_device):
    cfg, model, xyz, dir_pe, codes, cot = _train_inputs(cuda_device, 64, 64)
    codes.requires_grad_()
    fm.reset_launch_counts()
    outs = fv.fused_mlp_eval(model, cfg, xyz, dir_pe, codes)
    g4 = cot.reshape(64, 64, 8)
    loss = ((outs[0] * g4[..., 0]).sum() + (outs[1] * g4[..., 1:4]).sum()
            + (outs[2] * g4[..., 4]).sum() + (outs[3] * g4[..., 5:8]).sum())
    loss.backward()
    torch.cuda.synchronize()
    assert fm.launch_counts["fused_mlp_eval"] == 1 and fm.launch_counts["fused_mlp_bwd"] == 1
    want, want_codes = fv.mlp_bwd_plain(model, cfg, xyz, dir_pe, codes.detach(), cot)
    for k, p in model.named_parameters():
        assert _rel(p.grad, want[k]) < BWD_REL_TOL, k
    assert _rel(codes.grad, want_codes) < BWD_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n,per_row", [(64, 64), (64 * 37, 64), (4096 * 64, 64), (300, 20),
                                       (7, 1)])
def test_sigma_kernel_matches_plain_bf16_on_card(cuda_device, n, per_row):
    """`fused_sigma_eval` against `sigma_eval_plain`, both branches: one
    pseudo-row, an N that is not a multiple of the 128-point tile, the edit
    chunk, and pseudo-rows that straddle tiles. Two launches give the same
    bits. A packing with the rgb heads serves as well as a sigma-only one."""
    cfg = ObjectNeRFConfig(use_voxel_embedding=False)
    models = init_params(torch.Generator().manual_seed(0), RenderSettings(mlp=cfg), {},
                         device=cuda_device)
    model = models.nerf_fine
    g = torch.Generator().manual_seed(2)
    pts = (torch.rand(n, 3, generator=g) * 3.0 - 1.5).to(cuda_device)
    codes = torch.randn(n // per_row, cfg.N_obj_code_length, generator=g).to(cuda_device)
    full = fm.pack_kernel_weights(model, cfg, forward_instance=True)
    fm.reset_launch_counts()
    for branch in fs.BRANCHES:
        got = fs.fused_sigma_eval(model, cfg, pts, codes, branch, per_row)
        again = fs.fused_sigma_eval(model, cfg, pts, codes, branch, per_row)
        other = fs.fused_sigma_eval(model, cfg, pts, codes, branch, per_row, packed=full)
        with torch.no_grad():
            want = fs.sigma_eval_plain(model, cfg, pts, codes, branch, per_row)
        torch.cuda.synchronize()
        assert got.shape == (n,) and got.dtype == torch.float32
        assert (got - want).abs().max().item() < FWD_TOL, branch
        assert torch.equal(got, again) and torch.equal(got, other), branch
    assert fm.launch_counts["fused_sigma_eval"] == 6


@pytest.mark.cuda
def test_sigma_kernel_wrapper_raises_on_card(cuda_device):
    cfg = ObjectNeRFConfig(use_voxel_embedding=False)
    models = init_params(torch.Generator().manual_seed(0), RenderSettings(mlp=cfg), {},
                         device=cuda_device)
    pts = torch.zeros(128, 3, device=cuda_device)
    scene_only = fm.pack_kernel_weights(models.nerf_fine, cfg, False, sigma_only=True)
    codes = torch.zeros(2, cfg.N_obj_code_length, device=cuda_device)
    with pytest.raises(ValueError, match="object branch"):
        fs.fused_sigma_eval(models.nerf_fine, cfg, pts, codes, "instance", packed=scene_only)
    with pytest.raises(ValueError, match="bf16"):
        fs.fused_sigma_eval(models.nerf_fine, cfg, pts, dtype=torch.float32)
    with pytest.raises(ValueError, match="another device"):
        fs.fused_sigma_eval(models.nerf_fine.cpu(), cfg, pts,
                            packed=fm.PackedWeights(scene_only.w.cpu(), scene_only.b.cpu(),
                                                    scene_only.scene, None, True))
