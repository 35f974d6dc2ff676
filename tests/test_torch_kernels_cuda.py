"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`: skipped where CUDA is unavailable. This file imports nothing
of JAX, so it runs on a machine with the card and no JAX:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from object_nerf_torch.models import voxel_grid as vg
from object_nerf_torch.models.embedding import freq_encode
from object_nerf_torch.models.mlp import ObjectNeRFConfig
from object_nerf_torch.ops import fused_mlp as fm
from object_nerf_torch.ops import fused_mlp_vjp as fv
from object_nerf_torch.ops import fused_sigma as fs
from object_nerf_torch.ops import gather, probes
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
            want = fm.coarse_weights_plain(models.nerf_coarse, cfg, xyz, z,
                                           last_delta_inf=last)
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


# -- the voxel operand of the eval and density kernels ----------------------------


def _voxel_setup(device, n, s, seed=3):
    """The default voxel-conditioned model, a small grid of N(0, 1) features
    and rays that start inside it and leave it (samples inside, on the border
    and outside), with the raw features the real lookup gives (bf16 table)."""
    cfg = ObjectNeRFConfig()
    rng = np.random.RandomState(seed)
    pcd = rng.rand(4000, 3) * [1.2, 1.0, 0.8] - [0.6, 0.5, 0.4]
    feats, topo, static = vg.build_voxel_grid(
        pcd, [0.0, 0.0, 0.0], 1.0, 0.1, 3, 24, cfg.N_freq_voxel, 100000,
        generator=torch.Generator().manual_seed(seed), device=device)
    models = init_params(torch.Generator().manual_seed(0),
                         RenderSettings(mlp=cfg, perturb=0.0, noise_std=0.0), {},
                         device=device, voxel_features=feats)
    with torch.no_grad():
        for m in (models.nerf_coarse, models.nerf_fine):
            m.sigma.bias += 1.0  # densities clear of the last sample's step at 0
    g = torch.Generator().manual_seed(seed)
    z = torch.sort(0.05 + 1.2 * torch.rand(n, s, generator=g), -1).values
    o, d = torch.randn(n, 3, generator=g) * 0.1, torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    xyz = (o[:, None] + d[:, None] * z[..., None]).contiguous().to(device)
    ct = vg.make_corner_table(feats, topo, static, lowp=True)
    with torch.no_grad():
        raw, invalid = vg.voxel_lookup_dense(None, topo, static, xyz.reshape(-1, 3), ct=ct)
    assert 0 < int(invalid.sum()) < invalid.numel()
    dir_pe = freq_encode(d, cfg.N_freq_dir).contiguous().to(device)
    codes = torch.randn(n, cfg.N_obj_code_length, generator=g).to(device)
    return cfg, models, xyz, z.contiguous().to(device), dir_pe, codes, \
        raw.reshape(n, s, 24).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("s,n", [(64, 37), (128, 19), (32, 9)])
def test_voxel_kernels_match_plain_bf16_on_card(cuda_device, s, n):
    """`fused_coarse_weights` and `fused_render_tiles` with the voxel operand
    against their plain versions (ragged last tiles)."""
    cfg, models, xyz, z, dir_pe, codes, raw = _voxel_setup(cuda_device, n, s)
    fm.reset_launch_counts()
    with torch.no_grad():
        got = fm.fused_coarse_weights(models.nerf_coarse, cfg, xyz, z, voxel_raw=raw)
        want = fm.coarse_weights_plain(models.nerf_coarse, cfg, xyz, z, voxel_raw=raw)
        assert (got - want).abs().max().item() < FWD_TOL
        for fi, ww in ((True, True), (True, False), (False, True)):
            got = fm.fused_render_tiles(models.nerf_fine, cfg, xyz, z, dir_pe, codes,
                                        voxel_raw=raw, forward_instance=fi, want_weights=ww,
                                        white_back=ww)
            want = fm.render_tiles_plain(models.nerf_fine, cfg, xyz, z, dir_pe, codes,
                                         voxel_raw=raw, forward_instance=fi,
                                         want_weights=ww, white_back=ww)
            assert set(got) == set(want)
            for k in want:
                assert (got[k] - want[k]).abs().max().item() < FWD_TOL, (fi, k)
    torch.cuda.synchronize()
    assert fm.launch_counts["fused_coarse_weights"] == 1
    assert fm.launch_counts["fused_render_tiles"] == 3
    with pytest.raises(ValueError, match="voxel_raw required"):
        fm.fused_coarse_weights(models.nerf_coarse, cfg, xyz, z)


@pytest.mark.cuda
@pytest.mark.parametrize("n,per_row", [(64 * 37, 64), (300, 20), (7, 1)])
def test_voxel_sigma_kernel_matches_plain_bf16_on_card(cuda_device, n, per_row):
    cfg, models, xyz, _, _, _, raw = _voxel_setup(cuda_device, n, 32)
    pts = xyz.reshape(-1, 3)[:n].contiguous()
    raw = raw.reshape(-1, 24)[:n].contiguous()
    codes = torch.randn(n // per_row, cfg.N_obj_code_length, device=cuda_device)
    for branch in fs.BRANCHES:
        got = fs.fused_sigma_eval(models.nerf_fine, cfg, pts, codes, branch, per_row,
                                  voxel_raw=raw)
        with torch.no_grad():
            want = fs.sigma_eval_plain(models.nerf_fine, cfg, pts, codes, branch, per_row,
                                       voxel_raw=raw)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() < FWD_TOL, branch


# -- the gather and the probes ------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,n", [(1000, 1), (1000, 4097), (114688, 491520)])
def test_gather_rows_is_index_select_on_card(cuda_device, dtype, rows, n):
    g = torch.Generator().manual_seed(4)
    table = torch.randn(rows, 192, generator=g).to(dtype).to(cuda_device)
    idx = torch.randint(0, rows, (n,), generator=g, dtype=torch.int32).to(cuda_device)
    gather.reset_launch_counts()
    got = gather.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gather.launch_counts["gather_rows"] == 1
    assert torch.equal(got, gather.gather_rows_plain(table, idx))
    with pytest.raises(IndexError):
        gather.gather_rows(table, torch.full((3,), rows, dtype=torch.int32,
                                             device=cuda_device))
    with pytest.raises(IndexError):
        gather.gather_rows(table, torch.full((3,), -1, dtype=torch.int32,
                                             device=cuda_device))


@pytest.mark.cuda
def test_voxel_lookup_goes_through_gather_rows_on_card(cuda_device):
    cfg, models, xyz, _, _, _, raw = _voxel_setup(cuda_device, 16, 32)
    assert raw.is_cuda and gather.launch_counts["gather_rows"] > 0


# the probe's 8-layer chain: as FWD_TOL, relative to the largest output
# (measured on an H100: at most 1.9e-3 over the eight modes)
PROBE_REL_TOL = 1e-2


def _probe_inputs(device, n, seed=5):
    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(device)

    x = t(n, 27)
    s = [t(3, 60), t(16, 192), t(8, 96), t(27, 348)]
    trunk = [t(375, 256, scale=0.05)] + [t(256, 256, scale=0.05) for _ in range(7)]
    return x, s, trunk


@pytest.mark.cuda
@pytest.mark.parametrize("mode", probes.MODES)
def test_pe_probe_matches_plain_on_card(cuda_device, mode):
    x, s, trunk = _probe_inputs(cuda_device, 128 * 5 + 17)
    probes.reset_launch_counts()
    got = probes.pe_probe(x, *s, trunk, mode)
    want = probes.pe_probe_plain(x, *s, trunk, mode)
    torch.cuda.synchronize()
    assert probes.launch_counts["pe_probe"] == 1
    assert got.shape == want.shape == (x.shape[0], 1)
    assert _rel(got, want) < PROBE_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(983040, 24), (1001,), (3, 5)])
def test_scale_copy_doubles_on_card(cuda_device, shape):
    x = torch.randn(*shape, device=cuda_device)
    got = probes.scale_copy(x)
    torch.cuda.synchronize()
    assert torch.equal(got, probes.scale_copy_plain(x))
