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
from object_nerf_torch.ops import fwd_chain as fc
from object_nerf_torch.ops import gather, probes
from object_nerf_torch.render.renderer import RenderSettings
from object_nerf_torch.train.system import init_params, make_train_step
from object_nerf_torch.utils import trace


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


def _nrel(got, want):
    return ((got - want).norm() / (want.norm() + 1e-30)).item()


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
            grads, d_codes, _ = fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, cot, fi)
            want, want_codes, _ = fv.mlp_bwd_plain(model, cfg, xyz, dir_pe, codes, cot, fi)
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
    a, ac, _ = fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, cot)
    b, bc, _ = fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, cot)
    torch.cuda.synchronize()
    assert torch.equal(ac, bc)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("voxel", [False, True], ids=["classical", "voxel"])
def test_backward_sweep_layout_on_card(cuda_device, voxel):
    """The built library's sweep layout (`fused_mlp_vjp.sweep_layout`) is the
    mirror's of tests/test_torch_fwd_chain.py (SWEEP_STAGES, `sweep_smem`):
    a ring of at least 4 stages, within a block's shared memory."""
    from test_torch_fwd_chain import SWEEP_STAGES, sweep_smem  # tests/ on sys.path

    stages, smem = fv.sweep_layout(voxel)
    assert (stages, smem) == (SWEEP_STAGES[int(voxel)], sweep_smem(voxel, stages))
    assert stages >= 4 and smem <= 232448


@pytest.mark.cuda
@pytest.mark.parametrize("voxel", [False, True], ids=["classical", "voxel"])
@pytest.mark.parametrize("s,n", [(32, 9), (128, 19)])
def test_backward_sweep_is_deterministic_on_card(cuda_device, voxel, s, n):
    """Two launches of the backward on the same inputs give the same bits,
    with the object branch and without, at 32 and 128 samples with a ragged
    last tile: every sum of the sweep (per warpgroup partials, code sums,
    d_vox rows) runs in a fixed order whatever the warpgroups' timing."""
    if voxel:
        cfg, models, xyz, _, dir_pe, codes, raw = _voxel_setup(cuda_device, n, s)
        model = models.nerf_fine
        g = torch.Generator().manual_seed(9)
        cot = (torch.randn(n * s, 8, generator=g).abs() * 1e-4).to(cuda_device)
    else:
        cfg, model, xyz, dir_pe, codes, cot = _train_inputs(cuda_device, n, s)
        raw = None
    with torch.no_grad():
        for fi in (True, False):
            a = fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, cot, fi, voxel_raw=raw)
            b = fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, cot, fi, voxel_raw=raw)
            torch.cuda.synchronize()
            assert torch.equal(a[1], b[1]), fi
            if voxel:
                assert torch.equal(a[2], b[2]), fi
            for k in a[0]:
                assert torch.equal(a[0][k], b[0][k]), (fi, k)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(64, 64), (128, 256), (64, 128), (128, 64)])
def test_weight_gradient_kernel_matches_torch_on_card(cuda_device, m, n):
    """The wgmma / TMA GEMM alone on a random workspace: each item's partial
    against torch in f32 on the same bf16 operands (exact products, f32
    sums in another order), several slices of rows, boxes at column
    offsets away from 0."""
    rows, cols = 512, 640
    g = torch.Generator().manual_seed(m + n)
    ws = torch.randn(rows, cols, generator=g).bfloat16().to(cuda_device)
    items, off = [], 0
    for a, gc, k0, k1 in ((0, 320, 0, 64), (64, 384, 64, 320), (192, 128, 320, 512)):
        items.append([a, gc, n, m, k0, k1, off, 0])
        off += m * n
    got = fv.wgrad_gemm(ws, torch.tensor(items, dtype=torch.int32, device=cuda_device), off)
    want = fv.wgrad_gemm_plain(ws, items, off)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("voxel", [False, True])
def test_backward_workspace_is_the_layouts_on_card(cuda_device, voxel):
    """What one backward launch allocates at its peak: the workspace of
    `bwd_workspace_layout` and the partials of `bwd_plan`, beside its
    outputs (gradients, flat buffer, d_codes, d_voxel_raw) and nothing of
    the size of a per-block stash."""
    n, s = 256, 64
    cfg = ObjectNeRFConfig(use_voxel_embedding=voxel)
    settings = RenderSettings(mlp=cfg)
    models = init_params(torch.Generator().manual_seed(0), settings, {}, device=cuda_device)
    model = models.nerf_fine
    g = torch.Generator().manual_seed(2)
    xyz = (torch.randn(n, s, 3, generator=g) * 0.5).to(cuda_device)
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=-1)
    dir_pe = freq_encode(d, cfg.N_freq_dir).contiguous().to(cuda_device)
    codes = torch.randn(n, cfg.N_obj_code_length, generator=g).to(cuda_device)
    raw = ((torch.randn(n, s, 24, generator=g) * 0.5).to(cuda_device) if voxel else None)
    cot = (torch.randn(n * s, 8, generator=g).abs() * 1e-4).to(cuda_device)
    packed = fc.pack_kernel_weights(model, cfg, True)
    fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, cot, packed=packed, voxel_raw=raw)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = fv.bwd_plan(packed, cfg, n * s, n_sm, min(n * s // 128, n_sm))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, cot, packed=packed, voxel_raw=raw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda_device) - base
    expected = plan.layout.nbytes + 4 * plan.n_parts
    outputs = 8 * (packed.w.numel() + packed.b.numel()) + 4 * codes.numel() + (
        4 * raw.numel() if voxel else 0)
    assert plan.layout.nbytes == 2 * n * s * plan.layout.cols
    assert expected <= peak <= expected + outputs + 2 ** 20


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
    want, want_codes, _ = fv.mlp_bwd_plain(model, cfg, xyz, dir_pe, codes.detach(), cot)
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
    full = fc.pack_kernel_weights(model, cfg, forward_instance=True)
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
    scene_only = fc.pack_kernel_weights(models.nerf_fine, cfg, False, sigma_only=True)
    codes = torch.zeros(2, cfg.N_obj_code_length, device=cuda_device)
    with pytest.raises(ValueError, match="object branch"):
        fs.fused_sigma_eval(models.nerf_fine, cfg, pts, codes, "instance", packed=scene_only)
    with pytest.raises(ValueError, match="bf16"):
        fs.fused_sigma_eval(models.nerf_fine, cfg, pts, dtype=torch.float32)
    with pytest.raises(ValueError, match="another device"):
        fs.fused_sigma_eval(models.nerf_fine.cpu(), cfg, pts,
                            packed=fc.PackedWeights(scene_only.w.cpu(), scene_only.b.cpu(),
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


# -- the voxel operand of the training kernels, and the table gradient -------------


@pytest.mark.cuda
@pytest.mark.parametrize("s,n", [(64, 37), (128, 19), (32, 9), (64, 2048), (128, 2048)])
def test_voxel_train_kernels_match_plain_bf16_on_card(cuda_device, s, n):
    """`fused_mlp_eval` and `fused_mlp_bwd` with the voxel operand against
    their plain versions (ragged last tiles, and the training shapes): every
    weight gradient, d_codes and d_voxel_raw; a second backward launch gives
    the same bits."""
    cfg, models, xyz, _, dir_pe, codes, raw = _voxel_setup(cuda_device, n, s)
    model = models.nerf_fine
    g = torch.Generator().manual_seed(9)
    cot = (torch.randn(n * s, 8, generator=g).abs() * 1e-4).to(cuda_device)
    fm.reset_launch_counts()
    with torch.no_grad():
        for fi, cs in ((True, True), (False, True), (True, False)):
            got = fv.fused_mlp_eval(model, cfg, xyz, dir_pe, codes, voxel_raw=raw,
                                    forward_instance=fi, compute_scene=cs)
            want = fv.mlp_eval_plain(model, cfg, xyz, dir_pe, codes, fi, cs, voxel_raw=raw)
            for a, b in zip(got, want):
                assert a.shape == b.shape
                assert (a - b).abs().max().item() < FWD_TOL, (fi, cs)
        for fi in (True, False):
            grads, d_codes, d_vox = fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, cot, fi,
                                                     voxel_raw=raw)
            want, want_codes, want_vox = fv.mlp_bwd_plain(model, cfg, xyz, dir_pe, codes, cot,
                                                          fi, voxel_raw=raw)
            torch.cuda.synchronize()
            for k in want:
                if want[k].abs().max() == 0:
                    assert grads[k].abs().max() == 0, k
                else:
                    assert _rel(grads[k], want[k]) < BWD_REL_TOL, (fi, k)
            assert d_vox.shape == raw.shape and d_vox.dtype == torch.float32
            # d_voxel_raw is per sample, so the two bf16 computations' drift does
            # not average out (chip_smoke.py, VOX_DVOX_NORM_TOL): in norm within a
            # quarter of the bf16 plain version's own distance to f32
            _, _, v32 = fv.mlp_bwd_plain(model, cfg, xyz, dir_pe, codes, cot, fi,
                                         torch.float32, voxel_raw=raw)
            assert _nrel(d_vox, want_vox) < 0.25 * _nrel(want_vox, v32), fi
            if fi:
                assert _rel(d_codes, want_codes) < BWD_REL_TOL
            else:
                assert d_codes.abs().max() == 0 and d_vox[..., 16:].abs().max() == 0
        again = fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, cot, False, voxel_raw=raw)
        torch.cuda.synchronize()
        assert torch.equal(again[2], d_vox)
        assert all(torch.equal(again[0][k], grads[k]) for k in grads)
    assert fm.launch_counts["fused_mlp_eval"] == 3 and fm.launch_counts["fused_mlp_bwd"] == 3


def _small_grid(device, seed=3):
    rng = np.random.RandomState(seed)
    pcd = rng.rand(4000, 3) * [1.2, 1.0, 0.8] - [0.6, 0.5, 0.4]
    return vg.build_voxel_grid(pcd, [0.0, 0.0, 0.0], 1.0, 0.1, 3, 24, 6, 100000,
                               generator=torch.Generator().manual_seed(seed), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("lowp", [False, True])
def test_table_gradient_on_card(cuda_device, lowp):
    """One trainable table, two lookups through `corner_lookup`, one backward:
    the hand-written table gradient against autograd of the plain version
    (f32 build, index_select, the bf16 cast passed straight through). Both
    sum in f32; index_add_'s order on the card is not fixed: 1e-5 relative."""
    feats, topo, static = _small_grid(cuda_device)
    g = torch.Generator().manual_seed(5)
    pts = [(torch.rand(n, 3, generator=g) * 1.4 - 0.7).to(cuda_device) for n in (4096, 9000)]
    wts = [torch.randn(len(p), 24, generator=g).to(cuda_device) for p in pts]

    def run(table_cls):
        f = feats.clone().requires_grad_()
        table = table_cls(f, topo, static, lowp=lowp)
        loss = sum((table.lookup(p)[0] * w).sum() for p, w in zip(pts, wts))
        loss.backward()
        return float(loss), f.grad

    gather.reset_launch_counts()
    vg.build_counts["corner_table"] = 0
    loss, got = run(vg.CornerTable)
    torch.cuda.synchronize()
    assert gather.launch_counts == {"gather_rows": 0, "corner_lookup": 2}
    assert vg.build_counts["corner_table"] == 1
    want_loss, want = run(vg.PlainCornerTable)
    assert got.dtype == torch.float32 and abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    assert _rel(got, want) < 1e-5
    # the lookup of features under autograd takes the same route on the card
    f = feats.clone().requires_grad_()
    out, _ = vg.voxel_lookup_dense(f, topo, static, pts[0], lowp=lowp)
    (out * wts[0]).sum().backward()
    assert f.grad is not None and float(f.grad.abs().max()) > 0


@pytest.mark.cuda
def test_voxel_train_step_spans_on_card(cuda_device):
    """A voxel train step under a profiler: its spans go into the registry's
    "on" bucket, the corner table's build and lookups with CUDA stream time
    from their event pairs, and the step still launches 7 kernels (2 + 2
    fused, 2 corner lookups, one table build); a step with no profiler
    records no stream time."""
    cfg = ObjectNeRFConfig()
    feats, topo, static = _small_grid(cuda_device)
    settings = RenderSettings(mlp=cfg, N_samples=64, N_importance=64, perturb=1.0,
                              noise_std=1.0)
    models = init_params(torch.Generator().manual_seed(0), settings, {}, device=cuda_device,
                         voxel_features=feats)
    weights = {"color_loss_weight": 1.0, "opacity_loss_weight": 10.0,
               "instance_color_loss_weight": 1.0}
    step = make_train_step(settings, weights, torch.optim.Adam(models.parameters(), lr=1e-3))
    g = torch.Generator().manual_seed(2)
    n = 2048
    o, d = torch.randn(n, 3, generator=g) * 0.1, torch.randn(n, 3, generator=g)
    rays = torch.cat([o, d / d.norm(dim=-1, keepdim=True), torch.full((n, 1), 0.05),
                      torch.full((n, 1), 1.2)], -1)
    batch = {k: v.to(cuda_device) for k, v in {
        "rays": rays, "rgbs": torch.rand(n, 3, generator=g),
        "valid_mask": torch.ones(n, dtype=torch.bool),
        "instance_ids": torch.randint(0, 4, (n,), generator=g),
        "instance_mask": torch.rand(n, generator=g) > 0.5,
        "instance_mask_weight": torch.rand(n, generator=g)}.items()}
    gen = torch.Generator(device=cuda_device).manual_seed(3)

    def run():
        m = step(models, batch, generator=gen, voxel_topo=topo, voxel_static=static)
        assert torch.isfinite(m["train/loss"])

    run()  # the kernels' build
    torch.cuda.synchronize()
    trace.reset()
    run()
    off = trace.totals()["spans"]["off"]
    assert off["voxel.lookup"]["count"] == 2 and off["voxel.lookup"]["stream_s"] is None
    trace.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        run()
        torch.cuda.synchronize()
    totals = trace.totals()
    on = totals["spans"]["on"]
    assert totals["spans"]["off"] == {}
    assert on["train.step"]["count"] == 1 and on["train.optim"]["count"] == 2
    assert on["voxel.lookup"]["count"] == 2 and on["voxel.table_grad"]["count"] == 1
    for name in ("voxel.table", "voxel.lookup"):
        assert 0 < on[name]["stream_s"] < on["train.step"]["host_s"] + 1.0, name
    assert on["train.backward"]["stream_s"] is None
    launches = {**fm.launch_counts, **gather.launch_counts, **vg.build_counts}
    assert sum(launches.values()) == 7 and launches["fused_mlp_bwd"] == 2, launches
    assert launches["corner_lookup"] == 2 and launches["gather_rows"] == 0, launches


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
    """The voxel lookup of a prebuilt table is one `corner_lookup` launch
    and no `gather_rows`: the fused lookup took the place of the gather and
    the torch chain around it."""
    gather.reset_launch_counts()
    cfg, models, xyz, _, _, _, raw = _voxel_setup(cuda_device, 16, 32)
    assert raw.is_cuda and gather.launch_counts == {"gather_rows": 0, "corner_lookup": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [1, 37, 4097, 131072, 491520, 983040])
def test_corner_lookup_matches_plain_on_card(cuda_device, dtype, n):
    """The fused lookup against the plain chain on the card: samples inside,
    on the border and outside the grid on every side. The row index, the
    weights and the flag are the same f32 / int32 operations: bit-equal. The
    sums are within 1e-6 of their terms' magnitude (any order of the 8
    products is), and bit-equal while the kernel's order is that of ATen's
    reduction over the corner axis of the (N, 8, C) f32 product, which ATen
    does not promise to keep."""
    feats, topo, static = _small_grid(cuda_device)
    ct = vg.make_corner_table(feats, topo, static, lowp=dtype == torch.bfloat16)
    g = torch.Generator().manual_seed(n)
    xyz = (torch.rand(n, 3, generator=g) * 2.0 - 1.0).to(cuda_device)
    gather.reset_launch_counts()
    got = gather.corner_lookup(ct, xyz, topo, static, with_addressing=True)
    eval_out, eval_inv = gather.corner_lookup(ct, xyz, topo, static)
    want = gather.corner_lookup_plain(ct, xyz, topo, static, with_addressing=True)
    torch.cuda.synchronize()
    assert gather.launch_counts == {"gather_rows": 0, "corner_lookup": 2}
    out, inv, flat, wts = got
    assert out.dtype == torch.float32 and out.shape == (n, 24) and inv.dtype == torch.bool
    assert torch.equal(flat, want[2]) and torch.equal(inv, want[1])
    assert torch.equal(wts.view(torch.int32), want[3].view(torch.int32))
    assert torch.equal(eval_out, out) and torch.equal(eval_inv, inv)
    rows = ct[flat.long()].reshape(n, 8, static.channels).float().abs()
    magnitude = (rows * wts.abs()[..., None]).sum(1)
    gap = (out - want[0]).abs()
    assert (gap <= 1e-6 * magnitude).all(), (
        f"sums off by up to {(gap / magnitude.clamp_min(1e-30)).max().item():.2e} of their "
        f"terms' magnitude (tolerance 1e-6)")
    assert torch.equal(out, want[0]), (
        f"{int((out != want[0]).sum())} sums differ in their last bits (at most "
        f"{(gap / magnitude.clamp_min(1e-30)).max().item():.2e} of their terms' magnitude, "
        f"within 1e-6): ATen now reduces the (N, 8, C) product in another order than "
        f"corner_lookup_kernel's sum, which copies it")
    if n > 1000:
        assert 0 < int(inv.sum()) < n


@pytest.mark.cuda
def test_corner_lookup_makes_no_host_sync_on_card(cuda_device):
    """A frame's lookups, a step's (under autograd, with the addressing) and
    the plain chain's, once its grid's shape tensor is made, under
    `torch.cuda.set_sync_debug_mode("error")`: none synchronises the host
    with the card. Uploading that shape does, which shows that the mode
    catches it (the plain chain made it on every call before it was kept)."""
    feats, topo, static = _small_grid(cuda_device)
    xyz = (torch.rand(4096, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1).to(
        cuda_device)
    frame = vg.CornerTable(feats, topo, static, lowp=True)
    step = vg.CornerTable(feats.clone().requires_grad_(), topo, static, lowp=True)
    frame.lookup(xyz)  # the build of the kernel library, outside the checked region
    gather.corner_lookup_plain(frame.ct, xyz, topo, static)  # its shape tensor, made once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            out, _ = frame.lookup(xyz)
        out_t, _, flat, wts = step.lookup(xyz, with_addressing=True)
        gather.corner_lookup_plain(frame.ct, xyz, topo, static)
        with pytest.raises(RuntimeError):
            torch.tensor(static.shape, dtype=torch.int32, device=cuda_device)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(out, out_t.detach()) and out_t.requires_grad


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
@pytest.mark.parametrize("n", [1, 63, 129, 132 * 128 + 5])
@pytest.mark.parametrize("mode", ["combined", "split_polysin"])
def test_pe_probe_ragged_rows_on_card(cuda_device, mode, n):
    """Fewer rows than a warpgroup (its other warpgroup and the rest of the
    grid empty), one tile and a row, more tiles than SMs and a tail; a
    relaunch is bit-equal."""
    x, s, trunk = _probe_inputs(cuda_device, n, seed=6)
    packed = probes.pack_probe_trunk(trunk)
    got = probes.pe_probe(x, *s, trunk, mode, packed=packed)
    again = probes.pe_probe(x, *s, trunk, mode, packed=packed)
    want = probes.pe_probe_plain(x, *s, trunk, mode)
    torch.cuda.synchronize()
    assert got.shape == (n, 1) and torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert _rel(got, want) < PROBE_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(983040, 24), (1001,), (3, 5)])
def test_scale_copy_doubles_on_card(cuda_device, shape):
    x = torch.randn(*shape, device=cuda_device)
    got = probes.scale_copy(x)
    torch.cuda.synchronize()
    assert torch.equal(got, probes.scale_copy_plain(x))


# -- the forward chain of fused_mlp_eval and fused_render_tiles ---------------------


def _chain_setup(device, voxel, n, s):
    """A fine model (scene densities raised clear of 0), n rays of s samples,
    their direction encoding, codes and, for the voxel model, the raw features
    of the real lookup."""
    if voxel:
        cfg, models, xyz, z, dir_pe, codes, raw = _voxel_setup(device, n, s, seed=7)
        return cfg, models.nerf_fine, xyz, z, dir_pe, codes, raw
    cfg = ObjectNeRFConfig(use_voxel_embedding=False)
    models = init_params(torch.Generator().manual_seed(0),
                         RenderSettings(mlp=cfg, perturb=0.0, noise_std=0.0), {},
                         device=device)
    with torch.no_grad():
        models.nerf_fine.sigma.bias += 1.0
    g = torch.Generator().manual_seed(7)
    z = torch.sort(0.5 + 4.0 * torch.rand(n, s, generator=g), -1).values
    o, d = torch.randn(n, 3, generator=g) * 0.3, torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    xyz = (o[:, None] + d[:, None] * z[..., None]).contiguous().to(device)
    dir_pe = freq_encode(d, cfg.N_freq_dir).contiguous().to(device)
    codes = torch.randn(n, cfg.N_obj_code_length, generator=g).to(device)
    return cfg, models.nerf_fine, xyz, z.contiguous().to(device), dir_pe, codes, None


@pytest.mark.cuda
@pytest.mark.parametrize("voxel", [False, True], ids=["classical", "voxel"])
@pytest.mark.parametrize("s,n", [(128, 1), (128, 3), (64, 301), (32, 4133)])
def test_forward_chain_matches_plain_bf16_on_card(cuda_device, voxel, s, n):
    """Both kernels on the chain against their bf16 plain versions: S = 128
    (one ray over both consumer warpgroups), fewer rays than SMs (1 and 3
    tiles), a ragged last tile over more tiles than SMs (151 and 1034 tiles,
    several per block); `fused_mlp_eval` with both branches, the scene alone
    and the object alone with weights packed beforehand (the edit call), the
    render with and without the instance branch; relaunches bit-equal."""
    cfg, model, xyz, z, dir_pe, codes, raw = _chain_setup(cuda_device, voxel, n, s)
    fm.reset_launch_counts()
    with torch.no_grad():
        packed = fc.pack_kernel_weights(model, cfg, True)
        for fi, cs in ((True, True), (False, True), (True, False)):
            got = fv.fused_mlp_eval(model, cfg, xyz, dir_pe, codes, raw, fi, cs, packed=packed)
            want = fv.mlp_eval_plain(model, cfg, xyz, dir_pe, codes, fi, cs, voxel_raw=raw)
            for a, b in zip(got, want):
                assert a.shape == b.shape
                assert (a - b).abs().max().item() < FWD_TOL, (fi, cs)
            again = fv.fused_mlp_eval(model, cfg, xyz, dir_pe, codes, raw, fi, cs,
                                      packed=packed)
            assert all(torch.equal(a, b) for a, b in zip(got, again))
        for fi in (True, False):
            got = fm.fused_render_tiles(model, cfg, xyz, z, dir_pe, codes, raw, fi,
                                        want_weights=True, packed=packed)
            want = fm.render_tiles_plain(model, cfg, xyz, z, dir_pe, codes, raw, fi,
                                         want_weights=True)
            assert set(got) == set(want)
            for k in want:
                assert (got[k] - want[k]).abs().max().item() < FWD_TOL, (fi, k)
            again = fm.fused_render_tiles(model, cfg, xyz, z, dir_pe, codes, raw, fi,
                                          want_weights=True, packed=packed)
            assert all(torch.equal(got[k], again[k]) for k in got)
    torch.cuda.synchronize()
    assert fm.launch_counts["fused_mlp_eval"] == 6
    assert fm.launch_counts["fused_render_tiles"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("voxel", [False, True], ids=["classical", "voxel"])
@pytest.mark.parametrize("s,n", [(128, 1), (64, 301), (32, 4133)])
def test_forward_chain_sigma_modes_match_plain_bf16_on_card(cuda_device, voxel, s, n):
    """The chain's modes that stop at the sigma head against their bf16
    plain versions at the render test's shapes: `fused_coarse_weights` (the
    last delta 1e10 and 0), and `fused_sigma_eval` on the same n * s points,
    both branches, a code per 1, 5, 64 and all of them (runs that straddle
    the warpgroups' 64 rows and the tiles); relaunches bit-equal."""
    cfg, model, xyz, z, _, _, raw = _chain_setup(cuda_device, voxel, n, s)
    pts, n_pts = xyz.reshape(-1, 3), n * s
    raw_p = None if raw is None else raw.reshape(n_pts, -1)
    g = torch.Generator().manual_seed(3)
    fm.reset_launch_counts()
    with torch.no_grad():
        for last in (True, False):
            got = fm.fused_coarse_weights(model, cfg, xyz, z, raw, last)
            want = fm.coarse_weights_plain(model, cfg, xyz, z, raw, last)
            assert (got - want).abs().max().item() < FWD_TOL, last
            assert torch.equal(got, fm.fused_coarse_weights(model, cfg, xyz, z, raw, last))
        for per_row in (1, 5, 64, n_pts):
            if n_pts % per_row:
                continue
            codes = torch.randn(n_pts // per_row, cfg.N_obj_code_length, generator=g)
            codes = codes.to(cuda_device)
            for branch in fs.BRANCHES:
                got = fs.fused_sigma_eval(model, cfg, pts, codes, branch, per_row, raw_p)
                want = fs.sigma_eval_plain(model, cfg, pts, codes, branch, per_row, raw_p)
                assert (got - want).abs().max().item() < FWD_TOL, (per_row, branch)
                again = fs.fused_sigma_eval(model, cfg, pts, codes, branch, per_row, raw_p)
                assert torch.equal(got, again), (per_row, branch)
    torch.cuda.synchronize()
    assert fm.launch_counts["fused_coarse_weights"] == 4


# (samples, rays) per mode: a ragged last tile at S = 32 and 64 (1033.25 and
# 150.5 tiles); at S = 128 a tile is one ray, and 133 tiles put two on one SM
MODE_SHAPES = [(32, 4133), (64, 301), (128, 133)]


@pytest.mark.cuda
@pytest.mark.parametrize("voxel", [False, True], ids=["classical", "voxel"])
@pytest.mark.parametrize("mode", fc.CHAIN_MODES)
@pytest.mark.parametrize("s,n", MODE_SHAPES)
def test_forward_chain_each_mode_on_card(cuda_device, voxel, mode, s, n):
    """Each of the chain's five modes alone, classical and voxel, at S = 32,
    64 and 128: within FWD_TOL of its plain version, and a relaunch on the
    same inputs bit-equal (the point-wise modes over the n * s points, a code
    per run of s)."""
    cfg, model, xyz, z, dir_pe, codes, raw = _chain_setup(cuda_device, voxel, n, s)
    pts, n_pts = xyz.reshape(-1, 3), n * s
    raw_p = None if raw is None else raw.reshape(n_pts, -1)
    with torch.no_grad():
        if mode == "eval":
            packed = fc.pack_kernel_weights(model, cfg, True)

            def run():
                return fv.fused_mlp_eval(model, cfg, xyz, dir_pe, codes, raw, packed=packed)
            want = fv.mlp_eval_plain(model, cfg, xyz, dir_pe, codes, voxel_raw=raw)
        elif mode == "render":
            packed = fc.pack_kernel_weights(model, cfg, True)

            def run():
                out = fm.fused_render_tiles(model, cfg, xyz, z, dir_pe, codes, raw,
                                            want_weights=True, packed=packed)
                return [out[k] for k in sorted(out)]
            want = fm.render_tiles_plain(model, cfg, xyz, z, dir_pe, codes, raw,
                                         want_weights=True)
            want = [want[k] for k in sorted(want)]
        elif mode == "weights":
            def run():
                return [fm.fused_coarse_weights(model, cfg, xyz, z, raw)]
            want = [fm.coarse_weights_plain(model, cfg, xyz, z, raw)]
        else:
            branch = "scene" if mode == "sigma_scene" else "instance"

            def run():
                return [fs.fused_sigma_eval(model, cfg, pts, codes, branch, s, raw_p)]
            want = [fs.sigma_eval_plain(model, cfg, pts, codes, branch, s, raw_p)]
        got, again = run(), run()
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() < FWD_TOL
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("voxel", [False, True], ids=["classical", "voxel"])
def test_forward_chain_ring_depth_on_card(cuda_device, voxel):
    """The built library's layout of every instantiation is the mirror's of
    tests/test_torch_fwd_chain.py (RING_STAGES), within a block's shared
    memory, and the voxel eval and render rings hold at least 4 stages."""
    from test_torch_fwd_chain import RING_STAGES  # the layout mirror, tests/ on sys.path

    for mode in fc.CHAIN_MODES:
        stages, smem = fc.chain_layout(voxel, mode)
        assert stages == RING_STAGES[mode][int(voxel)], mode
        assert 0 < smem <= 232448, mode
    for mode in ("eval", "render"):
        assert fc.chain_layout(voxel, mode)[0] >= (4 if voxel else 7)


@pytest.mark.cuda
def test_forward_chain_build_on_card(cuda_device):
    """The chain's ten instantiations (fwd_chain_kernel<VOX, MODE>, MODE 0-4:
    fused_mlp_eval, fused_render_tiles, fused_coarse_weights and
    fused_sigma_eval's scene and object branch, classical and voxel) issue
    wgmma (HGMMA) and TMA loads (UTMALDG) in their machine code, and ptxas
    serialized none of their wgmma (C7510: the pipeline crosses a call;
    C7512: too few registers; C7515: other instructions define accumulator
    registers inside it) nor spilled a register."""
    import re
    import shutil
    import subprocess

    from object_nerf_torch.ops import _build

    _build.load_library()
    current = None
    for line in _build.library_path().with_suffix(".log").read_text().splitlines():
        if any(code in line for code in ("(C7510)", "(C7512)", "(C7515)")):
            assert "fwd_chain_kernel" not in line, line
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([^' ]+)", line)
        if m:
            current = m.group(1) if "fwd_chain_kernel" in m.group(1) else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if current is not None and m:
            assert m.groups() == ("0", "0"), (current, line)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.library_path())], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    names = [f"fwd_chain_kernelILb{vox}ELi{mode}E" for vox in (0, 1) for mode in range(5)]
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((k for k in names if k in line), None)
            if current is not None:
                counts[current] = {"HGMMA": 0, "UTMALDG": 0}
        elif current is not None:
            for op in counts[current]:
                counts[current][op] += op in line
    assert len(counts) == len(names), counts
    for k, c in counts.items():
        assert c["HGMMA"] > 0 and c["UTMALDG"] > 0, (k, c)


@pytest.mark.cuda
def test_sincosf_is_sinf_and_cosf_on_card(cuda_device):
    """The chain takes both values of an encoded pair from one full-precision
    sincosf: it must give sinf's and cosf's bits, at the encodings' scale
    (xyz times up to 2^9, voxel features times up to 2^5) and beyond."""
    g = torch.Generator().manual_seed(11)
    x = torch.cat([torch.randn(1 << 20, generator=g) * s for s in (1.0, 30.0, 600.0, 2e4)])
    assert fc.sincos_mismatches(x.to(cuda_device)) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("voxel", [False, True], ids=["classical", "voxel"])
def test_route_coarse_pass_matches_plain_bf16_on_card(cuda_device, voxel):
    """`fused_mlp_eval` as the rays_in_bbox eval chunk calls it: 7680 rays x
    64 samples, both branches, the frame's packed inference weights."""
    n, s = 7680, 64
    if voxel:
        cfg, models, xyz, _, dir_pe, codes, raw = _voxel_setup(cuda_device, n, s)
    else:
        cfg = ObjectNeRFConfig(use_voxel_embedding=False)
        models = init_params(torch.Generator().manual_seed(0),
                             RenderSettings(mlp=cfg, perturb=0.0, noise_std=0.0), {},
                             device=cuda_device)
        g = torch.Generator().manual_seed(5)
        z = torch.sort(0.5 + 4.0 * torch.rand(n, s, generator=g), -1).values
        o, d = torch.randn(n, 3, generator=g) * 0.3, torch.randn(n, 3, generator=g)
        d = d / d.norm(dim=-1, keepdim=True)
        xyz = (o[:, None] + d[:, None] * z[..., None]).contiguous().to(cuda_device)
        dir_pe = freq_encode(d, cfg.N_freq_dir).contiguous().to(cuda_device)
        codes = torch.randn(n, cfg.N_obj_code_length, generator=g).to(cuda_device)
        raw = None
    fm.reset_launch_counts()
    with torch.no_grad():
        packed = fc.pack_kernel_weights(models.nerf_coarse, cfg, forward_instance=True)
        got = fv.fused_mlp_eval(models.nerf_coarse, cfg, xyz, dir_pe, codes, voxel_raw=raw,
                                packed=packed)
        want = fv.mlp_eval_plain(models.nerf_coarse, cfg, xyz, dir_pe, codes, voxel_raw=raw)
    torch.cuda.synchronize()
    assert fm.launch_counts["fused_mlp_eval"] == 1
    for name, a, b in zip(("sigma", "rgb", "inst_sigma", "inst_rgb"), got, want):
        assert a.abs().max().item() > 0, name
        assert (a - b).abs().max().item() < FWD_TOL, name


@pytest.mark.cuda
def test_route_eval_chunk_matches_plain_on_card(cuda_device):
    """The rays_in_bbox eval chunk through the kernels (`fused_mlp_eval` for
    the coarse pass, `fused_render_tiles` for the fine) against
    `render_rays_plain` with bf16 operands; no `fused_coarse_weights`."""
    from object_nerf_torch.render.renderer import render_rays_fused_eval, render_rays_plain
    from object_nerf_torch.train.metrics import psnr

    cfg = ObjectNeRFConfig(use_voxel_embedding=False)
    settings = RenderSettings(mlp=cfg, perturb=0.0, noise_std=0.0, is_eval=True,
                              rays_in_bbox=True)
    models = init_params(torch.Generator().manual_seed(0), settings, {}, device=cuda_device)
    with torch.no_grad():
        for m in (models.nerf_coarse, models.nerf_fine):
            m.sigma.bias += 1.0  # densities clear of the last sample's step at 0
            m.instance_sigma.bias += 1.0  # the route's pdf is the object's
    g = torch.Generator().manual_seed(2)
    n = 4096
    o, d = torch.randn(n, 3, generator=g) * 0.2, torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    near = 0.3 + torch.rand(n, 1, generator=g)
    rays = torch.cat([o, d, near, near + 1.0 + torch.rand(n, 1, generator=g)], -1)
    rays[:100, 6:] = 0.0  # rays that miss the box: near = far = 0
    rays = rays.to(cuda_device)
    codes = models.code_library(torch.randint(0, 64, (n,), generator=g).to(cuda_device))
    packed = {"coarse": fc.pack_kernel_weights(models.nerf_coarse, cfg, True),
              "fine": fc.pack_kernel_weights(models.nerf_fine, cfg, True)}
    fm.reset_launch_counts()
    with torch.no_grad():
        got = render_rays_fused_eval(models, rays, settings, codes, packed)
    torch.cuda.synchronize()
    assert fm.launch_counts == {"fused_coarse_weights": 0, "fused_render_tiles": 1,
                                "fused_mlp_eval": 1, "fused_mlp_bwd": 0, "fused_sigma_eval": 0}
    with torch.no_grad():
        want = render_rays_plain(models, rays, settings, codes, matmul_dtype=torch.bfloat16)
    for k, v in got.items():
        assert torch.isfinite(v).all(), k
    assert psnr(got["rgb_fine"], want["rgb_fine"]).item() >= 70.0
    assert (got["opacity_instance_fine"] - want["opacity_instance_fine"]).abs().max() < 5e-3


@pytest.mark.cuda
def test_two_gloo_ranks_match_one_process_on_card(cuda_device, tmp_path, capsys):
    """`python -m object_nerf_torch.parallel.dryrun --nprocs 2 --device cuda
    --backend gloo`: two ranks on the card, at the kernels' widths, against
    one process, to chip_smoke.py phase 27's limits (`dryrun.LIMITS["cuda"]`:
    the first step's loss within 1e-3 and every summed gradient within 5e-3
    of its largest entry, frames bit-equal or 40 dB; grids equal), both ranks
    bit-equal in everything they return."""
    from object_nerf_torch.parallel import dryrun

    assert dryrun.main(["--nprocs", "2", "--device", "cuda", "--backend", "gloo",
                        "--out", str(tmp_path)]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("dryrun(2): OK")
