"""Voxel training in the port against the JAX package, on the CPU.

* The training op with the voxel operand (object_nerf_torch/ops/
  fused_mlp_vjp.py): `mlp_eval_plain(voxel_raw=)` against the Pallas forward
  kernel in interpret mode, `mlp_bwd_plain` (weights, d_codes, d_voxel_raw)
  against the Pallas backward kernel in interpret mode and against torch
  autograd, and the backward kernel's voxel dataflow (the input tile in the
  block's workspace staged 128 columns at a time, the input gradient reduced
  128 columns at a time through the encoding's chain) emulated at flagship
  width against the bf16 plain version.
* The table gradient (models/voxel_grid.py): `corner_table_transpose` and
  one table read by two lookups against the JAX split step's P8.
* One voxel train step against `jax.grad` of the XLA path and the JAX split
  step (Pallas kernels in interpret mode, f32) on the same weights, batch and
  draws; prune and subdivide against the JAX package; the epoch hooks; a
  checkpoint round trip after a subdivision.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_nerf_tpu.models import voxel_grid as jvg
from object_nerf_tpu.models.code_library import lookup_codes
from object_nerf_tpu.models.embedding import freq_encode as jfreq_encode
from object_nerf_tpu.models.mlp import ObjectNeRFConfig as JaxConfig
from object_nerf_tpu.models.mlp import init_object_nerf, scene_forward
from object_nerf_tpu.ops import pallas_mlp as jk
from object_nerf_tpu.ops.pallas_mlp_vjp import _run_bwd
from object_nerf_tpu.render.renderer import RenderSettings as JaxSettings
from object_nerf_tpu.render.renderer import render_rays as jax_render_rays
from object_nerf_tpu.train import optim as jo
from object_nerf_tpu.train.losses import total_loss as jax_total_loss
from object_nerf_tpu.train.split_step import make_split_train_step
from object_nerf_tpu.train.system import TrainState

from object_nerf_torch.config import load_config
from object_nerf_torch.data import dataset_dict
from object_nerf_torch.models import voxel_grid as vg
from object_nerf_torch.models.embedding import freq_encode
from object_nerf_torch.models.mlp import ObjectNeRF, ObjectNeRFConfig, embed_inputs
from object_nerf_torch.ops import fused_mlp as fm
from object_nerf_torch.ops import fused_mlp_vjp as fv
from object_nerf_torch.ops import fused_sigma as fs
from object_nerf_torch.ops import fwd_chain as fc
from object_nerf_torch.render.renderer import RenderSettings
from object_nerf_torch.train import optim as to
from object_nerf_torch.train.checkpoint import save_checkpoint
from object_nerf_torch.train.convert import from_jax_grads, from_jax_params, voxel_from_jax
from object_nerf_torch.train.system import ObjectNeRFModels, ObjectNeRFSystem, make_train_step

from _torch_port import CFG_JAX, N_OBJS, SMALL, jax_params, to_numpy
from test_torch_train_render import jax_draws, port_draws

torch.set_num_threads(2)

# -- the training op with the voxel operand ---------------------------------------

OP = dict(D=3, W=32, skips=(1,), inst_D=2, inst_W=16, inst_skips=(1,),
          use_voxel_embedding=True, N_obj_code_length=8, N_freq_xyz=4, N_freq_dir=2,
          N_freq_voxel=2)
OP_JAX, OP_CFG = JaxConfig(**OP), ObjectNeRFConfig(**OP)
N, S, C_VOX = 6, 8, 24
# f32 forward: the JAX kernel's encodings are sin(x @ S + phase) (cos as
# sin(t + pi/2)), ~1e-6 off sin / cos at these frequencies
FWD_ATOL = 2e-5
# gradients, per tensor, relative to its largest entry (tests/test_pallas_vjp.py:95)
GRAD_REL = 5e-4


def _op_inputs(seed=1, n=N, s=S):
    rng = np.random.RandomState(seed)
    xyz = (rng.randn(n, s, 3) * 0.3).astype(np.float32)
    dirs = rng.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dir_pe = np.asarray(jfreq_encode(jnp.asarray(dirs), OP_CFG.N_freq_dir))
    codes = (rng.randn(n, OP_CFG.N_obj_code_length) * 0.2).astype(np.float32)
    # trilinear blends of N(0, 1) features; a fifth of the samples outside (0)
    raw = (rng.randn(n, s, C_VOX) * (rng.rand(n, s, 1) > 0.2)).astype(np.float32)
    g = rng.randn(n * s, 8).astype(np.float32)
    return xyz, dir_pe, codes, raw, g


def _op_models(seed=0):
    params = init_object_nerf(jax.random.PRNGKey(seed), OP_JAX)
    sd = from_jax_params({"coarse": jax.tree_util.tree_map(np.asarray, params)})
    model = ObjectNeRF(OP_CFG)
    model.load_state_dict({k.removeprefix("nerf_coarse."): v for k, v in sd.items()})
    return params, model


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-8)


def _split_g(g, n=N, s=S):
    g = g.reshape(n, s, 8)
    return g[..., 0], g[..., 1:4], g[..., 4], g[..., 5:8]


@pytest.mark.parametrize("forward_instance,compute_scene",
                         [(True, True), (False, True), (True, False)])
def test_voxel_mlp_eval_plain_matches_jax_kernel(forward_instance, compute_scene):
    params, model = _op_models()
    xyz, dir_pe, codes, raw, _ = _op_inputs()
    want = jk.fused_mlp_eval(params, OP_JAX, jnp.asarray(xyz), jnp.asarray(dir_pe),
                             jnp.asarray(codes), forward_instance=forward_instance,
                             compute_scene=compute_scene, voxel_raw=jnp.asarray(raw),
                             rays_per_tile=2, dtype=jnp.float32, interpret=True)
    fm.reset_launch_counts()
    with torch.no_grad():
        got = fv.fused_mlp_eval(model, OP_CFG, _t(xyz), _t(dir_pe), _t(codes),
                                voxel_raw=_t(raw), forward_instance=forward_instance,
                                compute_scene=compute_scene, dtype=torch.float32)
    assert sum(fm.launch_counts.values()) == 0  # CPU tensors: the plain version
    for name, a, b in zip(("sigma", "rgb", "inst_sigma", "inst_rgb"), got, want):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FWD_ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("forward_instance", [True, False])
def test_voxel_mlp_bwd_plain_matches_jax_bwd_kernel(forward_instance):
    params, model = _op_models(seed=1)
    xyz, dir_pe, codes, raw, g = _op_inputs(seed=2)
    d_params, d_codes, d_vox = _run_bwd(
        params, jnp.asarray(xyz), jnp.asarray(dir_pe), jnp.asarray(codes), jnp.asarray(raw),
        jnp.asarray(g), cfg=OP_JAX, forward_instance=forward_instance,
        bwd_rows_budget=2 * S, dtype=jnp.float32, interpret=True)
    sd = from_jax_grads({"coarse": jax.tree_util.tree_map(np.asarray, d_params)})
    want = {k.removeprefix("nerf_coarse."): v.numpy() for k, v in sd.items()}
    got, got_codes, got_vox = fv.mlp_bwd_plain(model, OP_CFG, _t(xyz), _t(dir_pe), _t(codes),
                                               _t(g), forward_instance, torch.float32,
                                               voxel_raw=_t(raw))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if np.abs(want[k]).max() == 0:
            assert float(got[k].abs().max()) == 0, k
        else:
            assert _rel(got[k].numpy(), want[k]) < GRAD_REL, k
    assert got_vox.shape == raw.shape and got_vox.dtype == torch.float32
    assert _rel(got_vox.numpy(), d_vox) < GRAD_REL
    if forward_instance:
        assert _rel(got_codes.numpy(), d_codes) < GRAD_REL
    else:
        assert float(got_codes.abs().max()) == 0 and float(got_vox[..., 16:].abs().max()) == 0


@pytest.mark.parametrize("forward_instance", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
def test_voxel_mlp_bwd_plain_matches_torch_autograd(forward_instance, dtype, tol):
    """The hand-derived backward, voxel chain included, against autograd of the
    plain forward (as tests/test_torch_fused_mlp_vjp.py holds the classical
    one); and `FusedMLP` on CPU tensors hands exactly the hand-derived
    d_voxel_raw to autograd."""
    _, model = _op_models(seed=3)
    xyz, dir_pe, codes, raw, g = (_t(a) for a in _op_inputs(seed=4))
    codes.requires_grad_()
    raw.requires_grad_()
    outs = fv.mlp_eval_plain(model, OP_CFG, xyz, dir_pe, codes, forward_instance, True, dtype,
                             voxel_raw=raw)
    model.zero_grad()
    sum((o * w).sum() for o, w in zip(outs, _split_g(g))).backward()
    got, got_codes, got_vox = fv.mlp_bwd_plain(model, OP_CFG, xyz, dir_pe, codes.detach(), g,
                                               forward_instance, dtype, voxel_raw=raw.detach())
    for k, p in model.named_parameters():
        if p.grad is None:
            assert float(got[k].abs().max()) == 0, k
        else:
            assert _rel(got[k].numpy(), p.grad.numpy()) < tol, k
    assert _rel(got_vox.numpy(), raw.grad.numpy()) < tol
    if forward_instance:
        assert _rel(got_codes.numpy(), codes.grad.numpy()) < tol
    if dtype == torch.float32:
        raw2 = raw.detach().clone().requires_grad_()
        outs = fv.fused_mlp_eval(model, OP_CFG, xyz, dir_pe, codes.detach(), voxel_raw=raw2,
                                 forward_instance=forward_instance, dtype=dtype)
        sum((o * w).sum() for o, w in zip(outs, _split_g(g))).backward()
        np.testing.assert_array_equal(raw2.grad.numpy(), got_vox.numpy())


# -- the backward kernel's voxel dataflow, emulated at flagship width --------------


def _emulate_vox_bwd(packed, cfg, xyz, dir_pe, codes, raw, g):
    """csrc/fused_mlp_train.cu's VOX backward in tensor code over the packed
    buffers, for d_codes and d_voxel_raw: tiles of 128 rows of whole rays,
    the input tile [svox | PE(svox) | xyz | PE(xyz) | ivox | PE(ivox) | code]
    in bf16, the trunk recomputed and swept back, and the input gradient of
    layer 0 and the skip layers of both branches reduced 128 columns at a
    time by `reduce_input_grad`'s column mapping."""
    n, s, _ = xyz.shape
    rpt = 128 // s
    w, b = packed.w.float(), packed.b
    c_s, c_i, nf = cfg.N_scn_voxel_size, cfg.N_obj_voxel_size, cfg.N_freq_voxel
    cv, code_len = c_s + c_i, cfg.N_obj_code_length
    o_ivox = c_s * (1 + 2 * nf) + cfg.xyz_pe_size
    o_code = o_ivox + c_i * (1 + 2 * nf)
    d_vox = torch.zeros(n * s, cv)
    d_codes = torch.zeros(n, code_len)

    def bf(x):
        return x.bfloat16().float()

    def lrelu(x):
        return torch.where(x >= 0, x, 0.01 * x)

    def slope(act, d):
        return torch.where(act >= 0, d, 0.01 * d)

    def mat(off, rows, cols):
        return w[off:off + rows * cols].reshape(rows, cols)

    def branch_dcats(tab, width, X, dirs, gs, gr):
        """[(layer offset of the input rows, G)] of the layers that read X."""
        k0, depth, nd = tab[fc.T_K0], tab[fc.T_DEPTH], width // 2
        skips = [i for i in range(depth) if (tab[fc.T_SKIPS] >> i) & 1]
        hs, h = [], None
        for i in range(depth):
            off = tab[fc.T_TW + i]
            if i == 0:
                acc = X[:, :k0] @ mat(off, k0, width)
            elif i in skips:
                acc = X[:, :k0] @ mat(off, k0, width) + h @ mat(off + k0 * width, width, width)
            else:
                acc = h @ mat(off, width, width)
            h = bf(lrelu(acc + b[tab[fc.T_TB + i]:tab[fc.T_TB + i] + width]))
            hs.append(h)
        hf = bf(h @ mat(tab[fc.T_FINW], width, width) + b[tab[fc.T_FINB]:tab[fc.T_FINB] + width])
        wdd = mat(tab[fc.T_DIRWD], fc.MAX_DIR, nd)
        dbias = bf(dirs) @ wdd[:dirs.shape[1]] + b[tab[fc.T_DIRB]:tab[fc.T_DIRB] + nd]
        denc = bf(lrelu(hf @ mat(tab[fc.T_DIRWH], width, nd) + dbias.repeat_interleave(s, 0)))
        w_rgb = mat(tab[fc.T_RGBW], 3, nd)
        rgb = torch.sigmoid(denc @ w_rgb.t() + b[tab[fc.T_RGBB]:tab[fc.T_RGBB] + 3])
        G = bf(slope(denc, bf(gr * rgb * (1 - rgb)) @ w_rgb))
        G = bf(G @ mat(tab[fc.T_DIRWH], width, nd).t())
        w_sig = w[tab[fc.T_SIGW]:tab[fc.T_SIGW] + width]
        d_h = G @ mat(tab[fc.T_FINW], width, width).t() + bf(gs) * w_sig[None, :]
        out = []
        for i in reversed(range(depth)):
            G = bf(slope(hs[i], d_h))
            off = tab[fc.T_TW + i]
            if i == 0 or i in skips:
                out.append((off, G))
                if i == 0:
                    break
                off += k0 * width
            d_h = G @ mat(off, width, width).t()
        return out, k0

    def reduce(D, c0, wid, br, rows_raw, dv, pr):
        """`reduce_input_grad`: columns [c0, c0 + wid) of one layer's input
        gradient into the d_vox tile and the per-ray code sums."""
        for ch in range(cv):
            inst = ch >= c_s
            if inst and br == 0:
                continue
            C, q = (c_i, ch - c_s) if inst else (c_s, ch)
            base = o_ivox if inst else 0
            acc = torch.zeros(128)
            if c0 <= base + q < c0 + wid:
                acc += D[:, base + q - c0]
            x = rows_raw[:, ch]
            for k in range(nf):
                cs = base + C + 2 * C * k + q
                f = float(2 ** k)
                if c0 <= cs < c0 + wid:
                    acc += D[:, cs - c0] * (f * torch.cos(x * f))
                if c0 <= cs + C < c0 + wid:
                    acc -= D[:, cs + C - c0] * (f * torch.sin(x * f))
            dv[:, ch] += acc
        if br == 1:
            for c in range(code_len):
                if c0 <= o_code + c < c0 + wid:
                    pr[:, c] += D[:, o_code + c - c0].reshape(rpt, s).sum(1)

    n_tiles = -(-n // rpt)
    for tile in range(n_tiles):
        lo, hi = tile * rpt, min((tile + 1) * rpt, n)
        real = (hi - lo) * s
        emb, ivox = embed_inputs(cfg, xyz[lo:hi].reshape(-1, 3), raw[lo:hi])
        X = torch.zeros(128, fc.OBJ_K0_VOX)
        X[:real] = torch.nn.functional.pad(
            torch.cat([emb, ivox, codes[lo:hi].repeat_interleave(s, 0)], -1),
            (0, fc.OBJ_K0_VOX - cfg.inst_channel_in))
        X = bf(X)
        rows_raw = torch.zeros(128, cv)
        rows_raw[:real] = raw[lo:hi].reshape(-1, cv)
        dirs = torch.zeros(rpt, dir_pe.shape[1])
        dirs[:hi - lo] = dir_pe[lo:hi]
        gt = torch.zeros(128, 8)
        gt[:real] = g[lo * s:hi * s]
        dv, pr = torch.zeros(128, cv), torch.zeros(rpt, code_len)
        for br, (tab, width, gsl) in enumerate(((packed.scene, fc.SCENE_W, slice(0, 4)),
                                                (packed.obj, fc.OBJ_W, slice(4, 8)))):
            layers, k0 = branch_dcats(tab, width, X, dirs, gt[:, gsl][:, :1], gt[:, gsl][:, 1:])
            hi_col = c_s * (1 + 2 * nf) if br == 0 else o_code + code_len
            for off, G in layers:
                for c0 in range(0, min(hi_col, k0), 128):
                    wid = min(128, k0 - c0)
                    D = G @ mat(off + c0 * width, wid, width).t()
                    reduce(D, c0, wid, br, rows_raw, dv, pr)
        d_vox[lo * s:hi * s] = dv[:real]
        d_codes[lo:hi] = pr[:hi - lo]
    return d_codes, d_vox.reshape(n, s, cv)


def test_backward_voxel_dataflow_reproduces_plain_bf16():
    """5 rays of 64 samples at the flagship voxel width (branch inputs of 271
    and 439 columns read as 320 and 448): three tiles, the last one half
    empty. d_codes and d_voxel_raw against `mlp_bwd_plain` in bf16, relative
    to the largest entry: both round the same operands to bf16 and run the
    chain in f32; the sums run in another order (per 128-column chunk and
    per layer here, over the whole input gradient there). A column of the
    wrong piece or octave is off by O(1)."""
    cfg = ObjectNeRFConfig()
    model = ObjectNeRF(cfg).reset_parameters_(torch.Generator().manual_seed(0))
    n, s = 5, 64
    gen = torch.Generator().manual_seed(1)
    z = torch.sort(0.5 + 4.0 * torch.rand(n, s, generator=gen), -1).values
    o, d = torch.randn(n, 3, generator=gen) * 0.2, torch.randn(n, 3, generator=gen)
    d = d / d.norm(dim=-1, keepdim=True)
    xyz = (o[:, None] + d[:, None] * z[..., None]).contiguous()
    dir_pe = freq_encode(d, cfg.N_freq_dir)
    codes = torch.randn(n, cfg.N_obj_code_length, generator=gen)
    raw = torch.randn(n, s, C_VOX, generator=gen) * (torch.rand(n, s, 1, generator=gen) > 0.2)
    g = torch.randn(n * s, 8, generator=gen) * 1e-3
    with torch.no_grad():
        packed = fc.pack_kernel_weights(model, cfg, True)
        got_codes, got_vox = _emulate_vox_bwd(packed, cfg, xyz, dir_pe, codes, raw, g)
        _, want_codes, want_vox = fv.mlp_bwd_plain(model, cfg, xyz, dir_pe, codes, g, True,
                                                   voxel_raw=raw)
    assert _rel(got_vox.numpy(), want_vox.numpy()) < 5e-3
    assert _rel(got_codes.numpy(), want_codes.numpy()) < 5e-3
    assert float(want_vox[..., 16:].abs().max()) > 0  # the instance piece has a gradient


# -- the table gradient ----------------------------------------------------------------


def _jgrid(seed=0, cap=5000):
    pcd = np.random.RandomState(seed).rand(300, 3) * 2.0 - 1.0
    j = jvg.build_voxel_grid(pcd, scene_center=[0, 0, 0], scale_factor=1.0,
                             voxel_size_world=0.4, neighbor_marks=3, channels=24,
                             n_freq_voxel=2, n_max_voxels=cap, key=jax.random.PRNGKey(seed))
    port = voxel_from_jax(np.asarray(j[0]), {k: np.asarray(v) for k, v in j[1]._asdict().items()},
                          dataclasses.asdict(j[2]))
    return j, port


def test_corner_table_transpose_matches_jax():
    (_, jt, js), (_, t, s) = _jgrid()
    n_rows = (s.shape[0] + 1) * (s.shape[1] + 1) * (s.shape[2] + 1)
    d_ct = np.random.RandomState(2).randn(n_rows, 8 * 24).astype(np.float32)
    want = jvg.corner_table_transpose(jnp.asarray(d_ct), jt.row_to_cell, js)
    got = vg.corner_table_transpose(torch.from_numpy(d_ct), t.row_to_cell, s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert (got[int(t.n_occupied):] == 0).all()  # rows of no cell


@pytest.mark.parametrize("lowp", [False, True])
def test_one_table_two_lookups_match_the_jax_split_step(lowp):
    """A step's table read by two lookups (the coarse and the fine samples):
    its gradient is the JAX split step's P8 (split_step.py:242-271): one
    segment-sum over the concatenated samples, then the transpose; one build
    counted."""
    (jf, jt, js), (f, t, s) = _jgrid(seed=1)
    rng = np.random.RandomState(3)
    pts = [(rng.rand(m, 3) * 2.4 - 1.2).astype(np.float32) for m in (64, 96)]
    cots = [rng.randn(len(p), 24).astype(np.float32) for p in pts]
    rows, flats = [], []
    for p, c in zip(pts, cots):
        _, _, flat, wts = jvg.voxel_lookup_dense(jf, jt, js, jnp.asarray(p), with_addressing=True)
        rows.append((jnp.asarray(c)[:, None, :] * wts[:, :, None]).reshape(-1, 8 * 24))
        flats.append(flat)
    n_rows = (js.shape[0] + 1) * (js.shape[1] + 1) * (js.shape[2] + 1)
    d_ct = jax.ops.segment_sum(jnp.concatenate(rows), jnp.concatenate(flats),
                               num_segments=n_rows)
    want = np.asarray(jvg.corner_table_transpose(d_ct, jt.row_to_cell, js))

    feats = f.clone().requires_grad_()
    vg.build_counts["corner_table"] = 0
    table = vg.CornerTable(feats, t, s, lowp=lowp)
    loss = sum((table.lookup(torch.from_numpy(p))[0] * torch.from_numpy(c)).sum()
               for p, c in zip(pts, cots))
    loss.backward()
    assert vg.build_counts["corner_table"] == 1 and feats.grad.dtype == torch.float32
    np.testing.assert_allclose(feats.grad.numpy(), want, rtol=0, atol=1e-5)
    assert np.abs(want).max() > 0.5


# -- one voxel train step against the JAX package ---------------------------------------

VCFG_JAX = dataclasses.replace(CFG_JAX, use_voxel_embedding=True, N_freq_voxel=2)
VCFG = ObjectNeRFConfig(**{**SMALL, "use_voxel_embedding": True, "N_freq_voxel": 2})
NS, NI, BATCH = 12, 4, 8
RENDER = dict(N_samples=NS, N_importance=NI, perturb=1.0, noise_std=1.0, white_back=False,
              forward_instance=True, frustum_bound_th=0.1, is_eval=False)
LOSS_W = {"color_loss_weight": 1.0, "depth_loss_weight": 0.1, "opacity_loss_weight": 10.0,
          "instance_color_loss_weight": 1.0, "instance_depth_loss_weight": 0.1}
TRAIN = {"optimizer": "adam", "lr": 1e-3, "weight_decay": 0.0, "lr_scheduler": "poly",
         "poly_exp": 2.0, "warmup_epochs": 0, "num_epochs": 3}
STEPS_PER_EPOCH = 10


def _step_grid():
    """The JAX split-step test's voxel grid (tests/test_split_step.py:124-136)."""
    pts = np.random.RandomState(0).rand(400, 3) * 3 - 1.5
    return jvg.build_voxel_grid(pts, [0, 0, 0], 1.0, 0.4, 3, 24, 2, 20000,
                                key=jax.random.PRNGKey(7))


def _step_batch(n=BATCH, seed=5):
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3).astype(np.float32) * 0.1
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 0.5, np.float32),
                           np.full((n, 1), 3.0, np.float32)], -1)
    return {"rays": rays, "instance_ids": rng.randint(0, N_OBJS, n),
            "rgbs": rng.rand(n, 3).astype(np.float32),
            "depths": (rng.rand(n).astype(np.float32) * 2) * (rng.rand(n) > 0.3),
            "valid_mask": rng.rand(n) > 0.1, "instance_mask": rng.rand(n) > 0.5,
            "instance_mask_weight": rng.rand(n).astype(np.float32)}


def test_voxel_train_step_matches_jax():
    """Loss, metrics, every gradient (the table's included) and one Adam
    update of the port's step (the fused route: on CPU tensors the op's plain
    forward, its hand-derived backward and the hand-written table gradient)
    against `jax.grad` of the JAX package's XLA render and its split train
    step (Pallas kernels in interpret mode, f32), from the same weights,
    batch and draws. Tolerances and the Adam rule of
    tests/test_torch_train_step.py:71-120."""
    params = jax_params(seed=5, cfg_jax=VCFG_JAX)
    jf, jt, js = _step_grid()
    params = {**params, "voxel_features": jf}
    features, topo, static = voxel_from_jax(
        np.asarray(jf), {k: np.asarray(v) for k, v in jt._asdict().items()},
        dataclasses.asdict(js))
    models = ObjectNeRFModels(VCFG, n_importance=1, n_max_objs=N_OBJS, voxel_features=features)
    models.load_state_dict(from_jax_params(to_numpy(params)))
    batch = _step_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(21)
    xla = JaxSettings(mlp=VCFG_JAX, **RENDER)

    def jax_loss(p):
        codes = lookup_codes(p["code_library"], jbatch["instance_ids"])
        res = jax_render_rays(p, jbatch["rays"], key, xla, embedding_instance=codes,
                              voxel_ctx=(p["voxel_features"], jt, js))
        return jax_total_loss(res, jbatch, LOSS_W, True)[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    opt = jo.make_optimizer(TRAIN, STEPS_PER_EPOCH)
    split = make_split_train_step(
        JaxSettings(mlp=VCFG_JAX, use_pallas=True, pallas_interpret=True,
                    pallas_dtype="float32", **RENDER),
        LOSS_W, opt, js, jo.make_lr_schedule(TRAIN, STEPS_PER_EPOCH), donate=False)
    state, want_metrics = split(TrainState(params, opt.init(params), jnp.int32(0)), jbatch,
                                key, jt)

    settings = RenderSettings(mlp=VCFG, matmul_dtype=torch.float32, **RENDER)
    step = make_train_step(settings, LOSS_W, to.make_optimizer(TRAIN, models.parameters()),
                           to.make_lr_schedule(TRAIN, STEPS_PER_EPOCH))
    grads = {}
    for name, p in models.named_parameters():
        p.register_hook(lambda g, name=name: grads.__setitem__(name, g.clone()))
    vg.build_counts["corner_table"] = 0
    metrics = step(models, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
                   draws=port_draws(jax_draws(key, BATCH, NS, NI)), voxel_topo=topo,
                   voxel_static=static)
    assert vg.build_counts["corner_table"] == 1  # one table, read by both passes

    assert set(metrics) == set(want_metrics)
    np.testing.assert_allclose(float(metrics["train/loss"]), float(want_loss), rtol=1e-4)
    for k in want_metrics:
        np.testing.assert_allclose(float(metrics[k]), float(want_metrics[k]), rtol=2e-4,
                                   atol=1e-7, err_msg=k)
    want_g = from_jax_grads(to_numpy(want_grads))
    assert set(grads) == set(want_g)
    for k, w in want_g.items():
        err = (grads[k] - w).abs().max() / (w.abs().max() + 1e-12)
        assert float(err) < 2e-3, (k, float(err))
    assert float(grads["embedding_xyz.embedding_space_ftr.weight"].abs().max()) > 0
    want_p = from_jax_params(to_numpy(state.params))
    for k, p in models.state_dict().items():
        diff = (p - want_p[k]).abs()
        assert float((diff > 2e-6).float().mean()) < 5e-3, k
        assert float(diff.max()) < 2.5e-4, k


# -- prune and subdivide ---------------------------------------------------------------


def _sigma_params():
    """A fine model whose densities straddle the prune threshold widely: the
    sigma head scaled up, so each voxel's largest alpha sits near 0 or 1."""
    cfg = dataclasses.replace(VCFG_JAX, N_freq_voxel=2)
    p = init_object_nerf(jax.random.PRNGKey(3), cfg)
    p["scene"]["sigma"]["w"] = p["scene"]["sigma"]["w"] * 40.0
    return cfg, p


def test_prune_matches_jax_with_its_jitter():
    (jf, jt, js), (f, t, s) = _jgrid(seed=2)
    cfg, p = _sigma_params()
    spv, batch = 8, 64
    key = jax.random.PRNGKey(11)

    def jsigma(emb):
        return scene_forward(p, cfg, emb, None, sigma_only=True)[0]

    want = jvg.prune_empty_voxels(jf, jt, js, jsigma, key, samples_per_voxel=spv,
                                  voxel_batch=batch)
    # the same draws, batch by batch (prune_empty_voxels' key schedule)
    n_batches = -(-int(jt.n_occupied) // batch)
    draws, k = [], key
    for _ in range(n_batches):
        k, sub = jax.random.split(k)
        draws.append(np.asarray(jax.random.uniform(sub, (batch * spv, 3))))
    model = ObjectNeRF(VCFG)
    sd = from_jax_params({"coarse": jax.tree_util.tree_map(np.asarray, p)})
    model.load_state_dict({k_.removeprefix("nerf_coarse."): v for k_, v in sd.items()})

    def sigma_fn(pts, voxel_raw):
        return fs.fused_sigma_eval(model, VCFG, pts, None, "scene", spv, voxel_raw=voxel_raw,
                                   dtype=torch.float32)

    got = vg.prune_empty_voxels(f, t, s, sigma_fn, uniform=torch.from_numpy(np.concatenate(draws)),
                                samples_per_voxel=spv, voxel_batch=batch)
    for name in ("idx_map", "occupancy", "n_occupied", "row_to_cell"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert 0 < int(got.n_occupied) < int(t.n_occupied)  # some kept, some dropped
    # a generator's draws instead: the same shapes and the same kind of answer
    other = vg.prune_empty_voxels(f, t, s, sigma_fn, generator=torch.Generator().manual_seed(0),
                                  samples_per_voxel=spv, voxel_batch=batch)
    assert 0 < int(other.n_occupied) < int(t.n_occupied)


def test_subdivide_matches_jax_and_refuses_past_capacity():
    """The new grid bit for bit (static, idx_map, occupancy, row_to_cell,
    n_occupied, voxel size and offset) and every table row that no child
    takes; the resampled rows to the lookup's f32 agreement (the JAX tool
    jit-compiles its lookup, and XLA fuses the trilinear weights' arithmetic:
    38 % of them differ from the eager formula in the last bit)."""
    (jf, jt, js), (f, t, s) = _jgrid(seed=3, cap=20000)
    wf, wt, ws = jvg.subdivide_voxels(jf, jt, js)
    gf, gt, gs = vg.subdivide_voxels(f, t, s)
    assert dataclasses.asdict(gs) == dataclasses.asdict(ws)
    assert gs.shape == tuple(2 * x for x in s.shape)
    for name in vg.VoxelTopology._fields:
        np.testing.assert_array_equal(getattr(gt, name).numpy(), np.asarray(getattr(wt, name)),
                                      err_msg=name)
    taken = int(gt.n_occupied)
    np.testing.assert_array_equal(gf[taken:].numpy(), np.asarray(wf)[taken:])
    np.testing.assert_allclose(gf[:taken].numpy(), np.asarray(wf)[:taken], rtol=0, atol=2e-6)
    small = dataclasses.replace(s, n_max_voxels=8 * int(t.n_occupied) - 1)
    with pytest.raises(ValueError, match="capacity"):
        vg.subdivide_voxels(f, t, small)


# -- the epoch hooks and a checkpoint after a subdivision ---------------------------------


def _system(tmp_path, ckpt_path=None, **train_over):
    from pathlib import Path

    from object_nerf_torch.data.ply_io import write_ply

    root = Path(__file__).resolve().parents[1]
    write_ply(str(tmp_path / "pcd.ply"),
              np.random.RandomState(0).rand(400, 3) * [2.4, 2.4, 1.2] - [1.2, 1.2, 0.2])
    args = [f"dataset_config={root / 'config/synthetic.yml'}", "img_wh=[8,6]", "device=cpu",
            "model.use_voxel_embedding=true", "model.N_freq_voxel=2",
            "model.N_max_voxels=20000", f"dataset_extra.pcd_path={tmp_path / 'pcd.ply'}",
            "dataset_extra.voxel_size=0.4", "dataset_extra.neighbor_marks=3", "model.D=2",
            "model.W=32", "model.skips=[1]", "model.inst_D=2", "model.inst_W=16",
            "model.inst_skips=[1]", "model.N_max_objs=8", "model.N_obj_code_length=8",
            "model.N_samples=8", "model.N_importance=4", "train.batch_size=32",
            "train.progressive_train=true", "train.prune_samples_per_voxel=8",
            "train.prune_voxel_batch=64", "train.num_epochs=6",
            "train.limit_train_batches=2"]
    cfg = load_config(cli_args=args + ([f"ckpt_path={ckpt_path}"] if ckpt_path else []))
    cfg.train.merge(train_over)
    kw = dict(img_wh=(8, 6), dataset_extra=cfg.dataset_extra)
    system = ObjectNeRFSystem(cfg, dataset=dataset_dict["synthetic"]("train", n_frames=2, **kw),
                              device="cpu")
    if ckpt_path is None:
        with torch.no_grad():  # dense enough that the prune keeps voxels
            system.models.nerf_fine.sigma.bias += 3.0
    return system


def _moments(system):
    return {id(p): {k: v.clone() for k, v in system.optimizer.state[p].items()
                    if torch.is_tensor(v)} for p in system.models.parameters()}


def test_progressive_hooks_prune_then_subdivide_keeping_the_moments(tmp_path):
    """The JAX package's tests/test_voxel_training.py:76-131 on the port:
    prune at epoch 3, subdivide at epoch 5 (a prune first, as there); the
    table keeps its capacity, so every parameter's Adam moments survive the
    subdivision, the table's included; training goes on."""
    system = _system(tmp_path)
    for _ in range(3):
        system.training_step(system.train_dataset.sample_batch(32, system.batch_rng))
    system.on_epoch_start(2)  # no hook before epoch 3
    n0 = int(system.voxel_topo.n_occupied)
    system.on_epoch_start(3)
    n1 = int(system.voxel_topo.n_occupied)
    assert 0 < n1 <= n0
    shape = system.voxel_static.shape
    before = _moments(system)
    table = system.models.voxel_features
    system.on_epoch_start(5)
    assert system.voxel_static.shape == tuple(2 * x for x in shape)
    assert system.models.voxel_features is table  # the same parameter, refilled
    after = _moments(system)
    assert before.keys() == after.keys()
    for pid in before:
        for k in before[pid]:
            assert torch.equal(before[pid][k], after[pid][k])
    assert any(float(v["exp_avg"].abs().max()) > 0 for v in before.values())
    m = system.training_step(system.train_dataset.sample_batch(32, system.batch_rng))
    assert np.isfinite(float(m["train/loss"])) and system.global_step == 4


def test_fit_runs_the_hook_at_each_epoch_it_begins(tmp_path):
    system = _system(tmp_path, num_epochs=2, progressive_train=False)
    seen = []
    system.on_epoch_start = seen.append
    system.fit()
    assert seen == [0, 1] and system.global_step == 4
    resumed = _system(tmp_path, num_epochs=2, progressive_train=False)
    resumed.train_step.global_step = 1  # mid-epoch 0: its hook already ran
    seen.clear()
    resumed.on_epoch_start = seen.append
    resumed.fit()
    assert seen == [1]


def test_checkpoint_after_subdivision_resumes_exactly(tmp_path):
    """A checkpoint written after a prune and a subdivision restores that grid
    (shape, idx_map, row_to_cell, n_occupied), the table and the optimizer
    state: the next steps of the resumed run equal the uninterrupted run's
    bit for bit on the CPU."""
    sys1 = _system(tmp_path)
    for _ in range(2):
        sys1.training_step(sys1.train_dataset.sample_batch(32, sys1.batch_rng))
    sys1.on_epoch_start(5)
    path = save_checkpoint(tmp_path / "ckpts", sys1)
    sys2 = _system(tmp_path, ckpt_path=path)
    assert sys2.voxel_static == sys1.voxel_static and sys2.global_step == 2
    for name in vg.VoxelTopology._fields:
        assert torch.equal(getattr(sys2.voxel_topo, name), getattr(sys1.voxel_topo, name)), name
    for _ in range(2):
        m1 = sys1.training_step(sys1.train_dataset.sample_batch(32, sys1.batch_rng))
        m2 = sys2.training_step(sys2.train_dataset.sample_batch(32, sys2.batch_rng))
        assert float(m1["train/loss"]) == float(m2["train/loss"])
    for (k, a), b in zip(sys1.models.state_dict().items(), sys2.models.state_dict().values()):
        assert torch.equal(a, b), k
