"""The training kernels' module (object_nerf_torch/ops/fused_mlp_vjp.py).

On the CPU the wrappers run their plain versions. `mlp_eval_plain` is held
against the JAX package's Pallas forward kernel in interpret mode,
`mlp_bwd_plain` against its backward kernel in interpret mode, against
`jax.grad` of the XLA path and against torch autograd of `mlp_eval_plain`.
The backward kernel's dataflow (tile loop over a persistent grid, per-block
partials in the packed weight layout, fixed-order reduction, zero-padded
last tile) is emulated at flagship width and held against `mlp_bwd_plain`.
The kernels themselves run only on the card
(tests/test_torch_kernels_cuda.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_nerf_tpu.models.embedding import freq_encode as jfreq_encode
from object_nerf_tpu.models.mlp import (
    ObjectNeRFConfig as JaxConfig, init_object_nerf, instance_forward, scene_forward,
)
from object_nerf_tpu.ops import pallas_mlp as jk
from object_nerf_tpu.ops.pallas_mlp_vjp import _run_bwd

from object_nerf_torch.models.embedding import freq_encode
from object_nerf_torch.models.mlp import ObjectNeRF, ObjectNeRFConfig
from object_nerf_torch.ops import fused_mlp as fm
from object_nerf_torch.ops import fused_mlp_vjp as fv
from object_nerf_torch.train.convert import from_jax_grads, from_jax_params

torch.set_num_threads(2)

SMALL = dict(D=3, W=32, skips=(1,), inst_D=2, inst_W=16, inst_skips=(1,),
             use_voxel_embedding=False, N_obj_code_length=8, N_freq_xyz=4, N_freq_dir=2)
CFG_JAX, CFG = JaxConfig(**SMALL), ObjectNeRFConfig(**SMALL)
N, S = 6, 8
# forward, f32: as in tests/test_torch_fused_mlp.py (the JAX kernel's PE is
# sin(x @ S + phase), ~1e-6 off sin/cos at these 4 frequencies)
FWD_ATOL = 2e-5
# gradients, per tensor, relative to the tensor's largest entry: the bound of
# the JAX package's own test (tests/test_pallas_vjp.py:95)
GRAD_REL = 5e-4


def _np_inputs(seed=1, n=N, s=S):
    rng = np.random.RandomState(seed)
    xyz = (rng.randn(n, s, 3) * 0.3).astype(np.float32)
    dirs = rng.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dir_pe = np.asarray(jfreq_encode(jnp.asarray(dirs), CFG.N_freq_dir))
    codes = (rng.randn(n, CFG.N_obj_code_length) * 0.2).astype(np.float32)
    g = rng.randn(n * s, 8).astype(np.float32)
    return xyz, dir_pe, codes, g


def _models(seed=0):
    """(JAX mlp params, the port's ObjectNeRF carrying them)."""
    params = init_object_nerf(jax.random.PRNGKey(seed), CFG_JAX)
    sd = from_jax_params({"coarse": jax.tree_util.tree_map(np.asarray, params)})
    model = ObjectNeRF(CFG)
    model.load_state_dict({k.removeprefix("nerf_coarse."): v for k, v in sd.items()})
    return params, model


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-8)


def _jax_grads_as_port(d_params):
    sd = from_jax_grads({"coarse": jax.tree_util.tree_map(np.asarray, d_params)})
    return {k.removeprefix("nerf_coarse."): v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("forward_instance,compute_scene",
                         [(True, True), (False, True), (True, False)])
def test_mlp_eval_plain_matches_jax_kernel(forward_instance, compute_scene):
    params, model = _models()
    xyz, dir_pe, codes, _ = _np_inputs()
    want = jk.fused_mlp_eval(params, CFG_JAX, jnp.asarray(xyz), jnp.asarray(dir_pe),
                             jnp.asarray(codes), forward_instance=forward_instance,
                             compute_scene=compute_scene, rays_per_tile=2,
                             dtype=jnp.float32, interpret=True)
    fm.reset_launch_counts()
    with torch.no_grad():
        got = fv.fused_mlp_eval(model, CFG, _t(xyz), _t(dir_pe), _t(codes),
                                forward_instance=forward_instance,
                                compute_scene=compute_scene, dtype=torch.float32)
    assert sum(fm.launch_counts.values()) == 0  # CPU tensors: the plain version
    for name, a, b in zip(("sigma", "rgb", "inst_sigma", "inst_rgb"), got, want):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FWD_ATOL, rtol=0,
                                   err_msg=name)
    if not forward_instance:
        assert float(got[2].abs().max()) == 0 and float(got[3].abs().max()) == 0
    if not compute_scene:
        assert float(got[0].abs().max()) == 0 and float(got[1].abs().max()) == 0


@pytest.mark.parametrize("forward_instance", [True, False])
def test_mlp_bwd_plain_matches_jax_bwd_kernel(forward_instance):
    params, model = _models()
    xyz, dir_pe, codes, g = _np_inputs()
    d_params, d_codes, d_vox = _run_bwd(
        params, jnp.asarray(xyz), jnp.asarray(dir_pe), jnp.asarray(codes), None,
        jnp.asarray(g), cfg=CFG_JAX, forward_instance=forward_instance,
        bwd_rows_budget=2 * S, dtype=jnp.float32, interpret=True)
    assert d_vox is None
    want = _jax_grads_as_port(d_params)
    got, got_codes, got_vox = fv.mlp_bwd_plain(model, CFG, _t(xyz), _t(dir_pe), _t(codes),
                                               _t(g), forward_instance, torch.float32)
    assert got_vox is None
    assert set(got) == set(want) == {k for k, _ in model.named_parameters()}
    for k in want:
        assert got[k].shape == want[k].shape, k
        if not forward_instance and "inst" in k:
            assert np.abs(want[k]).max() == 0 and float(got[k].abs().max()) == 0, k
        else:
            assert _rel(got[k].numpy(), want[k]) < GRAD_REL, k
    if forward_instance:
        assert _rel(got_codes.numpy(), d_codes) < GRAD_REL
    else:
        assert np.abs(np.asarray(d_codes)).max() == 0 and float(got_codes.abs().max()) == 0


def _xla_forward(params, xyz, dir_pe, codes):
    n, s, _ = xyz.shape
    emb = jfreq_encode(xyz.reshape(-1, 3), CFG_JAX.N_freq_xyz)
    d = jnp.repeat(dir_pe, s, axis=0)
    sigma, rgb = scene_forward(params, CFG_JAX, emb, d)
    isigma, irgb = instance_forward(params, CFG_JAX, emb, jnp.repeat(codes, s, axis=0),
                                    None, d)
    return (sigma.reshape(n, s), rgb.reshape(n, s, 3), isigma.reshape(n, s),
            irgb.reshape(n, s, 3))


def _split_g(g, n=N, s=S):
    g = g.reshape(n, s, 8)
    return g[..., 0], g[..., 1:4], g[..., 4], g[..., 5:8]


@pytest.mark.parametrize("forward_instance", [True, False])
def test_mlp_bwd_plain_matches_jax_grad_of_xla_path(forward_instance):
    params, model = _models(seed=3)
    xyz, dir_pe, codes, g = _np_inputs(seed=2)
    if not forward_instance:
        g[:, 4:] = 0.0  # the object branch is off: its outputs carry no cotangent
    lw = [jnp.asarray(x) for x in _split_g(g)]

    def loss(p, c):
        outs = _xla_forward(p, jnp.asarray(xyz), jnp.asarray(dir_pe), c)
        return sum(jnp.sum(o * w) for o, w in zip(outs, lw))

    d_params, d_codes = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(codes))
    want = _jax_grads_as_port(d_params)
    got, got_codes, _ = fv.mlp_bwd_plain(model, CFG, _t(xyz), _t(dir_pe), _t(codes), _t(g),
                                         forward_instance, torch.float32)
    for k in want:
        if np.abs(want[k]).max() == 0:
            assert float(got[k].abs().max()) == 0, k
        else:
            assert _rel(got[k].numpy(), want[k]) < GRAD_REL, k
    if forward_instance:
        assert _rel(got_codes.numpy(), d_codes) < GRAD_REL


@pytest.mark.parametrize("forward_instance", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
def test_mlp_bwd_plain_matches_torch_autograd(forward_instance, dtype, tol):
    """The hand-derived backward against autograd of the plain forward. In
    f32 they are the same sums in another order (1e-5 of the largest entry).
    In bf16 autograd keeps f32 cotangents where the hand-derived version
    rounds every d_pre to bf16 as the kernel does (2^-8 each, over a chain of
    up to 7 products: 3e-2)."""
    _, model = _models(seed=5)
    xyz, dir_pe, codes, g = (_t(a) for a in _np_inputs(seed=4))
    codes.requires_grad_()
    outs = fv.mlp_eval_plain(model, CFG, xyz, dir_pe, codes, forward_instance, True, dtype)
    model.zero_grad()
    sum((o * w).sum() for o, w in zip(outs, _split_g(g))).backward()
    got, got_codes, _ = fv.mlp_bwd_plain(model, CFG, xyz, dir_pe, codes.detach(), g,
                                         forward_instance, dtype)
    for k, p in model.named_parameters():
        if p.grad is None:
            assert float(got[k].abs().max()) == 0, k
        else:
            assert _rel(got[k].numpy(), p.grad.numpy()) < tol, k
    if forward_instance:
        assert _rel(got_codes.numpy(), codes.grad.numpy()) < tol
    else:
        assert codes.grad is None and float(got_codes.abs().max()) == 0


@pytest.mark.parametrize("forward_instance", [True, False])
def test_fused_mlp_function_on_cpu(forward_instance):
    """`FusedMLP` on CPU tensors: autograd reaches the parameters and the codes
    through the plain backward, xyz and dir_pe get no gradient, and nothing is
    kept between forward and backward but the inputs."""
    _, model = _models(seed=6)
    xyz, dir_pe, codes, g = (_t(a) for a in _np_inputs(seed=7))
    for t in (xyz, dir_pe, codes):
        t.requires_grad_()
    outs = fv.fused_mlp_eval(model, CFG, xyz, dir_pe, codes,
                             forward_instance=forward_instance, dtype=torch.float32)
    assert outs[0].grad_fn is outs[3].grad_fn
    saved = outs[0].grad_fn.saved_tensors
    assert len(saved) == 4 and all(a is b for a, b in zip(saved[:3], (xyz, dir_pe, codes)))
    assert saved[3] is None  # no voxel operand
    model.zero_grad()
    sum((o * w).sum() for o, w in zip(outs, _split_g(g))).backward()
    assert xyz.grad is None and dir_pe.grad is None
    want, want_codes, _ = fv.mlp_bwd_plain(model, CFG, xyz.detach(), dir_pe.detach(),
                                           codes.detach(), g, forward_instance, torch.float32)
    for k, p in model.named_parameters():
        np.testing.assert_array_equal(p.grad.numpy(), want[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(codes.grad.numpy(), want_codes.numpy())


def test_wrappers_check_their_inputs():
    _, model = _models()
    xyz, dir_pe, codes, g = (_t(a) for a in _np_inputs())
    with pytest.raises(ValueError, match="float32"):
        fv.fused_mlp_eval(model, CFG, xyz.double(), dir_pe, codes)
    with pytest.raises(ValueError, match="shape"):
        fv.fused_mlp_eval(model, CFG, xyz, dir_pe[:, :3].contiguous(), codes)
    with pytest.raises(ValueError, match="shape"):
        fv.fused_mlp_bwd(model, CFG, xyz, dir_pe, codes, g[:, :4].contiguous())
    # the voxel operand goes with a voxel-conditioned model and with no other
    with pytest.raises(ValueError, match="voxel_raw given to a model without"):
        fv.fused_mlp_eval(model, CFG, xyz, dir_pe, codes, voxel_raw=xyz)
    with pytest.raises(ValueError, match="voxel_raw given to a model without"):
        fv.fused_mlp_bwd(model, CFG, xyz, dir_pe, codes, g, voxel_raw=xyz)
    vcfg = dataclasses.replace(CFG, use_voxel_embedding=True)
    with pytest.raises(ValueError, match="voxel_raw required"):
        fv.fused_mlp_eval(model, vcfg, xyz, dir_pe, codes)
    with pytest.raises(ValueError, match="shape"):
        fv.fused_mlp_eval(model, vcfg, xyz, dir_pe, codes, voxel_raw=xyz)
    assert set(fm.launch_counts) == {"fused_coarse_weights", "fused_render_tiles",
                                     "fused_mlp_eval", "fused_mlp_bwd",
                                     "fused_sigma_eval"}


# -- the backward kernel's dataflow, emulated at flagship width on the CPU ------


def _emulate_bwd(packed, cfg, model, xyz, dir_pe, codes, g, n_blocks):
    """csrc/fused_mlp_train.cu in tensor code over the packed buffers: tiles
    of 128 rows of whole rays, zero-padded past the last ray; block b walks
    tiles b, b + n_blocks, ... and adds each tile's gradients into its own
    partial (weight gradients at the weights' offsets, bias gradients after
    them); the partials are summed in block order."""
    n, s, _ = xyz.shape
    rays_per_tile = 128 // s
    n_tiles = -(-n // rays_per_tile)
    w, b = packed.w.float(), packed.b
    nw, nb = w.numel(), b.numel()
    partials = torch.zeros(n_blocks, nw + nb)
    d_codes = torch.zeros_like(codes)
    pe_size = cfg.xyz_pe_size

    def bf(x):
        return x.bfloat16().float()

    def lrelu(x):
        return torch.where(x >= 0, x, 0.01 * x)

    def slope(act, d):
        return torch.where(act >= 0, d, 0.01 * d)

    def branch(tab, width, X, dirs, gs, gr, part, want_dcat):
        gw, gb = part[:nw], part[nw:]

        def mat(off, rows, cols):
            return w[off:off + rows * cols].reshape(rows, cols)

        def add_w(off, val):
            gw[off:off + val.numel()] += val.reshape(-1)

        def add_b(off, val):
            gb[off:off + val.numel()] += val.reshape(-1)

        k0, depth, nd = tab[fm.T_K0], tab[fm.T_DEPTH], width // 2
        skips = [i for i in range(depth) if (tab[fm.T_SKIPS] >> i) & 1]
        hs, h = [], None
        for i in range(depth):
            off = tab[fm.T_TW + i]
            if i == 0:
                acc = X[:, :k0] @ mat(off, k0, width)
            elif i in skips:
                acc = X[:, :k0] @ mat(off, k0, width) + h @ mat(off + k0 * width, width, width)
            else:
                acc = h @ mat(off, width, width)
            h = bf(lrelu(acc + b[tab[fm.T_TB + i]:tab[fm.T_TB + i] + width]))
            hs.append(h)
        hf = bf(h @ mat(tab[fm.T_FINW], width, width) + b[tab[fm.T_FINB]:tab[fm.T_FINB] + width])
        wdd = mat(tab[fm.T_DIRWD], fm.MAX_DIR, nd)
        dbias = bf(dirs) @ wdd[:dirs.shape[1]] + b[tab[fm.T_DIRB]:tab[fm.T_DIRB] + nd]
        denc = bf(lrelu(hf @ mat(tab[fm.T_DIRWH], width, nd) + dbias.repeat_interleave(s, 0)))
        w_rgb = mat(tab[fm.T_RGBW], 3, nd)
        rgb = torch.sigmoid(denc @ w_rgb.t() + b[tab[fm.T_RGBB]:tab[fm.T_RGBB] + 3])
        # reverse sweep
        dpr = gr * rgb * (1 - rgb)
        add_w(tab[fm.T_RGBW], bf(dpr).t() @ denc)
        add_b(tab[fm.T_RGBB], dpr.sum(0))
        add_b(tab[fm.T_SIGB], gs.sum(0))
        d_pre_d = slope(denc, bf(dpr) @ w_rgb)
        G = bf(d_pre_d)
        add_b(tab[fm.T_DIRB], d_pre_d.sum(0))
        raysum = G.reshape(-1, s, nd).sum(1)  # per ray, then the direction product
        gdd = torch.zeros(fm.MAX_DIR, nd)
        gdd[:dirs.shape[1]] = bf(dirs).t() @ raysum
        add_w(tab[fm.T_DIRWD], gdd)
        add_w(tab[fm.T_DIRWH], hf.t() @ G)
        d_hf = G @ mat(tab[fm.T_DIRWH], width, nd).t()
        add_b(tab[fm.T_FINB], d_hf.sum(0))
        G = bf(d_hf)
        add_w(tab[fm.T_FINW], hs[-1].t() @ G)
        w_sig = w[tab[fm.T_SIGW]:tab[fm.T_SIGW] + width]
        add_w(tab[fm.T_SIGW], hs[-1].t() @ bf(gs))
        d_h = G @ mat(tab[fm.T_FINW], width, width).t() + bf(gs) * w_sig[None, :]
        dcat = torch.zeros(X.shape[0], k0)
        for i in reversed(range(depth)):
            d_pre = slope(hs[i], d_h)
            add_b(tab[fm.T_TB + i], d_pre.sum(0))
            G = bf(d_pre)
            off = tab[fm.T_TW + i]
            if i == 0 or i in skips:
                add_w(off, X[:, :k0].t() @ G)
                if want_dcat:
                    dcat += G @ mat(off, k0, width).t()
                if i == 0:
                    break
                off += k0 * width
            add_w(off, hs[i - 1].t() @ G)
            d_h = G @ mat(off, width, width).t()
        return dcat

    for tile in range(n_tiles):
        part = partials[tile % n_blocks]
        lo, hi = tile * rays_per_tile, min((tile + 1) * rays_per_tile, n)
        real = (hi - lo) * s
        X = torch.zeros(128, fm.OBJ_K0)
        X[:real, :pe_size] = freq_encode(xyz[lo:hi].reshape(-1, 3), cfg.N_freq_xyz)
        X[:real, pe_size:pe_size + codes.shape[1]] = codes[lo:hi].repeat_interleave(s, 0)
        X = bf(X)
        dirs = torch.zeros(rays_per_tile, dir_pe.shape[1])
        dirs[:hi - lo] = dir_pe[lo:hi]
        gt = torch.zeros(128, 8)
        gt[:real] = g[lo * s:hi * s]
        branch(packed.scene, fm.SCENE_W, X, dirs, gt[:, 0:1], gt[:, 1:4], part, False)
        dcat = branch(packed.obj, fm.OBJ_W, X, dirs, gt[:, 4:5], gt[:, 5:8], part, True)
        dc = dcat[:, pe_size:pe_size + codes.shape[1]].reshape(rays_per_tile, s, -1).sum(1)
        d_codes[lo:hi] = dc[:hi - lo]
    flat = torch.zeros(nw + nb)
    for blk in range(n_blocks):  # fixed order
        flat = flat + partials[blk]
    grads = {}
    pe = cfg.xyz_pe_size
    fv._unpack_branch(model, "scene", packed.scene, pe, cfg.in_channels_dir, flat[:nw],
                      flat[nw:], grads)
    fv._unpack_branch(model, "object", packed.obj, pe + cfg.N_obj_code_length,
                      cfg.in_channels_dir, flat[:nw], flat[nw:], grads)
    return grads, d_codes


def test_backward_dataflow_reproduces_plain_bf16():
    """5 rays of 64 samples: three tiles of two rays, the last one half empty,
    walked by two blocks. Against `mlp_bwd_plain` in bf16, relative to each
    tensor's largest entry: both round the same operands to bf16, their f32
    sums run in another order (per tile, per block), which now and then moves
    one bf16 rounding; 5e-3 bounds that on these 320 rows."""
    cfg = ObjectNeRFConfig(use_voxel_embedding=False)
    model = ObjectNeRF(cfg).reset_parameters_(torch.Generator().manual_seed(0))
    n, s = 5, 64
    gen = torch.Generator().manual_seed(1)
    z = torch.sort(0.5 + 4.0 * torch.rand(n, s, generator=gen), -1).values
    o, d = torch.randn(n, 3, generator=gen) * 0.2, torch.randn(n, 3, generator=gen)
    d = d / d.norm(dim=-1, keepdim=True)
    xyz = (o[:, None] + d[:, None] * z[..., None]).contiguous()
    dir_pe = freq_encode(d, cfg.N_freq_dir)
    codes = torch.randn(n, cfg.N_obj_code_length, generator=gen)
    g = torch.randn(n * s, 8, generator=gen) * 1e-3
    with torch.no_grad():
        packed = fm.pack_kernel_weights(model, cfg, True)
        got, got_codes = _emulate_bwd(packed, cfg, model, xyz, dir_pe, codes, g, n_blocks=2)
        want, want_codes, _ = fv.mlp_bwd_plain(model, cfg, xyz, dir_pe, codes, g, True)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert _rel(got[k].numpy(), want[k].numpy()) < 5e-3, k
    assert _rel(got_codes.numpy(), want_codes.numpy()) < 5e-3
