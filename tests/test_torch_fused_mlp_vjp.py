"""The training kernels' module (object_nerf_torch/ops/fused_mlp_vjp.py).

On the CPU the wrappers run their plain versions. `mlp_eval_plain` is held
against the JAX package's Pallas forward kernel in interpret mode,
`mlp_bwd_plain` against its backward kernel in interpret mode, against
`jax.grad` of the XLA path and against torch autograd of `mlp_eval_plain`.
The backward's dataflow (the tile sweep over a persistent grid writing the
workspace of `bwd_workspace_layout` and per-block partials, the split-K
weight-gradient GEMM over `wgrad_work_list`, the fixed-order reduction, the
zero-padded last tile) is emulated at flagship width, for the classical and
the voxel-conditioned model, and held against `mlp_bwd_plain`; the work list
and the TMA boxes it implies are checked against the rules the kernel and
the hardware need. The kernels themselves run only on the card
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
from object_nerf_torch.models.mlp import ObjectNeRF, ObjectNeRFConfig, embed_inputs
from object_nerf_torch.ops import fused_mlp as fm
from object_nerf_torch.ops import fused_mlp_vjp as fv
from object_nerf_torch.ops import fwd_chain as fc
from object_nerf_torch.train.convert import from_jax_grads, from_jax_params

from test_torch_fwd_chain import SMEM, SWEEP_STAGES, SWEEP_STAGES_BEFORE, sweep_smem

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


def _emulate_bwd(packed, cfg, model, xyz, dir_pe, codes, g, n_sm, n_blocks, voxel_raw=None):
    """csrc/fused_mlp_train.cu in tensor code over the packed buffers and the
    tables of `bwd_plan`. The sweep walks tiles of 128 rows of whole rays,
    zero-padded past the last ray, block b taking tiles b, b + n_blocks, ...:
    it writes the input tile, every activation and every rounded d_pre into
    the workspace at the layout's columns, and adds the bias and small-head
    gradients of each 64 rows into their consumer warpgroup's compact partial
    (2 b for rows 0-63 of a tile, 2 b + 1 for rows 64-127). Every product
    takes its weight operand from the sweep's chunk order (`plan.chunks`),
    chunk by chunk as the producer loads it, the boxes of each chunk cut
    out of the packed weights by its tensor map, and each tile uses up the
    order exactly. Then every item of the work
    list writes act^T @ d_pre over its slice of rows into its own partial,
    and each reduction segment adds its partials in order. Returns
    (gradients by name, d_codes, d_voxel_raw or None)."""
    n, s, _ = xyz.shape
    rays_per_tile = 128 // s
    ray_of = torch.arange(128) // s  # a tile row's ray
    n_tiles = -(-n // rays_per_tile)
    plan = fv.bwd_plan(packed, cfg, n_tiles * 128, n_sm, n_blocks, True)
    lay = plan.layout
    ws = torch.zeros(lay.rows, lay.cols)  # bf16 values, held in f32
    parts = torch.zeros(plan.n_parts)
    w, b = packed.w.float(), packed.b
    nw, nb = w.numel(), b.numel()
    emb, obj_voxel = embed_inputs(cfg, xyz.reshape(-1, 3), voxel_raw)
    pieces = [emb] + ([obj_voxel] if obj_voxel is not None else [])
    inputs = torch.cat(pieces + [codes.repeat_interleave(s, 0)], dim=-1)
    o_code = inputs.shape[1] - codes.shape[1]
    dcats = [torch.zeros(n * s, lay.x_cols), torch.zeros(n * s, lay.x_cols)]
    d_codes = torch.zeros_like(codes)

    def bf(x):
        return x.bfloat16().float()

    def lrelu(x):
        return torch.where(x >= 0, x, 0.01 * x)

    def slope(act, d):
        return torch.where(act >= 0, d, 0.01 * d)

    def mat(off, rows, cols):
        return w[off:off + rows * cols].reshape(rows, cols)

    def chunk_boxes():
        """The next chunk of the tile's order: (slot, its boxes stacked as
        the stage holds them, (x, y, nx, ny, box rows))."""
        word = chunks.pop(0)
        slot, x, y = word & 31, 64 * ((word >> 5) & 7), 16 * ((word >> 8) & 2047)
        nx, ny = ((word >> 19) & 3) + 1, ((word >> 21) & 3) + 1
        off, rows, cols = plan.weight_maps[slot]
        box_rows = fc.forward_chunk_rows(cols)
        assert rows > 0 and nx * ny * box_rows * 128 == fc.FWD_STAGE_BYTES
        assert x + 64 * nx <= cols and y + ny * box_rows <= rows
        return slot, mat(off, rows, cols), (x, y, nx, ny, box_rows)

    def take_w(slot, r0, k):
        """W[r0:r0 + k, :] of map `slot`, row chunks (all columns) at a time."""
        got = []
        while sum(c.shape[0] for c in got) < k:
            sl, m, (x, y, nx, ny, br) = chunk_boxes()
            assert sl == slot and x == 0 and nx * 64 == m.shape[1] and ny == 1
            assert y == r0 + sum(c.shape[0] for c in got)
            got.append(m[y:y + br])
        return torch.cat(got)

    def take_wt(slot, r0, nout, k):
        """W[r0:r0 + nout, 0:k] of map `slot`, K-major chunks: per 64 columns
        128 rows, or for 64 rows two blocks of 64 columns."""
        out = torch.full((nout, k), float("nan"))
        for k0 in range(0, k, 64 if nout >= 128 else 128):
            for h in range(max(1, nout // 128)):
                sl, m, (x, y, nx, ny, br) = chunk_boxes()
                assert sl == slot and x == k0 and y == r0 + 128 * h
                assert ny * br == min(nout, 128) and nx == (1 if nout >= 128 else 2)
                out[128 * h:128 * h + ny * br, x:x + 64 * nx] = m[y:y + ny * br, x:x + 64 * nx]
        assert not out.isnan().any()
        return out

    hi_cols = fv._input_grad_columns(cfg)

    def branch(bi, tab, gt, width, X, dirs, gs, gr, wsr, part_wg, want_dcat):
        act, fin, gcol, gfin, gdir = lay.branches[bi]
        base = bi * fc.SWEEP_MAPS_PER_BRANCH

        def add(key, f):  # f(rows) over each warpgroup's 64 rows, into its partial
            for h, part in enumerate(part_wg):
                val = f(slice(64 * h, 64 * h + 64))
                part[gt[key]:gt[key] + val.numel()] += val.reshape(-1)

        k0, depth, nd = tab[fc.T_K0], tab[fc.T_DEPTH], width // 2
        skips = [i for i in range(depth) if (tab[fc.T_SKIPS] >> i) & 1]
        hs, h = [], None
        for i in range(depth):
            if i == 0:
                acc = X[:, :k0] @ take_w(base + i, 0, k0)
            elif i in skips:
                acc = X[:, :k0] @ take_w(base + i, 0, k0) + h @ take_w(base + i, k0, width)
            else:
                acc = h @ take_w(base + i, 0, width)
            h = bf(lrelu(acc + b[tab[fc.T_TB + i]:tab[fc.T_TB + i] + width]))
            hs.append(h)
            wsr[:, act + i * width:act + (i + 1) * width] = h
        hf = bf(h @ take_w(base + 8, 0, width) + b[tab[fc.T_FINB]:tab[fc.T_FINB] + width])
        wsr[:, fin:fin + width] = hf
        wdd = mat(tab[fc.T_DIRWD], fc.MAX_DIR, nd)
        dbias = bf(dirs) @ wdd[:dirs.shape[1]] + b[tab[fc.T_DIRB]:tab[fc.T_DIRB] + nd]
        denc = bf(lrelu(hf @ take_w(base + 9, 0, width) + dbias.repeat_interleave(s, 0)))
        w_rgb = mat(tab[fc.T_RGBW], 3, nd)
        rgb = torch.sigmoid(denc @ w_rgb.t() + b[tab[fc.T_RGBB]:tab[fc.T_RGBB] + 3])
        # reverse sweep: small heads and bias sums into the block's partial
        dpr = gr * rgb * (1 - rgb)
        add(fc.T_RGBW, lambda r: bf(dpr[r]).t() @ denc[r])
        add(fc.T_RGBB, lambda r: dpr[r].sum(0))
        add(fc.T_SIGB, lambda r: gs[r].sum(0))
        d_pre_d = slope(denc, bf(dpr) @ w_rgb)
        G = bf(d_pre_d)
        add(fc.T_DIRB, lambda r: d_pre_d[r].sum(0))

        def gdd(r):  # per ray over the warpgroup's rows, then the direction product
            raysum = torch.zeros(dirs.shape[0], nd).index_add_(0, ray_of[r], G[r])
            out = torch.zeros(fc.MAX_DIR, nd)
            out[:dirs.shape[1]] = bf(dirs).t() @ raysum
            return out

        add(fc.T_DIRWD, gdd)
        wsr[:, gdir:gdir + nd] = G
        d_hf = G @ take_wt(base + 9, 0, width, nd).t()
        add(fc.T_FINB, lambda r: d_hf[r].sum(0))
        G = bf(d_hf)
        wsr[:, gfin:gfin + width] = G
        w_sig = w[tab[fc.T_SIGW]:tab[fc.T_SIGW] + width]
        add(fc.T_SIGW, lambda r: hs[-1][r].t() @ bf(gs[r]))
        d_h = G @ take_wt(base + 8, 0, width, width).t() + bf(gs) * w_sig[None, :]
        dcat = torch.zeros(X.shape[0], lay.x_cols)
        for i in reversed(range(depth)):
            d_pre = slope(hs[i], d_h)
            add(fc.T_TB + i, lambda r: d_pre[r].sum(0))
            G = bf(d_pre)
            wsr[:, gcol + i * width:gcol + (i + 1) * width] = G
            rows = 0  # the hidden rows of a skip layer follow its input rows
            if i == 0 or i in skips:
                if voxel_raw is not None:  # SWEEP_D input columns at a time, up to the last used
                    for c0 in range(0, min(hi_cols[bi], k0), fv.SWEEP_D):
                        dcat[:, c0:c0 + fv.SWEEP_D] += G @ take_wt(base + i, c0, fv.SWEEP_D,
                                                                    width).t()
                elif want_dcat:
                    dcat[:, :k0] += G @ take_wt(base + i, 0, k0, width).t()
                if i == 0:
                    break
                rows = k0
            d_h = G @ take_wt(base + i, rows, width, width).t()
        return dcat

    for tile in range(n_tiles):
        blk = tile % n_blocks
        part = [parts[plan.small_base + (2 * blk + h) * plan.small_stride:][:plan.small_stride]
                for h in range(2)]
        lo, hi = tile * rays_per_tile, min((tile + 1) * rays_per_tile, n)
        real = (hi - lo) * s
        wsr = ws[tile * 128:(tile + 1) * 128]
        X = torch.zeros(128, lay.x_cols)
        X[:real, :inputs.shape[1]] = inputs[lo * s:hi * s]
        X = bf(X)
        wsr[:, lay.x:lay.x + lay.x_cols] = X
        dirs = torch.zeros(rays_per_tile, dir_pe.shape[1])
        dirs[:hi - lo] = dir_pe[lo:hi]
        gt = torch.zeros(128, 8)
        gt[:real] = g[lo * s:hi * s]
        chunks = list(plan.chunks)  # the tile's chunk order, from its start
        for bi, (tab, gtab, width) in enumerate(((packed.scene, plan.gtabs[0], fc.SCENE_W),
                                                  (packed.obj, plan.gtabs[1], fc.OBJ_W))):
            want = bi == 1 or voxel_raw is not None
            dcat = branch(bi, tab, gtab, width, X, dirs, gt[:, 4 * bi:4 * bi + 1],
                          gt[:, 4 * bi + 1:4 * bi + 4], wsr, part, want)
            dcats[bi][lo * s:hi * s] = dcat[:real]
        assert not chunks  # the tile took every chunk of the order
        dc = dcats[1][lo * s:hi * s, o_code:o_code + codes.shape[1]]
        d_codes[lo:hi] = dc.reshape(hi - lo, s, -1).sum(1)
    wg = fv.wgrad_gemm(ws.bfloat16(), torch.tensor(plan.work.items, dtype=torch.int32),
                       plan.work.n_floats)  # the weight-gradient GEMM
    parts[:plan.work.n_floats] = wg
    flat = torch.zeros(nw + nb)
    for dst, length, src, stride, n_parts in plan.segments:  # the reduction, in order
        acc = torch.zeros(length)
        for q in range(n_parts):
            acc = acc + parts[src + q * stride:src + q * stride + length]
        flat[dst:dst + length] = acc
    grads = {}
    fv._unpack_branch(model, "scene", packed.scene, cfg.in_channels_xyz, cfg.in_channels_dir,
                      flat[:nw], flat[nw:], grads)
    fv._unpack_branch(model, "object", packed.obj, cfg.inst_channel_in, cfg.in_channels_dir,
                      flat[:nw], flat[nw:], grads)
    d_vox = None
    if voxel_raw is not None:
        raw = voxel_raw.reshape(n * s, -1)
        c_s, nf = cfg.N_scn_voxel_size, cfg.N_freq_voxel
        w_s, w_i, c_in_s = c_s * (2 * nf + 1), cfg.N_obj_voxel_size * (2 * nf + 1), emb.shape[1]
        d_svox = fv._freq_encode_vjp(raw[:, :c_s], dcats[0][:, :w_s] + dcats[1][:, :w_s], nf)
        d_ivox = fv._freq_encode_vjp(raw[:, c_s:], dcats[1][:, c_in_s:c_in_s + w_i], nf)
        d_vox = torch.cat([d_svox, d_ivox], dim=-1).reshape(n, s, -1)
    return grads, d_codes, d_vox


@pytest.mark.parametrize("voxel", [False, True], ids=["classical", "voxel"])
def test_backward_dataflow_reproduces_plain_bf16(voxel):
    """5 rays of 64 samples: three tiles of two rays, the last one half empty,
    swept by two blocks; six slices of 64 rows per weight-gradient tile.
    Against `mlp_bwd_plain` in bf16, relative to each tensor's largest
    entry: both round the same operands to bf16, their f32 sums run in
    another order (per slice, per block), which now and then moves one bf16
    rounding; 5e-3 bounds that on these 320 rows."""
    cfg = ObjectNeRFConfig(use_voxel_embedding=voxel)
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
    raw = None
    if voxel:
        n_vox = cfg.N_scn_voxel_size + cfg.N_obj_voxel_size
        raw = torch.randn(n, s, n_vox, generator=gen) * 0.5
    with torch.no_grad():
        packed = fc.pack_kernel_weights(model, cfg, True)
        plan = fv.bwd_plan(packed, cfg, 384, 132, 2)
        assert len(plan.work.slices) == 6
        got, got_codes, got_vox = _emulate_bwd(packed, cfg, model, xyz, dir_pe, codes, g,
                                               n_sm=132, n_blocks=2, voxel_raw=raw)
        want, want_codes, want_vox = fv.mlp_bwd_plain(model, cfg, xyz, dir_pe, codes, g, True,
                                                      voxel_raw=raw)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert _rel(got[k].numpy(), want[k].numpy()) < 5e-3, k
    assert _rel(got_codes.numpy(), want_codes.numpy()) < 5e-3
    if voxel:
        assert got_vox.shape == want_vox.shape
        assert _rel(got_vox.numpy(), want_vox.numpy()) < 5e-3
    else:
        assert got_vox is None and want_vox is None


# -- the weight-gradient kernel's tables ------------------------------------------

# (rows, SMs) of a launch: the training shapes on an H100, the emulation's
# three tiles, one tile on a small card
PLAN_SHAPES = ((2048 * 64, 132), (2048 * 128, 132), (384, 132), (128, 4))


def _plans(voxel, forward_instance):
    cfg = ObjectNeRFConfig(use_voxel_embedding=voxel)
    packed = fc.pack_kernel_weights(ObjectNeRF(cfg), cfg, True)
    for rows, n_sm in PLAN_SHAPES:
        n_blocks = min(rows // fv.TILE_ROWS, n_sm)
        yield packed, fv.bwd_plan(packed, cfg, rows, n_sm, n_blocks, forward_instance)


def _gradient_ranges(packed, forward_instance):
    """(start, length) of every gradient the backward returns, in the packed
    gradient buffer (weights, then biases at nw + offset), split into the
    weight-gradient kernel's matrices and the rest."""
    nw = packed.w.numel()
    big, small = [], []
    for tab, width in zip([packed.scene] + ([packed.obj] if forward_instance else []),
                          (fc.SCENE_W, fc.OBJ_W)):
        k0, depth, nd = tab[fc.T_K0], tab[fc.T_DEPTH], width // 2
        for i in range(depth):
            rows = k0 if i == 0 else (k0 + width if (tab[fc.T_SKIPS] >> i) & 1 else width)
            big.append((tab[fc.T_TW + i], rows * width))
            small.append((nw + tab[fc.T_TB + i], width))
        big += [(tab[fc.T_FINW], width * width), (tab[fc.T_DIRWH], width * nd)]
        small += [(tab[fc.T_SIGW], width), (tab[fc.T_DIRWD], fc.MAX_DIR * nd),
                  (tab[fc.T_RGBW], 3 * nd), (nw + tab[fc.T_SIGB], 1),
                  (nw + tab[fc.T_FINB], width), (nw + tab[fc.T_DIRB], nd),
                  (nw + tab[fc.T_RGBB], 3)]
    return big, small


def _cover(ranges, size):
    hits = np.zeros(size, np.int64)
    for start, length in ranges:
        hits[start:start + length] += 1
    return hits


@pytest.mark.parametrize("forward_instance", [True, False])
@pytest.mark.parametrize("voxel", [False, True], ids=["classical", "voxel"])
def test_work_list_partitions_rows_and_covers_every_weight_once(voxel, forward_instance):
    """The slices partition the workspace's rows in order; in every slice the
    items write each weight element of each matrix exactly once, each into a
    partial of its own; the reduction then writes every gradient the
    backward returns exactly once, adding one partial per slice (per
    consumer warpgroup of each sweep block, two a block, for the sweep's
    gradients)."""
    for packed, plan in _plans(voxel, forward_instance):
        work, rows = plan.work, plan.layout.rows
        assert work.slices[0][0] == 0 and work.slices[-1][1] == rows
        assert all(a[1] == b[0] for a, b in zip(work.slices, work.slices[1:]))
        assert all(k1 > k0 and k0 % fv.WG_BOX[1] == 0 and k1 % fv.WG_BOX[1] == 0
                   for k0, k1 in work.slices)
        big, small = _gradient_ranges(packed, forward_instance)
        size = packed.w.numel() + packed.b.numel()
        # each unit's segment names where its slices' partials lie
        seg_of = {tuple(u): seg for u, seg in zip(work.units, work.segments)}
        assert len(work.items) == len(work.units) * len(work.slices)
        per_slice = {sl: [] for sl in work.slices}
        for a, g, n, m, k0, k1, off, pad in work.items:
            unit = next(u for u in work.units if u[:4] == (a, g, n, m)
                        and seg_of[u][2] <= off < seg_of[u][2] + len(work.slices) * m * n)
            dst, length, base, stride, n_parts = seg_of[unit]
            sl = (off - base) // stride
            assert (off - base) % stride == 0 and work.slices[sl] == (k0, k1) and pad == 0
            per_slice[(k0, k1)].append((dst, m * n))
        for ranges in per_slice.values():
            hits = _cover(ranges, size)
            assert (_cover(big, size)[hits > 0] == 1).all()
            np.testing.assert_array_equal(hits, _cover(big, size))
        # partials: disjoint, inside the buffer, apart from the sweep's
        parts = _cover([(it[6], it[2] * it[3]) for it in work.items], plan.small_base)
        assert parts.max() == 1 and parts.sum() == work.n_floats
        # the reduction writes every returned gradient once
        hits = _cover([(dst, length) for dst, length, _, _, _ in plan.segments], size)
        np.testing.assert_array_equal(hits, _cover(big + small, size))
        for dst, length, src, stride, n_parts in plan.segments[len(work.segments):]:
            assert n_parts == 2 * plan.n_blocks and stride == plan.small_stride
            assert plan.small_base <= src and src - plan.small_base + length <= stride
        assert plan.n_parts == plan.small_base + 2 * plan.n_blocks * plan.small_stride


@pytest.mark.parametrize("forward_instance", [True, False])
@pytest.mark.parametrize("voxel", [False, True], ids=["classical", "voxel"])
def test_tma_boxes_meet_the_hardware_rules(voxel, forward_instance):
    """The tensor map over the workspace and every box an item loads: global
    strides 16-byte aligned, box dimensions within 256, the inner box extent
    a multiple of 16 bytes and within the 128-byte swizzle span; each box
    starts on a 128-byte row boundary, lies inside the workspace and inside
    its own layout block; items fit the kernel's tile (at most 128 x 256)."""
    for packed, plan in _plans(voxel, forward_instance):
        lay = plan.layout
        box_cols, box_rows = fv.WG_BOX
        assert (2 * lay.cols) % 16 == 0 and lay.cols < 2 ** 32 and lay.rows < 2 ** 32
        assert box_cols <= 256 and box_rows <= 256
        assert (2 * box_cols) % 16 == 0 and 2 * box_cols <= fv.WG_SWIZZLE_BYTES
        blocks = [(lay.x, lay.x_cols)]
        for (act, fin, g, gfin, gdir), width in zip(lay.branches, fc.BRANCH_WIDTHS):
            depth = (fin - act) // width
            blocks += [(act, depth * width), (fin, width), (g, depth * width), (gfin, width),
                       (gdir, width // 2)]
        assert sum(w for _, w in blocks) == lay.cols
        assert _cover(blocks, lay.cols).max() == 1
        assert all(start % box_cols == 0 and w % box_cols == 0 for start, w in blocks)
        for a, g, n, m, k0, k1, off, _ in plan.work.items:
            assert m in (64, 128) and m <= fv.WG_M and n in (64, 128, 256) and n <= fv.WG_N
            assert a % box_cols == 0 and g % box_cols == 0 and k0 % box_rows == 0
            assert (k1 - k0) % box_rows == 0 and 0 <= k0 < k1 <= lay.rows
            for start, width in ((a, m), (g, n)):
                assert any(b <= start and start + width <= b + w for b, w in blocks)
            assert off % 2 == 0  # the epilogue's float2 stores


@pytest.mark.parametrize("forward_instance", [True, False])
@pytest.mark.parametrize("voxel", [False, True], ids=["classical", "voxel"])
def test_sweep_weight_maps_meet_the_hardware_rules(voxel, forward_instance):
    """The sweep's weight tensor maps: one per matrix it multiplies by, each
    exactly that matrix of the packed weights (the weight-gradient kernel's
    matrices, disjoint); the global address and row stride 16-byte aligned,
    the inner box extent within the 128-byte swizzle span, box dimensions
    within 256; rows and columns whole boxes, so every chunk the sweep loads
    (64 rows of W, or 64 columns of 64-row blocks of W^T, from row 0 or from
    a skip layer's k0, or the voxel input's 128-column chunks) lies inside its
    map; the object branch's input rows hold the 128-row code product."""
    cfg = ObjectNeRFConfig(use_voxel_embedding=voxel)
    packed = fc.pack_kernel_weights(ObjectNeRF(cfg), cfg, True)
    maps = fc.sweep_weight_maps(packed, forward_instance)
    assert len(maps) == 2 * fc.SWEEP_MAPS_PER_BRANCH
    box_cols, box_rows = fc.SWEEP_BOX
    assert box_cols <= 256 and box_rows <= 256 and 2 * box_cols == fv.WG_SWIZZLE_BYTES
    big, _ = _gradient_ranges(packed, forward_instance)
    used = [m for m in maps if m[1]]
    assert sorted((off, rows * cols) for off, rows, cols in used) == sorted(big)
    assert _cover([(off, rows * cols) for off, rows, cols in used], packed.w.numel()).max() == 1
    for off, rows, cols in used:
        assert (2 * off) % 16 == 0 and (2 * cols) % 16 == 0
        assert rows % box_rows == 0 and cols % box_cols == 0 and cols <= 256
        assert off + rows * cols <= packed.w.numel()
    for bi, tab in enumerate([packed.scene] + ([packed.obj] if forward_instance else [])):
        base, k0 = bi * fc.SWEEP_MAPS_PER_BRANCH, tab[fc.T_K0]
        assert k0 % box_rows == 0 and k0 % 128 in (0, 64)
        assert maps[base][1] == k0 and (bi == 0 or k0 >= 128)
        for slot in range(tab[fc.T_DEPTH], 8):
            assert maps[base + slot] == (0, 0, 0)
    if not forward_instance:
        assert all(m == (0, 0, 0) for m in maps[fc.SWEEP_MAPS_PER_BRANCH:])


# -- the sweep's weight ring ----------------------------------------------------------


@pytest.mark.parametrize("voxel", [False, True], ids=["classical", "voxel"])
def test_sweep_ring_fits_a_block_and_is_deeper(voxel):
    """Each sweep instantiation's shared memory, laid out as SweepCfg does
    (`sweep_smem` of tests/test_torch_fwd_chain.py; the card test holds the
    built library's `fused_mlp_vjp.sweep_layout` to it), fits a block's
    232,448 bytes with the stage count the source derives, and one stage
    more would not: at least 4 stages, twice the old sweep's 2 (a 32 KB stage
    and a borrowed buffer), holding more bytes than those two. Every chunk of
    a tile's order fills one stage, and a tile has more chunks than the ring
    has stages (the producer wraps around it within a tile)."""
    stages = SWEEP_STAGES[int(voxel)]
    assert sweep_smem(voxel, stages) <= SMEM < sweep_smem(voxel, stages + 1)
    assert stages >= 2 * SWEEP_STAGES_BEFORE >= 4
    assert stages * fc.FWD_STAGE_BYTES > SWEEP_STAGES_BEFORE * 32768
    cfg = ObjectNeRFConfig(use_voxel_embedding=voxel)
    packed = fc.pack_kernel_weights(ObjectNeRF(cfg), cfg, True)
    maps = fc.sweep_weight_maps(packed, True)
    for fi in (True, False):
        chunks = fv.sweep_chunks(packed, cfg, fi)
        assert len(chunks) > stages
        for slot, x, y, nx, ny in chunks:
            off, rows, cols = maps[slot]
            box_rows = fc.forward_chunk_rows(cols)
            assert nx * ny * box_rows * 128 == fc.FWD_STAGE_BYTES
            assert x + 64 * nx <= cols and y + ny * box_rows <= rows
        assert fv.pack_sweep_chunks(chunks) == fv.bwd_plan(
            packed, cfg, 128, 132, 1, fi).chunks


@pytest.mark.parametrize("forward_instance", [True, False])
@pytest.mark.parametrize("voxel", [False, True], ids=["classical", "voxel"])
def test_sweep_recompute_reads_the_forward_chains_chunks(voxel, forward_instance):
    """Each branch's run of the sweep's chunk order starts with the forward
    chain's own chunks of that branch in its eval mode, in that order (the
    recompute); the reverse sweep's chunks follow, and the branches follow
    one another."""
    cfg = ObjectNeRFConfig(use_voxel_embedding=voxel)
    packed = fc.pack_kernel_weights(ObjectNeRF(cfg), cfg, True)
    chain = fc.forward_chunks(packed, "eval", forward_instance)
    sweep = fv.sweep_chunks(packed, cfg, forward_instance)
    per_branch = fc.SWEEP_MAPS_PER_BRANCH
    branches = [slot // per_branch for slot, *_ in sweep]
    assert branches == sorted(branches) and set(branches) == ({0, 1} if forward_instance else {0})
    for b in set(branches):
        run = [c for c in sweep if c[0] // per_branch == b]
        fwd = [(slot, y, nx) for slot, x, y, nx, ny in run[:len(chain)]]
        own = [c for c in chain if c[0] // per_branch == b]
        assert fwd[:len(own)] == own
        assert all(x == 0 and ny == 1 for _, x, _, _, ny in run[:len(own)])
        assert len(run) > len(own)
