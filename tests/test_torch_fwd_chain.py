"""The forward chain of `fused_mlp_eval`, `fused_render_tiles`,
`fused_coarse_weights` and `fused_sigma_eval`
(object_nerf_torch/ops/csrc/fused_mlp_wg.cuh), emulated on the CPU.

The kernel's producer streams the weight chunks of `fwd_chain.forward_chunks`
through a ring; two consumer warpgroups each compute 64 rows of a 128-row tile
from the boxes that the tensor maps of `sweep_weight_maps` cut out of the
packed weights. The emulation below walks the chunk list in the producer's
order, checks that each chunk is the one the consumer's loop reads next, and
computes each warpgroup's rows from those boxes in bf16 with f32 sums, with
the kernel's epilogues (bias and LeakyReLU in f32, then bf16: the kernel keeps
each layer's rounded output in registers as the next product's A operand; the
heads and the per-ray direction bias as the kernel forms them). It must reproduce the
plain versions (`mlp_eval_plain`, `render_tiles_plain`, which the JAX
package's kernels hold in tests/test_torch_fused_mlp*.py) for the classical
and the voxel model, S in {32, 64, 128}, each branch on and off, and a ragged
last tile. The modes that stop at the sigma head walk the sigma-only chunk
order: the coarse weights (the scene trunk, then the kernel's per-ray scan)
against `coarse_weights_plain`, the point-wise density (rows are points, a
code per run of `per_row` of them) against `sigma_eval_plain`. The kernels
themselves run on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import ast
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from object_nerf_torch.models.embedding import freq_encode
from object_nerf_torch.models.mlp import ObjectNeRF, ObjectNeRFConfig, embed_inputs
from object_nerf_torch.ops import _build
from object_nerf_torch.ops import fused_mlp as fm
from object_nerf_torch.ops import fused_mlp_vjp as fv
from object_nerf_torch.ops import fused_sigma as fs
from object_nerf_torch.ops import fwd_chain as fc
from object_nerf_torch.ops.compositing import composite, composite_instance

torch.set_num_threads(2)

# emulation vs plain version, max abs: both round the same operands to bf16
# and sum in f32, in another order (per chunk of K rows, a skip layer in two
# products), which now and then flips one bf16 rounding of an activation
# (2^-8 relative) that the following layers carry; the card's kernels are
# held to the same 1e-3 (tests/test_torch_kernels_cuda.py)
TOL = 1e-3
WG_ROWS = 64  # rows of a consumer warpgroup
SMEM = 232448  # shared memory a block may use


def _bf(x):
    return x.bfloat16().float()


def _lrelu(x):
    return torch.where(x >= 0, x, 0.01 * x)


def _setup(voxel, n, s, seed=1):
    cfg = ObjectNeRFConfig(use_voxel_embedding=voxel)
    model = ObjectNeRF(cfg).reset_parameters_(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.sigma.bias += 1.0  # densities clear of the last sample's step at 0
    rng = np.random.RandomState(seed)
    z = np.sort(0.5 + 4.0 * rng.rand(n, s), -1).astype(np.float32)
    o, d = rng.randn(n, 3) * 0.3, rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    xyz = torch.from_numpy((o[:, None] + d[:, None] * z[..., None]).astype(np.float32))
    dirs = torch.from_numpy(d.astype(np.float32))
    codes = torch.from_numpy(rng.randn(n, cfg.N_obj_code_length).astype(np.float32))
    raw = None
    if voxel:
        n_vox = cfg.N_scn_voxel_size + cfg.N_obj_voxel_size
        raw = torch.from_numpy((rng.randn(n, s, n_vox) * 0.5).astype(np.float32))
    return (cfg, model, xyz.contiguous(), torch.from_numpy(z), freq_encode(dirs, cfg.N_freq_dir),
            codes, raw)


def _emulate(packed, cfg, xyz, dir_pe, codes, raw, mode, forward_instance=None,
             compute_scene=None):
    """The chain in `mode` over the launch's tiles; returns (n*S, 8) rows
    [sigma, rgb, sigma_inst, rgb_inst] (zeros for a branch that is off). The
    modes without the rgb heads stop at the sigma head (no `final`, no
    direction layer, rgb left at zero; `dir_pe` unused), and their tile holds
    the scene branch's columns alone when the object branch is off. The
    point-wise modes are the same dataflow with a "ray" of S points per code:
    xyz (N / S, S, 3)."""
    n, s, _ = xyz.shape
    chunks = fc.forward_chunks(packed, mode, forward_instance, compute_scene)
    forward_instance, compute_scene = fc.chain_branches(mode, forward_instance, compute_scene)
    sigma_only = mode not in fc.HEAD_MODES
    maps = fc.sweep_weight_maps(packed, forward_instance)
    w, b = packed.w.float(), packed.b
    # the tile holds the object branch's columns, or the scene's alone
    x_cols = fc.input_tile_columns(cfg)[int(forward_instance or not sigma_only)]
    emb, obj_voxel = embed_inputs(cfg, xyz.reshape(-1, 3), raw)
    pieces = [emb]  # then the object branch's own columns, as the kernel's build
    if forward_instance:
        pieces += ([obj_voxel] if obj_voxel is not None else []) + [codes.repeat_interleave(s, 0)]
    inputs = torch.cat(pieces, dim=-1)
    n_rows = n * s
    n_tiles = -(-n_rows // 128)
    out = torch.zeros(n_rows, 8)

    def box_rows(slot, row):  # one chunk's rows of a map's matrix, box by box
        off, rows, cols = maps[slot]
        k_rows = fc.forward_chunk_rows(cols)
        mat = w[off:off + rows * cols].reshape(rows, cols)
        boxes = [mat[row:row + k_rows, c:c + fc.SWEEP_BOX[0]]
                 for c in range(0, cols, fc.SWEEP_BOX[0])]
        return torch.cat(boxes, dim=1)

    for tile in range(n_tiles):
        for wg in range(2):
            g0 = tile * 128 + WG_ROWS * wg
            real = max(0, min(WG_ROWS, n_rows - g0))
            X = torch.zeros(WG_ROWS, x_cols)
            X[:real, :inputs.shape[1]] = inputs[g0:g0 + real]
            X = _bf(X)
            cursor = 0  # every warpgroup reads the tile's whole chunk list

            def gemm(A, slot, r0, k):
                nonlocal cursor
                acc = 0.0
                k_rows = fc.forward_chunk_rows(maps[slot][2])
                for kc in range(0, k, k_rows):
                    c_slot, c_row, c_boxes = chunks[cursor]
                    assert (c_slot, c_row) == (slot, r0 + kc), (cursor, chunks[cursor])
                    assert c_boxes * fc.SWEEP_BOX[0] == maps[slot][2]
                    acc = acc + A[:, kc:kc + k_rows] @ box_rows(slot, c_row)
                    cursor += 1
                return acc

            for bi, (tab, width) in enumerate(((packed.scene, fc.SCENE_W),
                                               (packed.obj, fc.OBJ_W))):
                if (bi == 0 and not compute_scene) or (bi == 1 and not forward_instance):
                    continue
                base, depth, k0 = bi * fc.SWEEP_MAPS_PER_BRANCH, tab[fc.T_DEPTH], tab[fc.T_K0]
                h = None
                for i in range(depth if sigma_only else depth + 1):  # the trunk, `final`
                    if i == 0:
                        acc = gemm(X, base, 0, k0)
                    elif i < depth and (tab[fc.T_SKIPS] >> i) & 1:
                        acc = gemm(X, base + i, 0, k0) + gemm(h, base + i, k0, width)
                    else:
                        acc = gemm(h, base + (i if i < depth else 8), 0, width)
                    bias = b[tab[fc.T_FINB if i == depth else fc.T_TB + i]:][:width]
                    pre = acc + bias
                    h = _bf(pre if i == depth else _lrelu(pre))
                    if i == depth - 1:
                        sig = h @ w[tab[fc.T_SIGW]:][:width] + b[tab[fc.T_SIGB]]
                out[g0:g0 + real, 4 * bi] = sig[:real]
                if sigma_only:
                    continue
                nd = width // 2
                rays = torch.arange(g0, g0 + WG_ROWS) // s
                d_rows = torch.zeros(WG_ROWS, dir_pe.shape[1])
                ok = rays < n
                d_rows[ok] = dir_pe[rays[ok]]
                wdd = w[tab[fc.T_DIRWD]:][:fc.MAX_DIR * nd].reshape(fc.MAX_DIR, nd)
                dbias = _bf(d_rows) @ wdd[:dir_pe.shape[1]] + b[tab[fc.T_DIRB]:][:nd]
                denc = _bf(_lrelu(gemm(h, base + 9, 0, width) + dbias))
                w_rgb = w[tab[fc.T_RGBW]:][:3 * nd].reshape(3, nd)
                rgb = torch.sigmoid(denc @ w_rgb.t() + b[tab[fc.T_RGBB]:][:3])
                out[g0:g0 + real, 4 * bi + 1:4 * bi + 4] = rgb[:real]
            assert cursor == len(chunks)
    return out


# (samples per ray, rays): a ragged last tile at every S
SHAPES = [(32, 9), (64, 5), (128, 3)]
FLAGS = [(True, True), (False, True), (True, False)]  # (forward_instance, compute_scene)


@pytest.mark.parametrize("voxel", [False, True], ids=["classical", "voxel"])
@pytest.mark.parametrize("s,n", SHAPES)
@pytest.mark.parametrize("forward_instance,compute_scene", FLAGS)
def test_chain_reproduces_mlp_eval_plain(voxel, s, n, forward_instance, compute_scene):
    cfg, model, xyz, _, dir_pe, codes, raw = _setup(voxel, n, s)
    with torch.no_grad():
        packed = fc.pack_kernel_weights(model, cfg, True)
        got = _emulate(packed, cfg, xyz, dir_pe, codes, raw, "eval", forward_instance,
                       compute_scene)
        want = fv.mlp_eval_plain(model, cfg, xyz, dir_pe, codes, forward_instance,
                                 compute_scene, voxel_raw=raw)
    want = torch.cat([want[0].reshape(-1, 1), want[1].reshape(-1, 3),
                      want[2].reshape(-1, 1), want[3].reshape(-1, 3)], dim=-1)
    assert (got - want).abs().max().item() < TOL
    if not compute_scene:
        assert got[:, :4].abs().max() == 0
    if not forward_instance:
        assert got[:, 4:].abs().max() == 0


@pytest.mark.parametrize("voxel", [False, True], ids=["classical", "voxel"])
@pytest.mark.parametrize("s,n", SHAPES)
@pytest.mark.parametrize("forward_instance", [True, False])
def test_chain_reproduces_render_tiles_plain(voxel, s, n, forward_instance):
    """The render's chain, then its compositing (one warp per ray and branch
    in the kernel: the scene pass with the 1e10 last delta, the instance pass
    with 0 and white-backed rgb)."""
    cfg, model, xyz, z, dir_pe, codes, raw = _setup(voxel, n, s)
    with torch.no_grad():
        packed = fc.pack_kernel_weights(model, cfg, forward_instance)
        rows = _emulate(packed, cfg, xyz, dir_pe, codes, raw, "render", forward_instance)
        want = fm.render_tiles_plain(model, cfg, xyz, z, dir_pe, codes, raw, forward_instance,
                                     want_weights=True)
    scene = composite(rows[:, 0].reshape(n, s), rows[:, 1:4].reshape(n, s, 3), z)
    got = {"rgb": scene.rgb, "depth": scene.depth, "opacity": scene.opacity,
           "weights": scene.weights}
    if forward_instance:
        inst = composite_instance(rows[:, 4].reshape(n, s), rows[:, 5:8].reshape(n, s, 3), z,
                                  scene.depth, apply_occlusion=False)
        got.update(rgb_instance=inst.rgb, depth_instance=inst.depth,
                   opacity_instance=inst.opacity)
    assert set(got) == set(want)
    for k in want:
        assert (got[k] - want[k]).abs().max().item() < TOL, k


# the kernel's ring stages per mode, (classical, voxel): FwdCfg in the source
# gives each mode as many as shared memory holds beside what it keeps there
# (no activations: they stay in registers)
RING_STAGES = {"eval": (11, 6), "render": (11, 6), "weights": (12, 8), "sigma_scene": (13, 9),
               "sigma_obj": (12, 7)}
# the same when the activations had a 64-row tile per warpgroup in shared
# memory: no mode may have fewer stages than then
RING_STAGES_WITH_H = {"eval": (7, 2), "render": (7, 2), "weights": (8, 4),
                      "sigma_scene": (9, 5), "sigma_obj": (8, 3)}
# each mode's chunk orders: (mode, forward_instance, compute_scene), None
# where the mode fixes the branch
CHUNK_MODES = [pytest.param("eval", fi, cs, id=f"eval-{fi}-{cs}") for fi, cs in FLAGS] + [
    pytest.param("render", fi, None, id=f"render-{fi}") for fi in (True, False)] + [
    pytest.param(mode, None, None, id=mode) for mode in ("weights", "sigma_scene", "sigma_obj")]


def _chain_smem(cfg, mode, stages):
    """Shared memory of one block of the chain in `mode` with `stages` ring
    stages, as FwdCfg lays it out: the stages, two warpgroups' input tiles
    (the columns the mode's branches read; the activations stay in
    registers, and the rows' own inputs are read through L1), two tiles' row
    buffers (the modes that composite), with the heads each warpgroup's
    direction biases and staged direction encodings (two rays), the
    barriers and 1 KB of alignment."""
    scene_k0, obj_k0 = fc.input_tile_columns(cfg)
    x_cols = scene_k0 if mode in ("weights", "sigma_scene") else obj_k0
    rowbuf = 9 * 128 if mode in ("render", "weights") else 0
    heads = mode in ("eval", "render")
    dbias = 2 * (fc.SCENE_W + fc.OBJ_W) // 2 if heads else 0
    dirs = 2 * fc.MAX_DIR if heads else 0
    return (stages * fc.FWD_STAGE_BYTES + 2 * WG_ROWS * x_cols * 2 + 2 * rowbuf * 4
            + 2 * dbias * 4 + 2 * dirs * 4 + 8 * (2 * stages + 2) + 1024)


@pytest.mark.parametrize("voxel", [False, True], ids=["classical", "voxel"])
@pytest.mark.parametrize("mode,forward_instance,compute_scene", CHUNK_MODES)
def test_chunks_meet_the_hardware_rules(voxel, mode, forward_instance, compute_scene):
    """Every chunk lies inside its tensor map: a row of boxes of 64 columns
    (128 bytes, the swizzle span) across the matrix, as many rows (a multiple
    of the 16-row K step, within 256) as fill one FWD_STAGE_BYTES stage, at a
    row that is a multiple of them; 16-byte aligned addresses and row strides.
    The ring's stages and the two warpgroups' tiles fit a block's shared
    memory in the mode, and one stage more would not (FwdCfg in the source:
    11 stages beside the classical tile, 6 beside the voxel one; the
    sigma-only modes hold fewer columns and buffers); a tile has more chunks
    than the ring has stages where row buffers alternate by tile parity on
    that, and the counts match the branches' layers (no `final` or direction
    layer in the sigma-only order)."""
    cfg = ObjectNeRFConfig(use_voxel_embedding=voxel)
    sigma_only = mode not in fc.HEAD_MODES
    packed = fc.pack_kernel_weights(ObjectNeRF(cfg), cfg, True, sigma_only=sigma_only)
    chunks = fc.forward_chunks(packed, mode, forward_instance, compute_scene)
    assert fc.forward_weight_bytes(packed, mode, forward_instance, compute_scene) == (
        fc.FWD_STAGE_BYTES * len(chunks))
    forward_instance, compute_scene = fc.chain_branches(mode, forward_instance, compute_scene)
    maps = fc.sweep_weight_maps(packed, forward_instance)
    box_cols = fc.SWEEP_BOX[0]
    assert 2 * box_cols == fv.WG_SWIZZLE_BYTES
    for slot, row, boxes in chunks:
        off, rows, cols = maps[slot]
        k_rows = fc.forward_chunk_rows(cols)
        assert rows > 0 and cols == boxes * box_cols and cols <= 256
        assert k_rows % 16 == 0 and k_rows <= 256
        assert boxes * box_cols * k_rows * 2 == fc.FWD_STAGE_BYTES
        assert row % k_rows == 0 and row + k_rows <= rows and row // 16 < 2048
        assert (2 * off) % 16 == 0 and (2 * cols) % 16 == 0
        if not compute_scene:
            assert slot >= fc.SWEEP_MAPS_PER_BRANCH
        if not forward_instance:
            assert slot < fc.SWEEP_MAPS_PER_BRANCH
        if sigma_only:
            assert slot % fc.SWEEP_MAPS_PER_BRANCH < 8
    # chunks per branch: layer 0 and the skip layers' input rows, the hidden
    # rows of the later layers and `final` (32 or 64 rows a chunk), the
    # direction layer (its width / 2 columns, twice the rows)
    want = 0
    for bi, tab in enumerate((packed.scene, packed.obj)):
        if (bi == 0 and not compute_scene) or (bi == 1 and not forward_instance):
            continue
        width, k0, depth = (fc.SCENE_W, fc.OBJ_W)[bi], tab[fc.T_K0], tab[fc.T_DEPTH]
        n_skip = bin(tab[fc.T_SKIPS]).count("1")
        k_rows = fc.forward_chunk_rows(width)
        if sigma_only:
            want += ((1 + n_skip) * k0 + (depth - 1) * width) // k_rows
        else:
            want += ((1 + n_skip) * k0 + depth * width) // k_rows + width // (2 * k_rows)
    assert len(chunks) == want <= fc.FWD_MAX_CHUNKS
    x_cols = fc.input_tile_columns(cfg)
    assert x_cols[0] % 64 == 0 and x_cols[1] % 64 == 0
    stages = RING_STAGES[mode][int(voxel)]
    assert _chain_smem(cfg, mode, stages) <= SMEM < _chain_smem(cfg, mode, stages + 1)
    if not mode.startswith("sigma"):
        assert len(chunks) > stages


@pytest.mark.parametrize("voxel", [False, True], ids=["classical", "voxel"])
def test_sigma_only_packing_maps_no_missing_slot(voxel):
    """A sigma_only packing holds no `final` and no direction layer: their
    map slots are empty ((0, 0, 0): the launcher encodes no map there), every
    other map covers its own layer's block of the packed weights and no
    other matrix's rows, the sigma-only modes' chunk orders read only maps
    that are there, and the modes with the rgb heads refuse the packing."""
    cfg = ObjectNeRFConfig(use_voxel_embedding=voxel)
    packed = fc.pack_kernel_weights(ObjectNeRF(cfg), cfg, True, sigma_only=True)
    maps = fc.sweep_weight_maps(packed, True)
    per = fc.SWEEP_MAPS_PER_BRANCH
    spans = []
    for bi, tab in enumerate((packed.scene, packed.obj)):
        assert maps[bi * per + 8] == maps[bi * per + 9] == (0, 0, 0)
        for i in range(tab[fc.T_DEPTH]):
            off, rows, cols = maps[bi * per + i]
            assert off == tab[fc.T_TW + i] and rows > 0 and cols == (fc.SCENE_W, fc.OBJ_W)[bi]
            spans.append((off, off + rows * cols))
        for i in range(tab[fc.T_DEPTH], 8):
            assert maps[bi * per + i] == (0, 0, 0)
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))  # no map overlaps another
    assert spans[-1][1] <= packed.w.numel()
    for mode in ("weights", "sigma_scene", "sigma_obj"):
        for slot, _, _ in fc.forward_chunks(packed, mode):
            assert maps[slot][1] > 0
    for flags in ((False, True), (True, False), (True, True)):
        with pytest.raises(ValueError):
            fc.forward_chunks(packed, "eval", *flags)
    with pytest.raises(ValueError):
        fc.forward_chunks(packed, "render")


@pytest.mark.parametrize("mode", fc.CHAIN_MODES)
def test_forward_launch_tables_match_the_chunk_order(mode):
    """The launch's flat tables are the branches' offset tables (the object
    branch's where it runs), the maps and the mode's chunk order, built once
    per layout: two packings of the same architecture (other weights, same
    offsets) share them."""
    cfg = ObjectNeRFConfig(use_voxel_embedding=False)
    packs = [fc.pack_kernel_weights(ObjectNeRF(cfg).reset_parameters_(
        torch.Generator().manual_seed(k)), cfg, True, sigma_only=mode not in fc.HEAD_MODES)
        for k in (0, 1)]
    tabs = [fc.forward_launch_tables(p, mode) for p in packs]
    assert tabs[0] is tabs[1]
    scene, obj, wmap, chunks, n = tabs[0]
    forward_instance = fc.chain_branches(mode)[0]
    assert list(scene) == packs[0].scene
    assert (list(obj) == packs[0].obj) if forward_instance else obj is None
    assert list(wmap) == [v for m in fc.sweep_weight_maps(packs[0], forward_instance) for v in m]
    want = fc.forward_chunks(packs[0], mode)
    assert n == len(want) and list(chunks) == [v for c in want for v in c]


def test_modes_fix_their_branches():
    """The mode is the one selector: "eval" takes both branch flags, "render"
    the object branch's, the other modes neither; the chunk order stops at
    the sigma head exactly in the modes without the rgb heads (FwdCfg::HEADS
    in the source)."""
    assert fc.chain_branches("eval") == (True, True)
    assert fc.chain_branches("eval", False, True) == (False, True)
    assert fc.chain_branches("render", False) == (False, True)
    assert fc.chain_branches("weights") == fc.chain_branches("sigma_scene") == (False, True)
    assert fc.chain_branches("sigma_obj") == (True, False)
    for mode, kw in (("render", {"compute_scene": True}), ("weights", {"forward_instance": False}),
                     ("sigma_scene", {"compute_scene": True}),
                     ("sigma_obj", {"forward_instance": True})):
        with pytest.raises(ValueError):
            fc.chain_branches(mode, **kw)
    with pytest.raises(ValueError):
        fc.chain_branches("density")
    assert fc.HEAD_MODES == ("eval", "render") == fc.CHAIN_MODES[:2]


def _scan_weights(sig, z, last_delta_inf):
    """The kernel's scan (composite_ray in the source) in f32: lane l of the
    ray's warp holds samples [l P, l P + P), P = S / 32; alpha = 1 - exp(-delta
    relu(sigma)), each lane's product of (1 - alpha + 1e-10), an inclusive
    scan of the lanes' products, each sample's exclusive transmittance from
    its lane's prefix and the products before it in the lane."""
    n, s = sig.shape
    last = torch.full((n, 1), 1e10 if last_delta_inf else 0.0)
    delta = torch.cat([z[:, 1:] - z[:, :-1], last], dim=-1)
    alpha = 1.0 - torch.exp(-delta * torch.relu(sig))
    t = (1.0 - alpha + 1e-10).reshape(n, 32, s // 32)
    in_lane = torch.cumprod(t, dim=-1)
    lanes = torch.cumprod(in_lane[..., -1], dim=-1)
    before = torch.cat([torch.ones(n, 1), lanes[:, :-1]], dim=-1)[..., None]
    trans = before * torch.cat([torch.ones(n, 32, 1), in_lane[..., :-1]], dim=-1)
    return alpha * trans.reshape(n, s)


@pytest.mark.parametrize("voxel", [False, True], ids=["classical", "voxel"])
@pytest.mark.parametrize("s,n", SHAPES)
@pytest.mark.parametrize("last_delta_inf", [True, False])
def test_chain_reproduces_coarse_weights_plain(voxel, s, n, last_delta_inf):
    """The coarse mode (FWD_WEIGHTS): the scene trunk and its sigma head over
    the sigma-only chunk order of a sigma_only packing, then the kernel's
    per-ray scan into the pdf weights; no rgb is computed."""
    cfg, model, xyz, z, _, _, raw = _setup(voxel, n, s)
    with torch.no_grad():
        packed = fc.pack_kernel_weights(model, cfg, False, sigma_only=True)
        rows = _emulate(packed, cfg, xyz, None, None, raw, "weights")
        want = fm.coarse_weights_plain(model, cfg, xyz, z, raw, last_delta_inf)
    assert rows[:, 1:].abs().max() == 0
    got = _scan_weights(rows[:, 0].reshape(n, s), z, last_delta_inf)
    assert (got - want).abs().max().item() < TOL


N_POINTS = 320  # 2.5 tiles: the last tile's second warpgroup has no row


@pytest.mark.parametrize("voxel", [False, True], ids=["classical", "voxel"])
@pytest.mark.parametrize("branch", fs.BRANCHES)
@pytest.mark.parametrize("per_row", [1, 5, 20, 64, N_POINTS])
def test_chain_reproduces_sigma_eval_plain(voxel, branch, per_row):
    """The point-wise modes (FWD_SIGMA_SCENE, FWD_SIGMA_OBJ): rows are
    consecutive points, the code of point p is row p // per_row, one branch
    runs over its sigma-only chunk order; N not a multiple of the tile."""
    cfg, model, xyz, _, _, _, raw = _setup(voxel, N_POINTS // 64, 64)
    rng = np.random.RandomState(7)
    pts = xyz.reshape(-1, 3)
    codes = torch.from_numpy(
        rng.randn(N_POINTS // per_row, cfg.N_obj_code_length).astype(np.float32))
    raw_p = None if raw is None else raw.reshape(N_POINTS, -1)
    instance = branch == "instance"
    with torch.no_grad():
        packed = fc.pack_kernel_weights(model, cfg, instance, sigma_only=True)
        rows = _emulate(packed, cfg, pts.reshape(-1, per_row, 3), None, codes,
                        None if raw_p is None else raw_p.reshape(-1, per_row, raw_p.shape[-1]),
                        "sigma_obj" if instance else "sigma_scene")
        want = fs.sigma_eval_plain(model, cfg, pts, codes, branch, per_row, raw_p)
    assert rows[:, 4 * (1 - instance)].abs().max() == 0  # the other branch is off
    assert (rows[:, 4 * instance] - want).abs().max().item() < TOL


@pytest.mark.parametrize("voxel", [False, True], ids=["classical", "voxel"])
@pytest.mark.parametrize("mode", list(RING_STAGES))
def test_ring_is_deeper_without_activation_tiles(voxel, mode):
    """With the activations in registers every (model, mode) keeps at least
    the stages it had beside a 64-row activation tile per warpgroup, the
    voxel eval and render rings (2 stages then, each chunk a full round trip
    to L2) at least 4; the mirror is the layout that fills the block, and
    the modes the chip's launchers name are the ones mirrored here."""
    cfg = ObjectNeRFConfig(use_voxel_embedding=voxel)
    stages = RING_STAGES[mode][int(voxel)]
    assert stages >= RING_STAGES_WITH_H[mode][int(voxel)]
    if voxel and mode in ("eval", "render"):
        assert stages >= 4
    assert _chain_smem(cfg, mode, stages) <= SMEM < _chain_smem(cfg, mode, stages + 1)
    assert fc.CHAIN_MODES == tuple(RING_STAGES)


def _c_fields(text, name):
    """(field name, C type) of `struct name { ... };` in a C source, in
    order; a pointer's type ends in '*'."""
    body = re.search(r"struct %s \{(.*?)\};" % name, re.sub(r"//[^\n]*", "", text), re.S)
    fields = []
    for decl in body.group(1).split(";"):
        if decl.strip():
            base, rest = re.match(r"\s*((?:const\s+)?\w+)(.*)", decl, re.S).groups()
            for d in rest.split(","):
                d = d.strip()
                fields.append((d.lstrip("*").strip(), base + "*" * d.startswith("*")))
    return fields


def _ctype(c_type, structs):
    if c_type.endswith("*"):
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong, **structs}[c_type]


def test_fwd_args_mirror_the_source():
    """fwd_chain.FwdArgs (and its VoxDims) has the fields of the source's
    structs, in their order and of their C types, so the one struct the
    chain's entry point reads is laid out alike on both sides."""
    csrc = _build.CSRC
    structs = {"VoxDims": fc.VoxDims}
    for mirror, name, src in ((fc.VoxDims, "VoxDims", "fused_mlp_common.cuh"),
                              (fc.FwdArgs, "FwdArgs", "fused_mlp_wg.cuh")):
        want = [(f, _ctype(t, structs)) for f, t in _c_fields((csrc / src).read_text(), name)]
        assert list(mirror._fields_) == want, name


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signatures_match_the_prototypes(name):
    """Every ctypes argument list of `_build.SIGNATURES` is its entry
    point's C prototype, argument by argument: a shifted argument would show
    only on the card."""
    protos = {}
    for src in _build.CSRC.glob("*.cu"):
        for m in re.finditer(r"^int (onerf_\w+)\(([^)]*)\)\s*\{", src.read_text(), re.M):
            protos[m.group(1)] = [re.sub(r"\s*\w+$", "", a.strip()).replace("const ", "")
                                  for a in m.group(2).split(",")]
    assert [_ctype(t, {}) for t in protos[name]] == _build.SIGNATURES[name]


def test_fwd_chain_is_the_only_owner():
    """`ops/fwd_chain.py` imports no `ops` module but `_build` (so every
    wrapper can import it at the top), and no `ops` module imports the
    backward's module inside a function; the library's one entry point
    launches the chain."""
    assert "onerf_fwd_chain" in _build.SIGNATURES
    ops = Path(fc.__file__).parent
    for node in ast.walk(ast.parse((ops / "fwd_chain.py").read_text())):
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            assert node.module == "_build", node.module
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            assert not (node.module or "").startswith("object_nerf_torch.ops")
    for path in sorted(ops.glob("*.py")):
        for fn in ast.walk(ast.parse(path.read_text())):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for node in ast.walk(fn):
                    if isinstance(node, ast.ImportFrom):
                        names = [node.module or ""] + [a.name for a in node.names]
                        assert not any(n.endswith("fused_mlp_vjp") for n in names), path.name
