"""The forward chain of `fused_mlp_eval`, `fused_render_tiles`,
`fused_coarse_weights` and `fused_sigma_eval`
(object_nerf_torch/ops/csrc/fused_mlp_wg.cuh), emulated on the CPU.

The kernel's producer streams the weight chunks of `fused_mlp_vjp.forward_chunks`
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

import numpy as np
import pytest
import torch

from object_nerf_torch.models.embedding import freq_encode
from object_nerf_torch.models.mlp import ObjectNeRF, ObjectNeRFConfig, embed_inputs
from object_nerf_torch.ops import fused_mlp as fm
from object_nerf_torch.ops import fused_mlp_vjp as fv
from object_nerf_torch.ops import fused_sigma as fs
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


def _emulate(packed, cfg, xyz, dir_pe, codes, raw, forward_instance, compute_scene,
             sigma_only=False):
    """The chain over the launch's tiles; returns (n*S, 8) rows [sigma, rgb,
    sigma_inst, rgb_inst] (zeros for a branch that is off). `sigma_only`:
    the modes that stop at the sigma head (no `final`, no direction layer,
    rgb left at zero; `dir_pe` unused), whose tile holds the scene branch's
    columns alone when the object branch is off. The point-wise mode is the
    same dataflow with a "ray" of S points per code: xyz (N / S, S, 3)."""
    n, s, _ = xyz.shape
    chunks = fv.forward_chunks(packed, forward_instance, compute_scene, sigma_only)
    maps = fv.sweep_weight_maps(packed, forward_instance)
    w, b = packed.w.float(), packed.b
    # the tile holds the object branch's columns, or the scene's alone
    x_cols = fm.input_tile_columns(cfg)[int(forward_instance or not sigma_only)]
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
        k_rows = fv.forward_chunk_rows(cols)
        mat = w[off:off + rows * cols].reshape(rows, cols)
        boxes = [mat[row:row + k_rows, c:c + fv.SWEEP_BOX[0]]
                 for c in range(0, cols, fv.SWEEP_BOX[0])]
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
                k_rows = fv.forward_chunk_rows(maps[slot][2])
                for kc in range(0, k, k_rows):
                    c_slot, c_row, c_boxes = chunks[cursor]
                    assert (c_slot, c_row) == (slot, r0 + kc), (cursor, chunks[cursor])
                    assert c_boxes * fv.SWEEP_BOX[0] == maps[slot][2]
                    acc = acc + A[:, kc:kc + k_rows] @ box_rows(slot, c_row)
                    cursor += 1
                return acc

            for bi, (tab, width) in enumerate(((packed.scene, fm.SCENE_W),
                                               (packed.obj, fm.OBJ_W))):
                if (bi == 0 and not compute_scene) or (bi == 1 and not forward_instance):
                    continue
                base, depth, k0 = bi * fv.SWEEP_MAPS_PER_BRANCH, tab[fm.T_DEPTH], tab[fm.T_K0]
                h = None
                for i in range(depth if sigma_only else depth + 1):  # the trunk, `final`
                    if i == 0:
                        acc = gemm(X, base, 0, k0)
                    elif i < depth and (tab[fm.T_SKIPS] >> i) & 1:
                        acc = gemm(X, base + i, 0, k0) + gemm(h, base + i, k0, width)
                    else:
                        acc = gemm(h, base + (i if i < depth else 8), 0, width)
                    bias = b[tab[fm.T_FINB if i == depth else fm.T_TB + i]:][:width]
                    pre = acc + bias
                    h = _bf(pre if i == depth else _lrelu(pre))
                    if i == depth - 1:
                        sig = h @ w[tab[fm.T_SIGW]:][:width] + b[tab[fm.T_SIGB]]
                out[g0:g0 + real, 4 * bi] = sig[:real]
                if sigma_only:
                    continue
                nd = width // 2
                rays = torch.arange(g0, g0 + WG_ROWS) // s
                d_rows = torch.zeros(WG_ROWS, dir_pe.shape[1])
                ok = rays < n
                d_rows[ok] = dir_pe[rays[ok]]
                wdd = w[tab[fm.T_DIRWD]:][:fm.MAX_DIR * nd].reshape(fm.MAX_DIR, nd)
                dbias = _bf(d_rows) @ wdd[:dir_pe.shape[1]] + b[tab[fm.T_DIRB]:][:nd]
                denc = _bf(_lrelu(gemm(h, base + 9, 0, width) + dbias))
                w_rgb = w[tab[fm.T_RGBW]:][:3 * nd].reshape(3, nd)
                rgb = torch.sigmoid(denc @ w_rgb.t() + b[tab[fm.T_RGBB]:][:3])
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
        packed = fm.pack_kernel_weights(model, cfg, True)
        got = _emulate(packed, cfg, xyz, dir_pe, codes, raw, forward_instance, compute_scene)
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
        packed = fm.pack_kernel_weights(model, cfg, forward_instance)
        rows = _emulate(packed, cfg, xyz, dir_pe, codes, raw, forward_instance, True)
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
# the modes that read each chunk order, by (forward_instance, compute_scene, sigma_only)
CHUNK_MODES = [pytest.param(fi, cs, False, id=f"{fi}-{cs}") for fi, cs in FLAGS] + [
    pytest.param(False, True, True, id="sigma_only-scene"),
    pytest.param(True, False, True, id="sigma_only-object")]


def _chain_smem(cfg, mode, stages):
    """Shared memory of one block of the chain in `mode` with `stages` ring
    stages, as FwdCfg lays it out: the stages, two warpgroups' input tiles
    (the columns the mode's branches read; the activations stay in
    registers, and the rows' own inputs are read through L1), two tiles' row
    buffers (the modes that composite), with the heads each warpgroup's
    direction biases and staged direction encodings (two rays), the
    barriers and 1 KB of alignment."""
    scene_k0, obj_k0 = fm.input_tile_columns(cfg)
    x_cols = scene_k0 if mode in ("weights", "sigma_scene") else obj_k0
    rowbuf = 9 * 128 if mode in ("render", "weights") else 0
    heads = mode in ("eval", "render")
    dbias = 2 * (fm.SCENE_W + fm.OBJ_W) // 2 if heads else 0
    dirs = 2 * fm.MAX_DIR if heads else 0
    return (stages * fv.FWD_STAGE_BYTES + 2 * WG_ROWS * x_cols * 2 + 2 * rowbuf * 4
            + 2 * dbias * 4 + 2 * dirs * 4 + 8 * (2 * stages + 2) + 1024)


@pytest.mark.parametrize("voxel", [False, True], ids=["classical", "voxel"])
@pytest.mark.parametrize("forward_instance,compute_scene,sigma_only", CHUNK_MODES)
def test_chunks_meet_the_hardware_rules(voxel, forward_instance, compute_scene, sigma_only):
    """Every chunk lies inside its tensor map: a row of boxes of 64 columns
    (128 bytes, the swizzle span) across the matrix, as many rows (a multiple
    of the 16-row K step, within 256) as fill one FWD_STAGE_BYTES stage, at a
    row that is a multiple of them; 16-byte aligned addresses and row strides.
    The ring's stages and the two warpgroups' tiles fit a block's shared
    memory in every mode that reads the chunk order, and one stage more would
    not (FwdCfg in the source: 11 stages beside the classical tile, 6 beside
    the voxel one; the sigma-only modes hold fewer columns and buffers); a
    tile has more chunks than the ring has stages where row buffers
    alternate by tile parity on that, and the counts match the branches'
    layers (no `final` or direction layer in the sigma-only order)."""
    cfg = ObjectNeRFConfig(use_voxel_embedding=voxel)
    packed = fm.pack_kernel_weights(ObjectNeRF(cfg), cfg, True, sigma_only=sigma_only)
    maps = fv.sweep_weight_maps(packed, forward_instance)
    chunks = fv.forward_chunks(packed, forward_instance, compute_scene, sigma_only)
    box_cols = fv.SWEEP_BOX[0]
    assert 2 * box_cols == fv.WG_SWIZZLE_BYTES
    for slot, row, boxes in chunks:
        off, rows, cols = maps[slot]
        k_rows = fv.forward_chunk_rows(cols)
        assert rows > 0 and cols == boxes * box_cols and cols <= 256
        assert k_rows % 16 == 0 and k_rows <= 256
        assert boxes * box_cols * k_rows * 2 == fv.FWD_STAGE_BYTES
        assert row % k_rows == 0 and row + k_rows <= rows and row // 16 < 2048
        assert (2 * off) % 16 == 0 and (2 * cols) % 16 == 0
        if not compute_scene:
            assert slot >= fv.SWEEP_MAPS_PER_BRANCH
        if not forward_instance:
            assert slot < fv.SWEEP_MAPS_PER_BRANCH
        if sigma_only:
            assert slot % fv.SWEEP_MAPS_PER_BRANCH < 8
    if not sigma_only:
        modes = ("eval", "render")
    else:
        modes = ("sigma_obj",) if forward_instance else ("weights", "sigma_scene")
    # chunks per branch: layer 0 and the skip layers' input rows, the hidden
    # rows of the later layers and `final` (32 or 64 rows a chunk), the
    # direction layer (its width / 2 columns, twice the rows)
    want = 0
    for bi, tab in enumerate((packed.scene, packed.obj)):
        if (bi == 0 and not compute_scene) or (bi == 1 and not forward_instance):
            continue
        width, k0, depth = (fm.SCENE_W, fm.OBJ_W)[bi], tab[fm.T_K0], tab[fm.T_DEPTH]
        n_skip = bin(tab[fm.T_SKIPS]).count("1")
        k_rows = fv.forward_chunk_rows(width)
        if sigma_only:
            want += ((1 + n_skip) * k0 + (depth - 1) * width) // k_rows
        else:
            want += ((1 + n_skip) * k0 + depth * width) // k_rows + width // (2 * k_rows)
    assert len(chunks) == want <= fv.FWD_MAX_CHUNKS
    x_cols = fm.input_tile_columns(cfg)
    assert x_cols[0] % 64 == 0 and x_cols[1] % 64 == 0
    for mode in modes:
        stages = RING_STAGES[mode][int(voxel)]
        assert _chain_smem(cfg, mode, stages) <= SMEM < _chain_smem(cfg, mode, stages + 1)
        if not mode.startswith("sigma"):
            assert len(chunks) > stages
    assert fv.forward_weight_bytes(packed, forward_instance, compute_scene, sigma_only) == (
        fv.FWD_STAGE_BYTES * len(chunks))


@pytest.mark.parametrize("voxel", [False, True], ids=["classical", "voxel"])
def test_sigma_only_packing_maps_no_missing_slot(voxel):
    """A sigma_only packing holds no `final` and no direction layer: their
    map slots are empty ((0, 0, 0): the launcher encodes no map there), every
    other map covers its own layer's block of the packed weights and no
    other matrix's rows, the sigma-only chunk order reads only maps that are
    there, and the full chunk order refuses the packing."""
    cfg = ObjectNeRFConfig(use_voxel_embedding=voxel)
    packed = fm.pack_kernel_weights(ObjectNeRF(cfg), cfg, True, sigma_only=True)
    maps = fv.sweep_weight_maps(packed, True)
    per = fv.SWEEP_MAPS_PER_BRANCH
    spans = []
    for bi, tab in enumerate((packed.scene, packed.obj)):
        assert maps[bi * per + 8] == maps[bi * per + 9] == (0, 0, 0)
        for i in range(tab[fm.T_DEPTH]):
            off, rows, cols = maps[bi * per + i]
            assert off == tab[fm.T_TW + i] and rows > 0 and cols == (fm.SCENE_W, fm.OBJ_W)[bi]
            spans.append((off, off + rows * cols))
        for i in range(tab[fm.T_DEPTH], 8):
            assert maps[bi * per + i] == (0, 0, 0)
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))  # no map overlaps another
    assert spans[-1][1] <= packed.w.numel()
    for flags in ((False, True), (True, False), (True, True)):
        for slot, _, _ in fv.forward_chunks(packed, *flags, sigma_only=True):
            assert maps[slot][1] > 0
        with pytest.raises(ValueError):
            fv.forward_chunks(packed, *flags)


@pytest.mark.parametrize("forward_instance,compute_scene,sigma_only",
                         [(True, True, False), (False, True, True), (True, False, True)])
def test_forward_launch_tables_match_the_chunk_order(forward_instance, compute_scene,
                                                     sigma_only):
    """The launchers' flat tables are the maps and the chunk order, built
    once per layout: two packings of the same architecture (other weights,
    same offsets) share them."""
    cfg = ObjectNeRFConfig(use_voxel_embedding=False)
    packs = [fm.pack_kernel_weights(ObjectNeRF(cfg).reset_parameters_(
        torch.Generator().manual_seed(k)), cfg, True, sigma_only=sigma_only) for k in (0, 1)]
    tabs = [fv.forward_launch_tables(p, forward_instance, compute_scene, sigma_only)
            for p in packs]
    assert tabs[0] is tabs[1]
    wmap, chunks, n = tabs[0]
    assert list(wmap) == [v for m in fv.sweep_weight_maps(packs[0], forward_instance) for v in m]
    want = fv.forward_chunks(packs[0], forward_instance, compute_scene, sigma_only)
    assert n == len(want) and list(chunks) == [v for c in want for v in c]


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
        packed = fm.pack_kernel_weights(model, cfg, False, sigma_only=True)
        rows = _emulate(packed, cfg, xyz, None, None, raw, False, True, sigma_only=True)
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
        packed = fm.pack_kernel_weights(model, cfg, instance, sigma_only=True)
        rows = _emulate(packed, cfg, pts.reshape(-1, per_row, 3), None, codes,
                        None if raw_p is None else raw_p.reshape(-1, per_row, raw_p.shape[-1]),
                        instance, not instance, sigma_only=True)
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
    assert fm.CHAIN_MODES == tuple(RING_STAGES)
