"""The forward chain of `fused_mlp_eval` and `fused_render_tiles`
(object_nerf_torch/ops/csrc/fused_mlp_wg.cuh), emulated on the CPU.

The kernel's producer streams the weight chunks of `fused_mlp_vjp.forward_chunks`
through a ring; two consumer warpgroups each compute 64 rows of a 128-row tile
from the boxes that the tensor maps of `sweep_weight_maps` cut out of the
packed weights. The emulation below walks the chunk list in the producer's
order, checks that each chunk is the one the consumer's loop reads next, and
computes each warpgroup's rows from those boxes in bf16 with f32 sums, with
the kernel's epilogues (bias and LeakyReLU in f32, then bf16; the heads and
the per-ray direction bias as the kernel forms them). It must reproduce the
plain versions (`mlp_eval_plain`, `render_tiles_plain`, which the JAX
package's kernels hold in tests/test_torch_fused_mlp*.py) for the classical
and the voxel model, S in {32, 64, 128}, each branch on and off, and a ragged
last tile. The kernels themselves run on the card
(tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest
import torch

from object_nerf_torch.models.embedding import freq_encode
from object_nerf_torch.models.mlp import ObjectNeRF, ObjectNeRFConfig, embed_inputs
from object_nerf_torch.ops import fused_mlp as fm
from object_nerf_torch.ops import fused_mlp_vjp as fv
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


def _emulate(packed, cfg, xyz, dir_pe, codes, raw, forward_instance, compute_scene):
    """The chain over the launch's tiles; returns (n*S, 8) rows [sigma, rgb,
    sigma_inst, rgb_inst] (zeros for a branch that is off)."""
    n, s, _ = xyz.shape
    chunks = fv.forward_chunks(packed, forward_instance, compute_scene)
    maps = fv.sweep_weight_maps(packed, forward_instance)
    w, b = packed.w.float(), packed.b
    x_cols = fm.input_tile_columns(cfg)[1]  # the tile holds the object branch's columns
    emb, obj_voxel = embed_inputs(cfg, xyz.reshape(-1, 3), raw)
    pieces = [emb] + ([obj_voxel] if obj_voxel is not None else [])
    if forward_instance:
        pieces.append(codes.repeat_interleave(s, 0))
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
                for i in range(depth + 1):  # the trunk, then `final`
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
                out[g0:g0 + real, 4 * bi] = sig[:real]
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


@pytest.mark.parametrize("voxel", [False, True], ids=["classical", "voxel"])
@pytest.mark.parametrize("forward_instance,compute_scene", FLAGS)
def test_chunks_meet_the_hardware_rules(voxel, forward_instance, compute_scene):
    """Every chunk lies inside its tensor map: a row of boxes of 64 columns
    (128 bytes, the swizzle span) across the matrix, as many rows (a multiple
    of the 16-row K step, within 256) as fill one FWD_STAGE_BYTES stage, at a
    row that is a multiple of them; 16-byte aligned addresses and row strides.
    The ring's stages and the two warpgroups' tiles fit a block's shared
    memory (FwdCfg in the source: 7 stages beside the classical tile, 2
    beside the voxel one); a tile has more chunks than the ring has stages
    (the render's row buffers alternate by tile parity on that), and the
    counts match the branches' layers."""
    cfg = ObjectNeRFConfig(use_voxel_embedding=voxel)
    packed = fm.pack_kernel_weights(ObjectNeRF(cfg), cfg, True)
    maps = fv.sweep_weight_maps(packed, forward_instance)
    chunks = fv.forward_chunks(packed, forward_instance, compute_scene)
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
    # the chain's shared memory: stages, two warpgroups' input tiles and
    # activations (64 rows each), two tiles' row buffers, the direction
    # biases, the barriers and 1 KB of alignment
    stages = 2 if voxel else 7
    x_cols = fm.input_tile_columns(cfg)[1]
    smem = (stages * fv.FWD_STAGE_BYTES + 2 * WG_ROWS * x_cols * 2
            + 2 * WG_ROWS * fm.SCENE_W * 2 + 2 * 9 * 128 * 4
            + 2 * 2 * (fm.SCENE_W + fm.OBJ_W) // 2 * 4 + 8 * (2 * stages + 2) + 1024)
    assert smem <= SMEM and x_cols % 64 == 0
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
        want += ((1 + n_skip) * k0 + depth * width) // k_rows + width // (2 * k_rows)
    assert len(chunks) == want > stages
    assert len(chunks) <= fv.FWD_MAX_CHUNKS
    assert fv.forward_weight_bytes(packed, forward_instance, compute_scene) == (
        fv.FWD_STAGE_BYTES * len(chunks))
