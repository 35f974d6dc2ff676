"""The fused corner-table lookup (`ops/gather.py:corner_lookup`, kernel
`corner_lookup_kernel` in `ops/csrc/gather_rows.cu`) on the CPU.

The kernel runs only on the card (tests/test_torch_kernels_cuda.py). Here a
numpy emulation of its dataflow (per sample the same f32 and int32 operations
in the same order, then per 8-channel slice the 8 weighted corners summed in
the order of torch's reduction on the card, with no fused multiply-add) is
held to the plain chain `corner_lookup_plain` (`corner_index_weights`,
`gather_rows_plain`, `corner_sum`): the row index, the weights and the flag
equal, the sums within 1e-6 of the size of their terms (torch's CPU reduction
sums in another order). The wrapper's checks and its CPU route are tested
too.
"""

import numpy as np
import pytest
import torch

from object_nerf_torch.models import voxel_grid as vg
from object_nerf_torch.ops import gather

torch.set_num_threads(2)

# two orders of an 8-term f32 sum differ by at most about 2 x 7 x 2^-24 of the
# sum of the terms' magnitudes
SUM_REL_TOL = 1e-6


def _grid(seed=3):
    """A small grid of N(0, 1) features: shape about (15, 13, 11), 24 channels."""
    rng = np.random.RandomState(seed)
    pcd = rng.rand(4000, 3) * [1.2, 1.0, 0.8] - [0.6, 0.5, 0.4]
    return vg.build_voxel_grid(pcd, [0.0, 0.0, 0.0], 1.0, 0.1, 3, 24, 6, 100000,
                               generator=torch.Generator().manual_seed(seed))


def _points(topo, static, which, seed=7):
    """f32 samples: `inside` the grid; on its `faces` and `edges` (scaled
    coordinates on the lattice at -1, 0, the last cell and one past it, mixed
    over the axes); `outside` it beyond each of its six sides, some far away."""
    rng = np.random.RandomState(seed)
    vs, off = float(topo.voxel_size), topo.voxel_offset.numpy().astype(np.float64)
    dims = np.asarray(static.shape, np.float64)
    if which == "inside":
        scaled = rng.rand(4000, 3) * (dims + 1.0) - 1.0
    elif which == "faces_edges":
        lattice = np.stack([np.asarray([-1.0, 0.0, d - 1.0, d, d - 0.5, 0.5]) for d in dims], 1)
        pick = rng.randint(0, lattice.shape[0], size=(3000, 3))
        scaled = lattice[pick, np.arange(3)]
        inner = rng.rand(3000, 3) < 0.3  # some coordinates anywhere inside instead
        scaled = np.where(inner, rng.rand(3000, 3) * dims, scaled)
    else:
        sides = []
        for axis in range(3):
            for beyond in (-rng.rand(400) * 5.0 - 1.0, dims[axis] + rng.rand(400) * 5.0):
                p = rng.rand(400, 3) * dims
                p[:, axis] = beyond
                sides.append(p)
        far = rng.rand(12, 3) * dims
        far[np.arange(12), np.arange(12) % 3] = np.tile([-1e10, 1e10], 6)
        scaled = np.concatenate(sides + [far])
    return torch.from_numpy((scaled * vs - off).astype(np.float32))


def _cvt_rzi(x):
    """int32 of f32 values as the card's cvt.rzi.s32.f32: toward zero,
    saturating, NaN to 0."""
    x = np.nan_to_num(x.astype(np.float64), nan=0.0)
    return np.clip(np.trunc(x), -2.0 ** 31, 2.0 ** 31 - 1).astype(np.int64)


def emulate_corner_lookup(ct, xyz, voxel_offset, voxel_size, shape):
    """The kernel's dataflow in numpy: ct (rows, 8 C) of f32 values (a bf16
    table widened exactly), xyz (N, 3) f32 -> (out (N, C), invalid, flat, wts)."""
    f32 = np.float32
    dims = np.asarray(shape, np.int64)
    _, Y, Z = shape
    c = ct.shape[1] // 8
    xs = (xyz + voxel_offset) / f32(voxel_size)  # IEEE f32 add, then divide
    base = np.floor(xs)
    q0 = _cvt_rzi(base)
    valid = np.all((q0 >= -1) & (q0 <= dims - 1), axis=1)
    q1 = (q0 + 1 + 2 ** 31) % 2 ** 32 - 2 ** 31  # the int32 add wraps
    pb = np.minimum(np.maximum(q1, 0), dims)
    flat = ((pb[:, 0] * (Y + 1) + pb[:, 1]) * (Z + 1) + pb[:, 2]).astype(np.int32)
    u, v, w = (xs - base).T
    lu, lv, lw = f32(1) - u, f32(1) - v, f32(1) - w
    m = valid.astype(f32)
    wts = np.stack([(uv * z) * m for uv in (lu * lv, lu * v, u * lv, u * v) for z in (lw, w)], 1)
    assert wts.dtype == f32
    rows = ct[flat]
    out = np.empty((len(xyz), c), f32)
    for s in range(c // gather.CORNER_SLICE):  # one thread's slice of 8 channels
        cols = slice(gather.CORNER_SLICE * s, gather.CORNER_SLICE * (s + 1))
        prod = [rows[:, k * c:(k + 1) * c][:, cols] * wts[:, k:k + 1] for k in range(8)]
        # four accumulators from +0 take corners k and k + 4, then add up in order
        part = [(f32(0) + prod[k]) + prod[k + 4] for k in range(4)]
        out[:, cols] = ((part[0] + part[1]) + part[2]) + part[3]
    return out, ~valid, flat, wts


def _terms_magnitude(ct, flat, wts, c):
    """Per output entry, the sum of |weight x corner| over the 8 corners."""
    rows = np.abs(ct[flat].reshape(-1, 8, c).astype(np.float64))
    return (rows * np.abs(wts.astype(np.float64))[..., None]).sum(1)


@pytest.mark.parametrize("which", ["inside", "faces_edges", "outside"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_emulated_kernel_matches_plain_chain(dtype, which):
    feats, topo, static = _grid()
    ct = vg.make_corner_table(feats, topo, static, lowp=dtype == torch.bfloat16)
    xyz = _points(topo, static, which)
    want_out, want_inv, want_flat, want_wts = gather.corner_lookup_plain(
        ct, xyz, topo, static, with_addressing=True)
    ct_np = ct.float().numpy()
    out, inv, flat, wts = emulate_corner_lookup(
        ct_np, xyz.numpy(), topo.voxel_offset.numpy(), topo.voxel_size.numpy(), static.shape)
    np.testing.assert_array_equal(flat, want_flat.numpy())
    np.testing.assert_array_equal(wts.view(np.uint32), want_wts.numpy().view(np.uint32))
    np.testing.assert_array_equal(inv, want_inv.numpy())
    gap = np.abs(out.astype(np.float64) - want_out.numpy())
    assert (gap <= SUM_REL_TOL * _terms_magnitude(ct_np, flat, wts, static.channels)).all()
    n_valid = int((~inv).sum())
    if which == "inside":
        assert n_valid == len(inv) and np.abs(out).max() > 0
    elif which == "faces_edges":
        assert 0 < n_valid < len(inv) and np.abs(out).max() > 0
    else:
        assert n_valid == 0 and (wts == 0).all()


@pytest.mark.parametrize("with_addressing", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wrapper_on_cpu_is_the_plain_chain(dtype, with_addressing):
    feats, topo, static = _grid()
    ct = vg.make_corner_table(feats, topo, static, lowp=dtype == torch.bfloat16)
    xyz = torch.cat([_points(topo, static, w) for w in ("inside", "faces_edges", "outside")])
    gather.reset_launch_counts()
    got = gather.corner_lookup(ct, xyz, topo, static, with_addressing=with_addressing)
    want = gather.corner_lookup_plain(ct, xyz, topo, static, with_addressing=with_addressing)
    assert gather.launch_counts == {"gather_rows": 0, "corner_lookup": 0}
    assert len(got) == (4 if with_addressing else 2)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # the lookups of a frame's table and of a step's trainable table take it too
    table = vg.CornerTable(feats, topo, static, lowp=dtype == torch.bfloat16)
    with torch.no_grad():
        assert torch.equal(table.lookup(xyz)[0], want[0])
    trainable = vg.CornerTable(feats.clone().requires_grad_(), topo, static,
                               lowp=dtype == torch.bfloat16)
    out, inv, flat, wts = trainable.lookup(xyz, with_addressing=True)
    assert out.requires_grad and torch.equal(out.detach(), want[0]) and torch.equal(inv, want[1])
    assert gather.launch_counts == {"gather_rows": 0, "corner_lookup": 0}


def _bad_inputs(case):
    feats, topo, static = _grid()
    ct = vg.make_corner_table(feats, topo, static)
    xyz = _points(topo, static, "inside")[:64].contiguous()
    if case == "channels":  # 12 channels: not a multiple of the 8-channel slice
        static = vg.VoxelStatic(static.shape, 12, static.n_freq_voxel, static.n_max_voxels)
        ct = ct[:, :96].contiguous()
    elif case == "xyz_strided":
        xyz = torch.cat([xyz, xyz], 1)[:, ::2]
    elif case == "ct_strided":
        ct = torch.cat([ct, ct], 1)[:, ::2]
    elif case == "xyz_dtype":
        xyz = xyz.double()
    elif case == "ct_dtype":
        ct = ct.half()
    elif case == "device":
        xyz = torch.empty(64, 3, device="meta")
    elif case == "rows":
        ct = ct[:-1]
    return ct, xyz, topo, static


@pytest.mark.parametrize("case,match", [
    ("channels", "slices of 8"), ("xyz_strided", "contiguous"), ("ct_strided", "contiguous"),
    ("xyz_dtype", "float32"), ("ct_dtype", "bfloat16 or float32"), ("device", "is on"),
    ("rows", "rows")])
def test_wrapper_refuses_what_the_kernel_cannot_take(case, match):
    ct, xyz, topo, static = _bad_inputs(case)
    with pytest.raises(ValueError, match=match):
        gather.corner_lookup(ct, xyz, topo, static)
