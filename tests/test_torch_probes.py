"""The probe kernels' module (object_nerf_torch/ops/probes.py) and the row
gather against the Pallas kernels of the JAX package's `scripts/`.

Those kernels take no `interpret` flag, so here they run with the module's
`pl.pallas_call` patched to interpret mode. `make_kernel` is only wrapped by a
`pallas_call` inside the script's `main()`, so the test builds that call
itself at a small size; `dummy_pallas` is a closure of its `main()` and cannot
be imported: `scale_copy_plain` is held to its written definition, `o = 2 x`
(scripts/profile_voxel_split.py:127-128). The CUDA kernels run only on the card
(tests/test_torch_kernels_cuda.py); the dataflow of `pe_probe`'s kernel over
its packed buffers (the encoding matrix, the trunk's chunks in the producer's
order, 64-row warpgroups with a ragged tail, the row sum in the kernel's
order) is emulated here and held to both.
"""

import functools
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import scripts.profile_dma_gather as jdg  # noqa: E402
import scripts.profile_pe_micro as jpe  # noqa: E402

from object_nerf_torch.ops import gather, probes  # noqa: E402
from object_nerf_torch.ops import fwd_chain as fc  # noqa: E402
from object_nerf_torch.scripts._fixtures import probe_inputs  # noqa: E402

torch.set_num_threads(2)

# both sides round the same operands to bf16 and sum in f32 in their own
# order; a flipped bf16 rounding travels through the 8-layer ReLU chain.
# Relative to the largest output; measured at most 2e-3 over the modes
PROBE_REL_TOL = 1e-2


def _interpret(mod):
    return mock.patch.object(mod.pl, "pallas_call",
                             functools.partial(mod.pl.pallas_call, interpret=True))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gather_rows_plain_matches_dma_gather(dtype):
    rng = np.random.RandomState(0)
    table = rng.randn(300, 192).astype(np.float32)
    idx = rng.randint(0, 300, size=(256,)).astype(np.int32)
    with _interpret(jdg):
        want = jdg.dma_gather(jnp.asarray(idx), jnp.asarray(table).astype(getattr(jnp, dtype)),
                              rows_per_tile=128, n_outstanding=8)
    t = torch.from_numpy(table).to(getattr(torch, dtype))
    got = gather.gather_rows(t, torch.from_numpy(idx))
    assert got.dtype == t.dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def _jax_probe(mode, x, s, trunk, tile=64):
    n = x.shape[0]
    with _interpret(jpe):
        call = jpe.pl.pallas_call(
            jpe.make_kernel(mode), grid=(n // tile,),
            in_specs=[jpe.pl.BlockSpec((tile, 27), lambda i: (i, 0))]
            + [jpe.pl.BlockSpec(a.shape, lambda i: (0, 0)) for a in list(s) + list(trunk)],
            out_specs=jpe.pl.BlockSpec((tile, 1), lambda i: (i, 0)),
            out_shape=jax.ShapeDtypeStruct((n, 1), jnp.float32))
        return np.asarray(call(*(jnp.asarray(a.numpy()) for a in [x] + list(s) + list(trunk))))


@pytest.mark.parametrize("mode", probes.MODES)
def test_pe_probe_plain_matches_make_kernel(mode):
    x, s, trunk = probe_inputs(128, "cpu", seed=1)
    want = _jax_probe(mode, x, s, trunk)
    probes.reset_launch_counts()
    got = probes.pe_probe(x, *s, trunk, mode)  # CPU tensors: the plain version
    assert probes.launch_counts == {"pe_probe": 0, "scale_copy": 0}
    assert got.shape == (128, 1) and got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err < PROBE_REL_TOL, err
    assert np.abs(want).max() > 0.1


def test_sin_turns_is_the_scripts_polynomial():
    u = np.linspace(-3.0, 3.0, 1001).astype(np.float32)
    np.testing.assert_allclose(probes.sin_turns(torch.from_numpy(u)).numpy(),
                               np.asarray(jpe._sin_turns(jnp.asarray(u))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(probes.sin_turns(torch.from_numpy(u)).numpy(),
                               np.sin(2 * np.pi * u.astype(np.float64)), rtol=0, atol=2e-5)


def test_modes_differ_where_they_should():
    x, s, trunk = probe_inputs(64, "cpu", seed=2)
    out = {m: probes.pe_probe_plain(x, *s, trunk, m) for m in probes.MODES}
    assert not torch.allclose(out["none"], out["xyz_only"])
    assert not torch.allclose(out["split"], out["combined"])
    # the polynomial sine is the sine of 2 pi u, not of u
    assert not torch.allclose(out["split"], out["split_polysin"])
    with pytest.raises(ValueError, match="mode"):
        probes.pe_probe_plain(x, *s, trunk, "fast")


def test_pack_probe_trunk_layout():
    _, _, trunk = probe_inputs(1, "cpu")
    packed = probes.pack_probe_trunk(trunk)
    assert packed.dtype == torch.bfloat16 and packed.numel() == 384 * 256 + 7 * 256 * 256
    first = packed[:384 * 256].reshape(384, 256)
    assert torch.equal(first[:375], trunk[0].bfloat16()) and (first[375:] == 0).all()
    assert torch.equal(packed[384 * 256 + 256 * 256:384 * 256 + 2 * 256 * 256],
                       trunk[2].bfloat16().reshape(-1))


def test_probe_wrappers_check_their_inputs():
    x, s, trunk = probe_inputs(8, "cpu")
    with pytest.raises(ValueError, match="mode"):
        probes.pe_probe(x, *s, trunk, "fast")
    with pytest.raises(ValueError, match="x must be"):
        probes.pe_probe(x[:, :20].contiguous(), *s, trunk, "none")
    with pytest.raises(ValueError, match="s_all"):
        probes.pe_probe(x, s[0], s[1], s[2], s[3].double(), trunk, "none")
    with pytest.raises(ValueError, match="8 matrices"):
        probes.pe_probe(x, *s, trunk[:3], "none")
    with pytest.raises(ValueError, match="contiguous float32"):
        probes.scale_copy(x.double())


@pytest.mark.parametrize("shape", [(256, 24), (7,), (3, 5, 2)])
def test_scale_copy_is_two_x(shape):
    x = torch.from_numpy(np.random.RandomState(0).randn(*shape).astype(np.float32))
    probes.reset_launch_counts()
    got = probes.scale_copy(x)
    assert probes.launch_counts["scale_copy"] == 0
    assert torch.equal(got, 2.0 * x) and torch.equal(probes.scale_copy_plain(x), got)


def _activate(u, mode):
    """The kernel's activation of the encoded columns in `mode`."""
    return (torch.sin, lambda t: t, probes.sin_turns)[probes.probe_activation(mode)](u)


@pytest.mark.parametrize("mode", probes.MODES)
def test_encoding_matrix_gives_the_plain_input_row(mode):
    """act(bf16(x) @ E_mode) in the columns from 27 on is the plain version's
    `[x | PE]`: the raw channels bf16(x) bit for bit, the encoded columns to
    1e-6 (the same bf16 operands, the f32 sums in another order), zero past
    column 375."""
    x, s, _ = probe_inputs(200, "cpu", seed=3)
    enc = probes.pack_probe_encoding(*s, mode)
    assert enc.dtype == torch.bfloat16 and enc.shape == (probes.ENC_K, probes.K0)
    xb = x.bfloat16().float()
    u = torch.nn.functional.pad(xb, (0, probes.ENC_K - probes.N_RAW)) @ enc.float()
    want = probes.probe_input_row(x, *s, mode)
    assert want.shape == (200, probes.N_RAW + probes.N_PE)
    assert torch.equal(u[:, :probes.N_RAW], xb)
    enc_cols = _activate(u[:, probes.N_RAW:375], mode)
    assert (enc_cols - want[:, probes.N_RAW:]).abs().max() <= 1e-6
    assert (u[:, 375:] == 0).all()
    if mode != "none":
        assert want[:, probes.N_RAW:].abs().max() > 0.5


def test_probe_chunks_cover_each_layer_once_in_order():
    """68 chunks of 32 rows (4 boxes of 64 columns: one 16 KB ring stage):
    layer 0's 384 rows, then each later layer's 256, each row once, inside
    the tensor maps, which tile the packed trunk."""
    maps, chunks = probes.probe_weight_maps(), probes.probe_chunks()
    assert len(chunks) == 68 <= fc.FWD_MAX_CHUNKS
    assert len(maps) == 2 * fc.SWEEP_MAPS_PER_BRANCH
    off = 0
    for i, (o, rows, cols) in enumerate(maps[:probes.DEPTH]):
        assert (o, rows, cols) == (off, probes.K0 if i == 0 else probes.WIDTH, probes.WIDTH)
        off += rows * cols
    assert off == probes.pack_probe_trunk(probe_inputs(1, "cpu")[2]).numel()
    assert all(m == (0, 0, 0) for m in maps[probes.DEPTH:])
    want = [(i, r, 4) for i in range(probes.DEPTH)
            for r in range(0, maps[i][1], 32)]
    assert chunks == want
    assert 2 * 32 * probes.WIDTH == fc.FWD_STAGE_BYTES == 2 * fc.forward_chunk_rows(256) * 256


WG_ROWS = 64  # rows of a consumer warpgroup


def _bf(t):
    return t.bfloat16().float()


def _emulate_probe(x, s, trunk, mode):
    """pe_probe's kernel on the CPU: per 128-row tile, two warpgroups of 64
    rows (rows past the end zero, never stored) stage bf16(x) padded to 32
    channels, take the encoding product by 64-column slices of E with the
    mode's activation on columns 27-374 (0 beyond), round to bf16, then run
    the trunk from the packed buffer: each layer's matrix is assembled from
    the chunks it consumes, each checked to be the next of the producer's
    order, and multiplied in one f32 product (the order of the sums inside
    the tensor cores is the hardware's; summing chunk by chunk here instead
    flips a bf16 rounding in a few rows, 3e-4 of the largest output), then
    ReLU and bf16; each row of the last layer is summed as the kernel does:
    each of a row's four lanes over its column pairs (8 n8 + c0, + 1), then
    the lanes by two shuffle steps."""
    packed = probes.pack_probe_trunk(trunk).float()
    enc = probes.pack_probe_encoding(*s, mode).float()
    maps, chunks = probes.probe_weight_maps(), probes.probe_chunks()
    n = x.shape[0]
    out = torch.full((n, 1), float("nan"))
    for tile in range(-(-n // 128)):
        for wg in range(2):
            g0 = tile * 128 + WG_ROWS * wg
            valid = max(0, min(WG_ROWS, n - g0))
            raw = torch.zeros(WG_ROWS, probes.ENC_K)
            raw[:valid, :probes.N_RAW] = _bf(x[g0:g0 + valid])
            h = torch.zeros(WG_ROWS, probes.K0)
            for c in range(0, probes.K0, 64):
                e = raw @ enc[:, c:c + 64]
                cols = torch.arange(c, c + 64)
                h[:, c:c + 64] = _bf(torch.where(
                    cols < probes.N_RAW, e,
                    torch.where(cols < 375, _activate(e, mode), torch.zeros(()))))
            cursor = 0
            for layer, (off, rows, cols) in enumerate(maps[:probes.DEPTH]):
                w = packed[off:off + rows * cols].reshape(rows, cols)
                parts = []
                for kc in range(0, rows, 32):
                    assert chunks[cursor][:2] == (layer, kc)
                    parts.append(w[kc:kc + 32])
                    cursor += 1
                h = _bf(torch.relu(h[:, :rows] @ torch.cat(parts)))
            assert cursor == len(chunks)
            hv = h.numpy()
            lanes = []
            for c0 in (0, 2, 4, 6):
                t = np.zeros(WG_ROWS, np.float32)
                for n8 in range(probes.WIDTH // 8):
                    t = t + (hv[:, 8 * n8 + c0] + hv[:, 8 * n8 + c0 + 1])
                lanes.append(t)
            total = (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])
            out[g0:g0 + valid, 0] = torch.from_numpy(total[:valid])
    return out


@pytest.mark.parametrize("mode", probes.MODES)
def test_kernel_dataflow_matches_plain_and_make_kernel(mode):
    """133 rows: a whole tile and a ragged one whose second warpgroup is
    empty. Against the plain version to 1e-5 of the largest output (the same
    bf16 operands and products; the row sums in the kernel's order), and
    against the JAX package's `make_kernel` (interpret mode, on the first 128
    rows) to PROBE_REL_TOL."""
    x, s, trunk = probe_inputs(133, "cpu", seed=4)
    got = _emulate_probe(x, s, trunk, mode)
    assert torch.isfinite(got).all()
    want = probes.pe_probe_plain(x, *s, trunk, mode)
    assert (got - want).abs().max() / want.abs().max() < 1e-5
    ref = _jax_probe(mode, x[:128], s, trunk)
    assert np.abs(got[:128].numpy() - ref).max() / np.abs(ref).max() < PROBE_REL_TOL
