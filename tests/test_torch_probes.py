"""The probe kernels' module (object_nerf_torch/ops/probes.py) and the row
gather against the Pallas kernels of the JAX package's `scripts/`.

Those kernels take no `interpret` flag, so here they run with the module's
`pl.pallas_call` patched to interpret mode. `make_kernel` is only wrapped by a
`pallas_call` inside the script's `main()`, so the test builds that call
itself at a small size; `dummy_pallas` is a closure of its `main()` and cannot
be imported: `scale_copy_plain` is held to its written definition, `o = 2 x`
(scripts/profile_voxel_split.py:127-128). The CUDA kernels run only on the card
(tests/test_torch_kernels_cuda.py).
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
