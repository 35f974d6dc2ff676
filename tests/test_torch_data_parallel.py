"""The port's data parallelism (`object_nerf_torch/parallel/`) on the CPU: two
gloo ranks against one process, and against the JAX package's single-device
step (tests/test_data_parallel.py's semantics: one loss over the global
batch, so N ranks equal one process).

The ranks run in one launch of `python -m object_nerf_torch.parallel.dryrun
--nprocs 2` (a `file://` rendezvous, so no port is taken; one thread per
rank; its own timeout), with JAX and the JAX package unimportable there; the
cases below read its results."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from object_nerf_torch.parallel import dryrun, mesh
from object_nerf_torch.train.convert import from_jax_grads, from_jax_params

from _torch_port import SMALL, jax_params, to_numpy
from test_torch_train_render import jax_draws
from test_torch_train_step import (
    BATCH, LOSS_W, NI, NS, RENDER, STEPS_PER_EPOCH, TRAIN, _batches, _jax_loss, _jnp,
)

ROOT = Path(__file__).resolve().parents[1]
NPROCS = 2
BLOCKED = ("jax", "jaxlib", "object_nerf_tpu", "scripts")


def blocked_path(tmp):
    """A directory whose modules shadow JAX, the JAX package and `scripts`
    with modules that raise on import: first on PYTHONPATH, it makes them
    unimportable in every process started with it."""
    tmp.mkdir(exist_ok=True)
    for name in BLOCKED:
        (tmp / f"{name}.py").write_text(f"raise ImportError('{name} is blocked')\n")
    return tmp


def _jax_step():
    """The JAX package's monolithic step of tests/test_torch_train_step.py
    (weights, batch, key) and its loss, gradients and metrics."""
    from object_nerf_tpu.render.renderer import RenderSettings as JaxSettings
    from object_nerf_tpu.train import optim as jo
    from object_nerf_tpu.train.system import TrainState
    from object_nerf_tpu.train.system import make_train_step as jax_make_train_step
    from _torch_port import CFG_JAX
    import jax.numpy as jnp

    params = jax_params(seed=5)
    batch = _batches(1)[0]
    key = jax.random.PRNGKey(21)
    jst = JaxSettings(mlp=CFG_JAX, **RENDER)
    loss, grads = jax.value_and_grad(_jax_loss)(params, _jnp(batch), key, jst)
    opt = jo.make_optimizer(TRAIN, STEPS_PER_EPOCH)
    step_fn = jax_make_train_step(jst, LOSS_W, opt, None,
                                  jo.make_lr_schedule(TRAIN, STEPS_PER_EPOCH), donate=False)
    state, metrics = step_fn(TrainState(params, opt.init(params), jnp.int32(0)),
                             _jnp(batch), key, None)
    spec = {"state_dict": from_jax_params(to_numpy(params)), "model": dict(SMALL),
            "render": {**RENDER, "matmul_dtype": torch.float32}, "loss": LOSS_W,
            "train": TRAIN, "steps_per_epoch": STEPS_PER_EPOCH, "batch": batch,
            "draws": jax_draws(key, BATCH, NS, NI)}
    want = {"loss": float(loss), "grads": from_jax_grads(to_numpy(grads)),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": from_jax_params(to_numpy(state.params)),
            "before": from_jax_params(to_numpy(params))}
    return spec, want


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One launch of the dry run at 2 ranks with every scenario."""
    tmp = tmp_path_factory.mktemp("dp")
    spec, want = _jax_step()
    torch.save(spec, tmp / "inputs.pt")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(blocked_path(tmp / "blocked"))
    proc = subprocess.run(
        [sys.executable, "-m", "object_nerf_torch.parallel.dryrun", "--nprocs", str(NPROCS),
         "--device", "cpu", "--out", str(tmp / "out"), "--inputs", str(tmp / "inputs.pt"),
         "--timeout", "240"],
        cwd=tmp, env={**env, "PYTHONPATH": env["PYTHONPATH"] + os.pathsep + str(ROOT)},
        capture_output=True, text=True, timeout=300)
    ranks = [torch.load(tmp / "out" / f"rank{r}.pt", weights_only=False)
             for r in range(NPROCS)] if proc.returncode == 0 else None
    single = torch.load(tmp / "out" / "single.pt", weights_only=False) \
        if proc.returncode == 0 else None
    return {"proc": proc, "ranks": ranks, "single": single, "jax": want}


def _ok(run):
    assert run["proc"].returncode == 0, run["proc"].stderr[-4000:]
    return run["ranks"], run["single"]


def _tensors_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_dryrun_at_two_ranks(run):
    """`python -m object_nerf_torch.parallel.dryrun --nprocs 2` passes its own
    checks (as tests/test_multichip.py runs the JAX dry run on 8 devices)."""
    _ok(run)
    tail = run["proc"].stdout.strip().splitlines()[-1]
    assert tail.startswith("dryrun(2): OK, classical_steps ") and "edit_render" in tail, tail


@pytest.mark.parametrize("name", ["classical_steps", "voxel_steps"])
def test_two_ranks_equal_one_process_after_three_steps(run, name):
    """Perturbation and noise on: JAX's limits (loss rtol 1e-5, parameters and
    the voxel table rtol 2e-4, atol 2e-6), both ranks bit-equal."""
    ranks, single = _ok(run)
    got, want = ranks[0][name], single[name]
    _tensors_equal(ranks[0][name]["after"], ranks[1][name]["after"])
    assert ranks[0][name]["metrics"] == ranks[1][name]["metrics"]
    assert len(got["metrics"]) == dryrun.STEPS
    for a, b in zip(got["metrics"], want["metrics"]):
        np.testing.assert_allclose(a["train/loss"], b["train/loss"], rtol=1e-5)
        np.testing.assert_allclose(a["train/psnr"], b["train/psnr"], rtol=1e-5)
    _tensors_equal(ranks[0][name]["grads1"], ranks[1][name]["grads1"])
    for k, w in want["grads1"].items():  # the first step's gradients, summed over the ranks
        np.testing.assert_allclose(got["grads1"][k].numpy(), w.numpy(), rtol=2e-4, atol=2e-6,
                                   err_msg=k)
    for k, w in want["after"].items():
        np.testing.assert_allclose(got["after"][k].numpy(), w.numpy(), rtol=2e-4, atol=2e-6,
                                   err_msg=k)
        assert not torch.equal(got["after"][k], got["before"][k]), k  # it trained
    if name == "voxel_steps":
        assert "embedding_xyz.embedding_space_ftr.weight" in got["after"]


def test_two_ranks_equal_the_jax_single_device_step(run):
    """The 2-rank step from the JAX package's weights, batch and draws against
    its single-device step, to tests/test_torch_train_step.py's limits: loss
    1e-4, metrics 2e-4, gradients (summed over the ranks) 2e-3 of each
    tensor's largest entry, updated parameters 99.5 % within 2e-6 and all
    within 2.5e-4."""
    ranks, _ = _ok(run)
    got, want = ranks[0]["given_step"], run["jax"]
    _tensors_equal(got["after"], ranks[1]["given_step"]["after"])
    _tensors_equal(got["grads"], ranks[1]["given_step"]["grads"])
    np.testing.assert_allclose(got["metrics"]["train/loss"], want["loss"], rtol=1e-4)
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=2e-4, atol=1e-7, err_msg=k)
    assert set(got["grads"]) == set(want["grads"])
    for k, w in want["grads"].items():
        err = (got["grads"][k] - w).abs().max() / (w.abs().max() + 1e-12)
        assert float(err) < 2e-3, (k, float(err))
    for k, w in want["params"].items():
        diff = (got["after"][k] - w).abs()
        assert float((diff > 2e-6).float().mean()) < 5e-3, k
        assert float(diff.max()) < 2.5e-4, k
        assert float((got["after"][k] - want["before"][k]).abs().max()) > 0, k


def test_a_rank_without_instance_pixels_keeps_the_global_loss(run):
    """Rank 1's rows hold no instance pixel: the loss, its terms and the
    updated parameters still equal one process's on the whole batch."""
    ranks, single = _ok(run)
    got, want = ranks[0]["empty_slice_step"], single["empty_slice_step"]
    assert got["tail_instance_pixels"] == 0
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, err_msg=k)
    for k, w in want["after"].items():
        np.testing.assert_allclose(got["after"][k].numpy(), w.numpy(), rtol=2e-4, atol=2e-6,
                                   err_msg=k)
    _tensors_equal(got["after"], ranks[1]["empty_slice_step"]["after"])


@pytest.mark.parametrize("name", ["eval_render", "voxel_eval_render", "edit_render"])
def test_sharded_renders_equal_one_process(run, name):
    """Each rank renders every other chunk (five chunks of 40, the last
    padded; the edit frame's compacted order), and both hold the frame."""
    ranks, single = _ok(run)
    want = single[name]["frame"]
    _tensors_equal(ranks[0][name]["frame"], ranks[1][name]["frame"])
    assert set(ranks[0][name]["frame"]) == set(want)
    for k, w in want.items():
        got = ranks[0][name]["frame"][k]
        assert got.shape == w.shape and got.shape[0] == dryrun.IMG_WH[0] * dryrun.IMG_WH[1], k
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0, atol=1e-6, err_msg=k)
    if name == "edit_render":
        assert ranks[0][name]["plan"] == single[name]["plan"]
        assert ranks[0][name]["plan"]["chunks"] == 5


def test_prune_and_subdivision_leave_identical_grids(run):
    ranks, single = _ok(run)
    got = ranks[0]["prune_subdivide"]
    for epoch in ("epoch3", "epoch5"):
        _tensors_equal(got[epoch], ranks[1]["prune_subdivide"][epoch])
        _tensors_equal(got[epoch], single["prune_subdivide"][epoch])
    assert 0 < int(got["epoch3"]["n_occupied"]) < got["occupied"]  # the prune dropped some
    assert got["epoch5"]["shape"].tolist() == (2 * got["epoch3"]["shape"]).tolist()


def test_a_batch_the_ranks_cannot_split_raises(run):
    ranks, _ = _ok(run)
    for res in ranks:
        assert "does not split over 2 processes" in res["indivisible_batch"]["raised"]


def test_distributed_flag_without_a_group_raises(monkeypatch, tmp_path):
    """`tpu.distributed=true` with no torchrun environment raises; the CLI
    never carries on as one process."""
    from object_nerf_torch.train import __main__ as train_cli

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE"):
        train_cli.main([f"dataset_config={ROOT / 'config' / 'synthetic.yml'}", "device=cpu",
                        "tpu.distributed=true"])
    assert not mesh.is_distributed() and not (tmp_path / "logs").exists()


def test_mesh_helpers_are_one_process_without_a_group():
    assert (mesh.rank(), mesh.world_size(), mesh.is_distributed()) == (0, 1, False)
    assert mesh.shard_rows(7) == slice(0, 7) and mesh.pad_to_multiple(10, 4) == 12
    assert mesh.rank_chunks(3) == [0, 1, 2]
    batch = {"a": np.arange(6), "b": np.ones((6, 2))}
    assert all(v is batch[k] or np.array_equal(v, batch[k])
               for k, v in mesh.shard_batch(batch).items())
    p = torch.nn.Parameter(torch.ones(3))
    q = torch.nn.Parameter(torch.ones(2))
    p.grad = torch.tensor([1.0, 2.0, 3.0])
    assert mesh.all_reduce_grads([p, q]) == 5 * 4
    assert p.grad.tolist() == [1.0, 2.0, 3.0] and q.grad is None
    maps = {"rgb": torch.ones(4, 3)}
    assert mesh.gather_maps(maps, [2, 2])["rgb"] is maps["rgb"]
    t = torch.tensor([1.0, 2.0], requires_grad=True)
    s = mesh.all_reduce_sum(t)
    assert not s.requires_grad and s.tolist() == [1.0, 2.0]
