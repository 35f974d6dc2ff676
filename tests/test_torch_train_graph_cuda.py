"""The train step as one CUDA graph (`train/system.py:TrainStep`), on the card.

Marked `cuda`: skipped where CUDA is unavailable. This file imports nothing
of JAX, so it runs on a machine with the card and no JAX:

    python -m pytest tests/test_torch_train_graph_cuda.py -m cuda --noconftest

Each step test runs the voxel-conditioned and the classical model at the
published widths, batch 2048, 64 + 64 samples. The eager reference is the
same program with the graph turned off (`graph_engages` patched to False),
from the same weights, batches and draws.

Tolerance. The graph replays the eager step's kernels in the eager step's
order, so the one expected difference is the card's unordered `index_add_`
in the voxel table's gradient (f32 sums in any order) and what it carries
into later steps. The classical step has no unordered sum: it must be bit
for bit the eager one. A voxel leaf is held by its norm: the distance
between the two runs' final values over the norm of the leaf's change in
the eager run, within `LEAF_TOL`; the same for Adam's moments (over their
own norm); losses within `LOSS_TOL` relative. Measured on an H100: the
table 1.8e-6 to 3.1e-6, its moments under 2e-7, every MLP leaf 0. A graph
reading a stale batch, draw, learning rate or grid moves those ratios by
0.1 or more.
"""

import io

import numpy as np
import pytest
import torch

from object_nerf_torch.models import voxel_grid as vg
from object_nerf_torch.models.mlp import ObjectNeRFConfig
from object_nerf_torch.ops import fused_mlp, gather
from object_nerf_torch.render.renderer import RenderDraws, RenderSettings
from object_nerf_torch.train import optim, system
from object_nerf_torch.utils import trace

N = 2048
LOSS_W = {"color_loss_weight": 1.0, "depth_loss_weight": 0.1, "opacity_loss_weight": 10.0,
          "instance_color_loss_weight": 1.0, "instance_depth_loss_weight": 0.1}
TRAIN = {"optimizer": "adam", "lr": 1e-3, "weight_decay": 0.0, "lr_scheduler": "poly",
         "poly_exp": 2.0, "warmup_epochs": 0, "num_epochs": 6}
LEAF_TOL = 1e-4
LOSS_TOL = 1e-5
KINDS = ["voxel", "classical"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    trace.reset()
    yield torch.device("cuda")
    trace.reset()


def _model(kind, device):
    """(settings, models, topology, static) of a seeded model; a voxel model
    on a small seeded grid (about 1.2 x 1.0 x 0.8 at 0.1)."""
    topo = static = feats = None
    if kind == "voxel":
        rng = np.random.RandomState(3)
        pcd = rng.rand(4000, 3) * [1.2, 1.0, 0.8] - [0.6, 0.5, 0.4]
        feats, topo, static = vg.build_voxel_grid(
            pcd, [0.0, 0.0, 0.0], 1.0, 0.1, 3, 24, 6, 100000,
            generator=torch.Generator().manual_seed(3), device=device)
    settings = RenderSettings(mlp=ObjectNeRFConfig(use_voxel_embedding=kind == "voxel"),
                              N_samples=64, N_importance=64, perturb=1.0, noise_std=1.0)
    models = system.init_params(torch.Generator().manual_seed(0), settings, {}, device=device,
                                voxel_features=feats)
    return settings, models, topo, static


def _inputs(settings, device, sizes, seed=1):
    """One seeded (batch, draws) a step, of `sizes[i]` rays."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for i, n in enumerate(sizes):
        o, d = torch.randn(n, 3, generator=g) * 0.1, torch.randn(n, 3, generator=g)
        batch = {
            "rays": torch.cat([o, d / d.norm(dim=-1, keepdim=True), torch.full((n, 1), 0.05),
                               torch.full((n, 1), 1.2)], -1),
            "rgbs": torch.rand(n, 3, generator=g),
            "depths": torch.rand(n, generator=g),
            "valid_mask": torch.rand(n, generator=g) > 0.1,
            "instance_mask": torch.rand(n, generator=g) > 0.5,
            "instance_mask_weight": torch.rand(n, generator=g),
            "pass_through_mask": torch.rand(n, generator=g) > 0.8,
            "instance_ids": torch.randint(0, 4, (n,), generator=g)}
        draws = RenderDraws.sample(settings, n, device,
                                   torch.Generator(device=device).manual_seed(seed + 100 + i))
        out.append(({k: v.to(device) for k, v in batch.items()}, draws))
    return out


def _pruned(topo):
    """The topology with every other occupied cell emptied (a prune)."""
    idx = topo.idx_map.clone()
    drop = torch.nonzero(idx >= 0).flatten()[::2]
    rows = idx[drop].long()
    idx[drop] = -1
    rtc = topo.row_to_cell.clone()
    rtc[rows] = idx.numel()
    occ = topo.occupancy.clone()
    occ[drop] = False
    return topo._replace(idx_map=idx, occupancy=occ, row_to_cell=rtc,
                         n_occupied=(idx >= 0).sum().to(torch.int32))


def _run(kind, device, graph, sizes=(N,) * 6, steps_per_epoch=2, drawn="given",
         prune_at=None, hold=False):
    """Steps from the seeded model on `_inputs`, through the graph or
    eagerly: (models, optimizer, initial parameters, metrics of every step).
    `drawn`: the step is given the draws, or takes them from a seeded
    generator. `prune_at`: the voxel grid is pruned before that step. `hold`:
    an autograd graph over the parameters, made on the default stream, stays
    alive through the steps."""
    settings, models, topo, static = _model(kind, device)
    p0 = {k: v.detach().clone() for k, v in models.named_parameters()}
    held = sum(p.sum() for p in models.parameters()) if hold else None
    opt = optim.make_optimizer(TRAIN, models.parameters())
    step = system.make_train_step(settings, LOSS_W, opt,
                                  optim.make_lr_schedule(TRAIN, steps_per_epoch))
    gen = torch.Generator(device=device).manual_seed(5)
    out = []
    with pytest.MonkeyPatch.context() as mp:
        if not graph:
            mp.setattr(system, "graph_engages", lambda *a: False)
        for i, (batch, draws) in enumerate(_inputs(settings, device, sizes)):
            if i == prune_at and topo is not None:
                topo = _pruned(topo)
            out.append(step(models, batch, generator=gen if drawn == "generator" else None,
                            draws=draws if drawn == "given" else None, voxel_topo=topo,
                            voxel_static=static))
    torch.cuda.synchronize()
    del held
    return models, opt, p0, out


def _rel(a, b, scale):
    return float((a - b).norm()) / max(float(scale), 1e-30)


def _assert_same_run(graphed, eager):
    """Losses, every parameter leaf and Adam's moments within the module's
    tolerance."""
    (mg, og, _, outg), (me, oe, p0, oute) = graphed, eager
    voxel = mg.embedding_xyz is not None
    loss_tol, tol = (LOSS_TOL, LEAF_TOL) if voxel else (0.0, 0.0)
    for i, (a, b) in enumerate(zip(outg, oute)):
        la, lb = float(a["train/loss"]), float(b["train/loss"])
        assert abs(la - lb) <= loss_tol * abs(lb), (i, la, lb)
        assert a["lr"] == b["lr"]
    worst = {}
    pe = dict(me.named_parameters())
    for name, p in mg.named_parameters():
        q = pe[name]
        worst[name] = _rel(p.detach(), q.detach(), (q.detach() - p0[name]).norm())
        sg, se = og.state[p], oe.state[q]
        assert float(sg["step"]) == float(se["step"]) == len(outg)
        for m in ("exp_avg", "exp_avg_sq"):
            worst[f"{name}.{m}"] = _rel(sg[m], se[m], se[m].norm())
    bad = {k: v for k, v in worst.items() if not v <= tol}
    print("graph vs eager, worst leaves:",
          sorted(worst.items(), key=lambda kv: -kv[1])[:4])
    assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("drawn", ["given", "generator"])
@pytest.mark.parametrize("kind", KINDS)
def test_six_graphed_steps_match_six_eager_steps(cuda_device, kind, drawn):
    """Six steps: the first eager, the second captured and replayed, four
    replays; the schedule's epoch is two steps, so the rate changes twice
    inside the replays."""
    graphed = _run(kind, cuda_device, True, drawn=drawn)
    assert system.graph_counts["train.graph_captures"] == 1
    assert system.graph_counts["train.graph_replays"] == 5
    _assert_same_run(graphed, _run(kind, cuda_device, False, drawn=drawn))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_a_replay_after_an_epoch_boundary_takes_the_new_rate(cuda_device, kind):
    """An epoch of one step: every replay crosses a boundary of the poly
    schedule, and the optimizer's rate tensor holds the last step's rate."""
    sched = optim.make_lr_schedule(TRAIN, 1)
    graphed = _run(kind, cuda_device, True, sizes=(N,) * 5, steps_per_epoch=1)
    lrs = [m["lr"] for m in graphed[3]]
    assert lrs == [sched(i) for i in range(5)] and len(set(lrs)) == 5
    assert float(graphed[1].param_groups[0]["lr"]) == pytest.approx(lrs[-1], rel=1e-6)
    _assert_same_run(graphed, _run(kind, cuda_device, False, sizes=(N,) * 5,
                                   steps_per_epoch=1))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_a_new_signature_captures_anew(cuda_device, kind):
    """A pruned grid (the voxel model) or a batch of another size (the
    classical one) before the third step: that step runs eagerly, the fourth
    captures again, and every step still matches the eager run."""
    sizes = (N, N) + ((N,) * 4 if kind == "voxel" else (N // 2,) * 4)
    graphed = _run(kind, cuda_device, True, sizes=sizes, prune_at=2)
    assert system.graph_counts["train.graph_captures"] == 2
    assert system.graph_counts["train.graph_replays"] == 4
    _assert_same_run(graphed, _run(kind, cuda_device, False, sizes=sizes, prune_at=2))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_a_step_that_cannot_be_captured_says_why(cuda_device, kind):
    """The caller keeps an autograd graph over the parameters alive, made on
    the default stream, which a capture cannot take: the second call raises
    an error that names the cause, having restored the current stream and
    the launch counters, and the eager first step stands."""
    with pytest.raises(RuntimeError, match="could not be captured into a CUDA graph"):
        _run(kind, cuda_device, True, hold=True)
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    assert system.graph_counts["train.graph_captures"] == 0
    assert fused_mlp.launch_counts["fused_mlp_bwd"] == 2  # the eager step's alone
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_successive_replays_return_their_own_losses(cuda_device, kind):
    """The benchmark keeps the losses of three calls and reads them after
    the third: the capture's and two replays' losses are distinct tensors
    with distinct storage and values, each the eager step's."""
    _, _, _, out = _run(kind, cuda_device, True, sizes=(N,) * 4)
    _, _, _, ref = _run(kind, cuda_device, False, sizes=(N,) * 4)
    losses = [m["train/loss"] for m in out[1:]]
    ptrs = {t.untyped_storage().data_ptr() for t in losses}
    values = [float(t) for t in losses]
    assert len(ptrs) == 3 and len(set(values)) == 3
    for got, want in zip(values, ref[1:]):
        assert abs(got - float(want["train/loss"])) <= LOSS_TOL * abs(float(want["train/loss"]))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_launches_per_step_are_the_same_on_both_paths(cuda_device, kind):
    """A replay adds the captured step's launches to the kernel counters: 7 a
    voxel step (2 + 2 fused, 2 corner lookups, 1 table build), 4 a classical
    one, as an eager step counts them."""
    def per_step(graph):
        settings, models, topo, static = _model(kind, cuda_device)
        step = system.make_train_step(settings, LOSS_W,
                                      optim.make_optimizer(TRAIN, models.parameters()))
        inputs = _inputs(settings, cuda_device, (N,) * 6)
        with pytest.MonkeyPatch.context() as mp:
            if not graph:
                mp.setattr(system, "graph_engages", lambda *a: False)
            for batch, draws in inputs[:2]:  # eager, then the capture
                step(models, batch, draws=draws, voxel_topo=topo, voxel_static=static)
            trace.reset()
            for batch, draws in inputs[2:]:
                step(models, batch, draws=draws, voxel_topo=topo, voxel_static=static)
        counts = {**fused_mlp.launch_counts, **gather.launch_counts, **vg.build_counts}
        return {k: v / 4 for k, v in counts.items()}, system.graph_counts["train.graph_replays"]

    (graphed, replays), (eager, none) = per_step(True), per_step(False)
    assert replays == 4 and none == 0
    assert graphed == eager
    assert sum(eager.values()) == (7 if kind == "voxel" else 4), eager


@pytest.mark.cuda
def test_adam_on_the_card_keeps_its_step_there_and_a_restore_round_trips(cuda_device):
    """`make_optimizer` over CUDA parameters: capturable Adam with a 0-d
    rate tensor on the card. Its state dict, saved and read onto the host as
    the checkpoints are, restores the rate and step counts on the card, and
    the restored optimizer takes the same next step."""
    params = [torch.nn.Parameter(torch.randn(64, device=cuda_device))]
    opt = optim.make_optimizer(TRAIN, params)
    g = opt.param_groups[0]
    assert g["capturable"] and torch.is_tensor(g["lr"]) and g["lr"].device.type == "cuda"
    assert optim.keeps_step_on_device(opt)
    params[0].grad = torch.randn(64, device=cuda_device)
    optim.set_lr(opt, 5e-4)
    opt.step()
    buf = io.BytesIO()
    torch.save(opt.state_dict(), buf)
    buf.seek(0)
    saved = torch.load(buf, map_location="cpu", weights_only=False)
    twin = [torch.nn.Parameter(params[0].detach().clone())]
    opt2 = optim.make_optimizer(TRAIN, twin)
    opt2.load_state_dict(saved)
    g2 = opt2.param_groups[0]
    assert g2["capturable"] and g2["lr"].device.type == "cuda"
    assert float(g2["lr"]) == pytest.approx(5e-4)
    st = opt2.state[twin[0]]
    assert st["step"].device.type == "cuda" and float(st["step"]) == 1.0
    grad = torch.randn(64, device=cuda_device)
    for p, o in ((params, opt), (twin, opt2)):
        p[0].grad = grad.clone()
        o.step()
    assert torch.equal(params[0], twin[0])
