"""Dry run of the port's data parallelism over N processes.

    python -m object_nerf_torch.parallel.dryrun --nprocs 2 [--device cpu]

Counterpart of the JAX package's `__graft_entry__.dryrun_multichip`. Starts
N ranks, one process each (`RANK`, `WORLD_SIZE` and `LOCAL_RANK` in the
environment as `torchrun` sets them, a `file://` rendezvous in a fresh
directory, so that no port is taken), at the JAX dry run's widths (D=2,
W=32, 8 + 4 samples; on the card the kernels' widths, 256 and 128, and
32 + 32 samples). Every rank runs the scenarios: three classical steps
and three voxel steps (perturbation and noise on; the feature table must
change), a sharded eval render (classical and voxel), a sharded edit render,
a prune and a subdivision, a step on a batch whose last rank holds no
instance pixel, and a batch size the ranks cannot split (it must raise).
This process then runs the same scenarios alone, with no process group,
holds every rank to it (`LIMITS`: on the CPU loss `rtol` 1e-5, parameters
and the table `rtol` 2e-4, `atol` 2e-6, frames within 1e-6; on the card the
first step to 1e-3 and 5e-3, frames bit-equal or 40 dB; grids equal) and the
ranks to each other bit for bit, and prints one line `dryrun(N): OK, ...`.

`--device cuda` runs the ranks on the cards (NCCL, or `--backend gloo`, with
which ranks may share one card). `--out DIR` keeps the results (`rank<r>.pt`,
`single.pt`); `--scenarios a,b` runs a subset; `--inputs FILE` gives the
`given_step` scenario its weights, batch and draws (a `torch.save`d dict, see
`given_step`). Every rank is stopped within `--timeout` seconds.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import mesh

ROOT = Path(__file__).resolve().parents[2]
STEPS = 3
RAYS_PER_RANK = 16
# the JAX dry run's model (__graft_entry__.py:101-108); on the card the
# kernels' widths (256 / 128) and sample counts (32, 64 or 128 a ray)
MODEL = {"cpu": dict(D=2, W=32, skips=[1], inst_D=2, inst_W=16, inst_skips=[1],
                     N_samples=8, N_importance=4, N_max_objs=8, N_obj_code_length=8),
         "cuda": dict(D=2, W=256, skips=[1], inst_D=2, inst_W=128, inst_skips=[1],
                      N_samples=32, N_importance=32, N_max_objs=8, N_obj_code_length=8)}
# ranks against one process. On the CPU (f32): the JAX sharded-step test's
# limits (tests/test_data_parallel.py:64-70) on every step's metrics and the
# parameters after the steps, frames within 1e-6. On the card (bf16 kernels,
# whose backward sums a rank's rows apart from the others'): chip_smoke.py
# phase 27's limits on the first step (loss 1e-3 relative, every summed
# gradient 5e-3 of its largest entry), frames bit-equal or within its 40 dB;
# a near-zero gradient's sign may differ, and Adam's first update moves that
# entry by lr either way, so later steps are held only rank to rank
LIMITS = {"cpu": dict(loss_rtol=1e-5, param_rtol=2e-4, param_atol=2e-6, frame_atol=1e-6),
          "cuda": dict(loss_rtol=1e-3, grad_rel=5e-3, frame_psnr=40.0)}
IMG_WH = (16, 12)
EVAL_CHUNK = 40  # 192 rays: five chunks, the last one padded
# the prune scenario's fine sigma head: random weights give densities near 0,
# which the prune's alpha threshold (0.5, sigma = ln 2) drops everywhere; a
# steeper head crosses it inside the grid (the epoch-3 prune keeps 923 of 997)
SIGMA_GAIN = 50.0


def launch(argv: Sequence[str], nprocs: int, timeout: float, workdir: str,
           env: Optional[Dict[str, str]] = None) -> List[str]:
    """Run `python <argv>` as ranks 0 .. nprocs-1 (`RANK`, `WORLD_SIZE`,
    `LOCAL_RANK` set as torchrun sets them, one thread each) and wait for
    all of them. Raises, with the end of each failed rank's stderr, when a
    rank fails or `timeout` seconds pass; every rank is stopped before this
    returns. Returns each rank's stdout."""
    base = dict(os.environ if env is None else env)
    base["PYTHONPATH"] = os.pathsep.join(
        [p for p in base.get("PYTHONPATH", "").split(os.pathsep) if p] + [str(ROOT)])
    base["OMP_NUM_THREADS"] = "1"
    procs, logs = [], []
    try:
        for r in range(nprocs):
            out = open(os.path.join(workdir, f"rank{r}.stdout"), "w+")
            err = open(os.path.join(workdir, f"rank{r}.stderr"), "w+")
            logs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, *argv], stdout=out, stderr=err,
                env={**base, "RANK": str(r), "WORLD_SIZE": str(nprocs), "LOCAL_RANK": str(r)}))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout:g} s")
            if any(p.returncode not in (None, 0) for p in procs):
                break  # the others would wait for it at the next collective
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            tails = []
            for r in failed:
                logs[r][1].seek(0)
                tails.append(f"rank {r} (exit {procs[r].returncode}):\n"
                             + logs[r][1].read()[-3000:])
            raise RuntimeError("\n".join(tails))
        outs = []
        for out, _ in logs:
            out.seek(0)
            outs.append(out.read())
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for out, err in logs:
            out.close()
            err.close()


# -- scenarios: each returns host tensors and numbers ------------------------------------


@dataclasses.dataclass(frozen=True)
class Ctx:
    """What a scenario runs with: a scratch directory, the device, the
    number of ranks of the run (also in the single process, which takes the
    same global batches) and the `given_step` inputs."""

    tmp: str
    device: object
    nprocs: int
    inputs: Optional[str] = None


def _config(ctx: Ctx, voxel: bool, *extra: str):
    from ..config import load_config

    model = MODEL[torch.device(ctx.device).type]
    args = [f"dataset_config={ROOT / 'config' / 'synthetic.yml'}",
            *(f"model.{k}={v}" for k, v in model.items()),
            f"train.batch_size={RAYS_PER_RANK * ctx.nprocs}",
            "dataset_extra.scale_factor=1.0", "dataset_extra.near=0.5",
            "dataset_extra.far=5.0", "dataset_extra.scene_center=[0.0,0.0,0.0]",
            f"model.use_voxel_embedding={str(voxel).lower()}", "train.optimizer=adam",
            "train.lr_scheduler=poly", *extra]
    if voxel:
        args += [f"dataset_extra.pcd_path={_pcd(ctx.tmp)}", "dataset_extra.voxel_size=0.25",
                 "dataset_extra.neighbor_marks=3", "model.N_max_voxels=20000"]
    return load_config(cli_args=args)


def _pcd(tmp: str) -> str:
    """The JAX dry run's point cloud (`__graft_entry__.py:255-258`)."""
    from ..data.ply_io import write_ply

    path = os.path.join(tmp, "scene.ply")
    if not os.path.exists(path):
        rng = np.random.RandomState(0)
        write_ply(path, rng.rand(2000, 3).astype(np.float32) * 2.0 - 1.0)
    return path


def _system(config, device, split="train"):
    from ..data import dataset_dict
    from ..train.system import ObjectNeRFSystem

    ds = dataset_dict["synthetic"](split, img_wh=IMG_WH, n_frames=2,
                                   dataset_extra=config.dataset_extra)
    if split == "train":
        return ObjectNeRFSystem(config, dataset=ds, device=device), ds
    return ObjectNeRFSystem(config, val_dataset=ds, device=device), ds


def _params(system) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in system.models.state_dict().items()}


def _steps(ctx: Ctx, voxel: bool) -> Dict[str, object]:
    system, ds = _system(_config(ctx, voxel), ctx.device)
    before = _params(system)
    losses, grads = [], None
    for _ in range(STEPS):
        batch = ds.sample_batch(int(system.config.train.batch_size), system.batch_rng)
        losses.append({k: float(v) for k, v in system.training_step(batch).items()})
        if grads is None:  # the first step's gradients, summed over the ranks
            grads = {k: p.grad.detach().cpu().clone()
                     for k, p in system.models.named_parameters()}
    return {"metrics": losses, "grads1": grads, "before": before, "after": _params(system)}


def classical_steps(ctx: Ctx):
    return _steps(ctx, voxel=False)


def voxel_steps(ctx: Ctx):
    return _steps(ctx, voxel=True)


def empty_slice_step(ctx: Ctx):
    """One step on a global batch whose last rank's rows hold no instance
    pixel (and the first rank's do): per-rank means would weigh that rank's
    instance terms as much as the others'; the global means do not."""
    system, ds = _system(_config(ctx, False), ctx.device)
    n = int(system.config.train.batch_size)
    pool = ds.sample_batch(64 * n, np.random.RandomState(3))
    inst = np.flatnonzero(pool["instance_mask"])
    none = np.flatnonzero(~pool["instance_mask"])
    tail = n // max(ctx.nprocs, 2)
    head = n - tail
    if len(inst) < head // 2 or len(none) < head - head // 2 + tail:
        raise RuntimeError("the pool holds too few rows with and without instance pixels")
    rows = np.concatenate([inst[:head // 2], none[:head - head // 2], none[-tail:]])
    batch = {k: v[rows] for k, v in pool.items()}
    metrics = system.training_step(batch)
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "after": _params(system),
            "grads1": {k: p.grad.detach().cpu().clone()
                       for k, p in system.models.named_parameters()},
            "tail_instance_pixels": int(batch["instance_mask"][head:].sum())}


def _eval_render(ctx: Ctx, voxel: bool):
    config = _config(ctx, voxel, "model.perturb=0", "model.noise_std=0")
    system, ds = _system(config, ctx.device, split="val")
    out = system.render_image(ds.whole_image_batch(0), chunk=EVAL_CHUNK)
    return {"frame": {k: torch.from_numpy(v) for k, v in out.items()}}


def eval_render(ctx: Ctx):
    return _eval_render(ctx, voxel=False)


def voxel_eval_render(ctx: Ctx):
    return _eval_render(ctx, voxel=True)


def edit_render(ctx: Ctx):
    """The JAX dry run's edit frame (`__graft_entry__.py:176-250`): the
    background and object 1 moved, in chunks of 40 of the compacted order."""
    from ..config import Config
    from ..edit.editable_renderer import EditableRenderer
    from ..render.renderer import RenderSettings
    from ..train.system import init_params

    bbox = os.path.join(ctx.tmp, "bbox.json")
    with open(bbox, "w") as f:
        json.dump({"labels": [{"id": 1, "data": {"position": [0.3, 0.0, 0.25],
                                                 "quaternion": [0, 0, 0, 1],
                                                 "scale": [0.5, 0.5, 0.5]}}]}, f)
    model = {**MODEL[torch.device(ctx.device).type], "use_voxel_embedding": False,
             "N_freq_xyz": 10, "N_freq_dir": 4, "N_freq_voxel": 6, "N_scn_voxel_size": 16,
             "N_obj_voxel_size": 8, "frustum_bound": -1, "use_disp": False, "perturb": 0,
             "noise_std": 0, "N_max_objs": 16}
    conf = Config({"ckpt_config": {
        "dataset_name": "toydesk", "model": model,
        "dataset_extra": {"near": 0.5, "far": 5.0, "scale_factor": 1.0,
                          "scene_center": [0.0, 0.0, 0.0], "bbox_dir": bbox}}})
    settings = RenderSettings.from_config(Config(conf.ckpt_config), is_eval=True)
    models = init_params(torch.Generator().manual_seed(0), settings, model, device=ctx.device)
    r = EditableRenderer(conf, models=models, device=ctx.device)
    move = np.eye(4)
    move[:3, 3] = [0.1, 0.0, 0.0]
    r.set_object_pose_transform(1, move, 0)
    twc = np.eye(4)
    twc[:3, 3] = [0.0, -2.0, 0.5]
    twc[:3, :3] = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], float)
    out = r.render_edit(h=IMG_WH[1], w=IMG_WH[0], camera_pose_Twc=twc, fovx_deg=70,
                        chunk=EVAL_CHUNK)
    return {"frame": {k: torch.from_numpy(v) for k, v in out.items()},
            "plan": dict(r.last_chunk_plan)}


def prune_subdivide(ctx: Ctx):
    """The epoch-3 prune and the epoch-5 prune and subdivision on fresh
    weights (every rank sweeps; rank 0's topology is kept)."""
    from ..models import voxel_grid as vg

    config = _config(ctx, True, "train.progressive_train=true",
                     "train.prune_samples_per_voxel=64", "train.prune_voxel_batch=64")
    system, _ = _system(config, ctx.device)
    with torch.no_grad():  # a density that crosses the prune's threshold inside the grid
        system.models.nerf_fine.sigma.weight.mul_(SIGMA_GAIN)
    out = {"occupied": int(system.voxel_topo.n_occupied)}
    for epoch in (3, 5):
        system.on_epoch_start(epoch)
        out[f"epoch{epoch}"] = {**vg.topology_to_dict(system.voxel_topo),
                                "shape": torch.tensor(system.voxel_static.shape),
                                "features": system.models.voxel_features.detach().cpu().clone()}
    return out


def indivisible_batch(ctx: Ctx):
    """A batch size the ranks cannot split must raise (the batch is not
    padded). One process splits every size, so alone this records nothing."""
    if mesh.world_size() == 1:
        return {"raised": None}
    config = _config(ctx, False, f"train.batch_size={RAYS_PER_RANK * ctx.nprocs + 1}")
    try:
        _system(config, ctx.device)
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": ""}


def given_step(ctx: Ctx):
    """One step from the weights, global batch and global draws of a file:
    a dict of `state_dict`, `model` (ObjectNeRFConfig keywords), `render`
    (RenderSettings keywords without `mlp`), `loss` (weights), `train` (the
    optimizer block), `steps_per_epoch`, `batch` and `draws` (global numpy
    arrays). Returns the metrics, the gradients (summed over the ranks) and
    the updated parameters."""
    if ctx.inputs is None:
        return {}
    device = ctx.device
    from ..models.mlp import ObjectNeRFConfig
    from ..render.renderer import RenderDraws, RenderSettings
    from ..train import optim
    from ..train.system import ObjectNeRFModels, make_train_step

    spec = torch.load(ctx.inputs, weights_only=False)
    cfg = ObjectNeRFConfig(**spec["model"])
    codes = spec["state_dict"]["code_library.embedding_instance.weight"]
    models = ObjectNeRFModels(cfg, n_importance=1, n_max_objs=codes.shape[0])
    models.load_state_dict(spec["state_dict"])
    models = models.to(device).train()
    settings = RenderSettings(mlp=cfg, **spec["render"])
    step = make_train_step(settings, spec["loss"], optim.make_optimizer(spec["train"],
                                                                        models.parameters()),
                           optim.make_lr_schedule(spec["train"], spec["steps_per_epoch"]))
    batch = mesh.shard_batch(spec["batch"]) if mesh.is_distributed() else spec["batch"]
    batch = {k: torch.from_numpy(np.array(v)).to(device) for k, v in batch.items()}
    draws = RenderDraws(**{k: torch.from_numpy(np.array(v)).to(device)
                           for k, v in spec["draws"].items()})
    metrics = step(models, batch, draws=draws)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: p.grad.detach().cpu().clone() for k, p in models.named_parameters()},
            "after": {k: v.detach().cpu().clone() for k, v in models.state_dict().items()}}


SCENARIOS: Dict[str, Callable] = {
    f.__name__: f for f in (classical_steps, voxel_steps, empty_slice_step, eval_render,
                            voxel_eval_render, edit_render, prune_subdivide,
                            indivisible_batch, given_step)}


def run_scenarios(names: Sequence[str], device, nprocs: int, inputs: Optional[str] = None
                  ) -> Dict[str, object]:
    """Every named scenario in this process (under its group, if any), with
    the global batches of a run of `nprocs` ranks."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = Ctx(tmp, device, nprocs, inputs)
        return {name: SCENARIOS[name](ctx) for name in names}


# -- checks -----------------------------------------------------------------------------


def _close(got, want, rtol, atol, what):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    if got.shape != want.shape or not torch.allclose(got, want, rtol=rtol, atol=atol):
        err = (got - want).abs().max().item() if got.shape == want.shape else "shape"
        raise AssertionError(f"{what}: max |difference| {err} (rtol {rtol:g}, atol {atol:g})")


def _bit_equal(a, b, what):
    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"{what}: keys differ")
        for k in a:
            _bit_equal(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, torch.Tensor):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: differs between ranks")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            _bit_equal(x, y, f"{what}[{i}]")
    elif a != b:
        raise AssertionError(f"{what}: {a} != {b}")


def check(ranks: List[Dict], single: Dict, device_type: str = "cpu") -> Dict[str, float]:
    """Hold every rank's results to each other (bit for bit) and to the
    single process's (`LIMITS`); returns a few figures for the summary line."""
    for r, res in enumerate(ranks[1:], 1):
        _bit_equal(ranks[0], res, f"rank {r} vs rank 0")
    got, summary, lim = ranks[0], {}, LIMITS[device_type]
    for name in ("classical_steps", "voxel_steps", "empty_slice_step"):
        if name not in got:
            continue
        g, w = got[name], single[name]
        gm = g["metrics"] if isinstance(g["metrics"], list) else [g["metrics"]]
        wm = w["metrics"] if isinstance(w["metrics"], list) else [w["metrics"]]
        rel = {k: ((g["grads1"][k] - v).abs().max() / (v.abs().max() + 1e-30)).item()
               for k, v in w["grads1"].items()}
        if device_type == "cuda":
            _close(gm[0]["train/loss"], wm[0]["train/loss"], lim["loss_rtol"], 0.0,
                   f"{name} step 0: train/loss")
            for k, err in rel.items():
                if not err <= lim["grad_rel"]:
                    raise AssertionError(f"{name}: summed gradient {k} {err:.2e} from one "
                                         f"process's (limit {lim['grad_rel']:g})")
        else:
            for i, (a, b) in enumerate(zip(gm, wm)):
                if set(a) != set(b):
                    raise AssertionError(f"{name} step {i}: metrics {sorted(a)} vs {sorted(b)}")
                for k in b:
                    _close(a[k], b[k], lim["loss_rtol"], 0.0, f"{name} step {i}: {k}")
            for k in w["after"]:
                _close(g["after"][k], w["after"][k], lim["param_rtol"], lim["param_atol"],
                       f"{name}: {k}")
        summary[name] = gm[-1]["train/loss"]
        summary[f"{name}/loss1_rel_err"] = abs(gm[0]["train/loss"] / wm[0]["train/loss"] - 1)
        summary[f"{name}/grad1_rel_err"] = max(rel.values())
        if name == "voxel_steps":
            key = "embedding_xyz.embedding_space_ftr.weight"
            if torch.equal(g["after"][key], g["before"][key]):
                raise AssertionError("voxel_steps: the feature table never changed")
        if name == "empty_slice_step" and g["tail_instance_pixels"] != 0:
            raise AssertionError("empty_slice_step: the last rank's rows hold instance pixels")
    for name in ("eval_render", "voxel_eval_render", "edit_render"):
        if name not in got:
            continue
        for k, v in single[name]["frame"].items():
            a = got[name]["frame"][k]
            if device_type == "cpu":
                _close(a, v, 0.0, lim["frame_atol"], f"{name}: {k}")
            elif not torch.equal(a, v):
                psnr = -10.0 * torch.log10(((a - v) ** 2).mean()).item()
                if not psnr >= lim["frame_psnr"]:
                    raise AssertionError(f"{name}: {k} {psnr:.1f} dB from one process's")
        summary[name] = float(got[name]["frame"]["rgb_fine"].mean())
        summary[f"{name}/max_abs_diff"] = max((got[name]["frame"][k] - v).abs().max().item()
                                              for k, v in single[name]["frame"].items())
    if "edit_render" in got and got["edit_render"]["plan"] != single["edit_render"]["plan"]:
        raise AssertionError("edit_render: the chunk plans differ")
    if "prune_subdivide" in got:
        _bit_equal(got["prune_subdivide"], single["prune_subdivide"],
                   "prune_subdivide vs one process")
    if "indivisible_batch" in got and len(ranks) > 1 and not got["indivisible_batch"]["raised"]:
        raise AssertionError("indivisible_batch: a batch the ranks cannot split did not raise")
    return summary


# -- entry points ------------------------------------------------------------------------


def _worker(args) -> None:
    torch.set_num_threads(1)
    mesh.initialize_distributed(args.init, backend=args.backend, device=args.device)
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    # a rank that raises exits at once (no barrier): `launch` then stops the others
    res = run_scenarios(args.scenarios.split(","), device, mesh.world_size(), args.inputs)
    torch.save(res, os.path.join(args.out, f"rank{mesh.rank()}.pt"))
    mesh.barrier()
    mesh.destroy()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nprocs", type=int, default=2)
    p.add_argument("--device", default="cpu")
    p.add_argument("--backend", default=None, help="nccl or gloo (default: by device)")
    p.add_argument("--scenarios", default=",".join(SCENARIOS))
    p.add_argument("--inputs", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    unknown = set(args.scenarios.split(",")) - set(SCENARIOS)
    if unknown:
        p.error(f"unknown scenarios {sorted(unknown)} (have {sorted(SCENARIOS)})")
    if args.worker:
        _worker(args)
        return 0

    work = tempfile.mkdtemp(prefix="onerf_dryrun_")
    try:
        out = args.out or work
        os.makedirs(out, exist_ok=True)
        argv_w = ["-m", "object_nerf_torch.parallel.dryrun", "--worker",
                  "--init", f"file://{os.path.join(work, 'rendezvous')}", "--out", out,
                  "--device", args.device, "--scenarios", args.scenarios]
        if args.backend:
            argv_w += ["--backend", args.backend]
        if args.inputs:
            argv_w += ["--inputs", args.inputs]
        launch(argv_w, args.nprocs, args.timeout, work)
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                 for r in range(args.nprocs)]
        torch.set_num_threads(1)
        device = args.device
        single = run_scenarios(args.scenarios.split(","), device, args.nprocs, args.inputs)
        torch.save(single, os.path.join(out, "single.pt"))
        summary = check(ranks, single, torch.device(device).type)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"dryrun({args.nprocs}): OK, " + ", ".join(
        f"{k} {v:.4g}" for k, v in summary.items()) + f" ({args.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
