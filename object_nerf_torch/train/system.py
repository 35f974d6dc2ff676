"""Model construction, the train step, the whole-image eval render and the
fit loop.

Counterpart of `object_nerf_tpu/train/system.py`: `init_params` (:46-60),
`make_train_step` (:69-118, the monolithic step; the split-program
schedule of the TPU is not ported), `make_render_fn` (:121-245) and
`ObjectNeRFSystem` (:248-667: `training_step`, `render_image`,
`validation`, `on_epoch_start`, `fit`). One train step is the stochastic
`render_rays` (two launches of the fused forward kernel), the reference
TotalLoss, autograd (two launches of the fused backward kernel), and the
optimizer with its learning rate set from the schedule. On one card with
Adam the step runs as one CUDA graph, captured on the second call of an
input signature and replayed on every later one (`TrainStep`); elsewhere it
is an eager PyTorch step.

Randomness: initial weights and batch sampling come from CPU generators, so
a seed means the same on every device; the perturbation and the density
noise of a step come from a `torch.Generator` on the training device (no
host-to-device copy in the loop), so they differ between CPU and CUDA runs.

A voxel-conditioned model (`model.use_voxel_embedding`, the reference's
default) carries its feature table under the reference's state-dict name
`embedding_xyz.embedding_space_ftr.weight`; the grid's topology and static
shape live beside the models (`ObjectNeRFSystem.voxel_topo`,
`.voxel_static`). The eval render builds the corner table once per frame and
hands it to every chunk; a training step builds one (bf16 on the card) that
both passes read, two `gather_rows` launches, and takes the table gradient of
both in one segment-sum (`render.renderer.train_voxel_ctx`). Under
`train.progressive_train` the epoch hooks prune (every epoch > 2) and
subdivide (epoch 5) the grid (`on_epoch_start`).

A dataset whose `is_rays_in_bbox()` holds (a ScanNet config's validation
frames under `use_bbox`) puts the render settings on the `rays_in_bbox` route
(JAX `:279-294`): the importance samples follow the instance weights, and the
eval render packs the coarse model in full for its coarse `fused_mlp_eval`.
`validation` keeps its batch and maps for `val_image_panel` (the reference's
7-panel image); `fit` runs `torch.profiler` over a few steps when
`tpu.profile_dir` is set.

Spans (`utils/trace.py`): a train step is `train.step`, its backward
`train.backward`, its optimizer work (learning rate, gradients cleared,
Adam's step) `train.optim` (a replayed step opens neither); a frame of
`make_render_fn` is `render.frame`. The counters `train.graph_captures`
and `train.graph_replays` count the step's graph.

Data parallel (JAX `:251-278`, `:331-337`, `:440-444`, `:470-486`): under a
`torch.distributed` process group (`parallel/mesh.py`) the models are
replicated (rank 0's initial weights broadcast), every rank draws the same
global batch and the global batch's draws from identically seeded
generators and keeps its rows, the loss divides by the global mask counts,
the gradients are summed over the ranks before the optimizer's step (so the
parameters stay bit-identical across ranks), the logged metrics are the
global batch's, the pruned grid is rank 0's, and the eval render gives each
rank every W-th chunk and gathers the frame on every rank. `fit` runs its
callbacks (logs, checkpoints) on rank 0 only; the other ranks wait for it.
Without a group nothing of this runs.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models.code_library import CodeLibrary
from ..models import voxel_grid as vg
from ..models.mlp import ObjectNeRF, ObjectNeRFConfig
from ..ops import fused_mlp, gather
from ..ops.fused_sigma import fused_sigma_eval
from ..ops.fwd_chain import pack_kernel_weights
from ..parallel import mesh
from ..render.renderer import (
    RenderDraws, RenderSettings, bbox_route, render_rays, render_rays_fused_eval,
)
from ..utils import trace
from .losses import term_counts, total_loss
from .metrics import mse, psnr, ssim
from .optim import keeps_step_on_device, make_lr_schedule, make_optimizer, set_lr


class VoxelEmbedding(nn.Module):
    """The voxel feature table under the reference's name
    (`embedding_xyz.embedding_space_ftr`, embedding_helper.py:187)."""

    def __init__(self, features: torch.Tensor):
        super().__init__()
        self.embedding_space_ftr = nn.Embedding(features.shape[0], features.shape[1])
        with torch.no_grad():
            self.embedding_space_ftr.weight.copy_(features)


class ObjectNeRFModels(nn.Module):
    """The reference system's modules under their state-dict names:
    `nerf_coarse`, `nerf_fine` (when N_importance > 0), `code_library` and,
    for a voxel-conditioned model, `embedding_xyz` (the feature table)."""

    def __init__(self, cfg: ObjectNeRFConfig, n_importance: int = 64,
                 n_max_objs: int = 64, voxel_features: Optional[torch.Tensor] = None):
        super().__init__()
        self.nerf_coarse = ObjectNeRF(cfg)
        self.nerf_fine = ObjectNeRF(cfg) if n_importance > 0 else None
        self.code_library = CodeLibrary(n_max_objs, cfg.N_obj_code_length)
        self.embedding_xyz = (VoxelEmbedding(voxel_features)
                              if voxel_features is not None else None)

    @property
    def voxel_features(self) -> Optional[torch.Tensor]:
        """The (capacity, channels) feature table, or None."""
        if self.embedding_xyz is None:
            return None
        return self.embedding_xyz.embedding_space_ftr.weight


def init_params(generator: torch.Generator, settings: RenderSettings, model_cfg,
                device=None, voxel_features: Optional[torch.Tensor] = None,
                ) -> ObjectNeRFModels:
    """Fresh models from a seeded CPU `torch.Generator`, moved to `device`
    (default `cuda`). Linear layers are U(±1/sqrt(fan_in)); codes N(0, 1).
    The same seed gives the same weights on every device. `voxel_features`
    (from `models/voxel_grid.build_voxel_grid`) becomes the models' feature
    table."""
    device = resolve_device(device)
    models = ObjectNeRFModels(settings.mlp, settings.N_importance,
                              int(model_cfg.get("N_max_objs", 64)), voxel_features)
    models.nerf_coarse.reset_parameters_(generator)
    if models.nerf_fine is not None:
        models.nerf_fine.reset_parameters_(generator)
    models.code_library.reset_parameters_(generator)
    return models.to(device)


def make_render_fn(settings: RenderSettings, voxel_static: Optional[vg.VoxelStatic] = None,
                   chunk: int = 4096):
    """Whole-image eval renderer: render(models, rays (N, 8), instance_ids
    (N,), voxel_topo=None) -> final-pass maps. Loops over chunks of `chunk`
    rays; the caller pads rays to a multiple of `chunk`. On the card the
    kernel weights are packed once per call (one frame), not once per chunk.

    A voxel-conditioned model (`voxel_static` given, `voxel_topo` at call
    time) gets its corner table built once per frame too, not per chunk, in
    bf16 when the kernels compute in bf16. On the `rays_in_bbox` route the
    coarse model is packed in full: its pass is `fused_mlp_eval` on both
    branches. A grid whose table would exceed
    `DENSE_CELL_TABLE_LIMIT_BYTES` renders through the per-corner gathers
    instead, with a warning. Under a process group each rank renders the
    chunks `r, r + W, ...` and every rank returns the whole frame."""
    cfg = settings.mlp
    use_voxel = voxel_static is not None
    if use_voxel != cfg.use_voxel_embedding:
        raise ValueError("a voxel-conditioned model needs its voxel_static, and no other "
                         "model takes one")
    dense = use_voxel and vg.dense_path_ok(voxel_static)
    if use_voxel and not dense:
        warnings.warn(
            f"voxel grid {voxel_static.shape} needs a "
            f"{vg.dense_table_bytes(voxel_static) / (1 << 30):.2f} GiB dense corner table > "
            f"{vg.DENSE_CELL_TABLE_LIMIT_BYTES / (1 << 30):.0f} GiB limit; rendering "
            f"through the per-corner gathers")

    @torch.no_grad()
    def render(models: ObjectNeRFModels, rays: torch.Tensor, instance_ids: torch.Tensor,
               voxel_topo: Optional[vg.VoxelTopology] = None) -> Dict[str, torch.Tensor]:
        with trace.span("render.frame"):
            codes = models.code_library(instance_ids) if settings.forward_instance else None
            voxel_ctx = None
            if use_voxel:
                voxel_ctx = (models.voxel_features, voxel_topo, voxel_static)
                if dense:
                    voxel_ctx += (vg.CornerTable(
                        models.voxel_features, voxel_topo, voxel_static,
                        lowp=settings.matmul_dtype == torch.bfloat16),)
            packed = {}
            if rays.device.type == "cuda":
                if settings.N_importance > 0:
                    packed["coarse"] = (
                        pack_kernel_weights(models.nerf_coarse, cfg, forward_instance=True)
                        if bbox_route(settings) else
                        pack_kernel_weights(models.nerf_coarse, cfg, forward_instance=False,
                                            sigma_only=True))
                    packed["fine"] = pack_kernel_weights(
                        models.nerf_fine, cfg, settings.forward_instance)
                else:
                    packed["coarse"] = pack_kernel_weights(
                        models.nerf_coarse, cfg, settings.forward_instance)
            def render_chunk(c):
                sl = slice(c * chunk, (c + 1) * chunk)
                return render_rays_fused_eval(models, rays[sl], settings,
                                              codes[sl] if codes is not None else None, packed,
                                              voxel_ctx)

            return mesh.render_chunks(rays.shape[0], chunk, render_chunk)

    return render


def render_image(models: ObjectNeRFModels, settings: RenderSettings, np_batch,
                 chunk: int = 4096, device=None,
                 voxel_topo: Optional[vg.VoxelTopology] = None,
                 voxel_static: Optional[vg.VoxelStatic] = None) -> Dict[str, np.ndarray]:
    """Render a whole-image batch (`rays`, `instance_ids`) at eval settings on
    `device` (default `cuda`; the models, and a voxel model's topology, must
    already be there). The last chunk is padded by repeating the last ray.
    Returns host arrays."""
    device = resolve_device(device)
    param_device = next(models.parameters()).device
    if param_device.type != device.type:
        raise ValueError(f"models are on {param_device}, render device is {device}")
    rays = np.asarray(np_batch["rays"], np.float32)
    ids = np.asarray(np_batch["instance_ids"], np.int64)
    n = len(rays)
    chunk = min(chunk, n)
    pad = (-n) % chunk
    if pad:
        rays = np.concatenate([rays, np.repeat(rays[-1:], pad, 0)])
        ids = np.concatenate([ids, np.repeat(ids[-1:], pad, 0)])
    render = make_render_fn(settings, voxel_static, chunk)
    out = render(models, torch.from_numpy(rays).to(device),
                 torch.from_numpy(ids).to(device), voxel_topo)
    return {k: v[:n].cpu().numpy() for k, v in out.items()}


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


# the train steps captured into a CUDA graph and replayed (`TrainStep`), counters
# of `utils/trace.py`: kept at 0 where no step replays
graph_counts = trace.counter_dict(("train.graph_captures", "train.graph_replays"))


def graph_engages(device: torch.device, distributed: bool, plain: bool,
                  optimizer: torch.optim.Optimizer) -> bool:
    """Whether a train step replays a CUDA graph of itself: its batch is on a
    CUDA device, it is neither data parallel nor `plain`, and the optimizer
    keeps every per-step quantity on the device (`optim.keeps_step_on_device`:
    Adam over CUDA parameters; RAdam, ranger and SGD count their steps on the
    host)."""
    return (device.type == "cuda" and not distributed and not plain
            and keeps_step_on_device(optimizer))


def _launch_counters():
    """The kernel modules' launch counter dicts a step adds to."""
    return (fused_mlp.launch_counts, gather.launch_counts, vg.build_counts)


class _StepGraph:
    """One train step captured as a CUDA graph: the forward (the corner
    table's build and lookups included), the loss, `loss.backward()` (the
    table gradient on autograd's thread and the backward kernels) and the
    optimizer's update, over static input buffers, with the step's scalar
    metrics stacked into one static vector. `key` is the input signature it
    was captured for; `pinned` holds the objects whose identity the key
    records, so that no id is reused while the graph lives."""

    def __init__(self, key, pinned, work: Callable, batch: Mapping[str, torch.Tensor],
                 draws: RenderDraws):
        self.key, self.pinned = key, pinned
        self.batch = {k: torch.empty_like(v) for k, v in batch.items()}
        self.draws = RenderDraws(*(torch.empty_like(t) for t in _draw_tensors(draws)))
        self.load(batch, draws)
        before = [dict(d) for d in _launch_counters()]
        stream = torch.cuda.current_stream()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                out = work(self.batch, self.draws)
                self.names = list(out)
                self.out = torch.stack([out[k] for k in self.names])
        except RuntimeError as err:
            # a failed capture leaves its own stream current, and launched nothing
            torch.cuda.set_stream(stream)
            for d, b in zip(_launch_counters(), before):
                d.update(b)
            raise RuntimeError(
                "the train step could not be captured into a CUDA graph; an autograd graph "
                "over the model's parameters kept alive between steps prevents it (compute "
                "such values under torch.no_grad())") from err
        # the kernel launches the capture recorded, which every replay repeats
        self.launches = [{k: d[k] - b.get(k, 0) for k in d}
                         for d, b in zip(_launch_counters(), before)]
        graph_counts["train.graph_captures"] += 1

    def load(self, batch: Mapping[str, torch.Tensor], draws: RenderDraws) -> None:
        for k, v in batch.items():
            self.batch[k].copy_(v)
        for dst, src in zip(_draw_tensors(self.draws), _draw_tensors(draws)):
            dst.copy_(src)

    def replay(self) -> Dict[str, torch.Tensor]:
        """Run the step; its metrics as views of a fresh copy of the static
        vector (a caller keeps them across later replays)."""
        self.graph.replay()
        graph_counts["train.graph_replays"] += 1
        return dict(zip(self.names, self.out.clone().unbind(0)))

    def count_launches(self) -> None:
        for d, n in zip(_launch_counters(), self.launches):
            for k, v in n.items():
                d[k] += v


def _draw_tensors(draws: RenderDraws):
    return [getattr(draws, f.name) for f in dataclasses.fields(draws)]


class TrainStep:
    """One optimisation step: `step(models, batch, generator=None,
    draws=None, voxel_topo=None, voxel_static=None) -> metrics`. `batch` is a
    dict of tensors on the models' device; `optimizer` must hold the models'
    parameters. `global_step` counts the steps taken and indexes the
    learning-rate schedule (set it when resuming). A voxel-conditioned
    model's step takes its grid (`voxel_topo`, `voxel_static`) at call time:
    pruning changes the topology, subdivision both. Metrics stay on the
    device: nothing here synchronises but a capture (below), once per input
    signature.

    Where `graph_engages` holds (and the step has its draws, given or from
    `generator`), the step runs as one CUDA graph. Its input signature is
    the batch's keys, shapes and dtypes, the draws' shapes, and the identity
    of the models, the grid, the parameters and the learning-rate tensors (a
    `load_state_dict` of the optimizer brings new ones). The first call of a
    signature runs eagerly: a real step, which makes the optimizer's state,
    the gradients and the kernels' cached plans. The second captures the
    step (capture runs nothing) and replays it at once; every later call
    copies its batch and draws into the graph's buffers, writes the
    schedule's rate into the optimizer's rate tensor, and replays. A new
    signature drops the graph and starts over. A replay opens no
    `train.backward`, `train.optim`, `voxel.*` or `mlp.pack` span (the host
    does no such work); it adds the captured step's kernel launches to their
    counters and one to `train.graph_replays`, and a capture one to
    `train.graph_captures`. The metrics are views of a fresh copy of the
    graph's output, and `metrics["lr"]` a host float, as on the eager path.
    A capture fails, with a `RuntimeError` that says so, where the caller
    keeps an autograd graph over the parameters alive between steps (its
    gradient accumulators sit on the stream that made it).

    Under a process group (found when the step is built) `batch` is this
    rank's rows of the global batch, `draws` are the global batch's (every
    rank passes the same; each keeps its rows) or are drawn for the global
    batch from `generator`; each loss term divides by its global mask count,
    the gradients are summed over the ranks in one all-reduce before the
    optimizer's step, and the metrics are the global batch's."""

    def __init__(self, settings: RenderSettings, loss_weights: Mapping[str, float],
                 optimizer: torch.optim.Optimizer,
                 lr_schedule: Optional[Callable[[int], float]] = None,
                 plain: bool = False):
        self.settings = settings
        self.loss_weights = dict(loss_weights)
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self.plain = plain
        self.global_step = 0
        self.distributed = mesh.is_distributed()
        self.rank, self.world = mesh.rank(), mesh.world_size()
        self._graph: Optional[_StepGraph] = None
        self._seen = None  # (signature, pinned objects) of the last eager call that could capture

    def __call__(self, models: ObjectNeRFModels, batch, generator=None,
                 draws: Optional[RenderDraws] = None,
                 voxel_topo: Optional[vg.VoxelTopology] = None,
                 voxel_static: Optional[vg.VoxelStatic] = None) -> Dict[str, object]:
        with trace.span("train.step"):
            st = self.settings
            if (voxel_static is not None) != st.mlp.use_voxel_embedding:
                raise ValueError("a voxel-conditioned model needs its voxel_static, and no "
                                 "other model takes one")
            metrics: Dict[str, object] = {}
            lr = None
            if self.lr_schedule is not None:
                lr = metrics["lr"] = self.lr_schedule(self.global_step)
            if (draws is not None or generator is not None) and graph_engages(
                    batch["rays"].device, self.distributed, self.plain, self.optimizer):
                out = self._graphed(models, batch, generator, draws, voxel_topo, voxel_static,
                                    lr)
            else:
                out = self._work(models, batch, generator, draws, voxel_topo, voxel_static, lr)
            self.global_step += 1
            metrics.update(out)
            return metrics

    def _graphed(self, models, batch, generator, draws, voxel_topo, voxel_static,
                 lr) -> Dict[str, torch.Tensor]:
        """The step through its CUDA graph (class docstring)."""
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        pinned = (models, voxel_topo, voxel_static, *params,
                  *(g["lr"] for g in self.optimizer.param_groups))
        key = (tuple((k, v.shape, v.dtype, v.device) for k, v in batch.items()),
               None if draws is None else tuple(t.shape for t in _draw_tensors(draws)),
               tuple(map(id, pinned)))
        graph = self._graph
        if graph is not None and graph.key != key:
            self._graph = graph = None
        if graph is None and (self._seen is None or self._seen[0] != key):
            self._seen = (key, pinned)  # the signature's first call runs eagerly
            return self._work(models, batch, generator, draws, voxel_topo, voxel_static, lr)
        if draws is None:  # the draws the eager path makes in `render_rays`
            draws = RenderDraws.sample(self.settings, batch["rays"].shape[0],
                                       batch["rays"].device, generator)
        if lr is not None:
            set_lr(self.optimizer, lr)
        if graph is None:
            self._seen = None
            self._graph = graph = _StepGraph(key, pinned, lambda b, d: self._work(
                models, b, None, d, voxel_topo, voxel_static, None), batch, draws)
        else:
            graph.load(batch, draws)
            graph.count_launches()
        return graph.replay()

    def _work(self, models, batch, generator, draws, voxel_topo, voxel_static,
              lr) -> Dict[str, torch.Tensor]:
        """The step's work: the forward, the loss, the backward and the
        optimizer's update with the learning rate `lr` (None: as set).
        Returns the loss, psnr and loss terms under their metric names."""
        st = self.settings
        counts = None
        if self.distributed:
            n = batch["rays"].shape[0]
            if draws is None and generator is not None:
                draws = RenderDraws.sample(st, n * self.world, batch["rays"].device, generator)
            if draws is not None:
                if draws.perturb.shape[0] != n * self.world:
                    raise ValueError(f"draws for {draws.perturb.shape[0]} rays; the global "
                                     f"batch has {n * self.world}")
                draws = draws.rows(slice(self.rank * n, (self.rank + 1) * n))
            counts = mesh.all_reduce_sum(term_counts(batch, st.forward_instance))
        codes = None
        if st.forward_instance:
            codes = models.code_library(batch["instance_ids"])
        voxel_ctx = None
        if voxel_static is not None:
            voxel_ctx = (models.voxel_features, voxel_topo, voxel_static)
        results = render_rays(models, batch["rays"], st, embedding_instance=codes,
                              pass_through_mask=batch.get("pass_through_mask"),
                              generator=generator, draws=draws, plain=self.plain,
                              voxel_ctx=voxel_ctx)
        loss, logs = total_loss(results, batch, self.loss_weights, st.forward_instance,
                                counts)
        typ = "fine" if st.N_importance > 0 else "coarse"
        with torch.no_grad():
            if self.distributed:  # the colour term's count is psnr's too
                err = mse(results[f"rgb_{typ}"], batch["rgbs"], batch["valid_mask"][:, None],
                          counts[0])
            else:
                train_psnr = psnr(results[f"rgb_{typ}"], batch["rgbs"],
                                  batch["valid_mask"][:, None])
        with trace.span("train.optim"):
            if lr is not None:
                set_lr(self.optimizer, lr)
            self.optimizer.zero_grad(set_to_none=True)
        with trace.span("train.backward"):
            loss.backward()
        if self.distributed:
            mesh.all_reduce_grads(p for g in self.optimizer.param_groups for p in g["params"])
        with trace.span("train.optim"):
            self.optimizer.step()
        loss = loss.detach()
        if self.distributed:  # the global batch's loss, terms and psnr
            names = list(logs)
            glob = mesh.all_reduce_sum(torch.stack([loss, err] + [logs[k] for k in names]))
            loss, train_psnr = glob[0], -10.0 * torch.log10(glob[1])
            logs = dict(zip(names, glob[2:]))
        out = {"train/loss": loss, "train/psnr": train_psnr}
        out.update({f"train/{k}": v for k, v in logs.items()})
        return out


def make_train_step(settings: RenderSettings, loss_weights: Mapping[str, float],
                    optimizer: torch.optim.Optimizer, lr_schedule=None,
                    plain: bool = False) -> TrainStep:
    """Build the train step (see `TrainStep`). `plain` routes the MLP and a
    voxel model's lookup through their plain versions under autograd on any
    device: the reference a kernel-path step is checked against."""
    return TrainStep(settings, loss_weights, optimizer, lr_schedule, plain)


def _fetch(metrics: Mapping[str, object]) -> Dict[str, float]:
    """Metrics as host floats (synchronises with the device)."""
    return {k: float(v) for k, v in metrics.items()}


class ObjectNeRFSystem:
    """End-to-end trainer with the reference system's public surface. Runs
    on `device` (default `cuda`; raises when CUDA is asked for and absent)."""

    def __init__(self, config, dataset=None, val_dataset=None, device=None):
        self.config = config
        self.device = resolve_device(device if device is not None
                                     else config.get("device"))
        self.use_voxel = bool(config.model.get("use_voxel_embedding", True))
        self.train_dataset = dataset
        self.val_dataset = val_dataset
        self._last_val = None

        def in_bbox(ds) -> bool:
            # bbox-bounded rays route the instance weights into the importance
            # sampling (reference train.py:156-160 -> rendering.py:228-229)
            return bool(getattr(ds, "is_rays_in_bbox", lambda: False)())

        seed = int(config.train.get("seed", 42))
        # the CUDA kernels compute in bf16; the CPU path is the exact f32 one
        dtype_kw = dict(matmul_dtype=torch.bfloat16 if self.device.type == "cuda"
                        else torch.float32)
        self.settings = RenderSettings.from_config(
            config, white_back=getattr(dataset, "white_back", False), is_eval=False,
            rays_in_bbox=in_bbox(dataset), **dtype_kw)
        self.eval_settings = RenderSettings.from_config(
            config, white_back=getattr(val_dataset or dataset, "white_back", False),
            is_eval=True, rays_in_bbox=in_bbox(val_dataset or dataset), **dtype_kw)

        # voxel grid, from the scene's point cloud (the reference builds it from
        # dataset_extra.pcd_path; its features have a generator of their own,
        # so a seed gives the MLPs the same weights with and without a grid)
        self.voxel_topo = None
        self.voxel_static = None
        voxel_features = None
        if self.use_voxel:
            from ..data.ply_io import read_ply

            pcd = read_ply(config.dataset_extra.pcd_path)["points"]
            voxel_features, self.voxel_topo, self.voxel_static = (
                vg.build_voxel_grid_from_config(
                    pcd, config, generator=torch.Generator().manual_seed(seed + 2),
                    device=self.device))

        self.models = init_params(torch.Generator().manual_seed(seed), self.settings,
                                  config.model, device=self.device,
                                  voxel_features=voxel_features)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.batch_rng = np.random.RandomState(seed)

        batch_size = int(config.train.batch_size)
        mesh.shard_rows(batch_size)  # raises unless the ranks split the batch evenly
        if dataset is not None:
            self.steps_per_epoch = max(1, self._steps_per_epoch(dataset, batch_size))
        else:
            self.steps_per_epoch = 1000
        self.lr_schedule = make_lr_schedule(config.train, self.steps_per_epoch)
        self._build_optimizer()
        if config.get("ckpt_path"):
            from .checkpoint import restore_system

            restore_system(self, config.ckpt_path)
        # every rank starts from rank 0's weights and grid
        mesh.broadcast_tensors([t.detach() for t in self.models.state_dict().values()])
        if self.voxel_topo is not None:
            mesh.broadcast_tensors(self.voxel_topo)

    def _build_optimizer(self) -> None:
        self.optimizer = make_optimizer(self.config.train, self.models.parameters())
        self.train_step = make_train_step(self.settings, dict(self.config.loss),
                                          self.optimizer, self.lr_schedule)

    def adopt_voxel_features(self, features: torch.Tensor) -> None:
        """Replace the feature table by one of another capacity (a reference
        checkpoint's) and rebuild the optimizer over the new parameter."""
        self.models.embedding_xyz = VoxelEmbedding(features).to(self.device)
        self._build_optimizer()

    @property
    def global_step(self) -> int:
        return self.train_step.global_step

    def _steps_per_epoch(self, dataset, batch_size) -> int:
        limit = self.config.train.get("limit_train_batches", 1.0)
        full = max(1, len(dataset) // batch_size)
        if limit is None:
            return full
        if isinstance(limit, float) and limit <= 1.0:
            return max(1, int(full * limit))
        return min(full, int(limit))

    def _device_batch(self, np_batch) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.asarray(v)).to(self.device)
                for k, v in np_batch.items()}

    # -- public API ---------------------------------------------------------------
    def training_step(self, np_batch) -> Dict[str, object]:
        """One step on a global host batch (under a process group this rank
        takes its rows)."""
        if mesh.is_distributed():
            np_batch = mesh.shard_batch(np_batch)
        return self.train_step(self.models, self._device_batch(np_batch),
                               generator=self.generator, voxel_topo=self.voxel_topo,
                               voxel_static=self.voxel_static)

    def on_epoch_start(self, epoch: int) -> None:
        """Progressive voxel training (reference train.py:140-145; the JAX
        package's `on_epoch_start`, system.py:534-583): under
        `train.progressive_train`, prune the grid at every epoch > 2 and
        subdivide it at epoch 5. Under a process group every rank sweeps (the
        generators agree) and then takes rank 0's pruned topology, so that the
        ranks cannot diverge; the subdivision follows from identical inputs.

        The prune sweeps `train.prune_samples_per_voxel` jittered points
        (default 16^3) per voxel, `train.prune_voxel_batch` voxels (default
        256) at a time, through the fine model's scene density
        (`fused_sigma_eval`: the kernel on the card, the plain f32 version on
        CPU), its jitter drawn from the step generator. The subdivision
        writes the resampled features into the same table parameter: the
        table keeps its capacity, so every parameter keeps its shape and the
        optimizer its state for all of them, the table's moments included,
        as the JAX package's shape-matched graft of the Adam state keeps
        them. The next step reads the new grid."""
        cfg = self.config.train
        if not (cfg.get("progressive_train", False) and self.use_voxel):
            return
        features = self.models.voxel_features
        if epoch > 2:
            model = (self.models.nerf_fine if self.models.nerf_fine is not None
                     else self.models.nerf_coarse)
            mlp = self.settings.mlp
            spv = int(cfg.get("prune_samples_per_voxel", 16 ** 3))
            packed = None
            if self.device.type == "cuda":
                packed = pack_kernel_weights(model, mlp, forward_instance=False,
                                             sigma_only=True)

            def sigma_fn(pts, voxel_raw):
                return fused_sigma_eval(model, mlp, pts, None, "scene", spv,
                                        voxel_raw=voxel_raw, dtype=self.settings.matmul_dtype,
                                        packed=packed)

            self.voxel_topo = vg.prune_empty_voxels(
                features.detach(), self.voxel_topo, self.voxel_static, sigma_fn,
                generator=self.generator, samples_per_voxel=spv,
                voxel_batch=int(cfg.get("prune_voxel_batch", 256)))
            mesh.broadcast_tensors(self.voxel_topo)
        if epoch == 5:
            feats, self.voxel_topo, self.voxel_static = vg.subdivide_voxels(
                features.detach(), self.voxel_topo, self.voxel_static)
            with torch.no_grad():
                features.copy_(feats)

    def render_image(self, np_batch, chunk: int = 4096) -> Dict[str, np.ndarray]:
        """Render a whole-image batch at eval settings; returns host arrays."""
        return render_image(self.models, self.eval_settings, np_batch, chunk=chunk,
                            device=self.device, voxel_topo=self.voxel_topo,
                            voxel_static=self.voxel_static)

    def validation(self, frame: int = 0, chunk: int = 4096, img_wh=None):
        """PSNR (over valid pixels of the frame's instance) and SSIM of one
        validation frame through the eval render: (metrics, maps). Keeps the
        batch and the maps for `val_image_panel`."""
        batch = self.val_dataset.whole_image_batch(frame)
        out = self.render_image(batch, chunk)
        typ = "fine" if self.eval_settings.N_importance > 0 else "coarse"
        mask = np.asarray(batch["valid_mask"], bool)
        if "instance_mask" in batch:
            mask = mask & np.asarray(batch["instance_mask"], bool)
        pred = torch.from_numpy(out[f"rgb_{typ}"])
        gt = torch.from_numpy(np.asarray(batch["rgbs"], np.float32))
        metrics = {"val/psnr": float(psnr(pred, gt, torch.from_numpy(mask)[:, None]))}
        img_wh = img_wh or getattr(self.val_dataset, "img_wh", None)
        if img_wh is not None:
            w, h = img_wh
            metrics["val/ssim"] = float(ssim(pred.reshape(h, w, 3), gt.reshape(h, w, 3)))
        self._last_val = (img_wh, batch, out, typ)
        return metrics, out

    def val_image_panel(self) -> Optional[np.ndarray]:
        """(N_panels, H, W, 3) image stack of the last validation (GT rgb |
        instance rgb | rgb | instance depth | depth | GT depth | instance
        opacity): the reference's val/GT_pred_depth image (JAX
        `system.py:520-532`, reference utils/train_helper.py:24-55). None
        before any validation."""
        if self._last_val is None or self._last_val[0] is None:
            return None
        from ..utils.train_helper import visualize_val_image

        img_wh, batch, out, typ = self._last_val
        return visualize_val_image(img_wh, batch, out, typ=typ)

    def fit(self, callbacks=None, epoch_end_callbacks=None):
        """The training loop, from `global_step` (0, or a resumed step) to
        `train.num_epochs` epochs.

        `callbacks` fire after each validation: cb(epoch, it, metrics, self);
        `epoch_end_callbacks` once per epoch after its last step: cb(epoch,
        self). Validation runs every `train.val_check_interval` of an epoch,
        its frame in chunks of the config's `chunk` rays (default 4096).
        `train.nan_guard` (default on) raises when the loss is not finite; it
        looks every `train.nan_check_every` steps (default 50), and that
        host fetch is the only synchronisation of the loop besides
        validation and the step's capture (once per input signature: after
        a prune or subdivision, a resume, and at the start). `on_epoch_start` runs before the first step of each epoch
        that the loop begins from its step 0; a run resumed in the middle of
        an epoch skips it for that epoch, since the checkpoint already holds
        the grid as that epoch's hook left it (pruned or subdivided). With
        `tpu.profile_dir` set (the scene configs' key), `torch.profiler`
        records steps 2 to 2 + `tpu.profile_steps` (default 5) of this call
        and writes them as a Chrome trace, `<profile_dir>/trace.json`, which
        holds the program's spans (`utils/trace.py`) as ranges too. Under
        a process group every rank validates (the render is collective); the
        callbacks, the epoch line and the profiler run on rank 0 only, and the
        other ranks wait for it.
        Returns the metrics of every validation."""
        callbacks = callbacks or []
        cfg = self.config.train
        batch_size = int(cfg.batch_size)
        num_epochs = int(cfg.num_epochs)
        val_interval = max(1, int(self.steps_per_epoch
                                  * float(cfg.get("val_check_interval", 0.25))))
        nan_guard = bool(cfg.get("nan_guard", True))
        nan_check_every = max(1, int(cfg.get("nan_check_every", 50)))
        val_chunk = int(self.config.get("chunk", 4096))
        tpu = self.config.get("tpu") or {}
        lead = mesh.rank() == 0
        profile_dir = tpu.get("profile_dir") if lead else None
        profile_steps = int(tpu.get("profile_steps", 5))
        prof, steps_taken = None, 0

        def check_finite(loss_value, epoch, it):
            if nan_guard and not np.isfinite(float(loss_value)):
                raise FloatingPointError(
                    f"non-finite loss at epoch {epoch} it {it}: lower train.lr "
                    f"or enable model.noise_std")

        history = []
        first_epoch, first_it = divmod(self.global_step, self.steps_per_epoch)
        for epoch in range(first_epoch, num_epochs):
            start = first_it if epoch == first_epoch else 0
            if start == 0:
                self.on_epoch_start(epoch)
            t0 = time.time()
            metrics = None
            for it in range(start, self.steps_per_epoch):
                if profile_dir and steps_taken == 2 and prof is None:
                    prof = self._start_profiler()
                np_batch = self.train_dataset.sample_batch(batch_size, self.batch_rng)
                metrics = self.training_step(np_batch)
                steps_taken += 1
                if prof is not None and steps_taken == 2 + profile_steps:
                    self._stop_profiler(prof, profile_dir)
                if nan_guard and self.global_step % nan_check_every == 0:
                    check_finite(metrics["train/loss"], epoch, it)
                if (it + 1) % val_interval == 0 and self.val_dataset is not None:
                    val_metrics, _ = self.validation(chunk=val_chunk)
                    metrics = {**_fetch(metrics), **val_metrics}
                    check_finite(metrics["train/loss"], epoch, it)
                    history.append(metrics)
                    for cb in callbacks if lead else []:
                        cb(epoch, it, metrics, self)
                    mesh.barrier()
            if metrics is None:
                continue
            m = _fetch(metrics)  # waits for the epoch's last step
            dt = time.time() - t0  # epoch timing excludes checkpoint writes
            for cb in (epoch_end_callbacks or []) if lead else []:
                cb(epoch, self)
            mesh.barrier()
            rays_per_sec = (self.steps_per_epoch - start) * batch_size / dt
            if lead:
                print(f"epoch {epoch}: loss={m['train/loss']:.4f} "
                      f"psnr={m['train/psnr']:.2f} ({rays_per_sec:,.0f} rays/s)")
        if prof is not None and steps_taken < 2 + profile_steps:
            self._stop_profiler(prof, profile_dir)  # the run ended first
        return history

    def _start_profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        return prof

    def _stop_profiler(self, prof, profile_dir) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace written to {path}")
