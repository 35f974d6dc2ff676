"""Model construction, the train step, the whole-image eval render and the
fit loop.

Counterpart of `object_nerf_tpu/train/system.py`: `init_params` (:46-60),
`make_train_step` (:69-118, the monolithic step; the split-program
schedule of the TPU is not ported), `make_render_fn` (:121-245) and
`ObjectNeRFSystem` (:248-667: `training_step`, `render_image`,
`validation`, `on_epoch_start`, `fit`). One train step is one eager PyTorch
step: the stochastic `render_rays` (two launches of the fused forward
kernel), the reference TotalLoss, autograd (two launches of the fused
backward kernel), and the optimizer with its learning rate set from the
schedule.

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

Not ported: multi-device meshes (one device), the profiler hook, TensorBoard
scalars and the validation image panel.
"""

from __future__ import annotations

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
from ..ops.fused_mlp import pack_kernel_weights
from ..ops.fused_sigma import fused_sigma_eval
from ..render.renderer import (
    RenderDraws, RenderSettings, render_rays, render_rays_fused_eval,
)
from .losses import total_loss
from .metrics import psnr, ssim
from .optim import make_lr_schedule, make_optimizer, set_lr


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
    bf16 when the kernels compute in bf16. A grid whose table would exceed
    `DENSE_CELL_TABLE_LIMIT_BYTES` renders through the per-corner gathers
    instead, with a warning."""
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
                packed["coarse"] = pack_kernel_weights(
                    models.nerf_coarse, cfg, forward_instance=False, sigma_only=True)
                packed["fine"] = pack_kernel_weights(
                    models.nerf_fine, cfg, settings.forward_instance)
            else:
                packed["coarse"] = pack_kernel_weights(
                    models.nerf_coarse, cfg, settings.forward_instance)
        outs = []
        for i in range(0, rays.shape[0], chunk):
            codes_c = codes[i:i + chunk] if codes is not None else None
            outs.append(render_rays_fused_eval(models, rays[i:i + chunk], settings,
                                               codes_c, packed, voxel_ctx))
        return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}

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


class TrainStep:
    """One optimisation step: `step(models, batch, generator=None,
    draws=None, voxel_topo=None, voxel_static=None) -> metrics`. `batch` is a
    dict of tensors on the models' device; `optimizer` must hold the models'
    parameters. `global_step` counts the steps taken and indexes the
    learning-rate schedule (set it when resuming). A voxel-conditioned
    model's step takes its grid (`voxel_topo`, `voxel_static`) at call time:
    pruning changes the topology, subdivision both. Metrics stay on the
    device: nothing here synchronises."""

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

    def __call__(self, models: ObjectNeRFModels, batch, generator=None,
                 draws: Optional[RenderDraws] = None,
                 voxel_topo: Optional[vg.VoxelTopology] = None,
                 voxel_static: Optional[vg.VoxelStatic] = None) -> Dict[str, object]:
        st = self.settings
        if (voxel_static is not None) != st.mlp.use_voxel_embedding:
            raise ValueError("a voxel-conditioned model needs its voxel_static, and no other "
                             "model takes one")
        metrics: Dict[str, object] = {}
        if self.lr_schedule is not None:
            metrics["lr"] = self.lr_schedule(self.global_step)
            set_lr(self.optimizer, metrics["lr"])
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
        loss, logs = total_loss(results, batch, self.loss_weights, st.forward_instance)
        typ = "fine" if st.N_importance > 0 else "coarse"
        with torch.no_grad():
            train_psnr = psnr(results[f"rgb_{typ}"], batch["rgbs"],
                              batch["valid_mask"][:, None])
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.global_step += 1
        metrics.update({"train/loss": loss.detach(), "train/psnr": train_psnr})
        metrics.update({f"train/{k}": v for k, v in logs.items()})
        return metrics


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
        for ds in (dataset, val_dataset):
            if ds is not None and getattr(ds, "is_rays_in_bbox", lambda: False)():
                raise NotImplementedError("rays_in_bbox datasets are not ported yet")

        seed = int(config.train.get("seed", 42))
        # the CUDA kernels compute in bf16; the CPU path is the exact f32 one
        dtype_kw = dict(matmul_dtype=torch.bfloat16 if self.device.type == "cuda"
                        else torch.float32)
        self.settings = RenderSettings.from_config(
            config, white_back=getattr(dataset, "white_back", False), is_eval=False,
            **dtype_kw)
        self.eval_settings = RenderSettings.from_config(
            config, white_back=getattr(val_dataset or dataset, "white_back", False),
            is_eval=True, **dtype_kw)

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
        if dataset is not None:
            self.steps_per_epoch = max(1, self._steps_per_epoch(dataset, batch_size))
        else:
            self.steps_per_epoch = 1000
        self.lr_schedule = make_lr_schedule(config.train, self.steps_per_epoch)
        self._build_optimizer()
        if config.get("ckpt_path"):
            from .checkpoint import restore_system

            restore_system(self, config.ckpt_path)

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
        return self.train_step(self.models, self._device_batch(np_batch),
                               generator=self.generator, voxel_topo=self.voxel_topo,
                               voxel_static=self.voxel_static)

    def on_epoch_start(self, epoch: int) -> None:
        """Progressive voxel training (reference train.py:140-145; the JAX
        package's `on_epoch_start`, system.py:534-583): under
        `train.progressive_train`, prune the grid at every epoch > 2 and
        subdivide it at epoch 5.

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
        validation frame through the eval render: (metrics, maps)."""
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
        return metrics, out

    def fit(self, callbacks=None, epoch_end_callbacks=None):
        """The training loop, from `global_step` (0, or a resumed step) to
        `train.num_epochs` epochs.

        `callbacks` fire after each validation: cb(epoch, it, metrics, self);
        `epoch_end_callbacks` once per epoch after its last step: cb(epoch,
        self). Validation runs every `train.val_check_interval` of an epoch.
        `train.nan_guard` (default on) raises when the loss is not finite; it
        looks every `train.nan_check_every` steps (default 50), and that
        host fetch is the only synchronisation of the loop besides
        validation. `on_epoch_start` runs before the first step of each epoch
        that the loop begins from its step 0; a run resumed in the middle of
        an epoch skips it for that epoch, since the checkpoint already holds
        the grid as that epoch's hook left it (pruned or subdivided). Returns
        the metrics of every validation."""
        callbacks = callbacks or []
        cfg = self.config.train
        batch_size = int(cfg.batch_size)
        num_epochs = int(cfg.num_epochs)
        val_interval = max(1, int(self.steps_per_epoch
                                  * float(cfg.get("val_check_interval", 0.25))))
        nan_guard = bool(cfg.get("nan_guard", True))
        nan_check_every = max(1, int(cfg.get("nan_check_every", 50)))

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
                np_batch = self.train_dataset.sample_batch(batch_size, self.batch_rng)
                metrics = self.training_step(np_batch)
                if nan_guard and self.global_step % nan_check_every == 0:
                    check_finite(metrics["train/loss"], epoch, it)
                if (it + 1) % val_interval == 0 and self.val_dataset is not None:
                    val_metrics, _ = self.validation()
                    metrics = {**_fetch(metrics), **val_metrics}
                    check_finite(metrics["train/loss"], epoch, it)
                    history.append(metrics)
                    for cb in callbacks:
                        cb(epoch, it, metrics, self)
            if metrics is None:
                continue
            m = _fetch(metrics)  # waits for the epoch's last step
            dt = time.time() - t0  # epoch timing excludes checkpoint writes
            for cb in (epoch_end_callbacks or []):
                cb(epoch, self)
            rays_per_sec = (self.steps_per_epoch - start) * batch_size / dt
            print(f"epoch {epoch}: loss={m['train/loss']:.4f} "
                  f"psnr={m['train/psnr']:.2f} ({rays_per_sec:,.0f} rays/s)")
        return history
