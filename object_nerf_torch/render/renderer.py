"""Renders of the hierarchical two-branch model.

Counterpart of `object_nerf_tpu/render/renderer.py`: `RenderSettings`
(:35-77, without the Pallas/TPU knobs), the deterministic eval render
`render_rays_fused_eval` (:218-306) and the stochastic, differentiable
`render_rays` of the training step (:121-215, :458-525).

Eval, per chunk of rays: stratified z -> `fused_coarse_weights` (scene
density -> pdf weights) -> `sample_pdf` + sort-merge -> `fused_render_tiles`
(both branches + compositing) -> the final pass's maps.

Training: perturbed stratified z -> `fused_mlp_eval` (both branches, raw
per-sample outputs, differentiable through its backward kernel) -> noisy
compositing of the scene and the instance -> importance samples from the
detached coarse weights -> the same again for the fine model. Both passes'
maps are emitted under the reference's key schema. The glue between the
kernels is plain tensor code under autograd.

Voxel-conditioned models pass a `voxel_ctx` = (features, topology, static[,
corner table]) (`models/voxel_grid.py`): the eval render looks the raw voxel
features of each pass's samples up once per chunk (`lookup_voxel_raw`, from
the frame's `voxel_grid.CornerTable`, in bf16 when the kernels compute in
bf16) and hands them to the kernels as their `voxel_raw` operand.
`render_rays` does the same under autograd: it builds ONE trainable
`CornerTable` (the JAX split step's P1, `train/split_step.py:131-152`)
unless `voxel_ctx` brings one, both passes read it, and the table gradient
of both passes is one segment-sum and one transpose of the build. With
`plain=True` the lookup and the MLP are the plain versions under autograd
(`voxel_grid.PlainCornerTable`).

The `rays_in_bbox` route (JAX `renderer.py:214-215`, `:324-331`, `:346`,
`:386-432`; reference rendering.py:228-229): rays bounded by one object's
box take their importance samples from the instance branch's compositing
weights, not the scene's. In `render_rays` (training) `weights_{typ}` is
then the instance compositing's weights. In the eval chunk the coarse pass
runs `fused_mlp_eval` on both branches (with the frame's `packed` inference
weights on the card), the compositing glue of `_composite_pass` runs on its
raw outputs without noise, and `sample_pdf` and `fused_render_tiles` follow
as on the plain route. A model without an instance branch takes the plain
route (JAX `:346`). The route's coarse pass, from its voxel lookup to the
pdf weights, is the stream span `render.route_coarse`, and each chunk it
renders adds one to the counter `render.route_chunks` (`utils/trace.py`);
the plain route opens neither.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..models import voxel_grid as vg
from ..models.embedding import freq_encode
from ..models.mlp import ObjectNeRFConfig
from ..models.voxel_grid import voxel_embed, voxel_lookup_raw
from ..ops.compositing import composite, composite_instance
from ..ops.fused_mlp import (
    coarse_weights_plain, fused_coarse_weights, fused_render_tiles, render_tiles_plain,
)
from ..ops.fused_mlp_vjp import MLPOut, fused_mlp_eval, mlp_eval_plain
from ..ops.fwd_chain import PackedWeights
from ..ops.sampling import merge_z_vals, sample_pdf, stratified_sample
from ..utils import trace


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static render configuration."""

    mlp: ObjectNeRFConfig
    N_samples: int = 64
    N_importance: int = 64
    use_disp: bool = False
    perturb: float = 1.0
    noise_std: float = 1.0
    white_back: bool = False
    forward_instance: bool = True
    frustum_bound_th: float = 0.0
    is_eval: bool = False
    rays_in_bbox: bool = False
    # matmul operand precision of the fused passes: the CUDA kernels run
    # bf16; on CPU tensors the plain versions follow this (float32 = exact)
    matmul_dtype: torch.dtype = torch.bfloat16

    @classmethod
    def from_config(cls, cfg, *, white_back=False, is_eval=False, **over):
        mlp = ObjectNeRFConfig.from_config(cfg.model)
        fb = float(cfg.model.frustum_bound)
        scale = float(cfg.dataset_extra.get("scale_factor", 1.0))
        kw = dict(
            mlp=mlp,
            N_samples=int(cfg.model.N_samples),
            N_importance=int(cfg.model.N_importance),
            use_disp=bool(cfg.model.use_disp),
            perturb=0.0 if is_eval else float(cfg.model.perturb),
            noise_std=0.0 if is_eval else float(cfg.model.noise_std),
            white_back=white_back,
            frustum_bound_th=fb / scale if fb > 0 else 0.0,
            is_eval=is_eval,
        )
        kw.update(over)
        return cls(**kw)


# Voxel context: (features, topology, static[, corner_table]) or None for the
# classical PE. The optional 4th element is a prebuilt `voxel_grid.CornerTable`
# (built once per frame by the eval renders, once per step by `render_rays`)
# or its `PlainCornerTable`; without it each lookup builds its own table, or
# takes the per-corner gathers of a grid too large for one.
VoxelCtx = Optional[Tuple]


def lookup_voxel_raw(settings: RenderSettings, voxel_ctx: VoxelCtx,
                      xyz: torch.Tensor) -> Optional[torch.Tensor]:
    """Raw (n, S, C) voxel features of samples xyz (n, S, 3) for the fused
    kernels, or None: the one place the passes fetch voxel features (from a
    bf16 corner table when the kernels compute in bf16). A trainable table
    (`voxel_ctx[3]` of a training step) looks up under autograd."""
    if voxel_ctx is None:
        return None
    if len(voxel_ctx) > 3:
        raw, _ = voxel_ctx[3].lookup(xyz.reshape(-1, 3))
    else:  # a table of its own, or the per-corner gathers
        raw, _ = voxel_lookup_raw(*voxel_ctx, xyz.reshape(-1, 3), trilinear=True,
                                  lowp=settings.matmul_dtype == torch.bfloat16)
    return raw.reshape(xyz.shape[0], xyz.shape[1], -1).contiguous()


def _embed_points(xyz_flat: torch.Tensor, settings: RenderSettings, voxel_ctx: VoxelCtx):
    """(emb_xyz (N, C), obj_voxel (N, Cv) or None): the EmbeddingVoxel.forward
    / classical Embedding split (reference train.py:45-53)."""
    if voxel_ctx is None:
        return freq_encode(xyz_flat, settings.mlp.N_freq_xyz), None
    features, topo, static = voxel_ctx[:3]
    ct = voxel_ctx[3].ct if len(voxel_ctx) > 3 else None
    return voxel_embed(features, topo, static, xyz_flat, n_freq_xyz=settings.mlp.N_freq_xyz,
                       ct=ct)


def bbox_route(settings: RenderSettings) -> bool:
    """Whether the importance samples follow the instance weights: the
    `rays_in_bbox` route, which needs an instance branch."""
    return settings.rays_in_bbox and settings.forward_instance


def _check_eval(settings: RenderSettings) -> None:
    if settings.perturb != 0 or settings.noise_std != 0:
        raise ValueError("fused render is the deterministic eval path "
                         "(perturb=0, noise_std=0)")


def _render_chunk(models: nn.Module, rays: torch.Tensor, settings: RenderSettings,
                  codes: Optional[torch.Tensor], coarse_fn, mlp_fn, tiles_fn,
                  packed: Dict[str, PackedWeights],
                  voxel_ctx: VoxelCtx = None) -> Dict[str, torch.Tensor]:
    _check_eval(settings)
    cfg = settings.mlp
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]

    z_vals = stratified_sample(near, far, settings.N_samples, settings.use_disp)
    dir_pe = freq_encode(rays_d, cfg.N_freq_dir).contiguous()
    codes = codes if settings.forward_instance else None

    xyz_c = (rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]).contiguous()
    if settings.N_importance > 0:
        if bbox_route(settings):
            # both branches' raw outputs, composited: the instance weights
            trace.count("render.route_chunks")
            with trace.span("render.route_coarse", stream=True):
                vox_c = lookup_voxel_raw(settings, voxel_ctx, xyz_c)
                raw = mlp_fn(models.nerf_coarse, cfg, xyz_c, dir_pe, codes, vox_c,
                             packed.get("coarse"))
                coarse: Dict[str, torch.Tensor] = {}
                _composite_pass(coarse, settings, "coarse", raw, z_vals, None, None, None)
                weights = coarse["weights_coarse"]
        else:
            # only the pdf weights survive the coarse pass: scene density only
            vox_c = lookup_voxel_raw(settings, voxel_ctx, xyz_c)
            weights = coarse_fn(models.nerf_coarse, cfg, xyz_c, z_vals, voxel_raw=vox_c,
                                packed=packed.get("coarse"))
        z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        z_fine = sample_pdf(z_mid, weights[:, 1:-1], settings.N_importance, det=True)
        z_final = merge_z_vals(z_vals, z_fine).contiguous()
        xyz = (rays_o[:, None, :] + rays_d[:, None, :] * z_final[..., None]).contiguous()
        model, typ = models.nerf_fine, "fine"
    else:
        z_final, xyz, model, typ = z_vals, xyz_c, models.nerf_coarse, "coarse"
    out = tiles_fn(model, cfg, xyz, z_final, dir_pe, obj_codes=codes,
                   voxel_raw=lookup_voxel_raw(settings, voxel_ctx, xyz),
                   forward_instance=settings.forward_instance,
                   white_back=settings.white_back, packed=packed.get(typ))
    keys = ["rgb", "depth", "opacity"]
    if settings.forward_instance:
        keys += ["rgb_instance", "depth_instance", "opacity_instance"]
    return {f"{k}_{typ}": out[k] for k in keys}


def render_rays_fused_eval(models: nn.Module, rays: torch.Tensor,
                           settings: RenderSettings,
                           embedding_instance: Optional[torch.Tensor] = None,
                           packed: Optional[Dict[str, PackedWeights]] = None,
                           voxel_ctx: VoxelCtx = None) -> Dict[str, torch.Tensor]:
    """Deterministic eval render of one chunk of rays (N, 8) = [o, d, near,
    far] through the two fused kernels (their plain versions on CPU
    tensors). `models` holds `nerf_coarse` (and `nerf_fine` when
    N_importance > 0); `embedding_instance` (N, C_code) are the rays' object
    codes; `packed` maps "coarse"/"fine" to weights packed once per frame
    (the coarse model's in full, `forward_instance=True`, on the
    `rays_in_bbox` route, its sigma-only weights otherwise); `voxel_ctx` is
    the voxel grid of a voxel-conditioned model (one lookup per pass). Emits
    only the final pass's maps."""

    def coarse_fn(model, cfg, xyz, z, voxel_raw=None, packed=None):
        return fused_coarse_weights(model, cfg, xyz, z, voxel_raw=voxel_raw,
                                    dtype=settings.matmul_dtype, packed=packed)

    def mlp_fn(model, cfg, xyz, dir_pe, codes, voxel_raw, packed) -> MLPOut:
        return fused_mlp_eval(model, cfg, xyz, dir_pe, codes, voxel_raw=voxel_raw,
                              forward_instance=True, dtype=settings.matmul_dtype,
                              packed=packed)

    def tiles_fn(model, cfg, xyz, z, dir_pe, packed=None, **kw):
        return fused_render_tiles(model, cfg, xyz, z, dir_pe, dtype=settings.matmul_dtype,
                                  packed=packed, **kw)

    return _render_chunk(models, rays, settings, embedding_instance, coarse_fn, mlp_fn,
                         tiles_fn, packed or {}, voxel_ctx)


def render_rays_plain(models: nn.Module, rays: torch.Tensor, settings: RenderSettings,
                      embedding_instance: Optional[torch.Tensor] = None,
                      matmul_dtype=torch.float32,
                      voxel_ctx: VoxelCtx = None) -> Dict[str, torch.Tensor]:
    """`render_rays_fused_eval` through the kernels' plain versions, on any
    device: the reference a kernel render is checked against. The voxel
    lookup follows `matmul_dtype` (a bf16 corner table for bf16), whatever
    `settings.matmul_dtype` says."""
    settings = dataclasses.replace(settings, matmul_dtype=matmul_dtype)

    def coarse_fn(model, cfg, xyz, z, voxel_raw=None, packed=None):
        return coarse_weights_plain(model, cfg, xyz, z, voxel_raw=voxel_raw,
                                    matmul_dtype=matmul_dtype)

    def mlp_fn(model, cfg, xyz, dir_pe, codes, voxel_raw, packed=None) -> MLPOut:
        return mlp_eval_plain(model, cfg, xyz, dir_pe, codes, forward_instance=True,
                              matmul_dtype=matmul_dtype, voxel_raw=voxel_raw)

    def tiles_fn(model, cfg, xyz, z, dir_pe, packed=None, **kw):
        return render_tiles_plain(model, cfg, xyz, z, dir_pe, matmul_dtype=matmul_dtype, **kw)

    return _render_chunk(models, rays, settings, embedding_instance, coarse_fn, mlp_fn,
                         tiles_fn, {}, voxel_ctx)


# ---------------------------------------------------------------------------
# The stochastic render of the training step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RenderDraws:
    """The random draws of one `render_rays` call, in the order of the JAX
    package's key split (`renderer.py:479`): uniform [0, 1) for `perturb`
    (N, N_samples) and `pdf` (N, N_importance), standard normal for the four
    density noises (coarse (N, N_samples), fine (N, N_samples +
    N_importance))."""

    perturb: torch.Tensor
    noise_coarse: torch.Tensor
    noise_inst_coarse: torch.Tensor
    pdf: torch.Tensor
    noise_fine: torch.Tensor
    noise_inst_fine: torch.Tensor

    @classmethod
    def sample(cls, settings: RenderSettings, n_rays: int, device,
               generator: Optional[torch.Generator] = None) -> "RenderDraws":
        """Draw them from `generator`, which lives on `device` (None: the
        device's default generator)."""
        s_c = settings.N_samples
        s_f = s_c + settings.N_importance

        def u(*shape):
            return torch.rand(shape, device=device, generator=generator)

        def nrm(*shape):
            return torch.randn(shape, device=device, generator=generator)

        return cls(u(n_rays, s_c), nrm(n_rays, s_c), nrm(n_rays, s_c),
                   u(n_rays, settings.N_importance), nrm(n_rays, s_f), nrm(n_rays, s_f))

    def rows(self, sl: slice) -> "RenderDraws":
        """The draws of rows `sl` (a data-parallel rank's share of the
        global batch's draws)."""
        return RenderDraws(*(getattr(self, f.name)[sl] for f in dataclasses.fields(self)))


def _eval_models(model: nn.Module, settings: RenderSettings, xyz: torch.Tensor,
                 dir_pe: torch.Tensor, codes: Optional[torch.Tensor], plain: bool,
                 voxel_ctx: VoxelCtx = None):
    """Both branches over (N_rays, S) samples: the fused op (kernels on CUDA
    tensors), or its plain version under autograd when `plain`. A voxel
    model's raw features come from the step's corner table (`voxel_ctx[3]`)
    and enter either as their `voxel_raw` operand."""
    voxel_raw = lookup_voxel_raw(settings, voxel_ctx, xyz)
    if plain:
        return mlp_eval_plain(model, settings.mlp, xyz, dir_pe, codes,
                              forward_instance=settings.forward_instance,
                              matmul_dtype=settings.matmul_dtype, voxel_raw=voxel_raw)
    return fused_mlp_eval(model, settings.mlp, xyz.contiguous(), dir_pe, codes,
                          voxel_raw=voxel_raw, forward_instance=settings.forward_instance,
                          dtype=settings.matmul_dtype)


def train_voxel_ctx(settings: RenderSettings, voxel_ctx: VoxelCtx,
                    plain: bool = False) -> VoxelCtx:
    """`voxel_ctx` with its trainable corner table, built here (once) unless
    it brings one: the table of a training step, which both passes read. In
    bf16 when the kernels compute in bf16; `plain` builds the plain version.
    A grid whose table would exceed `DENSE_CELL_TABLE_LIMIT_BYTES` keeps the
    per-corner gathers (plain tensor code under autograd), with a warning."""
    if voxel_ctx is None or len(voxel_ctx) > 3:
        return voxel_ctx
    features, topo, static = voxel_ctx
    if not vg.dense_path_ok(static):
        warnings.warn(
            f"voxel grid {static.shape} needs a "
            f"{vg.dense_table_bytes(static) / (1 << 30):.2f} GiB dense corner table > "
            f"{vg.DENSE_CELL_TABLE_LIMIT_BYTES / (1 << 30):.0f} GiB limit; training "
            f"through the per-corner gathers")
        return voxel_ctx
    table = vg.PlainCornerTable if plain else vg.CornerTable
    return (features, topo, static,
            table(features, topo, static, lowp=settings.matmul_dtype == torch.bfloat16))


def _composite_pass(results: Dict[str, torch.Tensor], settings: RenderSettings, typ: str,
                    raw, z_vals: torch.Tensor, noise: Optional[torch.Tensor],
                    noise_inst: Optional[torch.Tensor],
                    pass_through_mask: Optional[torch.Tensor]) -> None:
    sigma, rgb, inst_sigma, inst_rgb = raw
    scene = composite(sigma, rgb, z_vals, noise_std=settings.noise_std,
                      last_delta_inf=True, white_back=settings.white_back, noise=noise)
    results[f"weights_{typ}"] = scene.weights
    results[f"opacity_{typ}"] = scene.opacity
    results[f"z_vals_{typ}"] = z_vals
    results[f"rgb_{typ}"] = scene.rgb
    results[f"depth_{typ}"] = scene.depth
    if settings.forward_instance:
        inst = composite_instance(
            inst_sigma, inst_rgb, z_vals, scene.depth, noise_std=settings.noise_std,
            frustum_bound_th=settings.frustum_bound_th, pass_through_mask=pass_through_mask,
            apply_occlusion=not settings.is_eval, noise=noise_inst)
        results[f"rgb_instance_{typ}"] = inst.rgb
        results[f"depth_instance_{typ}"] = inst.depth
        results[f"opacity_instance_{typ}"] = inst.opacity
        if settings.rays_in_bbox:  # the pdf follows the object (rendering.py:228-229)
            results[f"weights_{typ}"] = inst.weights


def render_rays(models: nn.Module, rays: torch.Tensor, settings: RenderSettings,
                embedding_instance: Optional[torch.Tensor] = None,
                pass_through_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                draws: Optional[RenderDraws] = None,
                plain: bool = False,
                voxel_ctx: VoxelCtx = None) -> Dict[str, torch.Tensor]:
    """Render a batch of rays (N, 8) = [o, d, near, far], differentiably.

    The randomness is `draws` when given, else it is drawn from `generator`
    on the rays' device; with neither, `perturb` uses the default generator
    and no density noise is added (as with no key in the JAX package).
    `plain` routes the MLP (and a voxel model's lookup) through the plain
    versions under autograd instead of the fused op. A voxel-conditioned
    model passes `voxel_ctx` = (features, topology, static[, trainable
    corner table]); without the table one is built here, once for both
    passes (`train_voxel_ctx`). Returns both passes' maps under the
    reference's keys (`rgb_fine`, `opacity_instance_coarse`, `weights_coarse`,
    ...); on the `rays_in_bbox` route `weights_{typ}` are the instance
    compositing's weights, which the importance samples follow."""
    cfg = settings.mlp
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    if draws is None and generator is not None:
        draws = RenderDraws.sample(settings, rays.shape[0], rays.device, generator)
    d = draws
    codes = embedding_instance if settings.forward_instance else None
    voxel_ctx = train_voxel_ctx(settings, voxel_ctx, plain)

    z_vals = stratified_sample(near, far, settings.N_samples, settings.use_disp,
                               settings.perturb, u=d.perturb if d else None)
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    dir_pe = freq_encode(rays_d, cfg.N_freq_dir).contiguous()

    results: Dict[str, torch.Tensor] = {}
    raw = _eval_models(models.nerf_coarse, settings, xyz, dir_pe, codes, plain, voxel_ctx)
    _composite_pass(results, settings, "coarse", raw, z_vals,
                    d.noise_coarse if d else None, d.noise_inst_coarse if d else None,
                    pass_through_mask)
    if settings.N_importance > 0:
        z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        z_fine = sample_pdf(z_mid, results["weights_coarse"][:, 1:-1], settings.N_importance,
                            det=(settings.perturb == 0), u=d.pdf if d else None)
        z_all = merge_z_vals(z_vals, z_fine)
        xyz_fine = rays_o[:, None, :] + rays_d[:, None, :] * z_all[..., None]
        raw_f = _eval_models(models.nerf_fine, settings, xyz_fine, dir_pe, codes, plain,
                             voxel_ctx)
        _composite_pass(results, settings, "fine", raw_f, z_all,
                        d.noise_fine if d else None, d.noise_inst_fine if d else None,
                        pass_through_mask)
    return results
