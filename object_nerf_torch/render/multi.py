"""Multi-object sort-merge compositing for editable rendering.

Counterpart of `object_nerf_tpu/render/multi.py` (reference
`render_rays_multi` / `volume_rendering_multi` / `inference_from_model`,
render_tools/multi_rendering.py:16-325):

* one ray set per active object (id 0 = the background scene), each with
  stratified z over its own near/far;
* an object set goes through the *object branch* with that id's latent code,
  the background set through the scene branch;
* muted rays (far == 0: the object's box was missed) get sigma = -1e5
  (multi_rendering.py:40-41,83,92), and so do background samples inside the
  boxes of removed objects (multi_rendering.py:239-241,309-311);
* joint compositing: all sets' z/rgb/sigma concatenated, sorted by z
  (stably: muted sets have z all 0, hence long runs of ties), one alpha
  composite with last delta 0 (multi_rendering.py:96-157);
* fine pass: the per-object coarse weights are recovered by inverting the
  sort, `sample_pdf` per object, re-evaluate, re-composite
  (multi_rendering.py:259-324).

Two entry points. `render_rays_multi` is the general one (perturbation and
density noise from explicit draws or a generator, both passes' maps, every
per-sample output); it evaluates the models with `fused_mlp_eval`, one
branch per ray set. `render_multi_fused_eval` is the deterministic frame
path of the edit renderer: the coarse pass only feeds the importance pdf, so
it runs the density-only kernel `fused_sigma_eval` per ray set, and only the
final pass's maps are returned. Its math is that of the JAX package's
`make_multi_eval_stages` (multi.py:323-590) without the split into 2K + 3
separately compiled programs, which exists there for the TPU toolchain. On
CUDA tensors both launch the kernels, on CPU tensors their plain versions.

A voxel-conditioned model passes `voxel_ctx` = (features, topology, static[,
corner table]) (`render/renderer.py`): every ray set's samples of each pass
take one lookup of their raw voxel features (`lookup_voxel_raw`: `gather_rows`
on the card, from the corner table the edit renderer builds once per frame,
in bf16 when the kernels compute in bf16), which feeds the kernels' voxel
operand (`fused_sigma_eval(voxel_raw=)`, `fused_mlp_eval(voxel_raw=)`), as
the JAX package's `lookup` / `stage_prep` / `_sigma_kernel_stage`
(multi.py:105-160, :326-590) do.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models.embedding import freq_encode
from ..ops.fused_mlp_vjp import fused_mlp_eval, mlp_eval_plain
from ..ops.fused_sigma import fused_sigma_eval
from ..ops.fwd_chain import PackedWeights, pack_kernel_weights
from ..ops.sampling import sample_pdf, stratified_sample
from ..utils import trace
from .renderer import RenderSettings, VoxelCtx, lookup_voxel_raw

MUTE_SIGMA = -1e5

# (affines (B, 4, 4), bounds (B, 2, 3), scale_factor): `edit.bbox.boxes_to_arrays`
SkipBoxes = Tuple[torch.Tensor, torch.Tensor, float]


def compact_hit_order(rays_list, obj_instance_ids, chunk: int):
    """Host-side chunk planner: skip object evaluation for all-miss chunks.

    The reference evaluates every object ray set densely: rays whose box
    intersection missed (near = far = 0) still run the coarse and fine MLP
    and are only muted at composite time. In a demo frame the edited object
    covers a small fraction of the pixels. The pixel order within a frame is
    free, so this returns a stable permutation that puts rays hit by at least
    one object first, plus the number of leading chunks that contain any hit.
    Those chunks run the full K-object render; every later chunk is all-miss
    and runs the background set alone.

    Muted samples are not exactly free in the composite (their alpha == 0
    rows still contribute the `+1e-10` transmittance epsilon and uniformly
    rescale the pdf weights), so dropping them changes the output at the 1e-8
    level. Callers that need the dense semantics pass compaction off.

    `rays_list`: K arrays or tensors (N, >= 8). Returns None when compaction
    does not apply (no background set leading, a zero id elsewhere, or every
    ray hits); else (perm (N,) numpy, n_mixed).
    """
    ids = tuple(int(i) for i in obj_instance_ids)
    if len(ids) < 2 or ids[0] != 0 or 0 in ids[1:]:
        return None
    n = int(rays_list[0].shape[0])
    any_hit = np.zeros(n, bool)
    for rays, oid in zip(rays_list, ids):
        if oid != 0:
            far = rays[:, 7]
            if isinstance(far, torch.Tensor):
                far = far.cpu().numpy()
            any_hit |= np.asarray(far) > 0
    n_hit = int(any_hit.sum())
    if n_hit == n:
        return None
    perm = np.argsort(~any_hit, kind="stable")
    n_mixed = -(-n_hit // chunk)  # ceil
    return perm, n_mixed


def _in_any_box(xyz: torch.Tensor, box_affines: torch.Tensor, box_bounds: torch.Tensor,
                scale_factor: float) -> torch.Tensor:
    """xyz (N, 3) NeRF coords -> bool (N,): inside any removal box."""
    p = xyz * scale_factor
    p = torch.einsum("bij,nj->bni", box_affines[:, :3, :3], p) + box_affines[:, None, :3, 3]
    inb = ((p >= box_bounds[:, None, 0]) & (p <= box_bounds[:, None, 1])).all(dim=-1)
    return inb.any(dim=0)


def _removal_mask(xyz: torch.Tensor, instance_id: int,
                  skip_boxes: Optional[SkipBoxes]) -> Optional[torch.Tensor]:
    """(N, S) bool: background samples inside removed-object boxes, or None.
    Only the background set (id 0) is carved out."""
    if instance_id != 0 or skip_boxes is None:
        return None
    affines, bounds, scale = skip_boxes
    return _in_any_box(xyz.reshape(-1, 3), affines, bounds, scale).reshape(xyz.shape[:2])


def _mute_sigma(sigma: torch.Tensor, z_vals: torch.Tensor,
                inb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rays whose box intersection missed (far == 0, so z all zero) and
    removal-box samples get sigma = -1e5."""
    mute = torch.full_like(sigma, MUTE_SIGMA)
    sigma = torch.where((z_vals[:, -1] == 0)[:, None], mute, sigma)
    if inb is not None:
        sigma = torch.where(inb, mute, sigma)
    return sigma


def _joint_weights(z_list, sigma_list, noise_std: float = 0.0,
                   noise: Optional[torch.Tensor] = None):
    """Concatenate the sets, sort by z (stable) and alpha-composite with last
    delta 0: (weights, sorted z, sort indices), each (N, S_total)."""
    z = torch.cat(z_list, dim=1)
    sigma = torch.cat(sigma_list, dim=1)
    z, idx = torch.sort(z, dim=-1, stable=True)
    sigma = torch.gather(sigma, 1, idx)
    deltas = torch.cat([z[:, 1:] - z[:, :-1], torch.zeros_like(z[:, :1])], dim=-1)
    if noise_std > 0 and noise is not None:
        sigma = sigma + noise * noise_std
    alphas = 1.0 - torch.exp(-deltas * torch.relu(sigma))
    trans = torch.cumprod(1.0 - alphas + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    return alphas * trans, z, idx


def _composite_multi(results: Dict[str, torch.Tensor], typ: str, z_list, rgb_list,
                     sigma_list, noise_std: float, white_back: bool,
                     keep_sort_idx: bool, noise: Optional[torch.Tensor] = None) -> None:
    weights, z, idx = _joint_weights(z_list, sigma_list, noise_std, noise)
    rgb = torch.gather(torch.cat(rgb_list, dim=1), 1, idx[..., None].expand(-1, -1, 3))
    if keep_sort_idx:
        results[f"sort_idx_{typ}"] = idx
    opacity = weights.sum(-1)
    rgb_map = (weights[..., None] * rgb).sum(-2)
    depth_map = (weights * z).sum(-1)
    if white_back:
        rgb_map = rgb_map + 1.0 - opacity[..., None]
    results[f"weights_{typ}"] = weights
    results[f"opacity_{typ}"] = opacity
    results[f"z_vals_{typ}"] = z
    results[f"rgb_{typ}"] = rgb_map
    results[f"depth_{typ}"] = depth_map


def _fine_z(rays: torch.Tensor, z: torch.Tensor, w_i: torch.Tensor, n_importance: int,
            det: bool, u: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One ray set's merged coarse + importance z. 10-channel rays carry a
    box-mask interval: fine samples that land inside (near_mask, far_mask)
    are moved to far_mask (reference multi_rendering.py:279-287)."""
    z_mid = 0.5 * (z[:, :-1] + z[:, 1:])
    z_imp = sample_pdf(z_mid, w_i[:, 1:-1], n_importance, det=det, u=u, generator=generator)
    z_all = torch.sort(torch.cat([z, z_imp], dim=-1), dim=-1).values
    if rays.shape[1] == 10:
        near_m, far_m = rays[:, 8:9], rays[:, 9:10]
        z_all = torch.where((z_all > near_m) & (z_all < far_m), far_m.expand_as(z_all), z_all)
    return z_all


def _sample_xyz(rays: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return (rays[:, None, 0:3] + rays[:, None, 3:6] * z[..., None]).contiguous()


def _codes(models: nn.Module, instance_id: int, n: int, device) -> Optional[torch.Tensor]:
    if instance_id <= 0:
        return None
    ids = torch.full((n,), instance_id, dtype=torch.long, device=device)
    return models.code_library(ids).contiguous()


def pack_multi_weights(models: nn.Module, settings: RenderSettings,
                       obj_instance_ids: Sequence[int]) -> Dict[str, PackedWeights]:
    """The kernel weights `render_multi_fused_eval` needs, packed once (per
    frame): {"coarse": density-only or full, "fine": full}, with the object
    branch when any id is an object."""
    inst = any(int(i) > 0 for i in obj_instance_ids)
    cfg = settings.mlp
    if settings.N_importance > 0:
        return {"coarse": pack_kernel_weights(models.nerf_coarse, cfg, inst, sigma_only=True),
                "fine": pack_kernel_weights(models.nerf_fine, cfg, inst)}
    return {"coarse": pack_kernel_weights(models.nerf_coarse, cfg, inst)}


@dataclasses.dataclass
class MultiDraws:
    """The random draws of one `render_rays_multi` call, in the order of the
    JAX package's key split (`multi.py:245`): uniform [0, 1) `perturb` (N,
    N_samples) and `pdf` (N, N_importance), shared by every ray set as there,
    and standard normal density noise over the concatenated samples, coarse
    (N, K * N_samples) and fine (N, K * (N_samples + N_importance))."""

    perturb: torch.Tensor
    noise_coarse: torch.Tensor
    pdf: torch.Tensor
    noise_fine: torch.Tensor

    @classmethod
    def sample(cls, settings: RenderSettings, n_rays: int, n_obj: int, device,
               generator: Optional[torch.Generator] = None) -> "MultiDraws":
        s_c, n_i = settings.N_samples, settings.N_importance
        return cls(
            torch.rand((n_rays, s_c), device=device, generator=generator),
            torch.randn((n_rays, n_obj * s_c), device=device, generator=generator),
            torch.rand((n_rays, n_i), device=device, generator=generator),
            torch.randn((n_rays, n_obj * (s_c + n_i)), device=device, generator=generator))


def _eval_object(models: nn.Module, settings: RenderSettings, typ: str, instance_id: int,
                 xyz: torch.Tensor, z_vals: torch.Tensor, dir_pe: torch.Tensor,
                 codes: Optional[torch.Tensor], skip_boxes: Optional[SkipBoxes],
                 plain: bool, packed: Optional[PackedWeights], voxel_ctx: VoxelCtx = None):
    """(rgb (N, S, 3), muted sigma (N, S)) of one ray set: the scene branch
    alone for the background, the object branch alone for an object."""
    model = getattr(models, f"nerf_{typ}")
    kw = dict(forward_instance=instance_id > 0, compute_scene=instance_id == 0,
              voxel_raw=lookup_voxel_raw(settings, voxel_ctx, xyz))
    if plain:
        out = mlp_eval_plain(model, settings.mlp, xyz, dir_pe, codes,
                             matmul_dtype=settings.matmul_dtype, **kw)
    else:
        out = fused_mlp_eval(model, settings.mlp, xyz, dir_pe, codes,
                             dtype=settings.matmul_dtype, packed=packed, **kw)
    sigma, rgb = (out[2], out[3]) if instance_id > 0 else (out[0], out[1])
    return rgb, _mute_sigma(sigma, z_vals, _removal_mask(xyz, instance_id, skip_boxes))


@torch.no_grad()
def render_rays_multi(models: nn.Module, rays_list: Sequence[torch.Tensor],
                      obj_instance_ids: Sequence[int], settings: RenderSettings,
                      skip_boxes: Optional[SkipBoxes] = None,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[MultiDraws] = None, plain: bool = False,
                      voxel_ctx: VoxelCtx = None) -> Dict[str, torch.Tensor]:
    """Joint render of K ray sets (N, 8), or (N, 10) with a per-ray box-mask
    interval in channels 8:10 that clips the fine samples.

    `obj_instance_ids[i]` is the object of `rays_list[i]` (0 = background; an
    id may repeat for a duplicated object). The randomness is `draws` when
    given, else drawn from `generator`; with neither, `perturb` uses the
    default generator and no density noise is added. `plain` evaluates the
    models with `mlp_eval_plain` on any device (the f32 reference of a frame
    rendered through the kernels). `voxel_ctx`: a voxel-conditioned model's
    grid (one lookup per ray set and pass). Returns both passes' `rgb_*`,
    `depth_*`, `opacity_*`, `weights_*` and `z_vals_*` (inference only)."""
    ids = [int(i) for i in obj_instance_ids]
    if len(rays_list) != len(ids):
        raise ValueError(f"{len(rays_list)} ray sets for {len(ids)} object ids")
    n_obj, n_samples = len(ids), settings.N_samples
    n, device = rays_list[0].shape[0], rays_list[0].device
    if draws is None and generator is not None:
        draws = MultiDraws.sample(settings, n, n_obj, device, generator)
    d = draws

    z_list, dir_list, codes_list = [], [], []
    for rays, oid in zip(rays_list, ids):
        z_list.append(stratified_sample(rays[:, 6:7], rays[:, 7:8], n_samples,
                                        settings.use_disp, settings.perturb,
                                        u=d.perturb if d else None))
        dir_list.append(freq_encode(rays[:, 3:6], settings.mlp.N_freq_dir).contiguous())
        codes_list.append(_codes(models, oid, n, device))

    def eval_pass(typ: str, zs: List[torch.Tensor]):
        rgbs, sigmas = [], []
        for i in range(n_obj):
            rgb, sigma = _eval_object(models, settings, typ, ids[i],
                                      _sample_xyz(rays_list[i], zs[i]), zs[i], dir_list[i],
                                      codes_list[i], skip_boxes, plain, None, voxel_ctx)
            rgbs.append(rgb)
            sigmas.append(sigma)
        return rgbs, sigmas

    results: Dict[str, torch.Tensor] = {}
    rgb_list, sigma_list = eval_pass("coarse", z_list)
    _composite_multi(results, "coarse", z_list, rgb_list, sigma_list, settings.noise_std,
                     settings.white_back, keep_sort_idx=settings.N_importance > 0,
                     noise=d.noise_coarse if d else None)
    if settings.N_importance > 0:
        # per-object coarse weights: invert the sort permutation
        inv = torch.argsort(results.pop("sort_idx_coarse"), dim=-1)
        w_orig = torch.gather(results["weights_coarse"], 1, inv)
        zf_list = [
            _fine_z(rays_list[i], z_list[i], w_orig[:, i * n_samples:(i + 1) * n_samples],
                    settings.N_importance, det=(settings.perturb == 0),
                    u=d.pdf if d else None)
            for i in range(n_obj)]
        rgb_list, sigma_list = eval_pass("fine", zf_list)
        _composite_multi(results, "fine", zf_list, rgb_list, sigma_list, settings.noise_std,
                         settings.white_back, keep_sort_idx=False,
                         noise=d.noise_fine if d else None)
    return results


@torch.no_grad()
def render_multi_fused_eval(models: nn.Module, rays_list: Sequence[torch.Tensor],
                            obj_instance_ids: Sequence[int], settings: RenderSettings,
                            skip_boxes: Optional[SkipBoxes] = None,
                            packed: Optional[Dict[str, PackedWeights]] = None,
                            voxel_ctx: VoxelCtx = None) -> Dict[str, torch.Tensor]:
    """The deterministic multi-object render of one chunk: K ray sets (N, 8 or
    10) -> the final pass's `rgb_*`, `depth_*`, `opacity_*`.

    With a fine pass the coarse pass is density only: `fused_sigma_eval` per
    ray set (scene branch for id 0, object branch with that id's code
    otherwise), the joint coarse weights, `sample_pdf` per object; then
    `fused_mlp_eval` per ray set on the fine model with one branch on, muting
    and the joint composite. The cross-set glue is the stream span
    `render.multi_joint` of `utils/trace.py`, twice with a fine pass (the
    joint coarse weights, their unsort and the K importance draws; the final
    composite), once without. `packed`: `pack_multi_weights(...)`, packed here
    (per call) when not given. `voxel_ctx`: a voxel-conditioned model's grid
    with its frame's corner table, which every ray set's lookups of both
    passes read. Raises unless perturb == 0 and noise_std == 0;
    `render_rays_multi` is the stochastic path."""
    if settings.perturb != 0 or settings.noise_std != 0:
        raise ValueError("the fused multi render is the deterministic eval path "
                         "(requires perturb=0 and noise_std=0); use render_rays_multi "
                         "for stochastic settings")
    ids = [int(i) for i in obj_instance_ids]
    if len(rays_list) != len(ids):
        raise ValueError(f"{len(rays_list)} ray sets for {len(ids)} object ids")
    cfg, n_obj, n_samples = settings.mlp, len(ids), settings.N_samples
    n, device = rays_list[0].shape[0], rays_list[0].device
    if packed is None:
        packed = pack_multi_weights(models, settings, ids) if device.type == "cuda" else {}
    typ_final = "fine" if settings.N_importance > 0 else "coarse"

    z_list = [stratified_sample(r[:, 6:7], r[:, 7:8], n_samples, settings.use_disp)
              for r in rays_list]
    dir_list = [freq_encode(r[:, 3:6], cfg.N_freq_dir).contiguous() for r in rays_list]
    codes_list = [_codes(models, oid, n, device) for oid in ids]

    if settings.N_importance > 0:
        sigma_list = []
        for i in range(n_obj):
            xyz = _sample_xyz(rays_list[i], z_list[i])
            raw = lookup_voxel_raw(settings, voxel_ctx, xyz)
            sigma = fused_sigma_eval(
                models.nerf_coarse, cfg, xyz.reshape(-1, 3), codes_list[i],
                branch="instance" if ids[i] > 0 else "scene", samples_per_row=n_samples,
                voxel_raw=None if raw is None else raw.reshape(n * n_samples, -1),
                dtype=settings.matmul_dtype, packed=packed.get("coarse"))
            sigma_list.append(_mute_sigma(sigma.reshape(n, n_samples), z_list[i],
                                          _removal_mask(xyz, ids[i], skip_boxes)))
        with trace.span("render.multi_joint", stream=True):
            weights, _, idx = _joint_weights(z_list, sigma_list)
            w_orig = torch.gather(weights, 1, torch.argsort(idx, dim=-1))
            z_list = [
                _fine_z(rays_list[i], z_list[i], w_orig[:, i * n_samples:(i + 1) * n_samples],
                        settings.N_importance, det=True)
                for i in range(n_obj)]

    rgb_list, sigma_list = [], []
    for i in range(n_obj):
        rgb, sigma = _eval_object(models, settings, typ_final, ids[i],
                                  _sample_xyz(rays_list[i], z_list[i]), z_list[i],
                                  dir_list[i], codes_list[i], skip_boxes, False,
                                  packed.get(typ_final), voxel_ctx)
        rgb_list.append(rgb)
        sigma_list.append(sigma)
    results: Dict[str, torch.Tensor] = {}
    with trace.span("render.multi_joint", stream=True):
        _composite_multi(results, typ_final, z_list, rgb_list, sigma_list, 0.0,
                         settings.white_back, keep_sort_idx=False)
    return {k: results[k] for k in (f"rgb_{typ_final}", f"depth_{typ_final}",
                                    f"opacity_{typ_final}")}
