"""The eval render of the `rays_in_bbox` route (reference models/rendering.py
:228-229: when the rays are bounded by an object's box, the importance
samples follow the object's compositing weights, not the scene's), in plain
PyTorch on the helpers of `render.py`, `model.py` and `voxel.py`.

Per ray, from its [near, far] (the box's entry and exit; 0 and 0 for a ray
that misses the box): N_samples evenly spaced depths -> both branches of
the coarse model with their heads -> the object composite (exclusive
transmittance with +1e-10, the last interval 0) -> N_importance depths by
inverse CDF of its weights [1:-1] at evenly spaced u -> both sets sorted
together -> both branches of the fine model over all of them, composited
as the scene (last interval 1e10) and as the object (last interval 0,
white background): the fine pass's six maps.

Departures from the reference's code, all of the eval render: no
perturbation and no density noise; no occlusion test in the object
composite (the frustum bound acts in training only); the coarse pass's own
maps are not returned. A missed ray keeps the output these steps give it:
every sample at its origin, the scene colour there (the 1e10 last
interval), the object composite empty (white)."""

from __future__ import annotations

from typing import Dict

import torch

from ..model_spec import Spec
from . import model, voxel
from .render import _weights, alphas, inverse_cdf, run_pass, stratified

CODES = "code_library.embedding_instance.weight"


@torch.no_grad()
def eval_rays(w, spec: Spec, grid_ctx, rays, ids, rnd) -> Dict[str, torch.Tensor]:
    """The route's deterministic render of rays (N, 8) with instance ids
    (N,): the fine pass's six maps."""
    dir_pe = model.pe(rays[:, 3:6], spec.N_freq_dir)
    codes = w[CODES][ids]
    n, s = rays.shape[0], spec.N_samples
    z = stratified(rays[:, 6:7], rays[:, 7:8], s)
    xyz = (rays[:, None, 0:3] + rays[:, None, 3:6] * z[..., None]).reshape(-1, 3)
    raw = voxel.lookup(grid_ctx[0], grid_ctx[1], xyz) if grid_ctx is not None else None
    rep = lambda t: t[:, None, :].expand(n, s, t.shape[-1]).reshape(n * s, -1)  # noqa: E731
    _, _, isig, _ = model.forward(w, "nerf_coarse", spec, xyz, raw, rep(dir_pe), rep(codes),
                                  rnd)
    wi = _weights(alphas(isig.reshape(n, s), z, last=0.0))
    mid = 0.5 * (z[:, :-1] + z[:, 1:])
    z_all = torch.sort(torch.cat([z, inverse_cdf(mid, wi[:, 1:-1], spec.N_importance)], -1),
                       -1).values
    out: Dict[str, torch.Tensor] = {}
    run_pass(w, "nerf_fine", spec, grid_ctx, rays, z_all, dir_pe, codes, rnd, out, "fine")
    return out
