"""The editable render of a voxel-conditioned model with several moved
objects (reference render_tools/multi_rendering.py and
render_tools/editable_renderer.py, on models/nerf_model.py's voxel inputs),
in plain PyTorch and numpy, on the helpers of `edit.py`, `model.py`,
`render.py` and `voxel.py`.

Ray sets: the background's, then one per moved object in the order given.
The background's are the camera's rays (centred by the scene centre,
scaled) over [near, far]; a moved object's are the same camera's rays
carried into the object's original frame by the inverse of its edit
(T_ow^-1 P T_ow), clipped to its oriented box by a slab test (a ray whose
origin lies inside the box, or that misses it, is muted: near = far = 0).
Each set: stratified depths; the raw voxel features at the set's samples
(`voxel.lookup`, in the object's original frame for an object); the scene
branch for the background and the object branch with the object's code for
an object; muted rays and background samples inside any removed object's
box get density -1e5. All sets' samples are sorted together (stably) and
composited once (last interval 0). The fine pass draws each set's
importance depths from its own share of the joint coarse weights.

Departures from the reference's code, all of the eval render: no
perturbation and no density noise; the coarse pass feeds only the
importance draws (its maps are not returned); boxes are not enlarged
(`bbox_enlarge` 0, the demo's setting)."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..model_spec import Spec
from . import model, voxel
from .edit import MUTE, _joint, _removed, world_to_box
from .render import inverse_cdf, stratified

CODES = "code_library.embedding_instance.weight"


def ray_sets(scene: dict, boxes: dict, wh, c2w: np.ndarray, fovx_deg: float,
             moved: Sequence[int], poses: Dict[int, np.ndarray]):
    """[(rays (N, 8) f32, id)] of the background and each moved object, and
    (N,) bool: the rays that hit any moved object's box."""
    w, h = wh
    focal = (w / 2) / np.tan(np.deg2rad(fovx_deg) / 2)
    j, i = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64),
                       indexing="ij")
    dirs = np.stack([(i - w / 2) / focal, -(j - h / 2) / focal, -np.ones_like(i)], -1)
    dirs = dirs.reshape(-1, 3)
    scale, center = float(scene["scale_factor"]), np.asarray(scene["scene_center"], float)
    twc = np.eye(4)
    twc[:3] = c2w
    twc[:3, 3] -= center
    n = len(dirs)
    out, any_hit = [], np.zeros(n, bool)
    for oid in [0] + list(moved):
        toc = twc.copy()
        if oid:
            tow = world_to_box(boxes[oid], center)
            toc = np.linalg.inv(np.linalg.inv(tow) @ poses[oid] @ tow) @ twc
        d = dirs @ toc[:3, :3].T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = np.broadcast_to(toc[:3, 3] / scale, d.shape)
        if oid == 0:
            near = np.full(n, scene["near"] / scale)
            far = np.full(n, scene["far"] / scale)
        else:
            a = world_to_box(boxes[oid], center)
            ob = (o * scale) @ a[:3, :3].T + a[:3, 3]
            db = d @ a[:3, :3].T
            half = boxes[oid][2] / 2
            db = np.where(db == 0, 1e-14, db)
            t0, t1 = (-half - ob) / db, (half - ob) / db
            tmin, tmax = np.minimum(t0, t1).max(-1), np.maximum(t0, t1).min(-1)
            hit = (tmin <= tmax) & (tmin >= 0) & (tmax >= 0)
            near = np.where(hit, tmin, 0.0) / scale
            far = np.where(hit, tmax, 0.0) / scale
            any_hit |= far > 0
        out.append((np.concatenate([o, d, near[:, None], far[:, None]], -1).astype(np.float32),
                    oid))
    return out, any_hit


def _set_pass(w, net, spec, grid_ctx, rays, oid, z, scene, boxes, removed, rnd, sigma_only):
    n, s = z.shape
    xyz = (rays[:, None, 0:3] + rays[:, None, 3:6] * z[..., None]).reshape(-1, 3)
    x, obj = model.inputs(spec, xyz, voxel.lookup(grid_ctx[0], grid_ctx[1], xyz))
    dir_pe = model.pe(rays[:, 3:6], spec.N_freq_dir)[:, None].expand(n, s, -1)
    dir_pe = dir_pe.reshape(n * s, -1)
    if oid == 0:
        sig, rgb = model.branch(w, net, spec, "scene", x, dir_pe, rnd, sigma_only)
    else:
        code = w[CODES][oid].expand(n * s, -1)
        sig, rgb = model.branch(w, net, spec, "object", torch.cat([x, obj, code], -1), dir_pe,
                                rnd, sigma_only)
    sig = sig.reshape(n, s)
    mute = (z[:, -1] == 0)[:, None].expand(n, s)
    if oid == 0 and removed:
        mute = mute | _removed(xyz, scene, boxes, removed).reshape(n, s)
    sig = torch.where(mute, torch.full_like(sig, MUTE), sig)
    return sig, (None if rgb is None else rgb.reshape(n, s, 3))


@torch.no_grad()
def render(w, spec: Spec, grid_ctx, scene, boxes, removed: List[int], sets,
           rnd) -> Dict[str, torch.Tensor]:
    """The final pass's maps of ray sets [(rays (N, 8) tensor, id)];
    `grid_ctx` = (grid, padded dense features) (`render.grid_context`)."""
    s = spec.N_samples

    def run(net, zs, sigma_only):
        return [_set_pass(w, net, spec, grid_ctx, r, oid, z, scene, boxes, removed, rnd,
                          sigma_only) for (r, oid), z in zip(sets, zs)]

    z_list = [stratified(r[:, 6:7], r[:, 7:8], s) for r, _ in sets]
    wts, _, idx = _joint(z_list, [o[0] for o in run("nerf_coarse", z_list, True)])
    own = torch.gather(wts, 1, torch.argsort(idx, -1))
    zf = []
    for k, z in enumerate(z_list):
        mid = 0.5 * (z[:, :-1] + z[:, 1:])
        wk = own[:, k * s:(k + 1) * s]
        zf.append(torch.sort(torch.cat([z, inverse_cdf(mid, wk[:, 1:-1], spec.N_importance)],
                                       -1), -1).values)
    outs = run("nerf_fine", zf, False)
    wts, z, idx = _joint(zf, [o[0] for o in outs])
    rgb = torch.gather(torch.cat([o[1] for o in outs], 1), 1, idx[..., None].expand(-1, -1, 3))
    return {"rgb_fine": (wts[..., None] * rgb).sum(-2), "depth_fine": (wts * z).sum(-1),
            "opacity_fine": wts.sum(-1)}
