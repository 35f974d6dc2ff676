"""The editable render of the reference (render_tools/multi_rendering.py,
utils/bbox_utils.py, editable_renderer.py), in plain PyTorch and numpy.

Ray sets: one per active object. The background's are the camera's rays
(centred by the scene centre, scaled) over [near, far]; a moved object's are
the same camera's rays carried into the object's original frame by the
inverse of its edit (T_ow^-1 P T_ow), clipped to its box by a slab test (a
ray whose origin lies inside the box, or that misses it, is muted: near =
far = 0). Each set: stratified depths, the scene branch for the background
and the object branch with the object's code for an object; muted rays and
background samples inside a removed object's box get density -1e5. All sets'
samples are sorted together (stably) and composited once (last interval 0).
The fine pass draws each set's importance depths from its own share of the
joint coarse weights."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..model_spec import Spec
from . import model
from .render import inverse_cdf, stratified

MUTE = -1e5


def _quat(q):
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0 else 2.0 / n
    return np.array([
        [1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y)],
        [s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x)],
        [s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y)]])


def world_to_box(box, center) -> np.ndarray:
    """(4, 4): the scene's centred frame to the box's frame."""
    pos, quat, _ = box
    m = np.eye(4)
    m[:3, :3], m[:3, 3] = _quat(quat), pos
    shift = np.eye(4)
    shift[:3, 3] = center
    return np.linalg.inv(m) @ shift


def ray_sets(scene: dict, boxes: dict, wh, c2w: np.ndarray, fovx_deg: float,
             moved: int, pose: np.ndarray):
    """[(rays (N, 8) f32, id)] of the background and the moved object."""
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
    out = []
    for oid in (0, moved):
        if oid == 0:
            toc = twc.copy()
        else:
            tow = world_to_box(boxes[oid], center)
            toc = np.linalg.inv(np.linalg.inv(tow) @ pose @ tow) @ twc
        d = dirs @ toc[:3, :3].T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = np.broadcast_to(toc[:3, 3] / scale, d.shape)
        n = len(d)
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
        out.append((np.concatenate([o, d, near[:, None], far[:, None]], -1).astype(np.float32),
                    oid))
    return out


def _removed(xyz, scene, boxes, removed) -> torch.Tensor:
    """(N,) bool: points of the normalised frame inside a removed object's box."""
    inside = torch.zeros(xyz.shape[0], dtype=torch.bool, device=xyz.device)
    center = np.asarray(scene["scene_center"], float)
    for oid in removed:
        a = torch.tensor(world_to_box(boxes[oid], center), dtype=torch.float32,
                         device=xyz.device)
        half = torch.tensor(boxes[oid][2] / 2, dtype=torch.float32, device=xyz.device)
        p = (xyz * float(scene["scale_factor"])) @ a[:3, :3].T + a[:3, 3]
        inside |= ((p >= -half) & (p <= half)).all(-1)
    return inside


def _set_pass(w, net, spec, rays, oid, z, scene, boxes, removed, rnd, sigma_only):
    n, s = z.shape
    xyz = (rays[:, None, 0:3] + rays[:, None, 3:6] * z[..., None]).reshape(-1, 3)
    x = model.pe(xyz, spec.N_freq_xyz)
    dir_pe = model.pe(rays[:, 3:6], spec.N_freq_dir)[:, None].expand(n, s, -1)
    dir_pe = dir_pe.reshape(n * s, -1)
    if oid == 0:
        sig, rgb = model.branch(w, net, spec, "scene", x, dir_pe, rnd, sigma_only)
    else:
        code = w["code_library.embedding_instance.weight"][oid].expand(n * s, -1)
        sig, rgb = model.branch(w, net, spec, "object", torch.cat([x, code], -1), dir_pe,
                                rnd, sigma_only)
    sig = sig.reshape(n, s)
    mute = (z[:, -1] == 0)[:, None].expand(n, s)
    if oid == 0 and removed:
        mute = mute | _removed(xyz, scene, boxes, removed).reshape(n, s)
    sig = torch.where(mute, torch.full_like(sig, MUTE), sig)
    return sig, (None if rgb is None else rgb.reshape(n, s, 3))


def _joint(z_list, sig_list):
    z, idx = torch.sort(torch.cat(z_list, 1), dim=-1, stable=True)
    sig = torch.gather(torch.cat(sig_list, 1), 1, idx)
    delta = torch.cat([z[:, 1:] - z[:, :-1], torch.zeros_like(z[:, :1])], -1)
    alpha = 1.0 - torch.exp(-delta * torch.relu(sig))
    keep = torch.cumprod(1.0 - alpha + 1e-10, -1)
    return alpha * torch.cat([torch.ones_like(keep[:, :1]), keep[:, :-1]], -1), z, idx


@torch.no_grad()
def render(w, spec: Spec, scene, boxes, removed: List[int], sets,
           rnd) -> Dict[str, torch.Tensor]:
    """The final pass's maps of ray sets [(rays (N, 8) tensor, id)]."""
    s = spec.N_samples
    z_list = [stratified(r[:, 6:7], r[:, 7:8], s) for r, _ in sets]
    sig = [_set_pass(w, "nerf_coarse", spec, r, oid, z, scene, boxes, removed, rnd, True)[0]
           for (r, oid), z in zip(sets, z_list)]
    wts, _, idx = _joint(z_list, sig)
    own = torch.gather(wts, 1, torch.argsort(idx, -1))
    zf = []
    for k, z in enumerate(z_list):
        mid = 0.5 * (z[:, :-1] + z[:, 1:])
        wk = own[:, k * s:(k + 1) * s]
        zf.append(torch.sort(torch.cat([z, inverse_cdf(mid, wk[:, 1:-1], spec.N_importance)],
                                       -1), -1).values)
    outs = [_set_pass(w, "nerf_fine", spec, r, oid, z, scene, boxes, removed, rnd, False)
            for (r, oid), z in zip(sets, zf)]
    wts, z, idx = _joint(zf, [o[0] for o in outs])
    rgb = torch.gather(torch.cat([o[1] for o in outs], 1), 1, idx[..., None].expand(-1, -1, 3))
    return {"rgb_fine": (wts[..., None] * rgb).sum(-2), "depth_fine": (wts * z).sum(-1),
            "opacity_fine": wts.sum(-1)}
