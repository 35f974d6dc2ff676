"""Mesh extraction CLI: the reference tools/extract_mesh.py contract.

    python -m object_nerf_torch.tools.extract_mesh dataset_config=config/synthetic.yml \\
        ckpt_path=logs/<run>/last.ckpt obj_id=0 N_grid=256 sigma_threshold=20 \\
        [device=cuda] [marching_backend=auto]

Counterpart of the JAX package's `tools/extract_mesh.py`. Queries the fine
model's density on a dense N^3 grid (scene branch, or the object branch with
a latent code when obj_id > 0, extract_mesh.py:95-110) through
`fused_sigma_eval` (the CUDA kernel on `device=cuda`, its plain version on
`device=cpu`), runs iso-surface extraction (marching tetrahedra: the native
C++ implementation when g++ is there, else numpy; the line printed after it
says which ran), rescales vertices by scale_factor with the reference's x/y
swap (extract_mesh.py:124-134), optionally predicts vertex colours through
the plain model with normals as view directions (extract_mesh.py:140-164),
keeps the largest connected component, and writes a PLY. A voxel-conditioned
checkpoint brings its grid along: the sweep looks each chunk's raw voxel
features up (corner table built once per sweep) and hands them to the kernel.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

SCRIPT_CONF = {
    "N_grid": 512,
    "x_range": [-1.5, 1.5],
    "y_range": [-1.5, 1.5],
    "z_range": [-1.5, 1.5],
    "sigma_threshold": 20.0,
    "chunk": 64 * 1024,
    "predict_color": False,
    "obj_id": 0,
    "prefix": "",
    "keep_largest_component": True,
    "out_dir": "debug",
    "marching_backend": "auto",
}
# the sweep is many launches of one kernel: on the card larger chunks mean
# fewer launches, and a chunk of points is only 3 MB
CUDA_CHUNK = 262144


def grid_points(config, off: int, size: int, device) -> torch.Tensor:
    """Points `off` .. `off + size` of the flattened grid (x outer, y mid, z
    inner), (size, 3) float32 on `device`; indices past the grid's end repeat
    its last point. Axis value = min + index * step in float32, product and
    sum each rounded: the JAX package's formula as numpy evaluates it on the
    host (its compiled program contracts some of these into a fused
    multiply-add, one last bit away). The index arithmetic is int64 (a 512^3
    grid has 2^27 points)."""
    n = int(config.N_grid)
    n3 = n * n * n
    (xmin, xmax), (ymin, ymax), (zmin, zmax) = config.x_range, config.y_range, config.z_range
    k = (off + torch.arange(size, dtype=torch.int64, device=device)).clamp_(max=n3 - 1)
    i, rem = k // (n * n), k % (n * n)
    return torch.stack(
        [xmin + i.float() * ((xmax - xmin) / (n - 1)),
         ymin + (rem // n).float() * ((ymax - ymin) / (n - 1)),
         zmin + (rem % n).float() * ((zmax - zmin) / (n - 1))], dim=-1).contiguous()


@torch.no_grad()
def extract_sigma_grid(models, settings, config, obj_id: int = 0, device=None,
                       plain: bool = False, as_tensor: bool = False, voxel_ctx=None):
    """Dense density query of the fine model over the configured grid:
    (N_grid, N_grid, N_grid) float32, clamped at 0, x outer / y mid / z inner.

    The grid points are synthesised on the device from each chunk's offset
    (`grid_points`), every chunk is one launch of `fused_sigma_eval` (the
    whole chunk one pseudo-row under the object's one code; the last chunk is
    as short as the grid's end leaves it, the kernel masks its own last tile)
    written into one device buffer, and nothing synchronises until the grid
    is copied to the host once at the end. `device` defaults to the models'
    own.

    `voxel_ctx` = (features, topology, static) of a voxel-conditioned model:
    every chunk then takes one lookup of its points' raw voxel features (f32,
    as the JAX package's sweep looks them up) before its launch, from a corner
    table built once per sweep, or through the per-corner gathers when the
    grid's table would exceed `DENSE_CELL_TABLE_LIMIT_BYTES`.

    `plain` and `as_tensor` serve tests and the smoke run, not the tool:
    `plain` evaluates `sigma_eval_plain` at `settings.matmul_dtype` on any
    device, the reference a kernel sweep is held against; `as_tensor` returns
    the device tensor instead of a host array."""
    from ..models import voxel_grid as vg
    from ..ops.fused_mlp import pack_kernel_weights
    from ..ops.fused_sigma import fused_sigma_eval, sigma_eval_plain

    n = int(config.N_grid)
    n3 = n * n * n
    device = torch.device(device) if device is not None \
        else next(models.parameters()).device
    model = models.nerf_fine if models.nerf_fine is not None else models.nerf_coarse
    cfg = settings.mlp
    branch = "instance" if obj_id > 0 else "scene"
    chunk = min(int(config.chunk), n3)

    code = None
    if obj_id > 0:
        code = models.code_library(torch.tensor([obj_id], device=device))
    packed = None
    if device.type == "cuda" and not plain:
        packed = pack_kernel_weights(model, cfg, forward_instance=obj_id > 0, sigma_only=True)

    ct = None
    if voxel_ctx is not None:
        features, topo, static = voxel_ctx[:3]
        if vg.dense_path_ok(static):
            ct = vg.make_corner_table(features, topo, static)

    sigma = torch.empty(n3, dtype=torch.float32, device=device)
    for off in range(0, n3, chunk):
        m = min(chunk, n3 - off)
        pts = grid_points(config, off, m, device)
        raw = None
        if voxel_ctx is not None:
            raw, _ = vg.voxel_lookup_raw(features, topo, static, pts, ct=ct)
        if plain:
            s = sigma_eval_plain(model, cfg, pts, code, branch, m, raw,
                                 settings.matmul_dtype)
        else:
            s = fused_sigma_eval(model, cfg, pts, code, branch, m, voxel_raw=raw,
                                 dtype=settings.matmul_dtype, packed=packed)
        sigma[off:off + m] = s
    sigma = sigma.clamp_(min=0.0).reshape(n, n, n)
    return sigma if as_tensor else sigma.cpu().numpy()


def _vertex_normals(verts, faces):
    n = np.zeros_like(verts)
    fv = verts[faces]
    fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    for i in range(3):
        np.add.at(n, faces[:, i], fn)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(norm, 1e-12)


def main(argv) -> None:
    from ..config import load_config
    from ..data.ply_io import write_ply
    from ..device import resolve_device
    from ..models.embedding import freq_encode
    from ..render.renderer import RenderSettings, _embed_points
    from ..train.convert import load_reference_ckpt, voxel_grid_from_ckpt
    from ..train.system import init_params
    from .marching import (
        largest_connected_component, marching_backend, marching_tetrahedra,
    )

    config = load_config(cli_args=argv)
    user_set_chunk = "chunk" in config
    config.merge({k: v for k, v in SCRIPT_CONF.items() if k not in config})
    if not config.get("ckpt_path"):
        raise SystemExit("ckpt_path not set")
    device = resolve_device(config.get("device", "cuda"))
    on_card = device.type == "cuda"
    if on_card and not user_set_chunk:
        config.merge(dict(chunk=CUDA_CHUNK))

    # the CUDA kernel computes in bf16; the CPU path is the exact f32 one
    settings = RenderSettings.from_config(
        config, is_eval=True, matmul_dtype=torch.bfloat16 if on_card else torch.float32)
    sd, voxel = load_reference_ckpt(config.ckpt_path, with_voxel=True)
    if (voxel is not None) != settings.mlp.use_voxel_embedding:
        raise SystemExit(f"{config.ckpt_path} holds {'a' if voxel is not None else 'no'} "
                         f"voxel grid, but model.use_voxel_embedding is "
                         f"{settings.mlp.use_voxel_embedding}")
    voxel_ctx = None
    if voxel is not None:  # the checkpoint's own grid: its table rows are indexed by it
        voxel_ctx = voxel_grid_from_ckpt(voxel, settings.mlp.N_freq_voxel, device)
    models = init_params(torch.Generator().manual_seed(0), settings, config.model,
                         device=device,
                         voxel_features=voxel_ctx[0] if voxel_ctx is not None else None)
    models.load_state_dict(sd)
    models.eval()
    if voxel_ctx is not None:
        voxel_ctx = (models.voxel_features.detach(),) + tuple(voxel_ctx[1:])

    obj_id = int(config.obj_id)
    t0 = time.perf_counter()
    sigma = extract_sigma_grid(models, settings, config, obj_id, device=device,
                               voxel_ctx=voxel_ctx)
    t_sigma = time.perf_counter() - t0

    backend = marching_backend(str(config.marching_backend))
    print(f"Extracting mesh ... (sigma grid {t_sigma:.1f}s on {device}, "
          f"marching backend {backend})")
    t0 = time.perf_counter()
    verts, faces = marching_tetrahedra(sigma, float(config.sigma_threshold),
                                       backend=str(config.marching_backend))
    print(f"{len(verts)} vertices, {len(faces)} faces ({time.perf_counter() - t0:.1f}s)")
    if len(verts) == 0:
        print("empty mesh: lower sigma_threshold?")
        return

    # index coords -> world, with the reference's x/y swap (extract_mesh.py:124-130)
    n = int(config.N_grid)
    v = verts / n
    (xmin, xmax), (ymin, ymax), (zmin, zmax) = config.x_range, config.y_range, config.z_range
    out = np.empty_like(v)
    out[:, 0] = (ymax - ymin) * v[:, 1] + ymin
    out[:, 1] = (xmax - xmin) * v[:, 0] + xmin
    out[:, 2] = (zmax - zmin) * v[:, 2] + zmin
    scale = float(config.dataset_extra.scale_factor)
    out *= scale

    if config.keep_largest_component:
        t0 = time.perf_counter()
        out, faces = largest_connected_component(out, faces)
        print(f"largest component: {len(out)} vertices, {len(faces)} faces "
              f"({time.perf_counter() - t0:.1f}s)")

    colors = None
    if config.predict_color:
        # vertex colours with inward normals as view dirs (extract_mesh.py:140-164),
        # through the plain f32 model: a few thousand points, once
        nrm = _vertex_normals(out, faces)
        model = models.nerf_fine if models.nerf_fine is not None else models.nerf_coarse
        with torch.no_grad():
            pts = torch.from_numpy(np.asarray(out / scale, np.float32)).to(device)
            dirs = torch.from_numpy(np.asarray(-nrm, np.float32)).to(device)
            emb, _ = _embed_points(pts, settings, voxel_ctx)
            _, rgb = model.scene_forward(emb, freq_encode(dirs, settings.mlp.N_freq_dir))
        colors = rgb.cpu().numpy()

    os.makedirs(config.out_dir, exist_ok=True)
    out_path = os.path.join(config.out_dir, f"extracted_mesh_{config.prefix}.ply")
    write_ply(out_path, out, colors=colors, faces=faces)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main(sys.argv[1:])
