"""Seeded inputs shared by the probe scripts and `chip_smoke.py`: the JAX
package's voxel bench scene (its point cloud, grid and rays) and the inputs of
the encoding probe. Nothing of the model or the renderer depends on them."""

from __future__ import annotations

import numpy as np
import torch

from ..models import voxel_grid as vg
from ..models.mlp import ObjectNeRFConfig

# the JAX package's voxel bench scene (bench.py:193-196, :216)
SCENE = dict(scene_center=[0.0, 0.0, 1.25], scale_factor=2.5, voxel_size_world=0.1,
             neighbor_marks=3)


def scannet_scale_pcd() -> np.ndarray:
    """Synthetic but ScanNet-scale scene point cloud (the JAX package's
    `bench.py:156-177`): a 6 x 6 x 2.5 m room shell (floor, 4 walls, 2
    objects). At the reference's 0.1 m ScanNet voxel size with
    neighbor_marks=3 its cell and occupied-voxel counts are those of a real
    scan, so corner-table size and gather traffic are real-use costs."""
    rng = np.random.RandomState(0)
    pts = []
    f = rng.rand(60000, 3).astype(np.float32)
    pts.append(f * [6.0, 6.0, 0.0] - [3.0, 3.0, 0.0])
    for ax, sgn in ((0, -3.0), (0, 3.0), (1, -3.0), (1, 3.0)):
        wpts = rng.rand(25000, 3).astype(np.float32) * [6.0, 6.0, 2.5]
        wpts[:, :2] -= 3.0
        wpts[:, ax] = sgn
        pts.append(wpts)
    for c, r in ([[0.8, 0.0, 0.6], 0.6], [[-0.9, 0.5, 0.45], 0.45]):
        d = rng.randn(20000, 3)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        pts.append((np.asarray(c) + r * d).astype(np.float32))
    return np.concatenate(pts)


def bench_grid(cfg: ObjectNeRFConfig, device, seed: int = 2):
    """(features, topology, static) of the ScanNet-scale room on `device`."""
    return vg.build_voxel_grid(
        scannet_scale_pcd(), channels=cfg.N_scn_voxel_size + cfg.N_obj_voxel_size,
        n_freq_voxel=cfg.N_freq_voxel, n_max_voxels=800000,
        generator=torch.Generator().manual_seed(seed), device=device, **SCENE)


def bench_rays(n: int, seed: int = 1) -> np.ndarray:
    """(n, 8) rays from mid-room, near 0.05, far 2.4 (samples stay inside)."""
    rng = np.random.RandomState(seed)
    dirs = rng.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return np.concatenate([np.zeros((n, 3), np.float32), dirs,
                           np.full((n, 1), 0.05, np.float32),
                           np.full((n, 1), 2.4, np.float32)], -1)


def probe_inputs(n_rows: int, device, seed: int = 0):
    """(x, [s_xyz, s_svox, s_ivox, s_all], trunk) as the JAX package's
    `scripts/profile_pe_micro.py` draws them."""
    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(device)

    x = t(n_rows, 27)
    s = [t(3, 60), t(16, 192), t(8, 96), t(27, 348)]
    trunk = [t(27 + 348, 256, scale=0.05)] + [t(256, 256, scale=0.05) for _ in range(7)]
    return x, s, trunk
