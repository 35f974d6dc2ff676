"""What does it cost to put a gather and a kernel side by side on this card?

    python -m object_nerf_torch.scripts.profile_voxel_split

Counterpart of `scripts/profile_voxel_split.py`. The original asked whether a
gather slows down when it shares an XLA program with a Pallas kernel, and
whether splitting the voxel chunk into several programs removes that penalty.
PyTorch runs eagerly: there are no programs to merge or split, every op is a
launch of its own on one stream, so the `single` / `split` pair has no
counterpart here and is not imitated. What remains of the question is what a
launch next to the gather costs, so this script times, on the bench grid's
bf16 corner table (114,688 x 192) and 983,040 random rows,

  gather alone       `gather_rows`
  gather + kernel    `gather_rows`, then `scale_copy` (the trivial hand-written
                     kernel, `ops/probes.py`) on the first 24 channels
  gather + sum       `gather_rows`, then a torch sum over the same slice
  launch floor       a tiny elementwise op (128 x 128), the cost of a launch

each as a median over launches by CUDA events, and the whole voxel chunk (7680
rays, 64 + 64 samples: lookup, coarse kernel, resampling, lookup, fine kernel)
as one stream of launches through `render_rays_fused_eval`. Every line carries
the card's name and power limit.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..models import voxel_grid as vg
from ..models.mlp import ObjectNeRFConfig
from ..ops.fwd_chain import pack_kernel_weights
from ..ops.gather import gather_rows
from ..ops.probes import scale_copy
from ..render.renderer import RenderSettings, render_rays_fused_eval
from ..train.system import init_params
from ._fixtures import bench_grid, bench_rays
from ._timing import card_line, median_ms, require_cuda

N_RAYS = 7680


def main(argv) -> None:
    dev = require_cuda()
    card = card_line()
    cfg = ObjectNeRFConfig()
    settings = RenderSettings(mlp=cfg, N_samples=64, N_importance=64, perturb=0.0,
                              noise_std=0.0, is_eval=True)
    features, topo, static = bench_grid(cfg, dev)
    models = init_params(torch.Generator().manual_seed(0), settings, {}, device=dev,
                         voxel_features=features)
    with torch.no_grad():
        ct = vg.make_corner_table(features, topo, static, lowp=True)
        packed = {"coarse": pack_kernel_weights(models.nerf_coarse, cfg, False, sigma_only=True),
                  "fine": pack_kernel_weights(models.nerf_fine, cfg, True)}
        rays = torch.from_numpy(bench_rays(N_RAYS)).to(dev)
        codes = torch.zeros(N_RAYS, cfg.N_obj_code_length, device=dev)
        flat = torch.from_numpy(np.random.RandomState(3).randint(
            0, ct.shape[0], size=(N_RAYS * 128,)).astype(np.int32)).to(dev)
        print(f"[{card}] grid {static.shape}, corner table {tuple(ct.shape)} {ct.dtype}, "
              f"{flat.shape[0]} rows")

        def chunk():
            return render_rays_fused_eval(models, rays, settings, codes, packed,
                                          (features, topo, static, ct))

        tiny = torch.zeros(128, 128, device=dev)
        for name, fn, n in (
            ("voxel chunk (7680 rays)", chunk, 5),
            ("gather alone", lambda: gather_rows(ct, flat, check_indices=False), 20),
            ("gather + kernel", lambda: scale_copy(
                gather_rows(ct, flat, check_indices=False)[:, :24].float().contiguous()), 20),
            ("gather + sum", lambda: gather_rows(ct, flat, check_indices=False)[:, :24]
             .float().sum(dim=-1), 20),
            ("launch floor", lambda: tiny + 1.0, 50),
        ):
            print(f"[{card}] {name:24s}: {median_ms(fn, n):8.3f} ms")


if __name__ == "__main__":
    main(sys.argv[1:])
