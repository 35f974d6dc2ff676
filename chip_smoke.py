#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths, the deterministic eval render, the training
step, the editable multi-object render and the mesh-extraction density sweep
of the flagship model (classical positional encoding, scene branch 8x256 with
a skip at 4, object branch 4x128 with a skip at 2, codes of 64, 64 coarse +
64 importance samples, instance branch on), on random weights from a seed:

1. prints the card's name and power limit (`nvidia-smi`);
2. builds the CUDA kernels from `object_nerf_torch/ops/csrc/` (`nvcc`);
3. holds each eval kernel against its plain PyTorch version (bf16 operands,
   f32 sums: the kernels' own rounding points) on identical seeded inputs
   at the chunk shape of the eval path, and times both;
4. renders one 640x480 frame of the synthetic scene with `render_image`
   (chunk 7680) and checks that both eval kernels ran 40 times, that the
   frame is finite, and that four of its chunks agree with the f32 plain
   path;
5. times the frame (median of a few, after a warm-up);
6. holds the training kernels `fused_mlp_eval` and `fused_mlp_bwd` against
   their plain versions at the training shapes (2048 rays x 64 and x 128
   samples), the backward on the cotangent of a real loss, and times them;
7. trains: an `ObjectNeRFSystem` on the synthetic scene (batch 2048, 64 + 64
   samples, perturbation and density noise on, Adam, poly schedule) takes
   one step through the kernels and the same step through the plain bf16
   path from identical weights and draws (loss and gradients compared),
   then 24 more steps: every loss finite, the loss falling, exactly two
   forward and two backward launches per step; times the step;
8. holds the point-wise density kernel `fused_sigma_eval` against its plain
   version, both branches, at the edit chunk's 4096 x 64 points, and times it;
9. renders one 320x240 edit frame with an `EditableRenderer` (background +
   object 1 moved, its original carved out of the background; chunk 4096):
   finite maps, the launch counts that the hit-compaction plan implies, two
   mixed chunks and one background-only chunk against `render_rays_multi`
   on the f32 plain path (colour by PSNR, opacity and depth by max abs), the
   compacted frame against the dense one; holds `fused_mlp_eval` against
   its plain version as this path calls it (4096 x 128, one branch on,
   weights packed beforehand); times the frame;
10. sweeps the density grid at 128^3 through `fused_sigma_eval`, scene branch
   and one object, each against the plain f32 sweep, runs marching
   tetrahedra on it (the native C++ backend wherever g++ exists) and writes
   and re-reads a PLY; times the sweep alone at
   512^3 (or 256^3 if that would take more than about a minute);
11. prints one JSON line describing every kernel, and, last, one JSON line
   naming the device.

`--profile` adds a `torch.profiler` table of the device time of three
training steps by kernel.

Any failed check exits non-zero. Without CUDA, or run from a directory that
holds this file and nothing else of the repository, it exits non-zero and
prints no result. It imports nothing of JAX or of `object_nerf_tpu`.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

W, H = 640, 480
CHUNK = 7680  # 640 x 480 = 40 chunks
SEED = 0
FRAMES_TIMED = 3
TIMED_LAUNCHES = 10
CHECK_CHUNKS = (0, 13, 26, 39)  # chunks of the frame re-rendered on the f32 plain path
# kernel vs bf16 plain version, on every weight and map: both round the same
# operands to bf16, but their f32 sums run in another order, which now and
# then flips the bf16 rounding of an activation (2^-8 relative) that then
# passes through the following layers
KERNEL_TOL = 1e-3
# frame chunks vs the f32 plain path: bf16 operands change the coarse
# weights, hence the importance samples, hence the fine maps
PSNR_FLOOR_DB = 40.0
# added to the scene sigma heads' biases of the random model: with the 1e10
# last delta the last sample's weight is a step function of the sign of its
# density, and freshly initialised densities (about +-0.003) straddle that
# step, so a last-bit difference flips whole rays; raised densities sit clear
# of it and make every ray composite over its samples
DENSITY_BIAS = 1.0

# training path: the shape of config/default_conf.yml
BATCH, N_SAMPLES, N_IMPORTANCE = 2048, 64, 64
TRAIN_STEPS = 24  # after the compared first step
STEPS_TIMED = 10
# backward kernel vs its bf16 plain version on the cotangent of the real loss,
# per gradient tensor, relative to the tensor's largest reference entry. Both
# round the same operands to bf16 and differ in the order of their f32 sums;
# a rounding that flips early in the 8-layer chain moves every later
# activation of its row by ~1e-4 and flips more roundings downstream, so the
# two drift apart by a fraction of the bf16 quantisation noise itself (the
# distance to f32 autograd printed beside each error, ~2e-2). Measured on an
# H100: 3.6e-4; a wrong term or layout is off by O(1).
BWD_TOL = 5e-3
# gradients of a whole step, kernel path vs plain bf16 path: the two forward
# passes already differ (KERNEL_TOL), hence the coarse weights, the
# importance samples and the cotangents that enter the backward; measured
# 3.6e-3, against ~2e-2 between the bf16 and the f32 gradients
STEP_GRAD_TOL = 2e-2
# loss of the kernel-path step vs the plain bf16 step, relative: the forward
# kernels agree with their plain versions to KERNEL_TOL per output
LOSS_TOL = 1e-3

# edit path: the frame of bench.py's edit metric (320x240, chunk 4096)
EDIT_W, EDIT_H, EDIT_CHUNK = 320, 240, 4096
EDIT_OBJ = 1  # the sphere that is moved (and carved out of the background)
EDIT_PROGRESS = 0.25  # point of the demo's duplication trajectory
# edit chunks vs render_rays_multi on the f32 plain path: bf16 operands change
# the coarse densities, hence each ray set's importance samples, hence the maps.
# Measured on an H100: 87.6 to 91.1 dB on rgb_fine, opacity within 8.6e-4 and
# depth (scene units, rays a few units long) within 1.2e-2 of the f32 maps; a
# wrong code row or a swapped branch moves the colours by their own size
EDIT_PSNR_FLOOR_DB = 70.0
EDIT_MAP_TOL = {"opacity_fine": 5e-3, "depth_fine": 5e-2}  # max abs
# compacted vs dense frame: the kernels compute each ray on its own, so the
# two differ only by the +1e-10 transmittance epsilon of the muted samples
# that the compacted background-only chunks leave out (1e-8 on a map)
COMPACT_TOL = 1e-5
# mesh path: grid of the checked sweep, and of the timed one
MESH_GRID, MESH_GRID_TIMED, MESH_CHUNK = 128, 512, 262144
MESH_OBJ = 1
# kernel sweep (bf16 operands) vs the plain f32 sweep, max abs over the grid:
# the bf16 roundings of eight (scene) or four (object) layers on densities of
# about 1 (scene, raised bias) and up to 0.17 (object); measured on an H100:
# 2.2e-4 and 9.2e-4
MESH_F32_TOL = 5e-3
SWEEP_BUDGET_S = 60.0

# dense bf16 tensor-core peak and memory rate by card (NVIDIA data sheets)
PEAKS = (  # (name substring, TFLOP/s, TB/s)
    ("H100 PCIe", 756.0, 2.0),
    ("H100 NVL", 835.0, 3.9),
    ("H200", 989.0, 4.8),
    ("H100", 989.0, 3.35),  # SXM
)


def _repo_root() -> str:
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "object_nerf_torch")):
        raise SystemExit(f"chip_smoke.py: no object_nerf_torch package beside {__file__}")
    return root


def _peaks(name: str):
    for key, tflops, tbs in PEAKS:
        if key in name:
            return tflops * 1e12, tbs * 1e12
    raise SystemExit(f"no published peaks for {name!r}")


def _cuda_ms(fn, n: int) -> float:
    """Mean device ms per call of fn over n calls, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _macs_per_sample(cfg, coarse: bool) -> int:
    """Multiply-adds of one sample through the kernel's layers (unpadded)."""

    def branch(width, depth, skips, c_in, heads):
        m = 0
        for i in range(depth):
            k = c_in if i == 0 else (c_in + width if i in skips else width)
            m += k * width
        m += width  # sigma head
        if heads:
            m += width * width + (width + cfg.in_channels_dir) * (width // 2)
            m += (width // 2) * 3
        return m

    pe = cfg.xyz_pe_size
    m = branch(cfg.W, cfg.D, cfg.skips, pe, heads=not coarse)
    if not coarse:
        m += branch(cfg.inst_W, cfg.inst_D, cfg.inst_skips,
                    pe + cfg.N_obj_code_length, heads=True)
    return m


def _bwd_macs_per_sample(cfg) -> int:
    """Multiply-adds of one sample row through the backward: the forward
    recompute, one product per weight for its gradient, and the input
    gradients that have a consumer (none for the PE and direction inputs;
    only the code columns of the object branch's input)."""

    def input_grads(width, depth, skips, c_need):
        m = 0
        for i in range(depth):
            if i > 0:
                m += width * width  # the hidden rows
            if i == 0 or i in skips:
                m += c_need * width  # the input rows that need a gradient
        # sigma head, final, direction layer's hidden part, rgb head
        return m + width + width * width + width * (width // 2) + (width // 2) * 3

    fwd = _macs_per_sample(cfg, False)
    return (2 * fwd + input_grads(cfg.W, cfg.D, cfg.skips, 0)
            + input_grads(cfg.inst_W, cfg.inst_D, cfg.inst_skips, cfg.N_obj_code_length))


def _rel(got, want) -> float:
    return ((got - want).abs().max() / (want.abs().max() + 1e-30)).item()


def _train_phases(torch, dev, peak_flops, peak_bytes, profile: bool):
    """Phases 6 and 7; returns the two training kernels' entries for the
    `kernels` line and prints everything else."""
    import copy

    from object_nerf_torch.config import load_config
    from object_nerf_torch.data import dataset_dict
    from object_nerf_torch.models.embedding import freq_encode
    from object_nerf_torch.ops import fused_mlp
    from object_nerf_torch.ops import fused_mlp_vjp as fv
    from object_nerf_torch.ops.compositing import composite, composite_instance
    from object_nerf_torch.ops.sampling import merge_z_vals, sample_pdf, stratified_sample
    from object_nerf_torch.render.renderer import RenderDraws
    from object_nerf_torch.train.losses import total_loss
    from object_nerf_torch.train.optim import make_optimizer
    from object_nerf_torch.train.system import ObjectNeRFSystem, make_train_step

    root = _repo_root()
    config = load_config(cli_args=[
        f"dataset_config={os.path.join(root, 'config', 'synthetic.yml')}",
        f"train.batch_size={BATCH}", f"model.N_samples={N_SAMPLES}",
        f"model.N_importance={N_IMPORTANCE}", "model.perturb=1", "model.noise_std=1",
        "train.optimizer=adam", "train.lr_scheduler=poly", f"train.seed={SEED}",
        "train.num_epochs=5", "train.nan_check_every=1000000"])
    kw = dict(img_wh=tuple(config.img_wh), dataset_extra=config.dataset_extra)
    system = ObjectNeRFSystem(config, dataset=dataset_dict["synthetic"]("train", **kw),
                              val_dataset=dataset_dict["synthetic"]("val", **kw), device=dev)
    models, settings, cfg = system.models, system.settings, system.settings.mlp
    with torch.no_grad():
        for m in (models.nerf_coarse, models.nerf_fine):
            m.sigma.bias += DENSITY_BIAS
    rng = system.batch_rng
    batch = system._device_batch(system.train_dataset.sample_batch(BATCH, rng))
    draws = RenderDraws.sample(settings, BATCH, dev, system.generator)

    # -- 6. the training kernels against their plain versions -----------------------
    rays = batch["rays"]
    with torch.no_grad():
        codes = models.code_library(batch["instance_ids"]).contiguous()
        dir_pe = freq_encode(rays[:, 3:6], cfg.N_freq_dir).contiguous()
        z_c = stratified_sample(rays[:, 6:7], rays[:, 7:8], N_SAMPLES, False, 1.0,
                                u=draws.perturb)
        xyz_c = (rays[:, None, 0:3] + rays[:, None, 3:6] * z_c[..., None]).contiguous()
        sig_c = fv.mlp_eval_plain(models.nerf_coarse, cfg, xyz_c, dir_pe, codes)[0]
        w_c = composite(sig_c, sig_c.new_zeros(BATCH, N_SAMPLES, 3), z_c, noise_std=1.0,
                        noise=draws.noise_coarse).weights
        z_mid = 0.5 * (z_c[:, :-1] + z_c[:, 1:])
        z_f = merge_z_vals(z_c, sample_pdf(z_mid, w_c[:, 1:-1], N_IMPORTANCE, u=draws.pdf))
        xyz_f = (rays[:, None, 0:3] + rays[:, None, 3:6] * z_f[..., None]).contiguous()
    shapes = {  # samples per ray -> (model, xyz, z, scene noise, instance noise)
        N_SAMPLES: (models.nerf_coarse, "coarse", xyz_c, z_c, draws.noise_coarse,
                    draws.noise_inst_coarse),
        N_SAMPLES + N_IMPORTANCE: (models.nerf_fine, "fine", xyz_f, z_f, draws.noise_fine,
                                   draws.noise_inst_fine),
    }

    def real_cotangent(model, typ, xyz, z, noise, noise_inst):
        """g (n*S, 8) of the training loss with respect to one pass's MLP
        outputs (from the bf16 plain forward)."""
        with torch.no_grad():
            outs = fv.mlp_eval_plain(model, cfg, xyz, dir_pe, codes)
        outs = [o.detach().requires_grad_() for o in outs]
        scene = composite(outs[0], outs[1], z, noise_std=1.0, noise=noise)
        inst = composite_instance(outs[2], outs[3], z, scene.depth, noise_std=1.0,
                                  frustum_bound_th=settings.frustum_bound_th,
                                  pass_through_mask=batch["pass_through_mask"], noise=noise_inst)
        results = {f"rgb_{typ}": scene.rgb, f"depth_{typ}": scene.depth,
                   f"rgb_instance_{typ}": inst.rgb, f"depth_instance_{typ}": inst.depth,
                   f"opacity_instance_{typ}": inst.opacity}
        total_loss(results, batch, dict(config.loss))[0].backward()
        n, s = z.shape
        return torch.cat([outs[0].grad.reshape(n * s, 1), outs[1].grad.reshape(n * s, 3),
                          outs[2].grad.reshape(n * s, 1), outs[3].grad.reshape(n * s, 3)],
                         dim=-1).contiguous()

    names = ("sigma", "rgb", "inst_sigma", "inst_rgb")
    ms = {"fused_mlp_eval": {}, "fused_mlp_bwd": {}}
    plain_ms = {"fused_mlp_eval": {}, "fused_mlp_bwd": {}}
    errs = {"fused_mlp_eval": 0.0, "fused_mlp_bwd": 0.0}
    pack_ms = 0.0
    for s_, (model, typ, xyz, z, noise, noise_inst) in shapes.items():
        with torch.no_grad():
            packed = fused_mlp.pack_kernel_weights(model, cfg, True)
            got = fv.fused_mlp_eval(model, cfg, xyz, dir_pe, codes)
            want = fv.mlp_eval_plain(model, cfg, xyz, dir_pe, codes)
            torch.cuda.synchronize()
            e = {k: (a - b).abs().max().item() for k, a, b in zip(names, got, want)}
            print(f"fused_mlp_eval {tuple(xyz.shape)}: max |kernel - plain bf16| "
                  + ", ".join(f"{k} {v:.2e}" for k, v in e.items()) + f" (tol {KERNEL_TOL:g})")
            errs["fused_mlp_eval"] = max(errs["fused_mlp_eval"], *e.values())
        g = real_cotangent(model, typ, xyz, z, noise, noise_inst)
        with torch.no_grad():
            grads, d_codes = fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, g, packed=packed)
            want_g, want_c = fv.mlp_bwd_plain(model, cfg, xyz, dir_pe, codes, g)
            torch.cuda.synchronize()
        # f32 autograd of the f32 plain forward, for scale only (not gated)
        outs32 = fv.mlp_eval_plain(model, cfg, xyz, dir_pe, codes, matmul_dtype=torch.float32)
        params = dict(model.named_parameters())
        g4 = g.reshape(BATCH, s_, 8)
        f32 = dict(zip(params, torch.autograd.grad(
            outs32, list(params.values()),
            [g4[..., 0], g4[..., 1:4], g4[..., 4], g4[..., 5:8]])))
        del outs32
        e = {k: _rel(grads[k], want_g[k]) for k in want_g}
        e["d_codes"] = _rel(d_codes, want_c)
        e32 = max(_rel(want_g[k], f32[k]) for k in want_g)
        worst = max(e, key=e.get)
        print(f"fused_mlp_bwd {tuple(xyz.shape)}, g of the real loss (|g| <= "
              f"{g.abs().max().item():.1e}): max over {len(e)} tensors of |kernel - plain "
              f"bf16| / max|plain| = {e[worst]:.2e} at {worst} (tol {BWD_TOL:g}); median "
              f"{statistics.median(e.values()):.2e}; plain bf16 vs f32 autograd {e32:.2e}")
        errs["fused_mlp_bwd"] = max(errs["fused_mlp_bwd"], e[worst])
        with torch.no_grad():
            ms["fused_mlp_eval"][s_] = _cuda_ms(
                lambda: fv._launch_eval(cfg, xyz, dir_pe, codes, packed, True, True),
                TIMED_LAUNCHES)
            ms["fused_mlp_bwd"][s_] = _cuda_ms(
                lambda: fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, g, packed=packed),
                TIMED_LAUNCHES)
            plain_ms["fused_mlp_eval"][s_] = _cuda_ms(
                lambda: fv.mlp_eval_plain(model, cfg, xyz, dir_pe, codes), 3)
            plain_ms["fused_mlp_bwd"][s_] = _cuda_ms(
                lambda: fv.mlp_bwd_plain(model, cfg, xyz, dir_pe, codes, g), 3)
            pack_ms = _cuda_ms(lambda: fused_mlp.pack_kernel_weights(model, cfg, True), 10)
    with torch.no_grad():  # a ragged last tile, and each branch alone
        model, _, xyz, _, _, _ = shapes[N_SAMPLES]
        n_small = 37
        args = (xyz[:n_small].contiguous(), dir_pe[:n_small].contiguous(),
                codes[:n_small].contiguous())
        for fi, cs in ((False, True), (True, False)):
            got = fv.fused_mlp_eval(model, cfg, *args, forward_instance=fi, compute_scene=cs)
            want = fv.mlp_eval_plain(model, cfg, *args, forward_instance=fi, compute_scene=cs)
            e = max((a - b).abs().max().item() for a, b in zip(got, want))
            off = [k for k, a in zip(names, got) if a.abs().max().item() == 0]
            print(f"fused_mlp_eval ({n_small}, {N_SAMPLES}) forward_instance={fi} "
                  f"compute_scene={cs}: max err {e:.2e}, all-zero outputs {off}")
            errs["fused_mlp_eval"] = max(errs["fused_mlp_eval"], e)
            if off != ([] if fi and cs else list(names[2:] if cs else names[:2])):
                raise SystemExit(f"a branch that is off must give zeros, got {off}")
    if not errs["fused_mlp_eval"] <= KERNEL_TOL:
        raise SystemExit(f"fused_mlp_eval disagrees with its plain version: "
                         f"{errs['fused_mlp_eval']:.3e}")
    if not errs["fused_mlp_bwd"] <= BWD_TOL:
        raise SystemExit(f"fused_mlp_bwd disagrees with its plain version: "
                         f"{errs['fused_mlp_bwd']:.3e}")

    # bounds: operations at the dense bf16 peak; bytes that must move (inputs
    # once, outputs once, the packed weights once). The backward design's own
    # traffic (stash written and read, per-tile read-modify-write of the
    # block's partial gradients, the partials read by the reduction) is
    # printed beside it.
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    stash_row = 2 * ((cfg.D + 1) * cfg.W + cfg.W // 2 + (cfg.inst_D + 1) * cfg.inst_W
                     + cfg.inst_W // 2)
    w_bytes = 2 * packed.w.numel() + 4 * packed.b.numel()
    g_bytes = 4 * (packed.w.numel() + packed.b.numel())
    entries = []
    for name, macs in (("fused_mlp_eval", _macs_per_sample(cfg, False)),
                       ("fused_mlp_bwd", _bwd_macs_per_sample(cfg))):
        bound, by = {}, {}
        for s_ in shapes:
            rows = BATCH * s_
            per_ray = 4 * BATCH * (cfg.in_channels_dir + cfg.N_obj_code_length)
            if name == "fused_mlp_eval":
                nbytes = rows * (12 + 32) + per_ray + w_bytes
            else:
                nbytes = (rows * (12 + 32) + per_ray + w_bytes + g_bytes
                          + 4 * BATCH * cfg.N_obj_code_length)
            t_ops, t_bytes = 2 * macs * rows / peak_flops * 1e3, nbytes / peak_bytes * 1e3
            bound[s_], by[s_] = max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
            extra = ""
            if name == "fused_mlp_bwd":
                tiles = rows // 128
                design = (rows * (2 * stash_row - cfg.W - cfg.inst_W)  # dir act. not re-read
                          + 2 * g_bytes * tiles + g_bytes * min(tiles, n_sm))
                extra = (f"; its own stash and partial-gradient traffic {design / 1e9:.2f} GB "
                         f"= {design / peak_bytes * 1e3:.3f} ms at the memory rate")
            print(f"{name} ({BATCH}, {s_}): {ms[name][s_]:.3f} ms/launch, plain "
                  f"{plain_ms[name][s_]:.3f} ms, bound {bound[s_]:.3f} ms ({by[s_]}: "
                  f"{2 * macs * rows / 1e12:.3f} TFLOP, {nbytes / 1e6:.1f} MB), "
                  f"{2 * macs * rows / ms[name][s_] / 1e9:.1f} TFLOP/s achieved{extra}")
        entries.append({
            "name": name, "route": "cuda",
            "source": "object_nerf_torch/ops/csrc/fused_mlp_train.cu",
            "replaces": ("object_nerf_tpu/ops/pallas_mlp.py:287" if name == "fused_mlp_eval"
                         else "object_nerf_tpu/ops/pallas_mlp_vjp.py:72"),
            "max_abs_err": errs[name], "tol": KERNEL_TOL if name == "fused_mlp_eval" else BWD_TOL,
            "err_is": ("max abs" if name == "fused_mlp_eval"
                       else "max abs / largest reference entry, per gradient tensor"),
            # one step launches each kernel once per shape: the sum is its cost
            "ms": sum(ms[name].values()), "plain_ms": sum(plain_ms[name].values()),
            "bound_ms": sum(bound.values()), "bound_by": by[N_SAMPLES], "library_ms": None,
            "ms_by_samples": ms[name], "bound_ms_by_samples": bound,
        })
    print(f"pack_kernel_weights: {pack_ms:.3f} ms per model (twice per step)")

    # -- 7. the training path -----------------------------------------------------------
    # the same first step through the kernels and through the plain bf16 path
    twin = copy.deepcopy(models)
    plain_step = make_train_step(settings, dict(config.loss),
                                 make_optimizer(config.train, twin.parameters()),
                                 system.lr_schedule, plain=True)
    fused_mlp.reset_launch_counts()
    m_k = system.train_step(models, batch, draws=draws)
    m_p = plain_step(twin, batch, draws=draws)
    torch.cuda.synchronize()
    loss_k, loss_p = float(m_k["train/loss"]), float(m_p["train/loss"])
    e = {k: _rel(p.grad, q.grad) for (k, p), q in zip(models.named_parameters(),
                                                      twin.parameters())}
    worst = max(e, key=e.get)
    lr = m_k["lr"]
    moved = torch.cat([(p - q).abs().reshape(-1) for p, q in zip(models.parameters(),
                                                                 twin.parameters())])
    print(f"step 1, kernels vs plain bf16 path: loss {loss_k:.6f} vs {loss_p:.6f} "
          f"(rel {abs(loss_k - loss_p) / abs(loss_p):.2e}, tol {LOSS_TOL:g}); gradients: worst "
          f"{e[worst]:.2e} at {worst} (tol {STEP_GRAD_TOL:g}), median "
          f"{statistics.median(e.values()):.2e}; updated parameters (Adam, lr {lr:g}): "
          f"mean |difference| {moved.mean().item():.2e}, max {moved.max().item():.2e}, "
          f"{(moved > 0.1 * lr).float().mean().item() * 100:.2f} % differ by more than lr/10")
    if not abs(loss_k - loss_p) <= LOSS_TOL * abs(loss_p):
        raise SystemExit("the kernel-path step's loss disagrees with the plain path's")
    if not e[worst] <= STEP_GRAD_TOL:
        raise SystemExit(f"the kernel-path step's gradients disagree: {e[worst]:.3e} at {worst}")
    # the first Adam step moves an entry by lr * g / (|g| + 1e-8), about lr
    # whatever the gradient's size: two steps differ by up to 2 lr wherever a
    # gradient within the tolerance of zero changes its sign, and hardly at all
    # elsewhere. The gradients above are the comparison that binds; this one
    # only bounds the update.
    if not moved.max().item() <= 2.001 * lr:
        raise SystemExit("the kernel-path step's updated parameters disagree")
    del twin, plain_step

    losses = [m_k["train/loss"]]
    for _ in range(TRAIN_STEPS):
        losses.append(system.training_step(system.train_dataset.sample_batch(BATCH, rng))
                      ["train/loss"])
    torch.cuda.synchronize()
    launches = dict(fused_mlp.launch_counts)
    losses = [float(x) for x in losses]
    n_steps = len(losses)
    print(f"{n_steps} steps: launches {launches} (expect {2 * n_steps} of each training "
          f"kernel); loss " + " ".join(f"{x:.4f}" for x in losses))
    if launches != {"fused_coarse_weights": 0, "fused_render_tiles": 0,
                    "fused_mlp_eval": 2 * n_steps, "fused_mlp_bwd": 2 * n_steps,
                    "fused_sigma_eval": 0}:
        raise SystemExit(f"expected 2 forward and 2 backward launches per step: {launches}")
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise SystemExit("a training loss is not finite")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    print(f"loss: mean of the first five {first:.4f}, of the last five {last:.4f}")
    if not last < first:
        raise SystemExit("the loss did not fall")
    for entry in entries:
        entry["launches"] = launches[entry["name"]]

    # step time: host clock around steps that end in a synchronise; the
    # optimizer alone by CUDA events
    times, opt_events = [], []
    optimizer_step = system.optimizer.step

    def timed_optimizer_step(*a, **k):
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        out = optimizer_step(*a, **k)
        ev[1].record()
        opt_events.append(ev)
        return out

    system.optimizer.step = timed_optimizer_step
    for _ in range(STEPS_TIMED):
        np_batch = system.train_dataset.sample_batch(BATCH, rng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system.training_step(np_batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    system.optimizer.step = optimizer_step
    opt_ms = statistics.median(a.elapsed_time(b) for a, b in opt_events)
    step_ms = statistics.median(times) * 1e3
    k_fwd, k_bwd = sum(ms["fused_mlp_eval"].values()), sum(ms["fused_mlp_bwd"].values())
    rest = step_ms - k_fwd - k_bwd - 2 * pack_ms - opt_ms
    print(f"train step: {step_ms:.2f} ms median of {STEPS_TIMED} (all: "
          f"{', '.join(f'{t * 1e3:.2f}' for t in times)}), {BATCH / (step_ms / 1e3):.0f} rays/s; "
          f"forward kernels {k_fwd:.2f} ms, backward kernels with their reduction "
          f"{k_bwd:.2f} ms, packing {2 * pack_ms:.2f} ms, optimizer {opt_ms:.2f} ms, glue + "
          f"loss + autograd + batch upload (by subtraction) {rest:.2f} ms; kernel bound "
          f"{sum(x['bound_ms'] for x in entries):.2f} ms")

    metrics, _ = system.validation(chunk=4800)
    print(f"validation through the eval render after {system.global_step} steps: "
          + ", ".join(f"{k} {v:.3f}" for k, v in metrics.items()))
    if not all(v == v for v in metrics.values()):
        raise SystemExit("validation metrics are not finite")

    if profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as torch_profile

        n_prof = 3
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_prof):
                system.training_step(system.train_dataset.sample_batch(BATCH, rng))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        averages = prof.key_averages()
        print(averages.table(sort_by="cuda_time_total", row_limit=25,
                             max_name_column_width=60))
        busy_ms = sum(e.self_device_time_total for e in averages  # kernels and copies only
                      if e.device_type == DeviceType.CUDA) / 1e3
        print(f"profiled {n_prof} steps: device busy {busy_ms / n_prof:.2f} ms per step of "
              f"{wall_ms / n_prof:.2f} ms wall (with the profiler's own cost on the host): "
              f"idle share {100 * (1 - busy_ms / wall_ms):.1f} %; against the unprofiled "
              f"{step_ms:.2f} ms step: {100 * (1 - busy_ms / n_prof / step_ms):.1f} %")
    return entries


def _branch_macs(cfg, instance: bool) -> int:
    """Multiply-adds of one point through one branch's trunk and sigma head
    (unpadded): what `fused_sigma_eval` computes."""
    width, depth, skips = ((cfg.inst_W, cfg.inst_D, cfg.inst_skips) if instance
                           else (cfg.W, cfg.D, cfg.skips))
    c_in = cfg.xyz_pe_size + (cfg.N_obj_code_length if instance else 0)
    m = width  # sigma head
    for i in range(depth):
        m += (c_in if i == 0 else (c_in + width if i in skips else width)) * width
    return m


def _sigma_phase(torch, dev, models, cfg, peak_flops, peak_bytes):
    """Phase 8; returns the kernel's entry for the `kernels` line (without
    its launches) and its ms per launch by branch."""
    from object_nerf_torch.ops import fused_mlp
    from object_nerf_torch.ops import fused_sigma as fs

    if _branch_macs(cfg, False) != _macs_per_sample(cfg, True):
        raise SystemExit("the scene branch's operation count disagrees with the coarse pass's")
    n_rows, s = EDIT_CHUNK, N_SAMPLES
    n = n_rows * s
    gen = torch.Generator().manual_seed(SEED + 2)
    pts = (torch.rand(n, 3, generator=gen) * 3.0 - 1.5).to(dev)
    ids = torch.randint(0, 64, (n_rows,), generator=gen).to(dev)
    model = models.nerf_coarse
    ms, plain_ms, bound, by, errs = {}, {}, {}, {}, {}
    with torch.no_grad():
        codes = models.code_library(ids).contiguous()
        packed = fused_mlp.pack_kernel_weights(model, cfg, True, sigma_only=True)
        for branch in fs.BRANCHES:
            def run(branch=branch):
                return fs.fused_sigma_eval(model, cfg, pts, codes, branch, s, packed=packed)

            def run_plain(branch=branch):
                return fs.sigma_eval_plain(model, cfg, pts, codes, branch, s)

            got, want = run(), run_plain()
            torch.cuda.synchronize()
            errs[branch] = (got - want).abs().max().item()
            print(f"fused_sigma_eval {branch} ({n} points, {n_rows} code rows): max |kernel - "
                  f"plain bf16| = {errs[branch]:.3e} (tol {KERNEL_TOL:g}; raw densities "
                  f"{got.min().item():.4f} .. {got.max().item():.4f})")
            if not errs[branch] <= KERNEL_TOL:
                raise SystemExit(f"fused_sigma_eval ({branch}) disagrees with its plain "
                                 f"version: {errs[branch]:.3e}")
            ms[branch] = _cuda_ms(run, TIMED_LAUNCHES)
            plain_ms[branch] = _cuda_ms(run_plain, 3)
            instance = branch == "instance"
            macs = _branch_macs(cfg, instance)
            depth, width = (cfg.inst_D, cfg.inst_W) if instance else (cfg.D, cfg.W)
            # points read and densities written once, the codes once, the
            # branch's weights (one per multiply-add of a point) and biases once
            nbytes = (16 * n + (4 * codes.numel() if instance else 0) + 2 * macs
                      + 4 * (depth * width + 1))
            t_ops, t_bytes = 2 * macs * n / peak_flops * 1e3, nbytes / peak_bytes * 1e3
            bound[branch] = max(t_ops, t_bytes)
            by[branch] = "operations" if t_ops >= t_bytes else "bytes"
            print(f"fused_sigma_eval {branch}: {ms[branch]:.3f} ms/launch, plain "
                  f"{plain_ms[branch]:.3f} ms, bound {bound[branch]:.3f} ms ({by[branch]}: "
                  f"{macs} multiply-adds per point, {2 * macs * n / 1e12:.3f} TFLOP, "
                  f"{nbytes / 1e6:.1f} MB), {2 * macs * n / ms[branch] / 1e9:.1f} TFLOP/s "
                  f"achieved")
    entry = {
        "name": "fused_sigma_eval", "route": "cuda",
        "source": "object_nerf_torch/ops/csrc/fused_sigma.cu",
        "replaces": "object_nerf_tpu/ops/pallas_mlp.py:971",
        "max_abs_err": max(errs.values()), "tol": KERNEL_TOL, "err_is": "max abs",
        # a mixed edit chunk launches each branch once: the sum is its cost
        "ms": sum(ms.values()), "plain_ms": sum(plain_ms.values()),
        "bound_ms": sum(bound.values()), "bound_by": by["scene"], "library_ms": None,
        "ms_by_branch": ms, "plain_ms_by_branch": plain_ms, "bound_ms_by_branch": bound,
    }
    return entry, ms


def _edit_phase(torch, dev, models, cfg, sigma_ms):
    """Phase 9: one edit frame through `EditableRenderer`; returns the
    frame's launch counts and the largest error of `fused_mlp_eval` against
    its plain version at the edit chunk's shape and flags."""
    import dataclasses
    import math
    import tempfile

    import numpy as np

    from object_nerf_torch.config import Config, load_config
    from object_nerf_torch.data import dataset_dict
    from object_nerf_torch.data.synthetic import _default_spheres
    from object_nerf_torch.edit.__main__ import get_transformation_with_duplication_offset
    from object_nerf_torch.edit.bbox import boxes_to_arrays
    from object_nerf_torch.edit.editable_renderer import EditableRenderer
    from object_nerf_torch.models.embedding import freq_encode
    from object_nerf_torch.ops import fused_mlp
    from object_nerf_torch.ops import fused_mlp_vjp as fv
    from object_nerf_torch.render.multi import compact_hit_order, render_rays_multi
    from object_nerf_torch.train.metrics import psnr

    root = _repo_root()
    ckpt = load_config(cli_args=[
        f"dataset_config={os.path.join(root, 'config', 'synthetic.yml')}",
        f"model.N_samples={N_SAMPLES}", f"model.N_importance={N_IMPORTANCE}"]).to_dict()
    ds = dataset_dict["synthetic"]("val", img_wh=(EDIT_W, EDIT_H))
    Twc = np.eye(4)
    Twc[:3] = np.asarray(ds.poses[0])[:3]
    fovx = math.degrees(2 * math.atan(0.5 / 0.7))  # the dataset's focal is 0.7 w
    with tempfile.TemporaryDirectory() as tmp:
        # the scene's spheres as ToyDesk oriented boxes (json only)
        bbox_path = os.path.join(tmp, "bbox.json")
        with open(bbox_path, "w") as f:
            json.dump({"labels": [
                {"id": int(s.instance_id),
                 "data": {"position": [float(x) for x in s.center],
                          "quaternion": [0.0, 0.0, 0.0, 1.0],
                          "scale": [float(2.2 * s.radius)] * 3}}
                for s in _default_spheres()]}, f)
        ckpt["dataset_name"] = "toydesk"
        ckpt["dataset_extra"]["bbox_dir"] = bbox_path
        renderer = EditableRenderer(Config({"ckpt_config": ckpt, "chunk": EDIT_CHUNK}),
                                    models=models, device=dev)
        renderer.remove_scene_object_by_ids([EDIT_OBJ])
        renderer.set_object_pose_transform(
            EDIT_OBJ, get_transformation_with_duplication_offset(EDIT_PROGRESS, 0), 0)
    kw = dict(h=EDIT_H, w=EDIT_W, camera_pose_Twc=Twc, fovx_deg=fovx, chunk=EDIT_CHUNK)

    fused_mlp.reset_launch_counts()
    frame = renderer.render_edit(**kw)
    torch.cuda.synchronize()
    launches = dict(fused_mlp.launch_counts)
    plan = renderer.last_chunk_plan
    n_chunks, n_mixed = plan["chunks"], plan["mixed"]
    expect = 2 * n_mixed + (n_chunks - n_mixed)
    print(f"edit frame {EDIT_W}x{EDIT_H}, background + object {EDIT_OBJ} moved, its original "
          f"removed: {n_chunks} chunks of {EDIT_CHUNK}, {n_mixed} with both ray sets; launches "
          f"{launches} (expect {expect} of fused_sigma_eval and of fused_mlp_eval)")
    if n_chunks != -(-EDIT_W * EDIT_H // EDIT_CHUNK) or not 0 < n_mixed < n_chunks:
        raise SystemExit(f"the frame should have mixed and background-only chunks: {plan}")
    if launches != {"fused_coarse_weights": 0, "fused_render_tiles": 0,
                    "fused_mlp_eval": expect, "fused_mlp_bwd": 0, "fused_sigma_eval": expect}:
        raise SystemExit(f"expected {expect} launches of each edit kernel: {launches}")
    if set(frame) != {"rgb_fine", "depth_fine", "opacity_fine"}:
        raise SystemExit(f"unexpected maps {sorted(frame)}")
    for k, v in frame.items():
        if v.shape[0] != EDIT_W * EDIT_H or not np.isfinite(v).all():
            raise SystemExit(f"edit map {k} is not finite or has shape {v.shape}")

    # chunks of the compacted order against render_rays_multi, f32 plain path
    rays_list, ids = renderer.edit_ray_sets(EDIT_H, EDIT_W, Twc, fovx)
    perm, n_mixed_plan = compact_hit_order(rays_list, ids, EDIT_CHUNK)
    if n_mixed_plan != n_mixed:
        raise SystemExit("the planner disagrees with the renderer's record")
    a, b, scale = boxes_to_arrays(renderer.get_skipping_bbox_helper(), renderer.scale_factor)
    skip_boxes = (torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev), scale)
    settings32 = dataclasses.replace(renderer.settings, matmul_dtype=torch.float32)
    checked = [("mixed", c) for c in range(min(2, n_mixed))] + [("background-only", n_mixed)]
    for kind, c in checked:
        idx = perm[c * EDIT_CHUNK:(c + 1) * EDIT_CHUNK]
        sets = [torch.from_numpy(np.ascontiguousarray(r[idx])).to(dev) for r in rays_list]
        ref = render_rays_multi(models, sets, ids, settings32, skip_boxes=skip_boxes,
                                plain=True)
        hits = int((rays_list[1][idx, 7] > 0).sum())
        p = psnr(torch.from_numpy(frame["rgb_fine"][idx]).to(dev), ref["rgb_fine"]).item()
        diff = {k: (torch.from_numpy(frame[k][idx]).to(dev) - ref[k]).abs().max().item()
                for k in frame}
        print(f"edit chunk {c} ({kind}, {hits} rays hit the object's box): rgb_fine PSNR vs "
              f"render_rays_multi f32 plain {p:.2f} dB (floor {EDIT_PSNR_FLOOR_DB:g}); max abs "
              f"diff " + ", ".join(f"{k} {v:.2e}" for k, v in diff.items())
              + " (limits " + ", ".join(f"{k} {v:g}" for k, v in EDIT_MAP_TOL.items()) + ")")
        if not p >= EDIT_PSNR_FLOOR_DB:
            raise SystemExit(f"edit chunk {c}: PSNR {p:.2f} dB below {EDIT_PSNR_FLOOR_DB:g}")
        for k, tol in EDIT_MAP_TOL.items():
            if not diff[k] <= tol:
                raise SystemExit(f"edit chunk {c}: {k} is {diff[k]:.3e} from the f32 plain "
                                 f"path (limit {tol:g})")
        if (kind == "mixed") != (hits > 0):
            raise SystemExit(f"edit chunk {c} should be {kind}, but {hits} rays hit")

    fused_mlp.reset_launch_counts()
    renderer.compact_rays = False
    dense = renderer.render_edit(**kw)
    renderer.compact_rays = True
    torch.cuda.synchronize()
    dense_launches = fused_mlp.launch_counts["fused_sigma_eval"]
    worst = max(float(np.abs(dense[k] - frame[k]).max()) for k in frame)
    moved = float(np.abs(frame["rgb_fine"] - renderer.render_origin(
        EDIT_H, EDIT_W, Twc, fovx, chunk=EDIT_CHUNK)["rgb_fine"]).max())
    print(f"dense frame (compaction off): {dense_launches} "
          f"launches of fused_sigma_eval; max |compacted - dense| = {worst:.2e} (tol "
          f"{COMPACT_TOL:g}); max |edited - unedited| = {moved:.3f}")
    if dense_launches != 2 * n_chunks:
        raise SystemExit("the dense frame should launch both branches on every chunk")
    if not worst <= COMPACT_TOL:
        raise SystemExit(f"compacted and dense frames disagree: {worst:.3e}")
    if not moved > 1e-3:
        raise SystemExit("the edit changed nothing in the frame")

    times = []
    for _ in range(FRAMES_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        renderer.render_edit(**kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    frame_ms = statistics.median(times) * 1e3
    host = []
    for _ in range(FRAMES_TIMED):  # the frame's host part before the first upload
        t0 = time.perf_counter()
        compact_hit_order(renderer.edit_ray_sets(EDIT_H, EDIT_W, Twc, fovx)[0], ids, EDIT_CHUNK)
        host.append(time.perf_counter() - t0)
    host_ms = statistics.median(host) * 1e3

    # the fine pass's kernel with one branch on, at the chunk's shape
    gen = torch.Generator().manual_seed(SEED + 3)
    s_f = N_SAMPLES + N_IMPORTANCE
    with torch.no_grad():
        xyz = (torch.rand(EDIT_CHUNK, s_f, 3, generator=gen) * 3.0 - 1.5).to(dev)
        dirs = torch.nn.functional.normalize(torch.randn(EDIT_CHUNK, 3, generator=gen), dim=-1)
        dir_pe = freq_encode(dirs.to(dev), cfg.N_freq_dir).contiguous()
        codes = models.code_library(torch.full((EDIT_CHUNK,), EDIT_OBJ, device=dev)).contiguous()
        packed = fused_mlp.pack_kernel_weights(models.nerf_fine, cfg, True)
        mlp_ms, mlp_err = {}, 0.0
        for name, fi, cs, cd in (("scene", False, True, None), ("instance", True, False, codes)):
            def run(fi=fi, cs=cs, cd=cd):
                return fv.fused_mlp_eval(models.nerf_fine, cfg, xyz, dir_pe, cd,
                                         forward_instance=fi, compute_scene=cs, packed=packed)

            # the fine pass's calls as the edit path makes them (one branch on,
            # weights packed once per frame) against the plain version
            got = run()
            want = fv.mlp_eval_plain(models.nerf_fine, cfg, xyz, dir_pe, cd,
                                     forward_instance=fi, compute_scene=cs)
            torch.cuda.synchronize()
            e = {k: (g_ - w_).abs().max().item()
                 for k, g_, w_ in zip(("sigma", "rgb", "inst_sigma", "inst_rgb"), got, want)}
            print(f"fused_mlp_eval {tuple(xyz.shape)} forward_instance={fi} compute_scene={cs} "
                  f"packed: max |kernel - plain bf16| "
                  + ", ".join(f"{k} {v:.2e}" for k, v in e.items()) + f" (tol {KERNEL_TOL:g})")
            if not max(e.values()) <= KERNEL_TOL:
                raise SystemExit(f"fused_mlp_eval ({name} branch alone, packed) disagrees with "
                                 f"its plain version: {max(e.values()):.3e}")
            live = ("inst_sigma", "inst_rgb") if fi else ("sigma", "rgb")
            if any(got[i].abs().max().item() == 0.0 for i, k in enumerate(e) if k in live):
                raise SystemExit(f"fused_mlp_eval ({name} branch alone) returned zeros")
            mlp_err = max(mlp_err, *e.values())
            mlp_ms[name] = _cuda_ms(run, TIMED_LAUNCHES)
    # whole chunks' worth of rays (the last chunk is shorter)
    n_bg = EDIT_W * EDIT_H / EDIT_CHUNK
    k_scene = n_bg * (sigma_ms["scene"] + mlp_ms["scene"])
    k_obj = n_mixed * (sigma_ms["instance"] + mlp_ms["instance"])
    print(f"edit frame: {frame_ms:.1f} ms median of {FRAMES_TIMED} (all: "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)}), "
          f"{EDIT_W * EDIT_H / (frame_ms / 1e3):.0f} pixels/s; per {EDIT_CHUNK}-ray chunk: "
          f"fused_sigma_eval scene {sigma_ms['scene']:.3f} ms, object "
          f"{sigma_ms['instance']:.3f} ms, fused_mlp_eval ({EDIT_CHUNK}, {s_f}) scene branch "
          f"alone {mlp_ms['scene']:.3f} ms, object branch alone {mlp_ms['instance']:.3f} ms; "
          f"background set's kernels {k_scene:.1f} ms, object set's {k_obj:.1f} ms, ray "
          f"generation + box tests + chunk plan on the host (numpy, timed alone) "
          f"{host_ms:.1f} ms, glue + packing + copies (by subtraction) "
          f"{frame_ms - k_scene - k_obj - host_ms:.1f} ms")
    return launches, mlp_err


def _mesh_phase(torch, dev, models, settings):
    """Phase 10: the density sweep, marching tetrahedra and a PLY round trip;
    returns the number of `fused_sigma_eval` launches of the sweeps."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from object_nerf_torch.config import Config
    from object_nerf_torch.data.ply_io import read_ply, write_ply
    from object_nerf_torch.ops import fused_mlp
    from object_nerf_torch.tools.extract_mesh import extract_sigma_grid
    from object_nerf_torch.tools.marching import marching_backend, marching_tetrahedra

    def grid_conf(n):
        return Config({"N_grid": n, "chunk": MESH_CHUNK, "x_range": [-1.5, 1.5],
                       "y_range": [-1.5, 1.5], "z_range": [-1.5, 1.5]})

    settings32 = dataclasses.replace(settings, matmul_dtype=torch.float32)
    per_sweep = -(-MESH_GRID ** 3 // MESH_CHUNK)
    launches = 0
    grids = {}
    for obj_id in (0, MESH_OBJ):
        fused_mlp.reset_launch_counts()
        got = extract_sigma_grid(models, settings, grid_conf(MESH_GRID), obj_id, device=dev,
                                 as_tensor=True)
        torch.cuda.synchronize()
        n_launch = fused_mlp.launch_counts["fused_sigma_eval"]
        launches += n_launch
        want = extract_sigma_grid(models, settings32, grid_conf(MESH_GRID), obj_id, device=dev,
                                  plain=True, as_tensor=True)
        err = (got - want).abs().max().item()
        print(f"sigma grid {MESH_GRID}^3, {'scene branch' if obj_id == 0 else f'object {obj_id}'}"
              f": {n_launch} launches (expect {per_sweep}); max |kernel sweep - plain f32 "
              f"sweep| = {err:.3e} (tol {MESH_F32_TOL:g}); densities {got.min().item():.4f} .. "
              f"{got.max().item():.4f}, {(got > 0).float().mean().item() * 100:.1f} % above 0")
        if n_launch != per_sweep or sum(fused_mlp.launch_counts.values()) != per_sweep:
            raise SystemExit(f"expected {per_sweep} launches of fused_sigma_eval alone")
        if not torch.isfinite(got).all() or not err <= MESH_F32_TOL:
            raise SystemExit(f"the kernel sweep disagrees with the plain f32 sweep: {err:.3e}")
        grids[obj_id] = got

    # a surface through the raised densities of the scene branch, and a PLY;
    # where there is a compiler the native marching code must have built
    if shutil.which("g++") is not None and marching_backend() != "native":
        raise SystemExit("g++ is there, but marching tetrahedra took the numpy backend")
    sigma = grids[0].cpu().numpy()
    level = float(np.median(sigma))
    t0 = time.perf_counter()
    verts, faces = marching_tetrahedra(sigma, level)
    t_march = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "extracted_mesh_smoke.ply")
        write_ply(path, verts, faces=faces)
        back = read_ply(path)
    print(f"marching tetrahedra ({marching_backend()} backend) at the median density "
          f"{level:.4f}: {len(verts)} vertices, {len(faces)} faces in {t_march:.1f} s; PLY "
          f"read back: {len(back['points'])} vertices, {len(back['faces'])} faces")
    if not (len(verts) > 0 and len(faces) > 0 and len(back["points"]) == len(verts)
            and len(back["faces"]) == len(faces)
            and np.array_equal(np.asarray(back["faces"]), faces)):
        raise SystemExit("the mesh or its PLY round trip is wrong")

    # the sweep alone at the reference's grid size (no marching)
    def timed_sweep(n):
        fused_mlp.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = extract_sigma_grid(models, settings, grid_conf(n), 0, device=dev, as_tensor=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not torch.isfinite(grid).all():
            raise SystemExit(f"the {n}^3 sweep is not finite")
        return dt, fused_mlp.launch_counts["fused_sigma_eval"]

    n_timed = MESH_GRID_TIMED // 2
    dt, n_launch = timed_sweep(n_timed)
    if 8 * dt <= SWEEP_BUDGET_S:
        n_timed = MESH_GRID_TIMED
        dt, n_launch = timed_sweep(n_timed)
    launches += n_launch
    print(f"sigma sweep {n_timed}^3 ({n_timed ** 3} points, scene branch, chunk {MESH_CHUNK}): "
          f"{dt * 1e3:.1f} ms, {n_launch} launches, {n_timed ** 3 / dt / 1e6:.1f} M points/s")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, _repo_root())

    from object_nerf_torch.data import dataset_dict
    from object_nerf_torch.models.embedding import freq_encode
    from object_nerf_torch.models.mlp import ObjectNeRFConfig
    from object_nerf_torch.ops import _build, fused_mlp
    from object_nerf_torch.ops.sampling import merge_z_vals, sample_pdf, stratified_sample
    from object_nerf_torch.render.renderer import RenderSettings, render_rays_plain
    from object_nerf_torch.train.metrics import psnr
    from object_nerf_torch.train.system import init_params, render_image

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. the card ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    peak_flops, peak_bytes = _peaks(kind)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().name})")
    log = _build.library_path().with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    # -- 3. each kernel against its plain version ------------------------------
    cfg = ObjectNeRFConfig(use_voxel_embedding=False)
    settings = RenderSettings(mlp=cfg, N_samples=64, N_importance=64, perturb=0.0,
                              noise_std=0.0, is_eval=True, forward_instance=True)
    models = init_params(torch.Generator().manual_seed(SEED), settings,
                         {"N_max_objs": 64}, device=dev)
    with torch.no_grad():
        for m in (models.nerf_coarse, models.nerf_fine):
            m.sigma.bias += DENSITY_BIAS
    ds = dataset_dict["synthetic"]("val", img_wh=(W, H))
    batch = ds.whole_image_batch(0)

    gen = torch.Generator().manual_seed(SEED + 1)
    rays = torch.from_numpy(batch["rays"][:CHUNK]).to(dev)
    ids = torch.randint(0, 64, (CHUNK,), generator=gen).to(dev)
    with torch.no_grad():
        codes = models.code_library(ids).contiguous()
        z_c = stratified_sample(rays[:, 6:7], rays[:, 7:8], settings.N_samples)
        xyz_c = (rays[:, None, 0:3] + rays[:, None, 3:6] * z_c[..., None]).contiguous()
        dir_pe = freq_encode(rays[:, 3:6], cfg.N_freq_dir).contiguous()
        w_plain = fused_mlp.coarse_weights_plain(models.nerf_coarse, cfg, xyz_c, z_c)
        z_mid = 0.5 * (z_c[:, :-1] + z_c[:, 1:])
        z_f = merge_z_vals(z_c, sample_pdf(z_mid, w_plain[:, 1:-1],
                                           settings.N_importance, det=True)).contiguous()
        xyz_f = (rays[:, None, 0:3] + rays[:, None, 3:6] * z_f[..., None]).contiguous()

        pk_c = fused_mlp.pack_kernel_weights(models.nerf_coarse, cfg, False, sigma_only=True)
        pk_f = fused_mlp.pack_kernel_weights(models.nerf_fine, cfg, True)

        def run_coarse():
            return fused_mlp.fused_coarse_weights(models.nerf_coarse, cfg, xyz_c, z_c,
                                                  packed=pk_c)

        def run_coarse_plain():
            return fused_mlp.coarse_weights_plain(models.nerf_coarse, cfg, xyz_c, z_c)

        def run_fine():
            return fused_mlp.fused_render_tiles(models.nerf_fine, cfg, xyz_f, z_f, dir_pe,
                                                codes, packed=pk_f)

        def run_fine_plain():
            return fused_mlp.render_tiles_plain(models.nerf_fine, cfg, xyz_f, z_f, dir_pe,
                                                codes)

        w_k = run_coarse()
        torch.cuda.synchronize()
        err_c = (w_k - w_plain).abs().max().item()
        print(f"fused_coarse_weights {tuple(xyz_c.shape)}: max |kernel - plain bf16| "
              f"= {err_c:.3e} (tol {KERNEL_TOL:g}; weights sum to "
              f"{w_k.sum(-1).mean().item():.4f} per ray on average)")
        maps_k, maps_p = run_fine(), run_fine_plain()
        torch.cuda.synchronize()
        errs_f = {k: (maps_k[k] - maps_p[k]).abs().max().item() for k in maps_p}
        err_f = max(errs_f.values())
        print(f"fused_render_tiles {tuple(xyz_f.shape)}: max |kernel - plain bf16| "
              f"= {err_f:.3e} (tol {KERNEL_TOL:g}): "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs_f.items()))
        for name, err in (("fused_coarse_weights", err_c), ("fused_render_tiles", err_f)):
            if not err <= KERNEL_TOL:
                raise SystemExit(f"{name} disagrees with its plain version: {err:.3e}")

        ms = {
            "fused_coarse_weights": _cuda_ms(run_coarse, TIMED_LAUNCHES),
            "fused_render_tiles": _cuda_ms(run_fine, TIMED_LAUNCHES),
        }
        plain_ms = {
            "fused_coarse_weights": _cuda_ms(run_coarse_plain, 3),
            "fused_render_tiles": _cuda_ms(run_fine_plain, 3),
        }
    n_c, n_f = CHUNK * settings.N_samples, CHUNK * (settings.N_samples + settings.N_importance)
    flops = {
        "fused_coarse_weights": 2 * _macs_per_sample(cfg, True) * n_c,
        "fused_render_tiles": 2 * _macs_per_sample(cfg, False) * n_f,
    }
    nbytes = {  # inputs read once, outputs written once, the packed weights once
        "fused_coarse_weights": 4 * (3 * n_c + n_c + n_c) + 2 * pk_c.w.numel() + 4 * pk_c.b.numel(),
        "fused_render_tiles": 4 * (3 * n_f + n_f + CHUNK * (27 + 64 + 16))
        + 2 * pk_f.w.numel() + 4 * pk_f.b.numel(),
    }
    bound_ms, bound_by = {}, {}
    for k in flops:
        t_ops, t_bytes = flops[k] / peak_flops * 1e3, nbytes[k] / peak_bytes * 1e3
        bound_ms[k] = max(t_ops, t_bytes)
        bound_by[k] = "operations" if t_ops >= t_bytes else "bytes"
        print(f"{k}: {ms[k]:.3f} ms/launch, plain {plain_ms[k]:.3f} ms, bound "
              f"{bound_ms[k]:.3f} ms ({bound_by[k]}: {flops[k] / 1e12:.3f} TFLOP, "
              f"{nbytes[k] / 1e6:.1f} MB), {flops[k] / ms[k] / 1e9:.1f} TFLOP/s achieved")

    # -- 4. one 640x480 frame through the main path -----------------------------
    fused_mlp.reset_launch_counts()
    frame = render_image(models, settings, batch, chunk=CHUNK, device=dev)
    torch.cuda.synchronize()
    launches = dict(fused_mlp.launch_counts)
    n_chunks = (W * H) // CHUNK
    print(f"frame {W}x{H}: launches {launches} (expect {n_chunks} of each eval kernel)")
    if launches != {"fused_coarse_weights": n_chunks, "fused_render_tiles": n_chunks,
                    "fused_mlp_eval": 0, "fused_mlp_bwd": 0, "fused_sigma_eval": 0}:
        raise SystemExit(f"expected {n_chunks} launches of each eval kernel on the frame")
    for k, v in frame.items():
        if v.shape[0] != W * H or not torch.isfinite(torch.from_numpy(v)).all():
            raise SystemExit(f"frame map {k} is not finite or has shape {v.shape}")

    all_ids = torch.from_numpy(batch["instance_ids"]).to(dev)
    with torch.no_grad():
        for c in CHECK_CHUNKS:
            sl = slice(c * CHUNK, (c + 1) * CHUNK)
            ref = render_rays_plain(models, torch.from_numpy(batch["rays"][sl]).to(dev),
                                    settings, models.code_library(all_ids[sl]),
                                    matmul_dtype=torch.float32)
            got = torch.from_numpy(frame["rgb_fine"][sl]).to(dev)
            p = psnr(got, ref["rgb_fine"]).item()
            diffs = ", ".join(
                f"{k} {(torch.from_numpy(frame[k][sl]).to(dev) - v).abs().max().item():.2e}"
                for k, v in ref.items())
            print(f"chunk {c}: rgb_fine PSNR vs f32 plain {p:.2f} dB "
                  f"(floor {PSNR_FLOOR_DB:g}); max abs diff {diffs}")
            if not p >= PSNR_FLOOR_DB:
                raise SystemExit(f"chunk {c}: PSNR {p:.2f} dB below {PSNR_FLOOR_DB:g}")

    # -- 5. frame time ------------------------------------------------------------
    times = []
    for _ in range(FRAMES_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_image(models, settings, batch, chunk=CHUNK, device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    frame_ms = statistics.median(times) * 1e3
    print(f"frame: {frame_ms:.1f} ms median of {FRAMES_TIMED} "
          f"(all: {', '.join(f'{t * 1e3:.1f}' for t in times)}), "
          f"{W * H / (frame_ms / 1e3):.0f} rays/s; kernel bound "
          f"{n_chunks * (bound_ms['fused_coarse_weights'] + bound_ms['fused_render_tiles']):.1f} ms")

    # -- 6, 7. the training kernels and the training path ------------------------------
    torch.cuda.empty_cache()
    train_entries = _train_phases(torch, dev, peak_flops, peak_bytes,
                                  profile="--profile" in sys.argv[1:])

    # -- 8, 9, 10. the density kernel, the edit frame and the mesh sweep ----------------
    torch.cuda.empty_cache()
    sigma_entry, sigma_ms = _sigma_phase(torch, dev, models, cfg, peak_flops, peak_bytes)
    edit_launches, edit_mlp_err = _edit_phase(torch, dev, models, cfg, sigma_ms)
    mesh_launches = _mesh_phase(torch, dev, models, settings)
    sigma_entry["launches_by_path"] = {"edit": edit_launches["fused_sigma_eval"],
                                       "mesh": mesh_launches}
    sigma_entry["launches"] = sum(sigma_entry["launches_by_path"].values())
    for entry in train_entries:
        if entry["name"] == "fused_mlp_eval":
            entry["launches_by_path"] = {"train": entry["launches"],
                                         "edit": edit_launches["fused_mlp_eval"]}
            entry["launches"] = sum(entry["launches_by_path"].values())
            entry["max_abs_err"] = max(entry["max_abs_err"], edit_mlp_err)

    # -- 11. the kernels ------------------------------------------------------------
    replaces = {
        "fused_coarse_weights": "object_nerf_tpu/ops/pallas_mlp.py:845",
        "fused_render_tiles": "object_nerf_tpu/ops/pallas_mlp.py:639",
    }
    errs = {"fused_coarse_weights": err_c, "fused_render_tiles": err_f}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": "object_nerf_torch/ops/csrc/fused_mlp.cu",
         "replaces": replaces[k], "launches": launches[k], "max_abs_err": errs[k],
         "tol": KERNEL_TOL, "err_is": "max abs", "ms": ms[k], "plain_ms": plain_ms[k],
         "bound_ms": bound_ms[k], "bound_by": bound_by[k], "library_ms": None}
        for k in replaces
    ] + train_entries + [sigma_entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
