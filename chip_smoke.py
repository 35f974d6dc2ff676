#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths on random weights from a seed. Phases 3 to 10:
the deterministic eval render, the training step, the editable multi-object
render and the mesh-extraction density sweep of the flagship model with the
classical positional encoding (scene branch 8x256 with a skip at 4, object
branch 4x128 with a skip at 2, codes of 64, 64 coarse + 64 importance samples,
instance branch on). Phases 11 to 15: the eval render and the density sweep of
the same model with voxel conditioning (the reference's default: 16 scene + 8
instance voxel channels, 6 octaves, so the branches read 271 and 439 input
columns) on the ScanNet-scale room of the JAX package's bench (6 x 6 x 2.5 m,
0.1 m voxels, grid (63, 63, 27), corner table 114,688 rows x 192 channels),
and the three probe kernels of the voxel path. Phases 16 to 19: that model
trained on the room (the JAX package's voxel train step, bench.py:73-134),
pruned and subdivided, and its edit render. Phases 20 to 25: the shipped scene
configs (`config/synthetic_desk.yml`, `config/scannet_base_0113_multi.yml`)
through the train, eval and edit CLIs on a desk scene written to disk, the
`rays_in_bbox` route among them. Phases 26 and 27: data parallel over a
`torch.distributed` group (`object_nerf_torch/parallel/`), on the one card.
Phases 28 and 29: the offline tools on the same desk (the mesh CLI on phase
21's checkpoint, the scene viewer with that mesh, data preparation):

1. prints the card's name and power limit (`nvidia-smi`);
2. builds the CUDA kernels from `object_nerf_torch/ops/csrc/` (`nvcc`);
3. holds each eval kernel against its plain PyTorch version (bf16 operands,
   f32 sums: the kernels' own rounding points) on identical seeded inputs
   at the chunk shape of the eval path (each also against its own
   relaunch, bit for bit), times both, prints the weight bytes their
   forward chain copies from L2 per launch, times each in turns against the
   same function as a chain of torch calls (`scripts/profile_mlp.py`: per
   layer a bf16 `mm` on cuBLAS into f32, the bias and the activation, the
   skip concatenation, the heads and the compositing; first held to the
   plain version), and checks that the card's
   `sincosf` gives `sinf`'s and `cosf`'s bits (the chain's encoding takes
   both values of a pair from one `sincosf`);
4. renders one 640x480 frame of the synthetic scene with `render_image`
   (chunk 7680) and checks that both eval kernels ran 40 times, that the
   frame is finite, and that four of its chunks agree with the f32 plain
   path;
5. times the frame (median of a few, after a warm-up);
6. holds the backward's weight-gradient GEMM alone (wgmma on TMA-loaded
   operands) against torch on a random workspace, holds the training kernels
   `fused_mlp_eval` and `fused_mlp_bwd` against their plain versions at the
   training shapes (2048 rays x 64 and x 128 samples), each with a bit-equal
   relaunch, the backward on the cotangent of a real loss, prints the
   registers, spills, stack frames and wgmma serialization (`-Xptxas -v`)
   of the forward chain's ten instantiations and the backward's kernels and
   counts the wgmma (HGMMA) and TMA (UTMALDG) instructions in their machine
   code (`cuobjdump -sass`; each must issue both, ptxas must serialize none
   of their wgmma, and the chain must not spill), prints each chain
   instantiation's weight-ring
   stages and shared memory (also on the kernels line, under `ring`), prints
   the forward's weight stream, and
   times them (the backward split into its sweep, its weight-gradient GEMM
   and its reduction by `torch.profiler`), reads the memory one backward
   launch adds at its peak (held to its workspace and partials), and times
   both in turns against their torch chains (the backward's: `torch.autograd`
   of the forward chain on the same cotangent);
7. trains: an `ObjectNeRFSystem` on the synthetic scene (batch 2048, 64 + 64
   samples, perturbation and density noise on, Adam, poly schedule) takes
   one step through the kernels and the same step through the plain bf16
   path from identical weights and draws (loss and gradients compared),
   then 24 more steps: every loss finite, the loss falling, exactly two
   forward and two backward launches per step; times the step and reads its
   peak device memory;
8. holds the point-wise density kernel `fused_sigma_eval` against its plain
   version, both branches, at the edit chunk's 4096 x 64 points (a code per
   64, and one code for all of them as the mesh sweep calls it) and against
   its relaunch, bit for bit, times it (and in turns against its torch
   chain) and prints its weight stream;
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
11. holds the row gather `gather_rows` against `index_select` bit for bit,
   bf16 and f32, at the probe's shape (890,000-row table, 983,040 indices) and
   at the voxel path's (the bench grid's corner table, a chunk's 491,520 and
   983,040 real sample addresses), and times both; then the fused lookup
   `corner_lookup` at those samples against its plain chain (row index,
   weights and flag bit for bit; the sums within 1e-6 of their terms'
   magnitude, then bit for bit while ATen's reduction order is the one the
   kernel copies), both timed; every main path below reads its `gather_rows`
   launches beside its `corner_lookup` launches and fails on one;
12. holds `fused_coarse_weights`, `fused_render_tiles` and `fused_sigma_eval`
   with the voxel operand against their bf16 plain versions on identical
   seeded inputs (`voxel_raw` from the real lookup on the bench grid) at
   7680 x 64, 7680 x 128 and 262,144 points (both branches, a code per 64
   points and one for all; each against its relaunch, bit for bit), times
   them, and prints their weight streams;
13. renders one 640x480 voxel frame with `render_image` (chunk 7680; rays from
   mid-room, near 0.05, far 2.4): finite maps, exactly 40 + 40 kernel
   launches, 80 `corner_lookup` launches and one corner-table build; four chunks
   against `render_rays_plain` on the same bf16 table (gated) and on the
   all-f32 path (gated lower, distance printed); times the frame and prints
   how it splits into kernels, lookups, table build and the rest;
14. sweeps the room's density grid at 128^3 through the voxel lookup and
   `fused_sigma_eval`, scene branch and one object, each against the plain f32
   sweep, and times the 512^3 voxel sweep (under the same budget rule);
15. prints `pe_probe`'s registers, spills, stack frame and HGMMA / UTMALDG
   counts, holds it (each of its eight modes, a few tiles) and `scale_copy`
   against their plain versions and `pe_probe` against its relaunch at
   983,040 rows, bit for bit, drives them once as the probe scripts do, and
   holds four modes at 983,040 rows against the plain version over every row
   (and the same function as plain torch calls, the torch bf16 chain of
   `scripts/profile_pe_micro.py`) before it times them: `pe_probe` against
   that chain in turns (library, kernel, kernel, library; 3 rounds of 5
   launches), `scale_copy` against `torch.mul` (5 rounds of 200), the L2
   flushed before each turn, and prints both medians and their turns;
16. holds `fused_mlp_eval` and `fused_mlp_bwd` with the voxel operand against
   their plain versions at the training shapes (2048 x 64 and x 128, raw
   features from the step's bf16 corner table at real sample addresses), the
   backward on the cotangent of the real loss (weights, d_codes, d_voxel_raw)
   with a bit-equal relaunch, times them (the backward by kernel), reads one
   backward launch's peak memory, and times the step's table build, lookups
   and table gradient alone;
17. trains the voxel model (`ObjectNeRFSystem` on the room, batch 2048,
   64 + 64 samples, perturbation and noise on, Adam): one step through the
   kernels against the same step through the plain bf16 path (loss, every
   gradient, the table's included), then 24 + 10 more steps: 2 + 2 kernel
   launches, 2 lookups and one table build per step, the loss falling; times
   the step;
18. runs the progressive hooks: the epoch-3 prune (one density launch and one
   lookup per batch of 256 voxels), the epoch-5 prune and subdivision (grid to
   (126, 126, 54), still the dense route), and times 10 steps on the
   subdivided grid;
19. renders one 320x240 voxel edit frame with an `EditableRenderer` on the room
   (object 1 moved and carved out, chunk 4096): the launch counts of its plan,
   one table build, three chunks against `render_rays_multi` on the f32 plain
   path; times it;
20. writes the procedural desk at 640x480 in the ToyDesk layout (12 frames,
   every PNG row filter in use, and ScanNet's box files) under
   `logs/chip_smoke_scenes/` (removed at the end), decodes every PNG (bit-equal
   to the arrays written) and checks `GenericDataset`'s train buffers (schema;
   rays equal to `get_rays` of the centred poses; masks, weights and
   pass-through from the decoded maps), timing writing, decoding and the build;
21. runs `train.__main__.main` on `config/synthetic_desk.yml` at 640x480,
   batch 2048, for 30 steps and one validation (chunk 7680): 2 + 2 kernel
   launches, 2 lookups and one table build per step, 40 + 40 on the
   validation frame, every loss finite and falling, a checkpoint and the
   config and source snapshots written;
22. builds an `ObjectNeRFSystem` on `config/scannet_base_0113_multi.yml`'s keys
   pointed at the same scene, with `use_bbox_only_for_test=false` so that
   training takes the route: the route's fine `z_vals` differ from the scene
   pdf's; one step through the kernels against the plain bf16 step (and the
   plain f32 step as the control) from the same weights and draws, on the
   route and off it;
23. renders the validation frame on the route (rays that miss the box have
   near = far = 0): 40 `fused_mlp_eval` (7680 x 64, both branches, packed) and
   40 `fused_render_tiles` launches, no `fused_coarse_weights`, finite maps,
   four chunks against `render_rays_plain` on the bf16 table (and all-f32);
   holds `fused_mlp_eval` at that shape against its plain version and times
   it; times the frame in turns beside the same frame on the scene pdf;
24. runs `eval.main` on the step's checkpoint with `save_images` and re-reads
   the PNG;
25. runs `edit.__main__.main` for two frames on phase 21's checkpoint and
   re-reads the PNGs;
26. runs phase 21's train CLI under `torchrun --standalone --nproc_per_node=1`
   with `tpu.distributed=true`: NCCL at world size 1 (a real all-reduce a
   step, a real all-gather on the validation frame); one run directory (rank
   0's), the loss below phase 21's start, its wall time beside phase 21's;
27. starts two gloo ranks on the one card (`--dp-worker`; gloo stages the
   CUDA tensors of a collective through the host; two processes on one card
   measure correctness and overhead, not scaling): phase 7's system at batch
   2048 (1024 rays a rank) for three steps, its first step against phase 7's
   single-process kernel step (the loss to LOSS_TOL, every summed gradient to
   BWD_TOL of its largest entry), then phase 17's voxel system for three
   steps; the ranks' parameters, the table included, bit-equal; 2 + 2
   launches a step on each rank (2 lookups and 1 table build for the voxel
   model); the epoch-3 prune on both ranks against the single process's on
   the same weights, grid and draws; phases 4 and 13's 640x480 frames and
   phase 9's edit frame chunk-sharded, against the single process's frames
   (bit-equal, else phase 4's PSNR floor); prints each rank's step times and
   the gradient all-reduce's bytes and time;
28. runs the mesh CLI (`tools.extract_mesh.main`) on phase 21's desk
   checkpoint as a user would: first at 64^3 to read its densities and
   choose `sigma_threshold` (a high quantile of the positive ones), then at
   256^3 with it: one `fused_sigma_eval` launch, one `corner_lookup` launch a
   chunk of 262,144 points and one table build, counted exactly; two
   x-slices of its grid against the plain bf16 path; a non-empty mesh. Then
   the scene viewer CLI (`tools.scene_visualizer.main`) with that mesh, the
   desk's poses and boxes, to HTML and to PLY: the point, line and mesh
   layers' counts, the labels `obj 1` to `obj 3`, the PLY's point count;
   prints the sweep's ms and the viewer's host seconds;
29. (host only, no image library) writes a `.sens` capture of the desk's 12
   frames (its poses, depth from a seed, intrinsics from its focal length,
   colour bytes that nothing decodes), loads it and exports depth (native and
   halved), poses and intrinsics, each bit-equal to what was written; runs
   the label export (`data_prep.scannet_labels.main`) on a scan of the
   desk's point cloud with one segment a sphere: one box per instance, each
   containing its vertices; prints the seconds of each;
30. prints one JSON line describing all eight kernels (launch counts by
   path, the data-parallel runs' and the desk mesh's among them; for rows
   1-5 the torch chain's ms as `library_ms`), and, last, one JSON line
   naming the device.

Any failed check exits non-zero. Without CUDA, or run from a directory that
holds this file and nothing else of the repository, it exits non-zero and
prints no result. It imports nothing of JAX or of `object_nerf_tpu`.
"""

from __future__ import annotations

import json
import os
import shutil
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
# the weight-gradient GEMM alone vs torch's f32 product of the same bf16
# operands: the products are exact in f32, only the order of the sums differs
# (4096 terms: ~1e-6 of the largest entry); a wrong descriptor, swizzle or
# fragment mapping is off by O(1)
WGRAD_TOL = 1e-4
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

# voxel path: the frame of bench.py's voxel metric (bench.py:193-196, :216)
VOX_OBJ = 1
# voxel frame chunks vs render_rays_plain with bf16 operands on the SAME bf16
# corner table (the kernels' own rounding points: table in bf16, 8-corner sum
# in f32, encoding in f32, then bf16): what is left is the order of the f32
# sums, which moves a coarse weight by ~1e-5, hence an importance sample,
# hence the fine maps. Measured on an H100: 122.1 dB on every checked chunk
VOX_PSNR_FLOOR_DB = 90.0
# the same chunks vs the all-f32 path (f32 table, f32 products): a bf16
# feature is off by up to 2^-9 of its size and the top octave multiplies that
# by 2^5 inside a sine, so the encoded inputs themselves differ by ~1e-1 where
# features are large. On the bench rays only 13 % of the samples lie in
# occupied voxels, and the random model is smooth: measured 90.2 dB on an
# H100. The floor leaves 20 dB (a tenfold larger error) for other seeds and
# cards; features that are wrong where voxels are occupied move the colours of
# those rays by their own size and land far below it
VOX_F32_PSNR_FLOOR_DB = 70.0
# voxel mesh sweep: the room's own box (the classical sweep's +-1.5 cube lies
# mostly outside the grid, where every feature is 0)
VOX_MESH_RANGES = {"x_range": [-1.2, 1.2], "y_range": [-1.2, 1.2], "z_range": [-0.5, 0.5]}
# kernel sweep (f32 table as in the JAX package's sweep, bf16 products) vs the
# plain f32 sweep, max abs over the grid: as MESH_F32_TOL, with the 208 + 104
# encoded voxel columns rounded to bf16 on top; measured on an H100: 2.3e-4
# (scene) and 1.4e-3 (object)
VOX_MESH_F32_TOL = 5e-3
# probes: shapes of the JAX package's scripts
PROBE_ROWS, PROBE_TABLE_ROWS, PROBE_CHANNELS = 983040, 890000, 192
# scale_copy against torch.mul: rounds of four turns (library, kernel, kernel,
# library) and launches a turn, the 50 MB L2 flushed before each turn
# (pe_probe against the torch bf16 chain: profile_pe_micro's ROUNDS, LAUNCHES)
SC_ROUNDS, SC_LAUNCHES = 5, 200
PROBE_CHECK_ROWS = 128 * 5 + 17  # a few tiles and a ragged one
PROBE_TIMED_MODES = ("none", "combined", "combined_polysin", "split_polysin")
# pe_probe vs its plain version, max abs over the rows relative to the largest
# output: both round the same operands to bf16; their f32 sums run in another
# order (and the card's sinf differs from torch's in the last bit), which
# flips bf16 roundings that the 8-layer ReLU chain then carries; measured on
# an H100: 3.4e-4 (no encoding) to 1.9e-3 (all 348 columns encoded) over 657
# rows, 2.0e-3 to 3.0e-3 as the largest of all 983,040 rows
PROBE_REL_TOL = 1e-2

# voxel training (phases 16-18). d_voxel_raw is per sample: no sum over rows
# averages its bf16 roundings out as they average out of a weight gradient, and
# each entry is a cancelling sum over 208 or 104 encoded columns whose top
# octave multiplies by 32. The bf16 plain version itself is 11-22 % of the
# largest entry from f32 in max abs (3-8 % in norm), and a rounding that flips
# in one of two bf16 computations moves one row by up to 10 % of the largest
# entry; the drift grows with depth (in norm: 1-2e-4 with one layer per branch,
# 5-8e-4 with two, 1-9e-3 at 8 + 4; measured on an H100 over 2368 and 131,072
# rows). That is on random-sign cotangents; on the real loss's cotangent
# (phase 16) the max abs reads 3.5e-4 of the largest entry. So d_voxel_raw is
# held in max abs within BWD_TOL of its largest entry, as every other output
# of the backward, and besides in the norm of the difference relative to the
# plain version's norm: within 5e-3, and within a quarter of the plain
# version's own distance to f32; a wrong column, piece or octave is off by
# O(1) in both
VOX_DVOX_NORM_TOL = 5e-3
# a whole voxel step, kernels vs plain bf16 path, per MLP gradient tensor:
# the classical backward's limit (ROADMAP.md section 3)
VOX_STEP_GRAD_TOL = 5e-3
# ... and the table's gradient, which sums the per-sample d_voxel_raw of both
# passes (a row of a voxel that few samples reach carries their drift; the
# card's index_add_ sums in no fixed order): within 1e-2 of its largest
# entry, and within a quarter of the plain bf16 step's own distance to the
# plain f32 step (the control printed beside it)
VOX_TABLE_GRAD_TOL = 1e-2
VOX_SUBDIV_STEPS = 10
# the prune's decisions, card vs plain f32 on the card, on the same jitter:
# samples per voxel of the check (the hook takes the config's 4096), the
# threshold is the median of the card's per-voxel alphas (the room's field,
# with the raised sigma biases, has alpha ~0.63 everywhere, so the hook's 0.5
# drops nothing); voxels whose plain alpha lies within this margin of the
# threshold may go either way (bf16 products move a density by ~2e-4, an
# alpha by less)
PRUNE_CHECK_SPV = 256
PRUNE_ALPHA_MARGIN = 1e-3
# voxel edit chunks (phase 19) vs render_rays_multi with bf16 operands on the
# frame's own bf16 corner table: the maps at phase 9's EDIT_MAP_TOL, the colour
# at 80 dB. Not phase 13's 90 dB: the edit path's kernels return raw outputs
# (fused_sigma_eval, fused_mlp_eval), which differ from their plain versions
# by up to 7.4e-4 on the object branch's densities (phases 12, 16; the eval
# kernels' composited outputs by 5e-6 to 4e-5), and the object densities,
# whose biases are not raised, sit near 0, where the ReLU and the 1e10 last
# delta carry that to whole samples of a few rays. Measured on an H100: 88.3
# and 99.8 dB, opacity within 3.8e-3, depth within 1.1e-2; a wrong code row, a
# swapped branch or a wrong voxel column moves the colours by their own size
VOX_EDIT_BF16_PSNR_FLOOR_DB = 80.0
# against the f32 plain path (f32 table, f32 products): colour
# at EDIT_PSNR_FLOOR_DB and depth at phase 9's limit; opacity looser than
# phase 9's 5e-3: the frame reads the bf16 corner table, whose features are
# off by up to 2^-9 of their size, which the top octave's sine multiplies by
# 32 (measured on an H100: 5.7e-3 on a chunk whose 4096 rays all hit the
# object's box, at 80.6 dB; the classical frame's chunks: 8.6e-4)
VOX_EDIT_MAP_TOL = {"opacity_fine": 2e-2, "depth_fine": 5e-2}
VOX_ROOM_GRID = (63, 63, 27)  # the room's grid at 0.1 m (bench.py:156-178)

# scene configs (phases 20-25): the procedural desk written to disk in the
# ToyDesk layout (and ScanNet's box files) at 640x480, a dozen frames (ten
# train, the last the validation frame), every PNG row filter in use
SCENE_FRAMES = 12
SCENE_STEPS = 30  # train CLI steps of phase 21, one validation after the last
SCENE_ID = "scene0113_00"
SCENE_EDIT_FRAMES = 2
# phase 28: the mesh CLI's grid on the desk checkpoint, and the coarse grid
# whose densities choose its sigma_threshold
DESK_MESH_GRID, DESK_MESH_PROBE_GRID = 256, 64
DESK_MESH_QUANTILE = 0.99
# the scannet-keyed step's table gradient, kernels vs plain bf16, relative to
# its largest entry: within this fraction of the plain bf16 step's own
# distance to the plain f32 step (phase 17's relative limit). Phase 17's
# absolute 1e-2 was set on the room's grid; on the desk's grid two correct
# bf16 steps drift 5.5e-3 to 2.3e-2 apart, with and without the route, at
# 0.06 to 0.20 of that distance (measured on an H100 over three batches,
# `python -m object_nerf_torch.scripts.profile_route_step`)
ROUTE_TABLE_GRAD = 0.25
# the fused lookup's 8-corner sums against the plain chain's, relative to the
# sum of their terms' magnitudes: two orders of an 8-term f32 sum differ by at
# most about 14 x 2^-24 of it
LOOKUP_SUM_TOL = 1e-6

# data parallel (phases 26-27): the card's machine has one card and NCCL takes
# one rank per card, so phase 26 runs the train CLI on NCCL at world size 1 and
# phase 27 runs two gloo ranks on the one card (gloo stages the CUDA tensors of
# a collective through the host): they check the semantics and show the
# overhead, not scaling
DP_RANKS = 2
DP_STEPS = 3
DP_TIMEOUT_S = 600
DP_ALLREDUCE_TIMED = 5

def _repo_root() -> str:
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "object_nerf_torch")):
        raise SystemExit(f"chip_smoke.py: no object_nerf_torch package beside {__file__}")
    return root


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


def _macs_per_sample(cfg, coarse: bool, k0=None) -> int:
    """Multiply-adds of one sample through the model's layers. `k0`: the
    (scene, object) input columns counted at layer 0 and the skip layers
    (default: the model's own; the kernels' padded tile for the count they
    actually perform)."""
    c_s, c_o = k0 or (cfg.in_channels_xyz, cfg.inst_channel_in)

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

    m = branch(cfg.W, cfg.D, cfg.skips, c_s, heads=not coarse)
    if not coarse:
        m += branch(cfg.inst_W, cfg.inst_D, cfg.inst_skips, c_o, heads=True)
    return m


def _bwd_macs_per_sample(cfg, k0=None, grad_cols=None) -> int:
    """Multiply-adds of one sample row through the backward: the forward
    recompute, one product per weight for its gradient, and the input
    gradients that have a consumer. `grad_cols`: the (scene, object) input
    columns whose gradient has a consumer, at layer 0 and the skip layers
    (default: none of the scene's, the object's code columns, a classical
    model's; a voxel model's are `_voxel_grad_cols`)."""

    def input_grads(width, depth, skips, c_need):
        m = 0
        for i in range(depth):
            if i > 0:
                m += width * width  # the hidden rows
            if i == 0 or i in skips:
                m += c_need * width  # the input rows that need a gradient
        # sigma head, final, direction layer's hidden part, rgb head
        return m + width + width * width + width * (width // 2) + (width // 2) * 3

    g_s, g_o = grad_cols or (0, cfg.N_obj_code_length)
    fwd = _macs_per_sample(cfg, False, k0)
    return (2 * fwd + input_grads(cfg.W, cfg.D, cfg.skips, g_s)
            + input_grads(cfg.inst_W, cfg.inst_D, cfg.inst_skips, g_o))


def _voxel_grad_cols(cfg):
    """(scene, object) input columns of a voxel model whose gradient has a
    consumer: the encoded scene voxel features, and those plus the encoded
    object voxel features and the code (the xyz encoding's get none)."""
    n = 2 * cfg.N_freq_voxel + 1
    return (cfg.N_scn_voxel_size * n,
            (cfg.N_scn_voxel_size + cfg.N_obj_voxel_size) * n + cfg.N_obj_code_length)


def _rel(got, want) -> float:
    return ((got - want).abs().max() / (want.abs().max() + 1e-30)).item()


def _nrel(got, want) -> float:
    return ((got - want).norm() / (want.norm() + 1e-30)).item()


# ptxas's notes that it serialized a kernel's wgmma
WGMMA_SERIALIZED = ("(C7510)", "(C7512)", "(C7515)")
# the backward's three kernels, by a piece of their (mangled or demangled) names
BWD_KERNELS = {"sweep": "mlp_bwd_kernel", "weight_gradient": "wgrad_kernel",
               "reduction": "reduce_segments_kernel"}


def _ptxas_resources(names):
    """{piece of a kernel name: {"registers", "spill_stores", "spill_loads",
    "stack_frame" (bytes), "wgmma_serialized" (ptxas's C7510, C7512 or
    C7515: it serialized the kernel's wgmma because their pipeline crosses a
    function call, for want of registers, or because other instructions
    define accumulator registers inside it)}}
    from the `-Xptxas -v` report kept beside the built library."""
    import re

    from object_nerf_torch.ops import _build

    found, current = {}, None
    for line in _build.library_path().with_suffix(".log").read_text().splitlines():
        if any(code in line for code in WGMMA_SERIALIZED):
            for k in names:
                if k in line:
                    found.setdefault(k, {})["wgmma_serialized"] = True
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([^' ]+)", line)
        if m:
            current = next((k for k in names if k in m.group(1)), None)
            continue
        if current is None:
            continue
        entry = found.setdefault(current, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            entry.update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                         spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
    missing = [k for k in names if "registers" not in found.get(k, {})]
    if missing:
        raise SystemExit(f"no ptxas report for {missing} in the build log")
    for k in names:
        found[k].setdefault("wgmma_serialized", False)
    return found


def _sass_counts(names, opcodes=("HGMMA", "UTMALDG")):
    """{piece of a kernel name: {opcode: count}} from `cuobjdump -sass` of
    the built library: what the compiler emitted for each kernel."""
    import shutil

    from object_nerf_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.library_path())], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, current = {k: {op: 0 for op in opcodes} for k in names}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((k for k in names if k in line), None)
        elif current is not None:
            for op in opcodes:
                if op in line:
                    counts[current][op] += 1
    return counts


def _bwd_split_ms(run, n: int):
    """Device ms per launch of each of the backward's three kernels, from
    torch.profiler over n launches of `run` (None where it saw none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    run()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    split = {k: 0.0 for k in BWD_KERNELS}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for part, piece in BWD_KERNELS.items():
                if piece in e.key:
                    split[part] += e.self_device_time_total / 1e3 / n
    return {k: (v if v > 0 else None) for k, v in split.items()}


def _fmt_split(split) -> str:
    return ", ".join(f"{k} " + ("not measured" if v is None else f"{v:.3f} ms")
                     for k, v in split.items())


# the kernels that issue wgmma, as the build names them: the forward chain's
# ten instantiations (fwd_chain_kernel<VOX, MODE>: fused_mlp_eval,
# fused_render_tiles, fused_coarse_weights and fused_sigma_eval's two
# branches, classical and voxel), the backward's sweep (two), its
# weight-gradient GEMM, pe_probe's kernel; then the reduction, which has no
# product
CHAIN_MODES = {0: "fused_mlp_eval", 1: "fused_render_tiles", 2: "fused_coarse_weights",
               3: "fused_sigma_eval scene", 4: "fused_sigma_eval object"}  # FWD_* in the source
# the chain's instantiations by label: (voxel, mode)
CHAIN_LABELS = {f"forward chain, {name} {model}": (vox, mode) for mode, name in CHAIN_MODES.items()
                for vox, model in ((0, "classical"), (1, "voxel"))}
WGMMA_INSTANTIATIONS = {
    **{label: f"fwd_chain_kernelILb{vox}ELi{mode}E" for label, (vox, mode) in CHAIN_LABELS.items()},
    "sweep, classical": "mlp_bwd_kernelILb0", "sweep, voxel": "mlp_bwd_kernelILb1",
    "weight gradient": "wgrad_kernel", "pe_probe": "pe_probe_wg_kernel"}
BUILD_INSTANTIATIONS = {**WGMMA_INSTANTIATIONS, "reduction": "reduce_segments_kernel"}


def _build_line(label, key, r, counts) -> str:
    """One kernel's line of the build report: ptxas figures `r`, SASS `counts`."""
    return (f"{label} ({key}): {r['registers']} registers, {r.get('spill_stores', 0)} bytes "
            f"spill stores, {r.get('spill_loads', 0)} bytes spill loads, "
            f"{r.get('stack_frame', 0)} bytes stack frame, wgmma serialized by ptxas: "
            f"{r['wgmma_serialized']}; SASS: " + ", ".join(f"{n} {op}" for op, n in counts.items()))


def _build_report():
    """Print the registers, spills, stack frame and wgmma serialization of
    the kernels on wgmma (and the backward's reduction), the tensor-core and
    TMA instructions in their machine code, and each forward-chain
    instantiation's weight-ring stages and shared memory
    (`fwd_chain.chain_layout`); fail unless each of them issues wgmma (HGMMA)
    and TMA loads (UTMALDG) and ptxas serialized none of their wgmma, or if
    a forward-chain instantiation spills.
    Returns {label: ptxas figures}, {label: SASS counts}, {label: ring}."""
    from object_nerf_torch.ops import fwd_chain

    res = _ptxas_resources(list(BUILD_INSTANTIATIONS.values()))
    sass = _sass_counts(list(BUILD_INSTANTIATIONS.values()))
    ring = {}
    for label, (vox, mode) in CHAIN_LABELS.items():
        stages, smem = fwd_chain.chain_layout(bool(vox), fwd_chain.CHAIN_MODES[mode])
        ring[label] = {"stages": stages, "smem_bytes": smem}
    for label, key in BUILD_INSTANTIATIONS.items():
        line = _build_line(label, key, res[key], sass[key])
        if label in ring:
            line += (f"; weight ring {ring[label]['stages']} stages, "
                     f"{ring[label]['smem_bytes']} bytes of shared memory")
        print(line)
    for label, key in WGMMA_INSTANTIATIONS.items():
        got = sass[key]
        if not (got["HGMMA"] > 0 and got["UTMALDG"] > 0):
            raise SystemExit(f"{label} issues no wgmma or no TMA load: {got}")
        if res[key]["wgmma_serialized"]:
            raise SystemExit(f"ptxas serialized the wgmma of {label} (C7510 / C7512 / C7515)")
        if label in CHAIN_LABELS and (res[key].get("spill_stores") or res[key].get("spill_loads")):
            raise SystemExit(f"{label} spills registers: {res[key]}")
    return ({k: res[v] for k, v in BUILD_INSTANTIATIONS.items()},
            {k: sass[v] for k, v in BUILD_INSTANTIATIONS.items()}, ring)


def _weight_stream(packed, n_rows: int, ms: float, mode: str) -> str:
    """The forward chain's weight stream of one launch, for a printed line:
    every block copies each chunk of the tile's chunk list from L2 into
    shared memory once per tile (`forward_weight_bytes`), and the rate that
    implies at the measured time. A figure of the design: the kernels line's
    bound counts the packed weights once."""
    from object_nerf_torch.ops import fwd_chain

    per_tile = fwd_chain.forward_weight_bytes(packed, mode)
    n_tiles = -(-n_rows // 128)
    total = per_tile * n_tiles
    return (f"weight stream: {n_tiles} tiles x {per_tile / 1e6:.3f} MB = {total / 1e9:.2f} GB "
            f"copied from L2 into shared memory per launch, {total / ms / 1e9:.2f} TB/s at "
            f"{ms:.3f} ms")


def _bwd_launch_peak(run, plan, packed, inputs: int) -> int:
    """The device memory one backward launch adds at its peak, read by
    `max_memory_allocated` around one launch of `run`: it must hold the
    workspace of `plan` and its partials, and hold nothing more than those,
    the gradients three times over (the f32 buffer in the packed layout, the
    zeros each parameter's gradient starts from, their unpacked copies),
    outputs as large as the `inputs` bytes (d_codes, d_voxel_raw) and 1 MiB
    of small tables."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    need = plan.layout.nbytes + 4 * plan.n_parts
    outputs = 12 * (packed.w.numel() + packed.b.numel()) + inputs
    if not need <= peak <= need + outputs + 2 ** 20:
        raise SystemExit(f"one backward launch adds {peak} bytes at its peak; its workspace "
                         f"and partials are {need} bytes, its outputs at most {outputs}")
    return peak


def _bwd_report(plan, split, peak: int, rows_of_acts: int, peak_bytes: float) -> str:
    """The backward's split by kernel, its workspace (the layout's size and
    the measured peak of one launch) and its own traffic, for a printed
    line."""
    design = _bwd_design_bytes(plan, rows_of_acts)
    return (f"; by kernel: {_fmt_split(split)}; workspace {plan.layout.nbytes / 1e9:.3f} GB "
            f"by its layout, one launch adds {peak / 1e9:.3f} GB at its peak (measured); "
            f"{len(plan.work.items)} weight-gradient items over {len(plan.work.slices)} row "
            f"slices; its own workspace and partial traffic {design / 1e9:.2f} GB = "
            f"{design / peak_bytes * 1e3:.3f} ms at the memory rate")


def _bwd_design_bytes(plan, rows_of_acts: int) -> int:
    """Device-memory traffic of the backward's own making: the workspace
    written once, the activations read back by the sweep, every item's
    boxes read by the weight-gradient kernel, the partials written and
    read by the reduction."""
    work = plan.work
    read = sum((it[2] + it[3]) * (it[5] - it[4]) * 2 for it in work.items)
    return (plan.layout.nbytes + rows_of_acts + read + 8 * work.n_floats
            + 8 * plan.n_blocks * plan.small_stride)


def _loss_cotangent(outs, typ, z, noise, noise_inst, settings, batch, loss_weights):
    """g (n*S, 8) of the training loss with respect to one pass's MLP outputs
    `outs` = (sigma, rgb, inst_sigma, inst_rgb) (the bf16 plain forward's)."""
    import torch

    from object_nerf_torch.ops.compositing import composite, composite_instance
    from object_nerf_torch.train.losses import total_loss

    outs = [o.detach().requires_grad_() for o in outs]
    scene = composite(outs[0], outs[1], z, noise_std=1.0, noise=noise)
    inst = composite_instance(outs[2], outs[3], z, scene.depth, noise_std=1.0,
                              frustum_bound_th=settings.frustum_bound_th,
                              pass_through_mask=batch["pass_through_mask"], noise=noise_inst)
    results = {f"rgb_{typ}": scene.rgb, f"depth_{typ}": scene.depth,
               f"rgb_instance_{typ}": inst.rgb, f"depth_instance_{typ}": inst.depth,
               f"opacity_instance_{typ}": inst.opacity}
    total_loss(results, batch, loss_weights)[0].backward()
    n, s = z.shape
    return torch.cat([outs[0].grad.reshape(n * s, 1), outs[1].grad.reshape(n * s, 3),
                      outs[2].grad.reshape(n * s, 1), outs[3].grad.reshape(n * s, 3)],
                     dim=-1).contiguous()


def _eval_model(torch, dev, voxel: bool):
    """The eval paths' model, random from SEED with the raised scene
    densities (DENSITY_BIAS): the classical one of phases 3-10, or the
    voxel-conditioned one (the reference's default) on the room's grid of
    phases 11-15. Returns (eval settings, models, (topology, static) or
    None)."""
    from object_nerf_torch.models.mlp import ObjectNeRFConfig
    from object_nerf_torch.render.renderer import RenderSettings
    from object_nerf_torch.scripts._fixtures import bench_grid
    from object_nerf_torch.train.system import init_params

    cfg = ObjectNeRFConfig(use_voxel_embedding=voxel)
    settings = RenderSettings(mlp=cfg, N_samples=N_SAMPLES, N_importance=N_IMPORTANCE,
                              perturb=0.0, noise_std=0.0, is_eval=True, forward_instance=True)
    features, grid = None, None
    if voxel:
        features, topo, static = bench_grid(cfg, dev, seed=SEED + 2)
        grid = (topo, static)
    models = init_params(torch.Generator().manual_seed(SEED), settings, {"N_max_objs": 64},
                         device=dev, voxel_features=features)
    with torch.no_grad():
        for m in (models.nerf_coarse, models.nerf_fine):
            m.sigma.bias += DENSITY_BIAS
    return settings, models, grid


def _frame_batch(voxel: bool):
    """The 640x480 frame's rays and instance ids: the synthetic scene's first
    validation view (phase 4), or rays from mid-room (phase 13)."""
    import numpy as np

    from object_nerf_torch.data import dataset_dict
    from object_nerf_torch.scripts._fixtures import bench_rays

    if not voxel:
        return dataset_dict["synthetic"]("val", img_wh=(W, H)).whole_image_batch(0)
    return {"rays": bench_rays(W * H, seed=0),
            "instance_ids": np.random.RandomState(SEED).randint(0, 64, W * H)}


def _train_system(torch, dev):
    """Phase 7's `ObjectNeRFSystem` (the synthetic scene, batch 2048, 64 + 64
    samples, perturbation and noise on, Adam, poly schedule) with the raised
    scene densities."""
    from object_nerf_torch.config import load_config
    from object_nerf_torch.data import dataset_dict
    from object_nerf_torch.train.system import ObjectNeRFSystem

    config = load_config(cli_args=[
        f"dataset_config={os.path.join(_repo_root(), 'config', 'synthetic.yml')}",
        f"train.batch_size={BATCH}", f"model.N_samples={N_SAMPLES}",
        f"model.N_importance={N_IMPORTANCE}", "model.perturb=1", "model.noise_std=1",
        "train.optimizer=adam", "train.lr_scheduler=poly", f"train.seed={SEED}",
        "train.num_epochs=5", "train.nan_check_every=1000000"])
    kw = dict(img_wh=tuple(config.img_wh), dataset_extra=config.dataset_extra)
    system = ObjectNeRFSystem(config, dataset=dataset_dict["synthetic"]("train", **kw),
                              val_dataset=dataset_dict["synthetic"]("val", **kw), device=dev)
    with torch.no_grad():
        for m in (system.models.nerf_coarse, system.models.nerf_fine):
            m.sigma.bias += DENSITY_BIAS
    return system


def _voxel_train_system(torch, dev, tmp):
    """Phase 17's voxel-conditioned `ObjectNeRFSystem` on the room (its point
    cloud written under `tmp`; progressive training on) with the raised
    scene densities."""
    from object_nerf_torch.config import load_config
    from object_nerf_torch.data import dataset_dict
    from object_nerf_torch.data.ply_io import write_ply
    from object_nerf_torch.scripts._fixtures import SCENE, scannet_scale_pcd
    from object_nerf_torch.train.system import ObjectNeRFSystem

    pcd = os.path.join(tmp, "room.ply")
    write_ply(pcd, scannet_scale_pcd())
    config = load_config(cli_args=[
        f"dataset_config={os.path.join(_repo_root(), 'config', 'synthetic.yml')}",
        "img_wh=[64,48]", f"train.batch_size={BATCH}", f"model.N_samples={N_SAMPLES}",
        f"model.N_importance={N_IMPORTANCE}", "model.perturb=1", "model.noise_std=1",
        "model.use_voxel_embedding=true", "model.N_max_voxels=800000",
        "train.optimizer=adam", "train.lr_scheduler=poly", f"train.seed={SEED}",
        "train.num_epochs=6", "train.nan_check_every=1000000",
        "train.progressive_train=true", f"dataset_extra.pcd_path={pcd}",
        f"dataset_extra.scale_factor={SCENE['scale_factor']}",
        "dataset_extra.scene_center=[" + ",".join(map(str, SCENE["scene_center"])) + "]",
        f"dataset_extra.voxel_size={SCENE['voxel_size_world']}",
        f"dataset_extra.neighbor_marks={SCENE['neighbor_marks']}",
        "dataset_extra.near=0.05", "dataset_extra.far=2.4"])
    kw = dict(img_wh=(64, 48), dataset_extra=config.dataset_extra)
    system = ObjectNeRFSystem(config, dataset=dataset_dict["synthetic"]("train", n_frames=2,
                                                                        **kw), device=dev)
    with torch.no_grad():
        for m in (system.models.nerf_coarse, system.models.nerf_fine):
            m.sigma.bias += DENSITY_BIAS
    return system


def _train_phases(torch, dev, peak_flops, peak_bytes):
    """Phases 6 and 7; returns the two training kernels' entries for the
    `kernels` line, the build report of the forward chain's kernels and the
    first step's loss and gradients, and prints everything else."""
    import copy

    from object_nerf_torch.models.embedding import freq_encode
    from object_nerf_torch.ops import fused_mlp, fwd_chain
    from object_nerf_torch.ops import fused_mlp_vjp as fv
    from object_nerf_torch.ops.compositing import composite
    from object_nerf_torch.ops.sampling import merge_z_vals, sample_pdf, stratified_sample
    from object_nerf_torch.render.renderer import RenderDraws
    from object_nerf_torch.scripts import profile_mlp as pm
    from object_nerf_torch.train.optim import make_optimizer
    from object_nerf_torch.train.system import graph_counts, make_train_step

    system = _train_system(torch, dev)
    config = system.config
    models, settings, cfg = system.models, system.settings, system.settings.mlp
    rng = system.batch_rng
    batch = system._device_batch(system.train_dataset.sample_batch(BATCH, rng))
    draws = RenderDraws.sample(settings, BATCH, dev, system.generator)

    # -- 6. the training kernels against their plain versions -----------------------
    # first the backward's weight-gradient GEMM alone (wgmma on TMA-loaded
    # MN-major operands) against torch on a random workspace: every item
    # shape the work lists use, boxes away from column and row 0
    gen = torch.Generator().manual_seed(SEED)
    ws = torch.randn(4096, 1024, generator=gen).bfloat16().to(dev)
    items, off = [], 0
    for i, (m, n) in enumerate(((64, 64), (64, 128), (128, 64), (128, 128), (128, 256))):
        items.append([64 * i, 512 + 64 * i, n, m, 64 * i, 4096 - 128 * i, off, 0])
        off += m * n
    got = fv.wgrad_gemm(ws, torch.tensor(items, dtype=torch.int32, device=dev), off)
    want = fv.wgrad_gemm_plain(ws, items, off)
    torch.cuda.synchronize()
    e = _rel(got, want)
    print(f"weight-gradient GEMM (wgmma, TMA) on a random (4096, 1024) workspace, items "
          f"(m, n) in {sorted({(it[3], it[2]) for it in items})}: max |kernel - torch f32| / "
          f"max |torch| = {e:.2e} (tol {WGRAD_TOL:g})")
    if not e <= WGRAD_TOL:
        raise SystemExit(f"the weight-gradient GEMM disagrees with torch: {e:.3e}")
    del ws, got, want
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
        with torch.no_grad():
            outs = fv.mlp_eval_plain(model, cfg, xyz, dir_pe, codes)
        return _loss_cotangent(outs, typ, z, noise, noise_inst, settings, batch,
                               dict(config.loss))

    names = ("sigma", "rgb", "inst_sigma", "inst_rgb")
    ms = {"fused_mlp_eval": {}, "fused_mlp_bwd": {}}
    plain_ms = {"fused_mlp_eval": {}, "fused_mlp_bwd": {}}
    library = {"fused_mlp_eval": {}, "fused_mlp_bwd": {}}  # the torch chains, in turns
    errs = {"fused_mlp_eval": 0.0, "fused_mlp_bwd": 0.0}
    split = {}  # samples per ray -> the backward's ms by kernel
    launch_peak = {}  # samples per ray -> the bytes one backward launch adds at its peak
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    pack_ms = 0.0
    for s_, (model, typ, xyz, z, noise, noise_inst) in shapes.items():
        with torch.no_grad():
            packed = fwd_chain.pack_kernel_weights(model, cfg, True)
            got = fv.fused_mlp_eval(model, cfg, xyz, dir_pe, codes)
            again = fv.fused_mlp_eval(model, cfg, xyz, dir_pe, codes)
            want = fv.mlp_eval_plain(model, cfg, xyz, dir_pe, codes)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise SystemExit("two launches of fused_mlp_eval on the same inputs differ")
            e = {k: (a - b).abs().max().item() for k, a, b in zip(names, got, want)}
            print(f"fused_mlp_eval {tuple(xyz.shape)}: max |kernel - plain bf16| "
                  + ", ".join(f"{k} {v:.2e}" for k, v in e.items()) + f" (tol {KERNEL_TOL:g}); "
                  "relaunch bit-equal")
            errs["fused_mlp_eval"] = max(errs["fused_mlp_eval"], *e.values())
        g = real_cotangent(model, typ, xyz, z, noise, noise_inst)
        with torch.no_grad():
            grads, d_codes, _ = fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, g, packed=packed)
            again = fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, g, packed=packed)
            want_g, want_c, _ = fv.mlp_bwd_plain(model, cfg, xyz, dir_pe, codes, g)
            torch.cuda.synchronize()
        same = torch.equal(again[1], d_codes) and all(torch.equal(again[0][k], grads[k])
                                                      for k in grads)
        del again
        if not same:
            raise SystemExit("two launches of the backward on the same inputs differ")
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
              f"{statistics.median(e.values()):.2e}; plain bf16 vs f32 autograd {e32:.2e}; "
              f"relaunch bit-equal: {same}")
        errs["fused_mlp_bwd"] = max(errs["fused_mlp_bwd"], e[worst])
        with torch.no_grad():
            ms["fused_mlp_eval"][s_] = _cuda_ms(
                lambda: fv._launch_eval(cfg, xyz, dir_pe, codes, packed, torch.bfloat16, True,
                                        True),
                TIMED_LAUNCHES)
            print(f"fused_mlp_eval {tuple(xyz.shape)}: "
                  + _weight_stream(packed, BATCH * s_, ms["fused_mlp_eval"][s_], "eval"))
            ms["fused_mlp_bwd"][s_] = _cuda_ms(
                lambda: fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, g, packed=packed),
                TIMED_LAUNCHES)
            split[s_] = _bwd_split_ms(
                lambda: fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, g, packed=packed),
                TIMED_LAUNCHES)
            rows = BATCH * s_
            launch_peak[s_] = _bwd_launch_peak(
                lambda: fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, g, packed=packed),
                fv.bwd_plan(packed, cfg, rows, n_sm, min(rows // 128, n_sm)), packed,
                4 * codes.numel())
            plain_ms["fused_mlp_eval"][s_] = _cuda_ms(
                lambda: fv.mlp_eval_plain(model, cfg, xyz, dir_pe, codes), 3)
            plain_ms["fused_mlp_bwd"][s_] = _cuda_ms(
                lambda: fv.mlp_bwd_plain(model, cfg, xyz, dir_pe, codes, g), 3)
            pack_ms = _cuda_ms(lambda: fwd_chain.pack_kernel_weights(model, cfg, True), 10)
            chain = pm.chain_layers(model)[0]
            library["fused_mlp_eval"][s_] = _library_turns(
                f"fused_mlp_eval {tuple(xyz.shape)}",
                lambda: fv._launch_eval(cfg, xyz, dir_pe, codes, packed, torch.bfloat16, True,
                                        True),
                lambda: pm.torch_mlp_eval(chain, cfg, xyz, dir_pe, codes), want)
            chain, leaves = pm.chain_layers(model, grad=True)
            library["fused_mlp_bwd"][s_] = _library_turns(
                f"fused_mlp_bwd {tuple(xyz.shape)} (the chain: torch.autograd, same cotangent)",
                lambda: fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, g, packed=packed),
                lambda: pm.torch_mlp_bwd(chain, leaves, cfg, xyz, dir_pe, codes, g),
                (want_g, want_c), BWD_TOL,
                lambda got, w: max(max(_rel(got[0][k], w[0][k]) for k in w[0]),
                                   _rel(got[1], w[1])))
            del chain, leaves
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
    # traffic (the workspace written, read back by the sweep and by the
    # weight-gradient kernel, the partials) is printed beside it.
    acts_row = 2 * (cfg.D * cfg.W + cfg.inst_D * cfg.inst_W)  # read back for the masks
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
                plan = fv.bwd_plan(packed, cfg, rows, n_sm, min(rows // 128, n_sm))
                extra = _bwd_report(plan, split[s_], launch_peak[s_], rows * acts_row,
                                    peak_bytes)
            print(f"{name} ({BATCH}, {s_}): {ms[name][s_]:.3f} ms/launch, plain "
                  f"{plain_ms[name][s_]:.3f} ms, bound {bound[s_]:.3f} ms ({by[s_]}: "
                  f"{2 * macs * rows / 1e12:.3f} TFLOP, {nbytes / 1e6:.1f} MB), "
                  f"{2 * macs * rows / ms[name][s_] / 1e9:.1f} TFLOP/s achieved{extra}")
        entries.append({
            "name": name, "route": "cuda",
            "source": ("object_nerf_torch/ops/csrc/fused_mlp_wg.cuh" if name == "fused_mlp_eval"
                       else "object_nerf_torch/ops/csrc/fused_mlp_train.cu"),
            "replaces": ("object_nerf_tpu/ops/pallas_mlp.py:287" if name == "fused_mlp_eval"
                         else "object_nerf_tpu/ops/pallas_mlp_vjp.py:72"),
            "max_abs_err": errs[name], "tol": KERNEL_TOL if name == "fused_mlp_eval" else BWD_TOL,
            "err_is": ("max abs" if name == "fused_mlp_eval"
                       else "max abs / largest reference entry, per gradient tensor"),
            # one step launches each kernel once per shape: the sum is its cost
            "ms": sum(ms[name].values()), "plain_ms": sum(plain_ms[name].values()),
            "bound_ms": sum(bound.values()), "bound_by": by[N_SAMPLES],
            "library_ms": sum(v["library_ms"] for v in library[name].values()),
            "library": (pm.LIBRARY if name == "fused_mlp_eval" else
                        f"torch.autograd of the {pm.LIBRARY} (its products' backward on cuBLAS "
                        "in bf16 with f32 sums)"),
            "ms_in_turns": sum(v["ms_in_turns"] for v in library[name].values()),
            "library_max_abs_err": max(v["library_max_abs_err"] for v in library[name].values()),
            "library_ms_by_samples": {k: v["library_ms"] for k, v in library[name].items()},
            "ms_by_samples": ms[name], "bound_ms_by_samples": bound,
        })
    entries[1]["split_ms_by_samples"] = split
    entries[1]["launch_peak_bytes_by_samples"] = launch_peak
    ptxas, sass, ring = _build_report()
    for entry, labels in ((entries[0], [k for k in ptxas if "fused_mlp_eval" in k]),
                          (entries[1], ["sweep, classical", "sweep, voxel", "weight gradient",
                                        "reduction"])):
        entry["ptxas"] = {k: ptxas[k] for k in labels}
        entry["sass_counts"] = {k: sass[k] for k in labels}
    entries[0]["ring"] = {k: v for k, v in ring.items() if "fused_mlp_eval" in k}
    # the forward chain's instantiations of the eval kernels, by kernel
    chain_build = {name: {key: {k: v for k, v in d.items() if name in k}
                          for key, d in (("ptxas", ptxas), ("sass_counts", sass), ("ring", ring))}
                   for name in ("fused_render_tiles", "fused_coarse_weights", "fused_sigma_eval",
                                "pe_probe")}
    del chain_build["pe_probe"]["ring"]  # pe_probe's ring is its own (probes.cu)
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
    with torch.no_grad():  # no autograd graph over the parameters outlives this
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
    # phase 27 holds the first data-parallel step to this one
    first_step = {"loss": loss_k, "grads": {k: p.grad.detach().cpu().clone()
                                            for k, p in models.named_parameters()}}

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

    # step time: host clock around steps that end in a synchronise (each
    # replays the step's CUDA graph: forward, backward and Adam)
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(STEPS_TIMED):
        np_batch = system.train_dataset.sample_batch(BATCH, rng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system.training_step(np_batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_peak = torch.cuda.max_memory_allocated(dev)
    print(f"train step: peak device memory {step_peak / 1e9:.3f} GB (max_memory_allocated "
          f"over the timed steps)")
    step_ms = statistics.median(times) * 1e3
    k_fwd, k_bwd = sum(ms["fused_mlp_eval"].values()), sum(ms["fused_mlp_bwd"].values())
    rest = step_ms - k_fwd - k_bwd - 2 * pack_ms
    print(f"train step: {step_ms:.2f} ms median of {STEPS_TIMED} (all: "
          f"{', '.join(f'{t * 1e3:.2f}' for t in times)}), {BATCH / (step_ms / 1e3):.0f} rays/s, "
          f"{graph_counts['train.graph_replays']} graph replays so far; "
          f"forward kernels {k_fwd:.2f} ms, backward kernels with their reduction "
          f"{k_bwd:.2f} ms, packing {2 * pack_ms:.2f} ms, Adam + glue + loss + batch upload "
          f"(by subtraction) {rest:.2f} ms; kernel bound "
          f"{sum(x['bound_ms'] for x in entries):.2f} ms")

    metrics, _ = system.validation(chunk=4800)
    print(f"validation through the eval render after {system.global_step} steps: "
          + ", ".join(f"{k} {v:.3f}" for k, v in metrics.items()))
    if not all(v == v for v in metrics.values()):
        raise SystemExit("validation metrics are not finite")

    return entries, chain_build, first_step


def _branch_macs(cfg, instance: bool) -> int:
    """Multiply-adds of one point through one branch's trunk and sigma head
    (unpadded): what `fused_sigma_eval` computes."""
    width, depth, skips = ((cfg.inst_W, cfg.inst_D, cfg.inst_skips) if instance
                           else (cfg.W, cfg.D, cfg.skips))
    c_in = cfg.inst_channel_in if instance else cfg.in_channels_xyz
    m = width  # sigma head
    for i in range(depth):
        m += (c_in if i == 0 else (c_in + width if i in skips else width)) * width
    return m


def _sigma_phase(torch, dev, models, cfg, peak_flops, peak_bytes):
    """Phase 8; returns the kernel's entry for the `kernels` line (without
    its launches) and its ms per launch by branch."""
    from object_nerf_torch.ops import fwd_chain
    from object_nerf_torch.ops import fused_sigma as fs
    from object_nerf_torch.scripts import profile_mlp as pm

    if _branch_macs(cfg, False) != _macs_per_sample(cfg, True):
        raise SystemExit("the scene branch's operation count disagrees with the coarse pass's")
    n_rows, s = EDIT_CHUNK, N_SAMPLES
    n = n_rows * s
    gen = torch.Generator().manual_seed(SEED + 2)
    pts = (torch.rand(n, 3, generator=gen) * 3.0 - 1.5).to(dev)
    ids = torch.randint(0, 64, (n_rows,), generator=gen).to(dev)
    model = models.nerf_coarse
    ms, plain_ms, bound, by, errs, library = {}, {}, {}, {}, {}, {}
    with torch.no_grad():
        codes = models.code_library(ids).contiguous()
        packed = fwd_chain.pack_kernel_weights(model, cfg, True, sigma_only=True)
        chain = pm.chain_layers(model)[0]
        for branch in fs.BRANCHES:
            def run(branch=branch):
                return fs.fused_sigma_eval(model, cfg, pts, codes, branch, s, packed=packed)

            def run_plain(branch=branch):
                return fs.sigma_eval_plain(model, cfg, pts, codes, branch, s)

            got, want, again = run(), run_plain(), run()
            torch.cuda.synchronize()
            if not torch.equal(again, got):
                raise SystemExit(f"two launches of fused_sigma_eval ({branch}) differ")
            errs[branch] = (got - want).abs().max().item()
            # the mesh sweep's call: the whole chunk shares one code
            whole = fs.fused_sigma_eval(model, cfg, pts, codes[:1], branch, n, packed=packed)
            err_whole = (whole - fs.sigma_eval_plain(model, cfg, pts, codes[:1], branch, n)
                         ).abs().max().item()
            print(f"fused_sigma_eval {branch} ({n} points, {n_rows} code rows): max |kernel - "
                  f"plain bf16| = {errs[branch]:.3e}, with one code for the whole chunk "
                  f"{err_whole:.3e} (tol {KERNEL_TOL:g}; raw densities "
                  f"{got.min().item():.4f} .. {got.max().item():.4f}); relaunch bit-equal")
            if not max(errs[branch], err_whole) <= KERNEL_TOL:
                raise SystemExit(f"fused_sigma_eval ({branch}) disagrees with its plain "
                                 f"version: {errs[branch]:.3e}, {err_whole:.3e}")
            errs[branch] = max(errs[branch], err_whole)
            del again, whole
            ms[branch] = _cuda_ms(run, TIMED_LAUNCHES)
            plain_ms[branch] = _cuda_ms(run_plain, 3)
            library[branch] = _library_turns(
                f"fused_sigma_eval {branch}", run,
                lambda branch=branch: pm.torch_sigma_eval(chain, cfg, pts, codes, branch, s),
                want)
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
                  f"achieved; " + _weight_stream(packed, n, ms[branch],
                                                 "sigma_obj" if instance else "sigma_scene"))
    entry = {
        "name": "fused_sigma_eval", "route": "cuda",
        "source": "object_nerf_torch/ops/csrc/fused_mlp_wg.cuh",
        "replaces": "object_nerf_tpu/ops/pallas_mlp.py:971",
        "max_abs_err": max(errs.values()), "tol": KERNEL_TOL, "err_is": "max abs",
        # a mixed edit chunk launches each branch once: the sum is its cost
        "ms": sum(ms.values()), "plain_ms": sum(plain_ms.values()),
        "bound_ms": sum(bound.values()), "bound_by": by["scene"],
        "library_ms": sum(v["library_ms"] for v in library.values()), "library": pm.LIBRARY,
        "ms_in_turns": sum(v["ms_in_turns"] for v in library.values()),
        "library_max_abs_err": max(v["library_max_abs_err"] for v in library.values()),
        "library_ms_by_branch": {k: v["library_ms"] for k, v in library.items()},
        "ms_by_branch": ms, "plain_ms_by_branch": plain_ms, "bound_ms_by_branch": bound,
    }
    return entry, ms


def _edit_setup(torch, dev, models, tmp):
    """Phase 9's `EditableRenderer` on `models` (the synthetic scene's spheres
    as ToyDesk boxes, written under `tmp`; object 1 moved and carved out)
    and the keywords of its frame."""
    import math

    import numpy as np

    from object_nerf_torch.config import Config, load_config
    from object_nerf_torch.data import dataset_dict
    from object_nerf_torch.data.synthetic import _default_spheres
    from object_nerf_torch.edit.__main__ import get_transformation_with_duplication_offset
    from object_nerf_torch.edit.editable_renderer import EditableRenderer

    root = _repo_root()
    ckpt = load_config(cli_args=[
        f"dataset_config={os.path.join(root, 'config', 'synthetic.yml')}",
        f"model.N_samples={N_SAMPLES}", f"model.N_importance={N_IMPORTANCE}"]).to_dict()
    ds = dataset_dict["synthetic"]("val", img_wh=(EDIT_W, EDIT_H))
    Twc = np.eye(4)
    Twc[:3] = np.asarray(ds.poses[0])[:3]
    fovx = math.degrees(2 * math.atan(0.5 / 0.7))  # the dataset's focal is 0.7 w
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
    return renderer, kw


def _edit_phase(torch, dev, models, cfg, sigma_ms):
    """Phase 9: one edit frame through `EditableRenderer`; returns the
    frame's launch counts, the largest error of `fused_mlp_eval` against
    its plain version at the edit chunk's shape and flags, and the frame."""
    import dataclasses
    import tempfile

    import numpy as np

    from object_nerf_torch.edit.bbox import boxes_to_arrays
    from object_nerf_torch.models.embedding import freq_encode
    from object_nerf_torch.ops import fused_mlp, fwd_chain
    from object_nerf_torch.ops import fused_mlp_vjp as fv
    from object_nerf_torch.render.multi import compact_hit_order, render_rays_multi
    from object_nerf_torch.train.metrics import psnr

    with tempfile.TemporaryDirectory() as tmp:
        renderer, kw = _edit_setup(torch, dev, models, tmp)
    Twc, fovx = kw["camera_pose_Twc"], kw["fovx_deg"]

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
        packed = fwd_chain.pack_kernel_weights(models.nerf_fine, cfg, True)
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
    return launches, mlp_err, frame


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


def _library_turns(name, kernel, chain, want, tol=KERNEL_TOL, err=None):
    """The kernel against the same function as a chain of torch calls
    (`scripts/profile_mlp.py`), in turns (library, kernel, kernel, library;
    the L2 flushed before each turn). The chain is first held to the kernel's
    plain version `want` (max abs, or `err(got, want)`). Returns the entries'
    library keys: its ms, the kernel's ms in the same turns, its error."""
    from object_nerf_torch.scripts import profile_mlp as pm

    got = chain()
    if err is None:
        pairs = ([(got[k], want[k]) for k in want] if isinstance(want, dict)
                 else list(zip(got, want)) if isinstance(want, (tuple, list)) else [(got, want)])
        e = max((a - b).abs().max().item() for a, b in pairs)
    else:
        e = err(got, want)
    del got
    if not e <= tol:
        raise SystemExit(f"the torch chain of {name} disagrees with its plain version: {e:.3e}")
    ms, lib, turns = pm.library_turns(kernel, chain)
    print(f"{_card()}: {name}: kernel {ms:.3f} ms, torch chain {lib:.3f} ms in turns "
          f"(library, kernel, "
          f"kernel, library; {pm.LIBRARY_ROUNDS} rounds of {pm.LIBRARY_LAUNCHES} calls; turns "
          "kernel " + " ".join(f"{t:.3f}" for t in turns["kernel"]) + ", torch "
          + " ".join(f"{t:.3f}" for t in turns["torch"]) + f"); the chain vs the plain "
          f"version: {e:.2e} (tol {tol:g})")
    return {"library_ms": lib, "library": pm.LIBRARY, "ms_in_turns": ms,
            "library_max_abs_err": e}


def _bound(flop, nbytes, peak_flops, peak_bytes):
    """(bound ms, "operations" or "bytes") of work that needs `flop`
    operations and moves `nbytes`."""
    t_ops, t_bytes = flop / peak_flops * 1e3, nbytes / peak_bytes * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _gather_phase(torch, dev, peak_bytes, ct_by_dtype, samples, topo, static):
    """Phase 11: `gather_rows` against `index_select`, bit for bit, and both
    timed, at the probe's shape and at the addresses of a chunk's samples
    (`samples`: rows -> xyz); then `corner_lookup` at those samples against its
    plain chain (row index, weights and flag bit-equal, the sums within
    LOOKUP_SUM_TOL of their terms' magnitude and then bit-equal), both timed.
    Returns the two kernels' entries for the `kernels` line without their
    launches: the gather's come from GATHER_ROWS_BY_PATH at the end, the
    lookup's from each path."""
    import numpy as np

    from object_nerf_torch.ops import gather

    flat_by_rows = {n: gather.corner_index_weights(topo, static, xyz)[0].contiguous()
                    for n, xyz in samples.items()}
    rng = np.random.RandomState(SEED + 4)
    probe_idx = torch.from_numpy(
        rng.randint(0, PROBE_TABLE_ROWS, size=(PROBE_ROWS,)).astype(np.int32)).to(dev)
    ms, lib_ms, bound = {}, {}, {}
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        probe_table = torch.from_numpy(
            rng.randn(PROBE_TABLE_ROWS, PROBE_CHANNELS).astype(np.float32)).to(dev).to(dtype)
        cases = [(f"probe table {PROBE_TABLE_ROWS} x {PROBE_CHANNELS}", probe_table, probe_idx)]
        cases += [(f"corner table {ct_by_dtype[tag].shape[0]} x {PROBE_CHANNELS}",
                   ct_by_dtype[tag], flat) for flat in flat_by_rows.values()]
        for what, table, idx in cases:
            got = gather.gather_rows(table, idx)  # with the index check
            want = gather.gather_rows_plain(table, idx)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"gather_rows ({what}, {tag}, {idx.shape[0]} rows) is not "
                                 f"index_select bit for bit")
            del got, want
            key = (what.split()[0], tag, idx.shape[0])
            ms[key] = _cuda_ms(lambda: gather.gather_rows(table, idx, check_indices=False),
                               TIMED_LAUNCHES)
            lib_ms[key] = _cuda_ms(lambda: gather.gather_rows_plain(table, idx), TIMED_LAUNCHES)
            # every output row written once and every index read once; of the
            # table only the rows that this run's indices name, each read once
            row_bytes = PROBE_CHANNELS * table.element_size()
            n_distinct = int(torch.unique(idx).numel())
            nbytes = idx.shape[0] * (row_bytes + 4) + n_distinct * row_bytes
            bound[key] = nbytes / peak_bytes * 1e3
            print(f"gather_rows {what} {tag}, {idx.shape[0]} rows ({n_distinct} distinct): "
                  f"bit-equal to index_select; {ms[key]:.3f} ms/launch "
                  f"({nbytes / ms[key] / 1e6:.0f} GB/s of the bytes it must move), index_select "
                  f"{lib_ms[key]:.3f} ms, bound {bound[key]:.3f} ms (bytes: "
                  f"{nbytes / 1e6:.1f} MB)")
        del probe_table
    try:
        gather.gather_rows(ct_by_dtype["bf16"], torch.full((4,), ct_by_dtype["bf16"].shape[0],
                                                           dtype=torch.int32, device=dev))
    except IndexError:
        pass
    else:
        raise SystemExit("gather_rows took an index past the table's end")
    # a voxel chunk gathers once per pass from the bf16 table: the sum is its cost
    path = [k for k in ms if k[0] == "corner" and k[1] == "bf16"]
    entry = {
        "name": "gather_rows", "route": "cuda",
        "source": "object_nerf_torch/ops/csrc/gather_rows.cu",
        "replaces": "scripts/profile_dma_gather.py:39",
        "max_abs_err": 0.0, "tol": 0.0, "err_is": "bit-equal to index_select",
        "ms": sum(ms[k] for k in path), "plain_ms": sum(lib_ms[k] for k in path),
        "bound_ms": sum(bound[k] for k in path), "bound_by": "bytes",
        "library_ms": sum(lib_ms[k] for k in path),
        "ms_by_shape": {" ".join(map(str, k)): v for k, v in ms.items()},
        "library_ms_by_shape": {" ".join(map(str, k)): v for k, v in lib_ms.items()},
        "bound_ms_by_shape": {" ".join(map(str, k)): v for k, v in bound.items()},
    }

    c = static.channels
    lk_ms, lk_plain_ms, lk_bound = {}, {}, {}
    for tag, table in ct_by_dtype.items():
        for n, xyz in samples.items():
            got = gather.corner_lookup(table, xyz, topo, static, with_addressing=True)
            want = gather.corner_lookup_plain(table, xyz, topo, static, with_addressing=True)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got[1:], want[1:])):
                raise SystemExit(f"corner_lookup ({tag}, {n} samples): its flag, row index or "
                                 f"weights differ from the plain chain's")
            flat, wts = got[2], got[3]
            magnitude = (table[flat.long()].reshape(n, 8, c).float().abs()
                         * wts.abs()[..., None]).sum(1)
            gap = (got[0] - want[0]).abs()
            sum_gap = (gap / magnitude.clamp_min(1e-30)).max().item()
            if not (gap <= LOOKUP_SUM_TOL * magnitude).all():
                raise SystemExit(f"corner_lookup ({tag}, {n} samples): sums off by up to "
                                 f"{sum_gap:.2e} of their terms' magnitude (tolerance "
                                 f"{LOOKUP_SUM_TOL:g})")
            if not torch.equal(got[0], want[0]):
                raise SystemExit(f"corner_lookup ({tag}, {n} samples): sums within "
                                 f"{sum_gap:.2e} of their terms' magnitude but not bit-equal: "
                                 f"ATen now reduces the (N, 8, C) product in another order "
                                 f"than the kernel's sum, which copies it")
            del got, want, magnitude, gap
            key = (tag, n)
            lk_ms[key] = _cuda_ms(lambda: gather.corner_lookup(table, xyz, topo, static),
                                  TIMED_LAUNCHES)
            lk_plain_ms[key] = _cuda_ms(
                lambda: gather.corner_lookup_plain(table, xyz, topo, static), TIMED_LAUNCHES)
            # xyz read, out and the flag written once; of the table only the
            # rows that these samples name, each read once
            n_distinct = int(torch.unique(flat).numel())
            nbytes = n * (12 + 4 * c + 1) + n_distinct * table.shape[1] * table.element_size()
            lk_bound[key] = nbytes / peak_bytes * 1e3
            print(f"corner_lookup {tag}, {n} samples ({n_distinct} distinct rows): bit-equal "
                  f"to the plain chain; {lk_ms[key]:.3f} ms/launch "
                  f"({nbytes / lk_ms[key] / 1e6:.0f} GB/s of the bytes it must move), plain "
                  f"chain {lk_plain_ms[key]:.3f} ms, bound {lk_bound[key]:.3f} ms (bytes: "
                  f"{nbytes / 1e6:.1f} MB)")
    # a voxel chunk looks up once per pass in the bf16 table: the sum is its cost
    path = [k for k in lk_ms if k[0] == "bf16"]
    lookup = {
        "name": "corner_lookup", "route": "cuda",
        "source": "object_nerf_torch/ops/csrc/gather_rows.cu",
        "replaces": "scripts/profile_dma_gather.py:39 with the trilinear sum around it",
        "max_abs_err": 0.0, "tol": 0.0, "err_is": "bit-equal to the plain chain",
        "ms": sum(lk_ms[k] for k in path), "plain_ms": sum(lk_plain_ms[k] for k in path),
        "bound_ms": sum(lk_bound[k] for k in path), "bound_by": "bytes",
        "library_ms": sum(lk_plain_ms[k] for k in path),
        "ms_by_shape": {" ".join(map(str, k)): v for k, v in lk_ms.items()},
        "plain_ms_by_shape": {" ".join(map(str, k)): v for k, v in lk_plain_ms.items()},
        "bound_ms_by_shape": {" ".join(map(str, k)): v for k, v in lk_bound.items()},
    }
    return entry, lookup


def _voxel_phases(torch, dev, peak_flops, peak_bytes):
    """Phases 11 to 14: the voxel-conditioned model's eval frame and density
    sweep. Returns phase 11's `gather_rows` and `corner_lookup` entries and,
    for the three kernels that
    gained the voxel operand, their voxel errors, times, bounds and launches."""
    import dataclasses

    import numpy as np

    from object_nerf_torch.config import Config
    from object_nerf_torch.models import voxel_grid as vg
    from object_nerf_torch.models.embedding import freq_encode
    from object_nerf_torch.ops import fused_mlp, fwd_chain, gather
    from object_nerf_torch.ops import fused_sigma as fs
    from object_nerf_torch.ops.sampling import merge_z_vals, sample_pdf, stratified_sample
    from object_nerf_torch.render.renderer import lookup_voxel_raw, render_rays_plain
    from object_nerf_torch.tools.extract_mesh import extract_sigma_grid
    from object_nerf_torch.train.metrics import psnr
    from object_nerf_torch.train.system import render_image

    t0 = time.perf_counter()
    settings, models, (topo, static) = _eval_model(torch, dev, voxel=True)
    cfg = settings.mlp
    features = models.voxel_features.detach()
    print(f"voxel grid: shape {static.shape}, {int(topo.n_occupied)} occupied voxels, feature "
          f"table {tuple(features.shape)}, built on the host (with the models) in "
          f"{time.perf_counter() - t0:.1f} s")
    n_vox = cfg.N_scn_voxel_size + cfg.N_obj_voxel_size
    batch = _frame_batch(voxel=True)

    with torch.no_grad():
        tables = {"bf16": vg.CornerTable(features, topo, static, lowp=True),
                  "f32": vg.CornerTable(features, topo, static)}
        ct = {k: t.ct for k, t in tables.items()}
        build_ms = _cuda_ms(lambda: vg.make_corner_table(features, topo, static, lowp=True), 5)
        print(f"corner table {tuple(ct['bf16'].shape)}: {ct['bf16'].numel() * 2 / 1e6:.1f} MB "
              f"in bf16, built in {build_ms:.3f} ms")
        ctx = (features, topo, static, tables["bf16"])

        # one chunk's inputs, as the eval path makes them
        rays = torch.from_numpy(batch["rays"][:CHUNK]).to(dev)
        ids = torch.from_numpy(batch["instance_ids"][:CHUNK]).to(dev)
        codes = models.code_library(ids).contiguous()
        dir_pe = freq_encode(rays[:, 3:6], cfg.N_freq_dir).contiguous()
        z_c = stratified_sample(rays[:, 6:7], rays[:, 7:8], settings.N_samples)
        xyz_c = (rays[:, None, 0:3] + rays[:, None, 3:6] * z_c[..., None]).contiguous()
        raw_c = lookup_voxel_raw(settings, ctx, xyz_c)
        w_plain = fused_mlp.coarse_weights_plain(models.nerf_coarse, cfg, xyz_c, z_c,
                                                 voxel_raw=raw_c)
        z_mid = 0.5 * (z_c[:, :-1] + z_c[:, 1:])
        z_f = merge_z_vals(z_c, sample_pdf(z_mid, w_plain[:, 1:-1], settings.N_importance,
                                           det=True)).contiguous()
        xyz_f = (rays[:, None, 0:3] + rays[:, None, 3:6] * z_f[..., None]).contiguous()
        raw_f = lookup_voxel_raw(settings, ctx, xyz_f)
        inside = (raw_f.abs().sum(-1) > 0).float().mean().item()
        print(f"chunk 0: {inside * 100:.1f} % of the fine samples lie in occupied voxels; raw "
              f"features within {raw_f.min().item():.2f} .. {raw_f.max().item():.2f}")
        samples = {xyz.shape[0] * xyz.shape[1]: xyz.reshape(-1, 3).contiguous()
                   for xyz in (xyz_c, xyz_f)}

    # -- 11. the gather and the lookup -----------------------------------------------------
    gather_entry, lookup_entry = _gather_phase(torch, dev, peak_bytes, ct, samples, topo,
                                               static)

    # -- 12. the three kernels with the voxel operand -----------------------------------
    with torch.no_grad():
        pk_c = fwd_chain.pack_kernel_weights(models.nerf_coarse, cfg, False, sigma_only=True)
        pk_f = fwd_chain.pack_kernel_weights(models.nerf_fine, cfg, True)
        runs = {
            "fused_coarse_weights": (
                lambda: fused_mlp.fused_coarse_weights(models.nerf_coarse, cfg, xyz_c, z_c,
                                                       voxel_raw=raw_c, packed=pk_c),
                lambda: fused_mlp.coarse_weights_plain(models.nerf_coarse, cfg, xyz_c, z_c,
                                                       voxel_raw=raw_c)),
            "fused_render_tiles": (
                lambda: fused_mlp.fused_render_tiles(models.nerf_fine, cfg, xyz_f, z_f, dir_pe,
                                                     codes, voxel_raw=raw_f, packed=pk_f),
                lambda: fused_mlp.render_tiles_plain(models.nerf_fine, cfg, xyz_f, z_f, dir_pe,
                                                     codes, voxel_raw=raw_f)),
        }
        n_c, n_f = CHUNK * N_SAMPLES, CHUNK * (N_SAMPLES + N_IMPORTANCE)
        work = {  # (operations, bytes: inputs once, outputs once, packed weights once)
            "fused_coarse_weights": (
                2 * _macs_per_sample(cfg, True) * n_c,
                4 * (3 + n_vox + 1 + 1) * n_c + 2 * pk_c.w.numel() + 4 * pk_c.b.numel()),
            "fused_render_tiles": (
                2 * _macs_per_sample(cfg, False) * n_f,
                4 * ((3 + n_vox + 1) * n_f + CHUNK * (27 + 64 + 16))
                + 2 * pk_f.w.numel() + 4 * pk_f.b.numel()),
        }
        vox = {}
        for name, (run, run_plain) in runs.items():
            got, want, again = run(), run_plain(), run()
            if name == "fused_render_tiles":
                same = all(torch.equal(again[k], got[k]) for k in got)
            else:
                same = torch.equal(again, got)
            if not same:
                raise SystemExit(f"two launches of the voxel {name} differ")
            del again
            torch.cuda.synchronize()
            if name == "fused_coarse_weights":
                errs = {"weights": (got - want).abs().max().item()}
            else:
                errs = {k: (got[k] - want[k]).abs().max().item() for k in want}
            err = max(errs.values())
            print(f"{name} voxel {tuple((xyz_c if name == 'fused_coarse_weights' else xyz_f).shape)}"
                  f": max |kernel - plain bf16| = {err:.3e} (tol {KERNEL_TOL:g}): "
                  + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + "; relaunch bit-equal")
            if not err <= KERNEL_TOL:
                raise SystemExit(f"{name} with the voxel operand disagrees with its plain "
                                 f"version: {err:.3e}")
            del got, want
            flop, nbytes = work[name]
            b_ms, b_by = _bound(flop, nbytes, peak_flops, peak_bytes)
            vox[name] = {"err": err, "ms": _cuda_ms(run, TIMED_LAUNCHES),
                         "plain_ms": _cuda_ms(run_plain, 3), "bound_ms": b_ms, "bound_by": b_by}
            print(f"{name} voxel: {vox[name]['ms']:.3f} ms/launch, plain "
                  f"{vox[name]['plain_ms']:.3f} ms, bound {b_ms:.3f} ms ({b_by}: "
                  f"{flop / 1e12:.3f} TFLOP, {nbytes / 1e6:.1f} MB), "
                  f"{flop / vox[name]['ms'] / 1e9:.1f} TFLOP/s achieved")
            if name == "fused_render_tiles":
                print(f"{name} voxel {tuple(xyz_f.shape)}: "
                      + _weight_stream(pk_f, n_f, vox[name]["ms"], "render"))
            else:
                print(f"{name} voxel {tuple(xyz_c.shape)}: "
                      + _weight_stream(pk_c, n_c, vox[name]["ms"], "weights"))

        # the density kernel at the sweep's chunk: points in and around the room,
        # features from the f32 table as the sweep looks them up
        gen = torch.Generator().manual_seed(SEED + 5)
        n_pts, per_row = MESH_CHUNK, N_SAMPLES
        pts = ((torch.rand(n_pts, 3, generator=gen) * 2.0 - 1.0)
               * torch.tensor([1.3, 1.3, 0.6])).to(dev)
        raw_p, _ = vg.voxel_lookup_raw(None, topo, static, pts, ct=ct["f32"])
        raw_p = raw_p.contiguous()
        code_rows = models.code_library(
            torch.randint(0, 64, (n_pts // per_row,), generator=gen).to(dev)).contiguous()
        pk_s = fwd_chain.pack_kernel_weights(models.nerf_fine, cfg, True, sigma_only=True)
        sig = {"err": 0.0, "ms": {}, "plain_ms": {}, "bound_ms": {}, "bound_by": {}}
        for branch in fs.BRANCHES:
            def run(branch=branch):
                return fs.fused_sigma_eval(models.nerf_fine, cfg, pts, code_rows, branch,
                                           per_row, voxel_raw=raw_p, packed=pk_s)

            def run_plain(branch=branch):
                return fs.sigma_eval_plain(models.nerf_fine, cfg, pts, code_rows, branch,
                                           per_row, voxel_raw=raw_p)

            got, want, again = run(), run_plain(), run()
            torch.cuda.synchronize()
            if not torch.equal(again, got):
                raise SystemExit(f"two launches of the voxel fused_sigma_eval ({branch}) differ")
            err = (got - want).abs().max().item()
            # the mesh sweep's call: the whole chunk shares one code
            whole = fs.fused_sigma_eval(models.nerf_fine, cfg, pts, code_rows[:1], branch,
                                        n_pts, voxel_raw=raw_p, packed=pk_s)
            err_whole = (whole - fs.sigma_eval_plain(models.nerf_fine, cfg, pts, code_rows[:1],
                                                     branch, n_pts, voxel_raw=raw_p)
                         ).abs().max().item()
            print(f"fused_sigma_eval voxel {branch} ({n_pts} points): max |kernel - plain "
                  f"bf16| = {err:.3e}, with one code for the whole chunk {err_whole:.3e} (tol "
                  f"{KERNEL_TOL:g}; raw densities {got.min().item():.4f} .. "
                  f"{got.max().item():.4f}); relaunch bit-equal")
            if not max(err, err_whole) <= KERNEL_TOL:
                raise SystemExit(f"fused_sigma_eval ({branch}) with the voxel operand "
                                 f"disagrees with its plain version: {err:.3e}, {err_whole:.3e}")
            err = max(err, err_whole)
            del again, whole
            instance = branch == "instance"
            macs = _branch_macs(cfg, instance)
            depth, width = (cfg.inst_D, cfg.inst_W) if instance else (cfg.D, cfg.W)
            nbytes = ((16 + 4 * n_vox) * n_pts + (4 * code_rows.numel() if instance else 0)
                      + 2 * macs + 4 * (depth * width + 1))
            sig["err"] = max(sig["err"], err)
            sig["ms"][branch] = _cuda_ms(run, TIMED_LAUNCHES)
            sig["plain_ms"][branch] = _cuda_ms(run_plain, 3)
            sig["bound_ms"][branch], sig["bound_by"][branch] = _bound(
                2 * macs * n_pts, nbytes, peak_flops, peak_bytes)
            print(f"fused_sigma_eval voxel {branch}: {sig['ms'][branch]:.3f} ms/launch, plain "
                  f"{sig['plain_ms'][branch]:.3f} ms, bound {sig['bound_ms'][branch]:.3f} ms "
                  f"({sig['bound_by'][branch]}: {macs} multiply-adds per point), "
                  f"{2 * macs * n_pts / sig['ms'][branch] / 1e9:.1f} TFLOP/s achieved; "
                  + _weight_stream(pk_s, n_pts, sig["ms"][branch],
                                   "sigma_obj" if instance else "sigma_scene"))
        vox["fused_sigma_eval"] = sig
        del pts, raw_p, got, want

        # the lookup of a chunk's two passes
        lookup_ms = _cuda_ms(lambda: (lookup_voxel_raw(settings, ctx, xyz_c),
                                      lookup_voxel_raw(settings, ctx, xyz_f)), TIMED_LAUNCHES)

    # -- 13. one 640x480 voxel frame through the main path ---------------------------------
    def reset_counts():
        fused_mlp.reset_launch_counts()  # every counter of utils/trace.py

    def frame():
        return render_image(models, settings, batch, chunk=CHUNK, device=dev,
                            voxel_topo=topo, voxel_static=static)

    n_chunks = (W * H) // CHUNK
    reset_counts()
    out = frame()
    torch.cuda.synchronize()
    launches = dict(fused_mlp.launch_counts)
    n_lookups, n_builds = _lookups(gather, "voxel_eval"), vg.build_counts["corner_table"]
    print(f"voxel frame {W}x{H}: launches {launches}, corner_lookup {n_lookups}, corner-table "
          f"builds {n_builds} (expect {n_chunks} of each eval kernel, {2 * n_chunks} lookups, "
          f"1 build)")
    if (launches != {"fused_coarse_weights": n_chunks, "fused_render_tiles": n_chunks,
                     "fused_mlp_eval": 0, "fused_mlp_bwd": 0, "fused_sigma_eval": 0}
            or n_lookups != 2 * n_chunks or n_builds != 1):
        raise SystemExit("the voxel frame's launch counts are not those of its path")
    for k, v in out.items():
        if v.shape[0] != W * H or not np.isfinite(v).all():
            raise SystemExit(f"voxel frame map {k} is not finite or has shape {v.shape}")
    eval_launches = {"fused_coarse_weights": n_chunks, "fused_render_tiles": n_chunks,
                     "corner_lookup": n_lookups}

    all_ids = torch.from_numpy(batch["instance_ids"]).to(dev)
    ctx32 = (features, topo, static, tables["f32"])
    with torch.no_grad():
        for c in CHECK_CHUNKS:
            sl = slice(c * CHUNK, (c + 1) * CHUNK)
            rays_c = torch.from_numpy(batch["rays"][sl]).to(dev)
            codes_c = models.code_library(all_ids[sl])
            got = torch.from_numpy(out["rgb_fine"][sl]).to(dev)
            ref16 = render_rays_plain(models, rays_c, settings, codes_c,
                                      matmul_dtype=torch.bfloat16, voxel_ctx=ctx)
            ref32 = render_rays_plain(models, rays_c, settings, codes_c,
                                      matmul_dtype=torch.float32, voxel_ctx=ctx32)
            p16, p32 = psnr(got, ref16["rgb_fine"]).item(), psnr(got, ref32["rgb_fine"]).item()
            diffs = ", ".join(
                f"{k} {(torch.from_numpy(out[k][sl]).to(dev) - v).abs().max().item():.2e}"
                for k, v in ref16.items())
            print(f"voxel chunk {c}: rgb_fine PSNR vs plain bf16 on the same bf16 table "
                  f"{p16:.2f} dB (floor {VOX_PSNR_FLOOR_DB:g}), vs the all-f32 path {p32:.2f} dB "
                  f"(floor {VOX_F32_PSNR_FLOOR_DB:g}); max abs diff vs plain bf16: {diffs}")
            if not p16 >= VOX_PSNR_FLOOR_DB:
                raise SystemExit(f"voxel chunk {c}: {p16:.2f} dB from the plain bf16 path")
            if not p32 >= VOX_F32_PSNR_FLOOR_DB:
                raise SystemExit(f"voxel chunk {c}: {p32:.2f} dB from the all-f32 path")
            del ref16, ref32

    times = []
    for _ in range(FRAMES_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    frame_ms = statistics.median(times) * 1e3
    k_ms = n_chunks * (vox["fused_coarse_weights"]["ms"] + vox["fused_render_tiles"]["ms"])
    l_ms = n_chunks * lookup_ms
    print(f"voxel frame: {frame_ms:.1f} ms median of {FRAMES_TIMED} (all: "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)}), {W * H / (frame_ms / 1e3):.0f} "
          f"rays/s; kernels {k_ms:.1f} ms, lookups (corner_lookup) {l_ms:.1f} ms, table build "
          f"{build_ms:.2f} ms, glue + packing + copies (by subtraction) "
          f"{frame_ms - k_ms - l_ms - build_ms:.1f} ms; kernel "
          f"bound {n_chunks * (vox['fused_coarse_weights']['bound_ms'] + vox['fused_render_tiles']['bound_ms']):.1f} ms")
    eval_launches["frame"] = out  # phase 27 holds its sharded frame to this one
    del out

    # -- 14. the voxel density sweep ---------------------------------------------------------
    def grid_conf(n):
        return Config({"N_grid": n, "chunk": MESH_CHUNK, **VOX_MESH_RANGES})

    sweep_ctx = (features, topo, static)
    settings32 = dataclasses.replace(settings, matmul_dtype=torch.float32)
    per_sweep = -(-MESH_GRID ** 3 // MESH_CHUNK)
    mesh_launches = {"fused_sigma_eval": 0, "corner_lookup": 0}
    for obj_id in (0, VOX_OBJ):
        reset_counts()
        got = extract_sigma_grid(models, settings, grid_conf(MESH_GRID), obj_id, device=dev,
                                 as_tensor=True, voxel_ctx=sweep_ctx)
        torch.cuda.synchronize()
        n_launch, n_lookup = (fused_mlp.launch_counts["fused_sigma_eval"],
                              _lookups(gather, "voxel_mesh"))
        n_builds = vg.build_counts["corner_table"]
        want = extract_sigma_grid(models, settings32, grid_conf(MESH_GRID), obj_id, device=dev,
                                  plain=True, as_tensor=True, voxel_ctx=sweep_ctx)
        err = (got - want).abs().max().item()
        print(f"voxel sigma grid {MESH_GRID}^3, "
              f"{'scene branch' if obj_id == 0 else f'object {obj_id}'}: {n_launch} launches, "
              f"{n_lookup} lookups, {n_builds} table build (expect {per_sweep}, {per_sweep}, "
              f"1); max |kernel sweep - plain f32 sweep| = {err:.3e} (tol "
              f"{VOX_MESH_F32_TOL:g}); densities {got.min().item():.4f} .. "
              f"{got.max().item():.4f}, {(got > 0).float().mean().item() * 100:.1f} % above 0")
        if (n_launch, n_lookup, n_builds) != (per_sweep, per_sweep, 1) \
                or sum(fused_mlp.launch_counts.values()) != per_sweep:
            raise SystemExit(f"expected {per_sweep} launches of fused_sigma_eval and of "
                             f"corner_lookup and one table build")
        if not torch.isfinite(got).all() or not err <= VOX_MESH_F32_TOL:
            raise SystemExit(f"the voxel kernel sweep disagrees with the plain f32 sweep: "
                             f"{err:.3e}")
        mesh_launches["fused_sigma_eval"] += n_launch
        mesh_launches["corner_lookup"] += n_lookup
        del got, want

    def timed_sweep(n):
        """Seconds of the n^3 voxel sweep and its (kernel, gather) launches, as
        counted; fails unless there was one of each per chunk and one table build."""
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = extract_sigma_grid(models, settings, grid_conf(n), 0, device=dev, as_tensor=True,
                                  voxel_ctx=sweep_ctx)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counted = (fused_mlp.launch_counts["fused_sigma_eval"],
                   _lookups(gather, "voxel_mesh"), vg.build_counts["corner_table"])
        expect = -(-n ** 3 // MESH_CHUNK)
        if counted != (expect, expect, 1) or sum(fused_mlp.launch_counts.values()) != expect:
            raise SystemExit(f"the {n}^3 voxel sweep counted {counted} launches of "
                             f"fused_sigma_eval, of corner_lookup and table builds; expected "
                             f"{(expect, expect, 1)}")
        if not torch.isfinite(grid).all():
            raise SystemExit(f"the {n}^3 voxel sweep is not finite")
        mesh_launches["fused_sigma_eval"] += counted[0]
        mesh_launches["corner_lookup"] += counted[1]
        return dt, counted[0], counted[1]

    n_timed = MESH_GRID_TIMED // 2
    dt, n_launch, n_lookup = timed_sweep(n_timed)
    if 8 * dt <= SWEEP_BUDGET_S:
        n_timed = MESH_GRID_TIMED
        dt, n_launch, n_lookup = timed_sweep(n_timed)
    print(f"voxel sigma sweep {n_timed}^3 ({n_timed ** 3} points, scene branch, chunk "
          f"{MESH_CHUNK}): {dt * 1e3:.1f} ms, {n_launch} launches and {n_lookup} lookups "
          f"counted, 1 table build, {n_timed ** 3 / dt / 1e6:.1f} M points/s; kernel launches "
          f"alone {n_launch * sig['ms']['scene']:.1f} ms")
    lookup_entry["launches_by_path"] = {"voxel_eval": eval_launches["corner_lookup"],
                                        "voxel_mesh": mesh_launches["corner_lookup"]}
    lookup_entry["launches"] = sum(lookup_entry["launches_by_path"].values())
    eval_launches["frame_ms"] = frame_ms
    return gather_entry, lookup_entry, vox, eval_launches, mesh_launches


def _probe_phase(torch, dev, peak_flops, peak_bytes, build):
    """Phase 15: the two probe kernels; returns their entries for the
    `kernels` line. `build`: pe_probe's figures of the build report."""
    from object_nerf_torch.ops import probes
    from object_nerf_torch.scripts._fixtures import probe_inputs
    from object_nerf_torch.scripts._timing import turns_ms
    from object_nerf_torch.scripts.profile_pe_micro import (
        LAUNCHES, ROUNDS, chain_operands, torch_chain,
    )

    print(_build_line("pe_probe", WGMMA_INSTANTIATIONS["pe_probe"], build["ptxas"]["pe_probe"],
                      build["sass_counts"]["pe_probe"]))
    with torch.no_grad():
        x, s, trunk = probe_inputs(PROBE_ROWS, dev, seed=SEED)
        packed = probes.pack_probe_trunk(trunk)
        xs = x[:PROBE_CHECK_ROWS].contiguous()
        errs = {}
        for mode in probes.MODES:
            got = probes.pe_probe(xs, *s, trunk, mode)
            want = probes.pe_probe_plain(xs, *s, trunk, mode)
            torch.cuda.synchronize()
            errs[mode] = _rel(got, want)
        print(f"pe_probe ({PROBE_CHECK_ROWS} rows): max |kernel - plain| / max |plain| by mode: "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f" (tol {PROBE_REL_TOL:g})")
        worst = max(errs, key=errs.get)
        if not errs[worst] <= PROBE_REL_TOL:
            raise SystemExit(f"pe_probe ({worst}) disagrees with its plain version: "
                             f"{errs[worst]:.3e}")
        first = probes.pe_probe(x, *s, trunk, "combined", packed=packed)
        again = probes.pe_probe(x, *s, trunk, "combined", packed=packed)
        torch.cuda.synchronize()
        print(f"pe_probe combined ({PROBE_ROWS} rows): relaunch bit-equal "
              f"{torch.equal(first, again)}")
        if not torch.equal(first, again):
            raise SystemExit("pe_probe's relaunch differs")
        del first, again
        y = x[:, :24].contiguous()
        got, want = probes.scale_copy(y), probes.scale_copy_plain(y)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit("scale_copy is not 2 x")
        del got, want

        # the probes' own path: each timed mode once at the fine pass's row
        # count, and the trivial kernel once, as the probe scripts launch them
        probes.reset_launch_counts()
        for mode in PROBE_TIMED_MODES:
            out = probes.pe_probe(x, *s, trunk, mode, packed=packed)
        doubled = probes.scale_copy(y)
        torch.cuda.synchronize()
        launches = dict(probes.launch_counts)
        print(f"probe path: launches {launches} (expect {len(PROBE_TIMED_MODES)} and 1); "
              f"outputs finite: {bool(torch.isfinite(out).all() and torch.isfinite(doubled).all())}")
        if launches != {"pe_probe": len(PROBE_TIMED_MODES), "scale_copy": 1}:
            raise SystemExit(f"unexpected probe launches {launches}")
        if not (torch.isfinite(out).all() and torch.isfinite(doubled).all()):
            raise SystemExit("a probe's output is not finite")
        del out, doubled

        chain = 375 * 256 + 7 * 256 * 256  # multiply-adds per row
        pe_macs = {"none": 0, "combined": 27 * 348, "combined_polysin": 27 * 348,
                   "split_polysin": 3 * 60 + 16 * 192 + 8 * 96}
        weights = 2 * (375 * 256 + 7 * 256 * 256) + 4 * 2 * 27 * 348
        ms, plain_ms, bound, full_errs, lib_ms, lib_errs = {}, {}, {}, {}, {}, {}
        for mode in PROBE_TIMED_MODES:
            ops = chain_operands(s, trunk, mode)
            got = probes.pe_probe(x, *s, trunk, mode, packed=packed)
            want = probes.pe_probe_plain(x, *s, trunk, mode)
            lib = torch_chain(x, *ops)
            torch.cuda.synchronize()
            full_errs[mode], lib_errs[mode] = _rel(got, want), _rel(lib, want)
            if not full_errs[mode] <= PROBE_REL_TOL:
                raise SystemExit(f"pe_probe ({mode}) at {PROBE_ROWS} rows disagrees with its "
                                 f"plain version: {full_errs[mode]:.3e}")
            if not lib_errs[mode] <= PROBE_REL_TOL:
                raise SystemExit(f"the torch bf16 chain ({mode}) disagrees with pe_probe's "
                                 f"plain version: {lib_errs[mode]:.3e}")
            del got, want, lib
            # the kernel against the torch bf16 chain in turns, the L2 flushed
            # before each turn; ms per launch of each turn
            turns = turns_ms({"kernel": lambda: probes.pe_probe(x, *s, trunk, mode,
                                                                packed=packed),
                              "torch": lambda: torch_chain(x, *ops)},
                             ("torch", "kernel", "kernel", "torch"), ROUNDS, LAUNCHES)
            ms[mode] = statistics.median(turns["kernel"])
            lib_ms[mode] = statistics.median(turns["torch"])
            plain_ms[mode] = _cuda_ms(lambda: probes.pe_probe_plain(x, *s, trunk, mode), 2)
            flop = 2 * (chain + pe_macs[mode]) * PROBE_ROWS
            bound[mode], by = _bound(flop, PROBE_ROWS * (27 * 4 + 4) + weights, peak_flops,
                                     peak_bytes)
            print(f"pe_probe {mode} ({PROBE_ROWS} rows): {ms[mode]:.3f} ms/launch "
                  f"({ms[mode] - ms['none']:+.3f} ms over none; turns "
                  + " ".join(f"{t:.3f}" for t in turns["kernel"])
                  + f"), torch bf16 chain {lib_ms[mode]:.3f} ms (turns "
                  + " ".join(f"{t:.3f}" for t in turns["torch"])
                  + f"; max |chain - plain| / max |plain| {lib_errs[mode]:.2e}), plain "
                  f"{plain_ms[mode]:.3f} ms, bound {bound[mode]:.3f} ms ({by}: "
                  f"{flop / 1e12:.3f} TFLOP), {flop / ms[mode] / 1e9:.1f} TFLOP/s achieved, "
                  f"{100 * bound[mode] / ms[mode]:.1f} % of the bound; max |kernel - plain| / "
                  f"max |plain| over all rows {full_errs[mode]:.2e} (tol {PROBE_REL_TOL:g})")
        nbytes = 2 * 4 * y.numel()
        sc_plain = _cuda_ms(lambda: probes.scale_copy_plain(y), 50)
        # scale_copy against torch.mul in turns
        turns = turns_ms({"kernel": lambda: probes.scale_copy(y),
                          "torch.mul": lambda: torch.mul(y, 2.0)},
                         ("torch.mul", "kernel", "kernel", "torch.mul"), SC_ROUNDS, SC_LAUNCHES)
        sc_ms, sc_lib = statistics.median(turns["kernel"]), statistics.median(turns["torch.mul"])
        spread = {k: max(v) - min(v) for k, v in turns.items()}
        slower = sc_ms - sc_lib > max(spread.values())
        sc_bound, sc_by = _bound(y.numel(), nbytes, peak_flops, peak_bytes)
        print(f"scale_copy {tuple(y.shape)} vs torch.mul, {SC_ROUNDS} rounds of library, "
              f"kernel, kernel, library, {SC_LAUNCHES} launches a turn, L2 flushed between "
              f"turns: kernel median {sc_ms:.5f} ms (spread {spread['kernel']:.5f}; turns "
              + " ".join(f"{t:.5f}" for t in turns["kernel"]) + f"), torch.mul median "
              f"{sc_lib:.5f} ms (spread {spread['torch.mul']:.5f}; turns "
              + " ".join(f"{t:.5f}" for t in turns["torch.mul"]) + f"); kernel - library "
              f"{sc_ms - sc_lib:+.5f} ms: "
              + ("slower by more than the spread" if slower else "within the spread")
              + f"; plain {sc_plain:.4f} ms, bound {sc_bound:.4f} ms ({sc_by}: "
              f"{nbytes / 1e6:.1f} MB), kernel at {100 * sc_bound / sc_ms:.1f} % of its bound, "
              f"{nbytes / sc_ms / 1e6:.0f} GB/s")
    return [
        {"name": "pe_probe", "route": "cuda",
         "source": "object_nerf_torch/ops/csrc/probes.cu",
         "replaces": "scripts/profile_pe_micro.py:53", "launches": launches["pe_probe"],
         "max_abs_err": max(errs[worst], *full_errs.values()), "tol": PROBE_REL_TOL,
         "err_is": ("max abs / largest reference output, worst of the eight modes at a few "
                    "tiles and of the four timed modes at every row"),
         # the mode that encodes all 27 channels at once with the built-in sine
         "ms": ms["combined"], "plain_ms": plain_ms["combined"],
         "bound_ms": bound["combined"], "bound_by": "operations",
         "library_ms": lib_ms["combined"],
         "library": "torch bf16 chain: bf16(x) @ E into f32, activation, bf16, "
                    "8 x (bf16 mm, relu_), row sum (22 calls)",
         "ms_by_mode": ms, "plain_ms_by_mode": plain_ms, "bound_ms_by_mode": bound,
         "library_ms_by_mode": lib_ms, "library_max_abs_err_by_mode": lib_errs, **build},
        {"name": "scale_copy", "route": "cuda",
         "source": "object_nerf_torch/ops/csrc/probes.cu",
         "replaces": "scripts/profile_voxel_split.py:130", "launches": launches["scale_copy"],
         "max_abs_err": 0.0, "tol": 0.0, "err_is": "bit-equal to 2 x",
         "ms": sc_ms, "plain_ms": sc_plain, "bound_ms": sc_bound, "bound_by": sc_by,
         "library_ms": sc_lib, "ms_spread": spread["kernel"],
         "library_ms_spread": spread["torch.mul"], "slower_than_library": slower},
    ]


def _voxel_train_phases(torch, dev, peak_flops, peak_bytes):
    """Phases 16 to 18: the voxel-conditioned model's training kernels against
    their plain versions, its training step, and the progressive hooks.
    Returns, for rows 3-4 and the sigma kernel and the lookup, what the
    `kernels` line needs of these paths."""
    import copy
    import dataclasses
    import math
    import tempfile

    import numpy as np

    from object_nerf_torch.models import voxel_grid as vg
    from object_nerf_torch.models.embedding import freq_encode
    from object_nerf_torch.ops import fused_mlp, fwd_chain, gather
    from object_nerf_torch.ops import fused_mlp_vjp as fv
    from object_nerf_torch.ops import fused_sigma as fs
    from object_nerf_torch.ops.compositing import composite
    from object_nerf_torch.ops.sampling import merge_z_vals, sample_pdf, stratified_sample
    from object_nerf_torch.render.renderer import RenderDraws
    from object_nerf_torch.train.optim import make_optimizer
    from object_nerf_torch.train.system import make_train_step

    def reset_counts():
        fused_mlp.reset_launch_counts()  # every counter of utils/trace.py

    def counts(path="voxel_train"):
        return (dict(fused_mlp.launch_counts), _lookups(gather, path),
                vg.build_counts["corner_table"])

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        system = _voxel_train_system(torch, dev, tmp)
    config = system.config
    models, settings, cfg = system.models, system.settings, system.settings.mlp
    topo, static = system.voxel_topo, system.voxel_static
    print(f"voxel training: grid {static.shape}, {int(topo.n_occupied)} occupied voxels, table "
          f"{tuple(models.voxel_features.shape)}, system built in {time.perf_counter() - t0:.1f} s")
    if static.shape != VOX_ROOM_GRID:
        raise SystemExit(f"the room's grid should be {VOX_ROOM_GRID}, got {static.shape}")
    rng = system.batch_rng
    batch = system._device_batch(system.train_dataset.sample_batch(BATCH, rng))
    draws = RenderDraws.sample(settings, BATCH, dev, system.generator)

    # -- 16. the training kernels with the voxel operand ---------------------------------
    rays = batch["rays"]
    features = models.voxel_features
    with torch.no_grad():
        table = vg.CornerTable(features.detach(), topo, static, lowp=True)
        codes = models.code_library(batch["instance_ids"]).contiguous()
        dir_pe = freq_encode(rays[:, 3:6], cfg.N_freq_dir).contiguous()
        z_c = stratified_sample(rays[:, 6:7], rays[:, 7:8], N_SAMPLES, False, 1.0,
                                u=draws.perturb)
        xyz_c = (rays[:, None, 0:3] + rays[:, None, 3:6] * z_c[..., None]).contiguous()

        def lookup(xyz):
            return table.lookup(xyz.reshape(-1, 3))[0].reshape(BATCH, xyz.shape[1], -1) \
                .contiguous()

        raw_c = lookup(xyz_c)
        sig_c = fv.mlp_eval_plain(models.nerf_coarse, cfg, xyz_c, dir_pe, codes,
                                  voxel_raw=raw_c)[0]
        w_c = composite(sig_c, sig_c.new_zeros(BATCH, N_SAMPLES, 3), z_c, noise_std=1.0,
                        noise=draws.noise_coarse).weights
        z_mid = 0.5 * (z_c[:, :-1] + z_c[:, 1:])
        z_f = merge_z_vals(z_c, sample_pdf(z_mid, w_c[:, 1:-1], N_IMPORTANCE, u=draws.pdf))
        xyz_f = (rays[:, None, 0:3] + rays[:, None, 3:6] * z_f[..., None]).contiguous()
        raw_f = lookup(xyz_f)
        inside = (raw_f.abs().sum(-1) > 0).float().mean().item()
    print(f"the step's batch: {inside * 100:.1f} % of the fine samples lie in occupied voxels")
    shapes = {
        N_SAMPLES: (models.nerf_coarse, "coarse", xyz_c, z_c, raw_c, draws.noise_coarse,
                    draws.noise_inst_coarse),
        N_SAMPLES + N_IMPORTANCE: (models.nerf_fine, "fine", xyz_f, z_f, raw_f,
                                   draws.noise_fine, draws.noise_inst_fine),
    }

    def real_cotangent(model, typ, xyz, z, raw, noise, noise_inst):
        with torch.no_grad():
            outs = fv.mlp_eval_plain(model, cfg, xyz, dir_pe, codes, voxel_raw=raw)
        return _loss_cotangent(outs, typ, z, noise, noise_inst, settings, batch,
                               dict(config.loss))

    names = ("sigma", "rgb", "inst_sigma", "inst_rgb")
    out = {"fused_mlp_eval": {"err": 0.0, "ms": {}, "plain_ms": {}, "bound_ms": {}},
           "fused_mlp_bwd": {"err": 0.0, "ms": {}, "plain_ms": {}, "bound_ms": {}, "split": {},
                             "launch_peak": {}}}
    # the bound counts the model's own input columns and the input gradients
    # that have a consumer; the kernels perform more (their padded tile, and
    # the 128-column chunks of the input gradient), printed beside it
    k0_pad, grad_cols = fwd_chain.input_tile_columns(cfg), _voxel_grad_cols(cfg)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    grad_cols_pad = (256, 448)
    n_vox = cfg.N_scn_voxel_size + cfg.N_obj_voxel_size
    dvox_err = {"max": 0.0, "norm": 0.0}
    for s_, (model, typ, xyz, z, raw, noise, noise_inst) in shapes.items():
        with torch.no_grad():
            packed = fwd_chain.pack_kernel_weights(model, cfg, True)
            got = fv.fused_mlp_eval(model, cfg, xyz, dir_pe, codes, voxel_raw=raw)
            again = fv.fused_mlp_eval(model, cfg, xyz, dir_pe, codes, voxel_raw=raw)
            want = fv.mlp_eval_plain(model, cfg, xyz, dir_pe, codes, voxel_raw=raw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise SystemExit("two launches of the voxel fused_mlp_eval differ")
            e = {k: (a - b).abs().max().item() for k, a, b in zip(names, got, want)}
        print(f"fused_mlp_eval voxel {tuple(xyz.shape)}: max |kernel - plain bf16| "
              + ", ".join(f"{k} {v:.2e}" for k, v in e.items()) + f" (tol {KERNEL_TOL:g}); "
              "relaunch bit-equal")
        out["fused_mlp_eval"]["err"] = max(out["fused_mlp_eval"]["err"], *e.values())
        g = real_cotangent(model, typ, xyz, z, raw, noise, noise_inst)
        with torch.no_grad():
            grads, d_codes, d_vox = fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, g,
                                                     packed=packed, voxel_raw=raw)
            again = fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, g, packed=packed,
                                     voxel_raw=raw)
            want_g, want_c, want_v = fv.mlp_bwd_plain(model, cfg, xyz, dir_pe, codes, g,
                                                      voxel_raw=raw)
            _, _, v32 = fv.mlp_bwd_plain(model, cfg, xyz, dir_pe, codes, g, True,
                                         torch.float32, voxel_raw=raw)
            torch.cuda.synchronize()
        same = (torch.equal(again[2], d_vox) and torch.equal(again[1], d_codes)
                and all(torch.equal(again[0][k], grads[k]) for k in grads))
        e = {k: _rel(grads[k], want_g[k]) for k in want_g}
        e["d_codes"] = _rel(d_codes, want_c)
        worst = max(e, key=e.get)
        dv = {"max": _rel(d_vox, want_v), "norm": _nrel(d_vox, want_v),
              "bf16_f32_max": _rel(want_v, v32), "bf16_f32_norm": _nrel(want_v, v32)}
        print(f"fused_mlp_bwd voxel {tuple(xyz.shape)}, g of the real loss: max over "
              f"{len(e)} tensors of |kernel - plain bf16| / max|plain| = {e[worst]:.2e} at "
              f"{worst} (tol {BWD_TOL:g}); d_voxel_raw in max abs {dv['max']:.2e} (tol "
              f"{BWD_TOL:g}; bf16 vs f32 {dv['bf16_f32_max']:.2e}), in norm {dv['norm']:.2e} "
              f"(tol {VOX_DVOX_NORM_TOL:g} and a quarter of the bf16 plain version's own "
              f"distance to f32, {dv['bf16_f32_norm']:.2e}); relaunch bit-equal: {same}")
        out["fused_mlp_bwd"]["err"] = max(out["fused_mlp_bwd"]["err"], e[worst], dv["max"])
        dvox_err = {k: max(v, dv[k]) for k, v in dvox_err.items()}
        if not (e[worst] <= BWD_TOL and dv["max"] <= BWD_TOL
                and dv["norm"] <= VOX_DVOX_NORM_TOL
                and dv["norm"] <= 0.25 * dv["bf16_f32_norm"]):
            raise SystemExit(f"fused_mlp_bwd with the voxel operand disagrees with its plain "
                             f"version: {e[worst]:.3e} at {worst}, d_voxel_raw {dv}")
        if not same:
            raise SystemExit("two launches of the voxel backward on the same inputs differ")
        rows = BATCH * s_
        with torch.no_grad():
            out["fused_mlp_eval"]["ms"][s_] = _cuda_ms(
                lambda: fv._launch_eval(cfg, xyz, dir_pe, codes, packed, torch.bfloat16, True,
                                        True, raw),
                TIMED_LAUNCHES)
            print(f"fused_mlp_eval voxel {tuple(xyz.shape)}: "
                  + _weight_stream(packed, BATCH * s_, out["fused_mlp_eval"]["ms"][s_],
                                   "eval"))
            out["fused_mlp_bwd"]["ms"][s_] = _cuda_ms(
                lambda: fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, g, packed=packed,
                                         voxel_raw=raw), TIMED_LAUNCHES)
            out["fused_mlp_bwd"]["split"][s_] = _bwd_split_ms(
                lambda: fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, g, packed=packed,
                                         voxel_raw=raw), TIMED_LAUNCHES)
            out["fused_mlp_bwd"]["launch_peak"][s_] = _bwd_launch_peak(
                lambda: fv.fused_mlp_bwd(model, cfg, xyz, dir_pe, codes, g, packed=packed,
                                         voxel_raw=raw),
                fv.bwd_plan(packed, cfg, rows, n_sm, min(rows // 128, n_sm)), packed,
                4 * codes.numel() + 4 * raw.numel())
            out["fused_mlp_eval"]["plain_ms"][s_] = _cuda_ms(
                lambda: fv.mlp_eval_plain(model, cfg, xyz, dir_pe, codes, voxel_raw=raw), 3)
            out["fused_mlp_bwd"]["plain_ms"][s_] = _cuda_ms(
                lambda: fv.mlp_bwd_plain(model, cfg, xyz, dir_pe, codes, g, voxel_raw=raw), 3)
        w_bytes = 2 * packed.w.numel() + 4 * packed.b.numel()
        per_ray = 4 * BATCH * (cfg.in_channels_dir + cfg.N_obj_code_length)
        for name, macs, pad_macs, nbytes in (
                ("fused_mlp_eval", _macs_per_sample(cfg, False),
                 _macs_per_sample(cfg, False, k0_pad),
                 rows * (12 + 4 * n_vox + 32) + per_ray + w_bytes),
                ("fused_mlp_bwd", _bwd_macs_per_sample(cfg, None, grad_cols),
                 _bwd_macs_per_sample(cfg, k0_pad, grad_cols_pad),
                 rows * (12 + 8 * n_vox + 32) + per_ray + w_bytes
                 + 4 * (packed.w.numel() + packed.b.numel()) + 4 * BATCH * cfg.N_obj_code_length)):
            b_ms, b_by = _bound(2 * macs * rows, nbytes, peak_flops, peak_bytes)
            out[name]["bound_ms"][s_], out[name]["bound_by"] = b_ms, b_by
            extra = ""
            if name == "fused_mlp_bwd":
                plan = fv.bwd_plan(packed, cfg, rows, n_sm, min(rows // 128, n_sm))
                acts_row = 2 * (cfg.D * cfg.W + cfg.inst_D * cfg.inst_W)
                extra = _bwd_report(plan, out[name]["split"][s_],
                                    out[name]["launch_peak"][s_], rows * acts_row, peak_bytes)
            print(f"{name} voxel ({BATCH}, {s_}): {out[name]['ms'][s_]:.3f} ms/launch, plain "
                  f"{out[name]['plain_ms'][s_]:.3f} ms, bound {b_ms:.3f} ms ({b_by}: "
                  f"{macs} multiply-adds per row, {2 * macs * rows / 1e12:.3f} TFLOP; the "
                  f"kernel's padded tile performs {pad_macs}), "
                  f"{2 * macs * rows / out[name]['ms'][s_] / 1e9:.1f} TFLOP/s achieved{extra}")
        del grads, again, want_g, v32
    if not out["fused_mlp_eval"]["err"] <= KERNEL_TOL:
        raise SystemExit(f"fused_mlp_eval with the voxel operand disagrees with its plain "
                         f"version: {out['fused_mlp_eval']['err']:.3e}")
    out["fused_mlp_bwd"]["dvox_err"] = dvox_err

    # the step's voxel pieces alone, by CUDA events: the table build, the two
    # lookups, and the table gradient of both passes (segment-sum + transpose)
    with torch.no_grad():
        build_ms = _cuda_ms(lambda: vg.make_corner_table(features.detach(), topo, static,
                                                         lowp=True), 5)
        look_ms = _cuda_ms(lambda: (lookup(xyz_c), lookup(xyz_f)), TIMED_LAUNCHES)
        cot = []
        for xyz in (xyz_c, xyz_f):
            flat, wts, _ = gather.corner_index_weights(topo, static, xyz.reshape(-1, 3))
            cot.append((torch.randn(flat.shape[0], n_vox, device=dev), flat, wts))
        torch.cuda.reset_peak_memory_stats(dev)
        base_mem = torch.cuda.memory_allocated(dev)
        grad_ms = _cuda_ms(lambda: vg.corner_table_grad(cot, topo, static), 5)
        grad_mem = torch.cuda.max_memory_allocated(dev) - base_mem
        n_samples = sum(c[1].shape[0] for c in cot)
        seg_bytes = n_samples * 8 * n_vox * 4
        del cot
    print(f"voxel step pieces: table build {build_ms:.3f} ms (bf16), two lookups "
          f"{look_ms:.3f} ms (two corner_lookup launches), table gradient "
          f"{grad_ms:.3f} ms (d_rows of {n_samples} samples: {seg_bytes / 1e6:.0f} MB, one "
          f"index_add_ into the f32 corner table, the transpose; {grad_mem / 1e6:.0f} MB of "
          f"transient device memory)")

    # -- 17. the voxel training step ---------------------------------------------------------
    # the plain bf16 step is the reference; the plain f32 step is the control
    # that says how far the bf16 rounding alone moves each gradient
    twin, twin32 = copy.deepcopy(models), copy.deepcopy(models)
    plain_step = make_train_step(settings, dict(config.loss),
                                 make_optimizer(config.train, twin.parameters()),
                                 system.lr_schedule, plain=True)
    plain_step32 = make_train_step(dataclasses.replace(settings, matmul_dtype=torch.float32),
                                   dict(config.loss),
                                   make_optimizer(config.train, twin32.parameters()),
                                   system.lr_schedule, plain=True)
    reset_counts()
    m_k = system.train_step(models, batch, draws=draws, voxel_topo=topo, voxel_static=static)
    torch.cuda.synchronize()
    first = counts()
    m_p = plain_step(twin, batch, draws=draws, voxel_topo=topo, voxel_static=static)
    plain_step32(twin32, batch, draws=draws, voxel_topo=topo, voxel_static=static)
    torch.cuda.synchronize()
    loss_k, loss_p = float(m_k["train/loss"]), float(m_p["train/loss"])
    e = {k: _rel(p.grad, q.grad) for (k, p), q in zip(models.named_parameters(),
                                                      twin.parameters())}
    control = {k: _rel(p.grad, q.grad) for (k, p), q in zip(twin.named_parameters(),
                                                            twin32.parameters())}
    table_name = "embedding_xyz.embedding_space_ftr.weight"
    e_table = e.pop(table_name)
    worst = max(e, key=e.get)
    print(f"voxel step 1, kernels vs plain bf16 path: loss {loss_k:.6f} vs {loss_p:.6f} (rel "
          f"{abs(loss_k - loss_p) / abs(loss_p):.2e}, tol {LOSS_TOL:g}); MLP gradients: worst "
          f"{e[worst]:.2e} at {worst} (tol {VOX_STEP_GRAD_TOL:g}; plain bf16 vs f32 there "
          f"{control[worst]:.2e}), median {statistics.median(e.values()):.2e}; table gradient "
          f"{e_table:.2e} (tol {VOX_TABLE_GRAD_TOL:g} and a quarter of the plain bf16 step's "
          f"distance to the plain f32 step, {control[table_name]:.2e}); plain bf16 vs f32 over "
          f"the MLP gradients: median {statistics.median(v for k, v in control.items() if k != table_name):.2e}"
          f"; launches {first}")
    if first[0]["fused_mlp_eval"] != 2 or first[0]["fused_mlp_bwd"] != 2 or first[1:] != (2, 1):
        raise SystemExit(f"a voxel step should launch 2 + 2 kernels, 2 lookups and build one "
                         f"table: {first}")
    if not abs(loss_k - loss_p) <= LOSS_TOL * abs(loss_p):
        raise SystemExit("the voxel step's loss disagrees with the plain path's")
    if not e[worst] <= VOX_STEP_GRAD_TOL:
        raise SystemExit(f"the voxel step's gradients disagree: {e[worst]:.3e} at {worst}")
    if not (e_table <= VOX_TABLE_GRAD_TOL and e_table <= 0.25 * control[table_name]):
        raise SystemExit(f"the voxel step's table gradient disagrees: {e_table:.3e} (plain "
                         f"bf16 vs f32 {control[table_name]:.3e})")
    del twin, twin32, plain_step, plain_step32

    def timed_steps(n):
        times = []
        for _ in range(n):
            np_batch = system.train_dataset.sample_batch(BATCH, rng)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            system.training_step(np_batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return times

    reset_counts()
    losses = [m_k["train/loss"]]
    for _ in range(TRAIN_STEPS):
        losses.append(system.training_step(system.train_dataset.sample_batch(BATCH, rng))
                      ["train/loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = timed_steps(STEPS_TIMED)
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated(dev)
    n_steps = TRAIN_STEPS + STEPS_TIMED
    launches, n_lookup, n_build = counts()
    losses = [float(x) for x in losses]
    print(f"{n_steps} more voxel steps: launches {launches}, corner_lookup {n_lookup}, table "
          f"builds {n_build} (expect {2 * n_steps}, {2 * n_steps}, {n_steps}); loss "
          + " ".join(f"{x:.4f}" for x in losses))
    if ((launches["fused_mlp_eval"], launches["fused_mlp_bwd"], n_lookup, n_build)
            != (2 * n_steps, 2 * n_steps, 2 * n_steps, n_steps)
            or sum(launches.values()) != 4 * n_steps):
        raise SystemExit("a voxel step should launch 2 + 2 kernels and 2 lookups, one build")
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise SystemExit("a voxel training loss is not finite")
    head, tail = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    print(f"voxel loss: mean of the first five {head:.4f}, of the last five {tail:.4f}")
    if not tail < head:
        raise SystemExit("the voxel loss did not fall")
    step_ms = statistics.median(times) * 1e3
    k_ms = sum(out["fused_mlp_eval"]["ms"].values()) + sum(out["fused_mlp_bwd"]["ms"].values())
    print(f"voxel train step: peak device memory {step_peak / 1e9:.3f} GB "
          f"(max_memory_allocated over the timed steps)")
    print(f"voxel train step: {step_ms:.2f} ms median of {STEPS_TIMED} (all: "
          f"{', '.join(f'{t * 1e3:.2f}' for t in times)}), {BATCH / (step_ms / 1e3):.0f} rays/s; "
          f"kernels {k_ms:.2f} ms (forward {sum(out['fused_mlp_eval']['ms'].values()):.2f}, "
          f"backward {sum(out['fused_mlp_bwd']['ms'].values()):.2f}), lookups {look_ms:.2f}, "
          f"table build {build_ms:.2f}, table gradient {grad_ms:.2f}, the rest (packing, "
          f"optimizer, glue, loss, autograd, upload; by subtraction) "
          f"{step_ms - k_ms - look_ms - build_ms - grad_ms:.2f} ms")
    train_launches = {"fused_mlp_eval": 2 * (n_steps + 1), "fused_mlp_bwd": 2 * (n_steps + 1),
                      "corner_lookup": 2 * (n_steps + 1)}

    # -- 18. prune and subdivide on the room, then the subdivided step ---------------------------
    # the prune's decisions on the card against its plain f32 version on the
    # same jitter, at the median of the card's per-voxel alphas
    topo0 = system.voxel_topo
    n0 = int(topo0.n_occupied)
    spv = int(config.train.get("prune_samples_per_voxel", 16 ** 3))
    per_batch = int(config.train.get("prune_voxel_batch", 256))
    model = models.nerf_fine
    with torch.no_grad():
        pk_s = fwd_chain.pack_kernel_weights(model, cfg, False, sigma_only=True)
    uniform = torch.rand(-(-n0 // per_batch) * per_batch * PRUNE_CHECK_SPV, 3, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(SEED + 7))

    def prune(th, plain):
        """(new topology, per-voxel largest alpha) of one prune of the room."""
        sigmas = []

        def sigma_fn(pts, raw):
            if plain:
                sig = fs.sigma_eval_plain(model, cfg, pts, None, "scene", PRUNE_CHECK_SPV,
                                          voxel_raw=raw, matmul_dtype=torch.float32)
            else:
                sig = fs.fused_sigma_eval(model, cfg, pts, None, "scene", PRUNE_CHECK_SPV,
                                          voxel_raw=raw, packed=pk_s)
            sigmas.append(sig)
            return sig

        new = vg.prune_empty_voxels(features.detach(), topo0, static, sigma_fn,
                                    uniform=uniform, max_alpha_th=th,
                                    samples_per_voxel=PRUNE_CHECK_SPV, voxel_batch=per_batch)
        alpha = (1.0 - torch.exp(-torch.relu(torch.cat(sigmas)))).reshape(-1, PRUNE_CHECK_SPV)
        return new, alpha.amax(-1)[:n0].cpu().numpy()

    _, alpha_k = prune(0.5, plain=False)
    th = float(np.median(alpha_k))
    topo_k, alpha_k = prune(th, plain=False)
    topo_p, alpha_p = prune(th, plain=True)
    cells = np.flatnonzero(topo0.occupancy.cpu().numpy())  # the order prune visits them
    keep_k = topo_k.occupancy.cpu().numpy()[cells]
    keep_p = topo_p.occupancy.cpu().numpy()[cells]
    clear = np.abs(alpha_p - th) > PRUNE_ALPHA_MARGIN
    mismatch = int((keep_k != keep_p)[clear].sum())
    idx0, idx_k = topo0.idx_map.cpu().numpy(), topo_k.idx_map.cpu().numpy()
    r2c0, r2c_k = topo0.row_to_cell.cpu().numpy(), topo_k.row_to_cell.cpu().numpy()
    dropped_rows = idx0[cells[~keep_k]]
    rewrite_ok = (np.all(idx_k[cells[~keep_k]] == -1)
                  and np.array_equal(idx_k[cells[keep_k]], idx0[cells[keep_k]])
                  and np.all(r2c_k[dropped_rows] == int(np.prod(static.shape)))
                  and np.array_equal(np.delete(r2c_k, dropped_rows), np.delete(r2c0, dropped_rows))
                  and int(topo_k.n_occupied) == int(keep_k.sum()))
    n_kept = int(keep_k.sum())
    print(f"prune check ({PRUNE_CHECK_SPV} samples per voxel, threshold {th:.6f}, the median "
          f"of the card's per-voxel alphas): card keeps {n_kept} of {n0}; plain f32 keeps "
          f"{int(keep_p.sum())}; {int((~clear).sum())} voxels within {PRUNE_ALPHA_MARGIN:g} of "
          f"the threshold, {mismatch} decisions differ outside it; max |alpha card - plain| "
          f"{np.abs(alpha_k - alpha_p).max():.2e}; idx_map / row_to_cell rewrite: {rewrite_ok}")
    if not (0 < n_kept < n0 and mismatch == 0 and rewrite_ok
            and np.array_equal(keep_k, alpha_k >= th) and np.array_equal(keep_p, alpha_p >= th)):
        raise SystemExit("the card's prune disagrees with its plain version")
    # one step on the pruned grid: the dropped voxels' rows get no gradient
    system.voxel_topo = topo_k
    reset_counts()
    m = system.training_step(system.train_dataset.sample_batch(BATCH, rng))
    torch.cuda.synchronize()
    launches, n_lookup, n_build = counts()
    grad = models.voxel_features.grad
    g_drop = grad[torch.from_numpy(dropped_rows).to(dev).long()].abs().max().item()
    g_kept = grad[torch.from_numpy(idx0[cells[keep_k]]).to(dev).long()].abs().max().item()
    print(f"a step on the pruned grid: loss {float(m['train/loss']):.4f}; largest table gradient "
          f"in the dropped voxels' rows {g_drop:.3e}, in the kept ones' {g_kept:.3e}; launches "
          f"{launches}, corner_lookup {n_lookup}, builds {n_build}")
    if (launches["fused_mlp_eval"], launches["fused_mlp_bwd"], n_lookup, n_build) != (2, 2, 2, 1):
        raise SystemExit("a voxel step should launch 2 + 2 kernels and 2 lookups, one build")
    if not (g_drop == 0.0 and g_kept > 0.0 and math.isfinite(float(m["train/loss"]))):
        raise SystemExit("the pruned voxels' rows should take no gradient, the kept ones some")
    for name in ("fused_mlp_eval", "fused_mlp_bwd", "corner_lookup"):
        train_launches[name] += 2

    # the hook (epoch 3: a prune at the config's threshold and sample count), timed
    n0 = n_kept
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    system.on_epoch_start(3)
    torch.cuda.synchronize()
    prune_s = time.perf_counter() - t0
    launches, n_lookup, n_build = counts("prune")
    n1 = int(system.voxel_topo.n_occupied)
    expect = -(-n0 // per_batch)
    print(f"prune (epoch 3): {n0} -> {n1} occupied voxels ({n0 - n1} dropped), {spv} samples "
          f"per voxel, {n0 * spv} points; {prune_s * 1e3:.1f} ms; fused_sigma_eval "
          f"{launches['fused_sigma_eval']}, corner_lookup {n_lookup}, table builds {n_build} "
          f"(expect {expect}, {expect}, 1)")
    if (launches["fused_sigma_eval"], n_lookup, n_build) != (expect, expect, 1) \
            or sum(launches.values()) != expect or not 0 < n1 <= n0:
        raise SystemExit("the prune should launch one density kernel and one lookup per batch "
                         "of voxels and keep some of them")
    prune_launches = {"fused_sigma_eval": expect, "corner_lookup": expect}
    shape0 = system.voxel_static.shape
    reset_counts()
    t0 = time.perf_counter()
    system.on_epoch_start(5)  # a prune, then the subdivision
    torch.cuda.synchronize()
    subdiv_s = time.perf_counter() - t0
    launches, n_lookup, n_build = counts("prune")
    static2 = system.voxel_static
    print(f"epoch-5 hook (prune, then subdivide): grid {shape0} -> {static2.shape}, "
          f"{int(system.voxel_topo.n_occupied)} occupied voxels, dense corner table "
          f"{vg.dense_table_bytes(static2) / 1e6:.0f} MB in f32 (dense route: "
          f"{vg.dense_path_ok(static2)}); {subdiv_s * 1e3:.1f} ms; launches {launches}, "
          f"corner_lookup {n_lookup}, builds {n_build}")
    if static2.shape != tuple(2 * x for x in shape0) or not vg.dense_path_ok(static2):
        raise SystemExit("the subdivision should double the grid and keep the dense route")
    prune_launches["fused_sigma_eval"] += launches["fused_sigma_eval"]
    prune_launches["corner_lookup"] += n_lookup
    reset_counts()
    times = timed_steps(VOX_SUBDIV_STEPS)
    launches, n_lookup, n_build = counts()
    sub_ms = statistics.median(times) * 1e3
    print(f"subdivided voxel step: {sub_ms:.2f} ms median of {VOX_SUBDIV_STEPS} (all: "
          f"{', '.join(f'{t * 1e3:.2f}' for t in times)}), {BATCH / (sub_ms / 1e3):.0f} rays/s; "
          f"launches {launches}, corner_lookup {n_lookup}, builds {n_build}")
    if (launches["fused_mlp_eval"], launches["fused_mlp_bwd"], n_lookup, n_build) != (
            2 * VOX_SUBDIV_STEPS, 2 * VOX_SUBDIV_STEPS, 2 * VOX_SUBDIV_STEPS, VOX_SUBDIV_STEPS):
        raise SystemExit("the subdivided step should launch 2 + 2 kernels and 2 lookups")
    for name in ("fused_mlp_eval", "fused_mlp_bwd", "corner_lookup"):
        train_launches[name] += 2 * VOX_SUBDIV_STEPS
    return out, train_launches, prune_launches


def _voxel_edit_phase(torch, dev):
    """Phase 19: one voxel edit frame through `EditableRenderer` on the room;
    returns its launch counts."""
    import dataclasses
    import tempfile

    import numpy as np

    from object_nerf_torch.config import Config
    from object_nerf_torch.edit.__main__ import get_transformation_with_duplication_offset
    from object_nerf_torch.edit.bbox import boxes_to_arrays
    from object_nerf_torch.edit.editable_renderer import EditableRenderer
    from object_nerf_torch.models import voxel_grid as vg
    from object_nerf_torch.models.mlp import ObjectNeRFConfig
    from object_nerf_torch.ops import fused_mlp, gather
    from object_nerf_torch.render.multi import compact_hit_order, render_rays_multi
    from object_nerf_torch.render.renderer import RenderSettings
    from object_nerf_torch.scripts._fixtures import SCENE, bench_grid
    from object_nerf_torch.train.metrics import psnr
    from object_nerf_torch.train.system import init_params

    cfg = ObjectNeRFConfig()
    features, topo, static = bench_grid(cfg, dev, seed=SEED + 2)
    models = init_params(torch.Generator().manual_seed(SEED),
                         RenderSettings(mlp=cfg, N_importance=N_IMPORTANCE), {"N_max_objs": 64},
                         device=dev, voxel_features=features)
    with torch.no_grad():
        for m in (models.nerf_coarse, models.nerf_fine):
            m.sigma.bias += DENSITY_BIAS
    model_conf = {"use_voxel_embedding": True, "N_samples": N_SAMPLES,
                  "N_importance": N_IMPORTANCE, "frustum_bound": -1, "use_disp": False,
                  "perturb": 0, "noise_std": 0, "N_max_objs": 64,
                  **{k: getattr(cfg, k) for k in (
                      "D", "W", "inst_D", "inst_W", "N_freq_xyz", "N_freq_dir",
                      "N_freq_voxel", "N_scn_voxel_size", "N_obj_voxel_size",
                      "N_obj_code_length")},
                  "skips": list(cfg.skips), "inst_skips": list(cfg.inst_skips)}
    # the room's object 1 (`scannet_scale_pcd`: a sphere of radius 0.6 m at
    # (0.8, 0, 0.6)) as a ToyDesk box; a camera at mid-room looking at it
    scale = SCENE["scale_factor"]
    Twc = np.eye(4)
    Twc[:3, 3] = [0.2, -2.0, 1.0]
    Twc[:3, :3] = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], float)
    with tempfile.TemporaryDirectory() as tmp:
        bbox_path = os.path.join(tmp, "bbox.json")
        with open(bbox_path, "w") as f:
            json.dump({"labels": [{"id": VOX_OBJ, "data": {
                "position": [0.8, 0.0, 0.6], "quaternion": [0.0, 0.0, 0.0, 1.0],
                "scale": [1.32, 1.32, 1.32]}}]}, f)
        ckpt = {"dataset_name": "toydesk", "model": model_conf,
                "dataset_extra": {"scale_factor": scale,
                                  "scene_center": list(SCENE["scene_center"]),
                                  "near": 0.05 * scale, "far": 2.4 * scale,
                                  "bbox_dir": bbox_path}}
        renderer = EditableRenderer(Config({"ckpt_config": ckpt, "chunk": EDIT_CHUNK}),
                                    models=models, device=dev, voxel_grid=(topo, static))
        renderer.remove_scene_object_by_ids([VOX_OBJ])
        renderer.set_object_pose_transform(
            VOX_OBJ, get_transformation_with_duplication_offset(EDIT_PROGRESS, 0), 0)
    fovx = 70.0
    kw = dict(h=EDIT_H, w=EDIT_W, camera_pose_Twc=Twc, fovx_deg=fovx, chunk=EDIT_CHUNK)

    fused_mlp.reset_launch_counts()  # every counter of utils/trace.py
    frame = renderer.render_edit(**kw)
    torch.cuda.synchronize()
    launches = dict(fused_mlp.launch_counts)
    n_lookup, n_build = _lookups(gather, "voxel_edit"), vg.build_counts["corner_table"]
    plan = renderer.last_chunk_plan
    n_chunks, n_mixed = plan["chunks"], plan["mixed"]
    expect = 2 * n_mixed + (n_chunks - n_mixed)
    print(f"voxel edit frame {EDIT_W}x{EDIT_H} on the room, background + object {VOX_OBJ} "
          f"moved, its original removed: {n_chunks} chunks, {n_mixed} with both ray sets; "
          f"launches {launches}, corner_lookup {n_lookup}, table builds {n_build} (expect "
          f"{expect} of each kernel, {2 * expect} lookups, 1 build)")
    if not 0 < n_mixed < n_chunks:
        raise SystemExit(f"the voxel edit frame should have mixed and background-only chunks: "
                         f"{plan}")
    if (launches != {"fused_coarse_weights": 0, "fused_render_tiles": 0,
                     "fused_mlp_eval": expect, "fused_mlp_bwd": 0, "fused_sigma_eval": expect}
            or n_lookup != 2 * expect or n_build != 1):
        raise SystemExit("the voxel edit frame's launch counts are not those of its path")
    for k, v in frame.items():
        if v.shape[0] != EDIT_W * EDIT_H or not np.isfinite(v).all():
            raise SystemExit(f"voxel edit map {k} is not finite or has shape {v.shape}")

    rays_list, ids = renderer.edit_ray_sets(EDIT_H, EDIT_W, Twc, fovx)
    perm, _ = compact_hit_order(rays_list, ids, EDIT_CHUNK)
    a, b, s = boxes_to_arrays(renderer.get_skipping_bbox_helper(), renderer.scale_factor)
    skip_boxes = (torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev), s)
    settings16 = dataclasses.replace(renderer.settings, matmul_dtype=torch.bfloat16)
    settings32 = dataclasses.replace(renderer.settings, matmul_dtype=torch.float32)
    with torch.no_grad():  # the frame's own bf16 table (the same build), and an f32 one
        refs = {"bf16": (settings16, (features, topo, static,
                                      vg.CornerTable(features, topo, static, lowp=True)),
                         VOX_EDIT_BF16_PSNR_FLOOR_DB, EDIT_MAP_TOL),
                "f32": (settings32, (features, topo, static,
                                     vg.CornerTable(features, topo, static)),
                        EDIT_PSNR_FLOOR_DB, VOX_EDIT_MAP_TOL)}
    checked = [("mixed", c) for c in range(min(2, n_mixed))] + [("background-only", n_mixed)]
    for kind, c in checked:
        idx = perm[c * EDIT_CHUNK:(c + 1) * EDIT_CHUNK]
        sets = [torch.from_numpy(np.ascontiguousarray(r[idx])).to(dev) for r in rays_list]
        hits = int((rays_list[1][idx, 7] > 0).sum())
        for ref_name, (st, ctx, floor, limits) in refs.items():
            ref = render_rays_multi(models, sets, ids, st, skip_boxes=skip_boxes, plain=True,
                                    voxel_ctx=ctx)
            p = psnr(torch.from_numpy(frame["rgb_fine"][idx]).to(dev), ref["rgb_fine"]).item()
            diff = {k: (torch.from_numpy(frame[k][idx]).to(dev) - ref[k]).abs().max().item()
                    for k in frame}
            print(f"voxel edit chunk {c} ({kind}, {hits} rays hit the box): rgb_fine PSNR vs "
                  f"render_rays_multi {ref_name} plain {p:.2f} dB (floor {floor:g}); max abs "
                  f"diff " + ", ".join(f"{k} {v:.2e}" for k, v in diff.items())
                  + " (limits " + ", ".join(f"{k} {v:g}" for k, v in limits.items()) + ")")
            if not p >= floor:
                raise SystemExit(f"voxel edit chunk {c}: PSNR {p:.2f} dB from the {ref_name} "
                                 f"plain path")
            for k, tol in limits.items():
                if not diff[k] <= tol:
                    raise SystemExit(f"voxel edit chunk {c}: {k} is {diff[k]:.3e} from the "
                                     f"{ref_name} plain path (limit {tol:g})")
        if (kind == "mixed") != (hits > 0):
            raise SystemExit(f"voxel edit chunk {c} should be {kind}, but {hits} rays hit")
    moved = float(np.abs(frame["rgb_fine"] - renderer.render_origin(
        EDIT_H, EDIT_W, Twc, fovx, chunk=EDIT_CHUNK)["rgb_fine"]).max())
    if not moved > 1e-3:
        raise SystemExit("the voxel edit changed nothing in the frame")
    times = []
    for _ in range(FRAMES_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        renderer.render_edit(**kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    frame_ms = statistics.median(times) * 1e3
    print(f"voxel edit frame: {frame_ms:.1f} ms median of {FRAMES_TIMED} (all: "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)}), "
          f"{EDIT_W * EDIT_H / (frame_ms / 1e3):.0f} pixels/s; max |edited - unedited| "
          f"{moved:.3f}")
    return {"fused_mlp_eval": expect, "fused_sigma_eval": expect, "corner_lookup": 2 * expect}


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def _expect(ok: bool, message: str) -> None:
    if not ok:
        raise SystemExit(message)


# `gather_rows` launches read on each main path beside its `corner_lookup`
# count; the kernels line's `gather_rows` entry is built from these readings
GATHER_ROWS_BY_PATH: dict = {}


def _lookups(gather, path: str) -> int:
    """The `corner_lookup` launches counted on `path` since the last reset,
    after reading its `gather_rows` launches into GATHER_ROWS_BY_PATH: the
    fused lookup fetches the corner rows itself, so a path that launches
    `gather_rows` fails."""
    n_rows = gather.launch_counts["gather_rows"]
    GATHER_ROWS_BY_PATH[path] = GATHER_ROWS_BY_PATH.get(path, 0) + n_rows
    _expect(n_rows == 0, f"{path}: {n_rows} gather_rows launches; the voxel lookup should "
                         f"fetch its rows in corner_lookup")
    return gather.launch_counts["corner_lookup"]


def _scene_phases(torch, dev, peak_flops, peak_bytes, frame13_ms):
    """Phases 20 to 26: the shipped scene configs through the entry points a
    user calls, on a desk scene this phase writes to disk (phase 26: the train
    CLI under torchrun). Returns the launch counts of these paths by kernel
    and path, and row 3 at the route's shape."""
    import copy
    import dataclasses
    import glob
    import shutil

    import numpy as np

    from object_nerf_torch import eval as eval_cli
    from object_nerf_torch.config import load_config
    from object_nerf_torch.data import dataset_dict, png_io
    from object_nerf_torch.data.generic_dataset import FIX_ROT
    from object_nerf_torch.data.geo_utils import center_pose_from_avg
    from object_nerf_torch.data.ray_utils import get_rays
    from object_nerf_torch.edit import __main__ as edit_cli
    from object_nerf_torch.models import voxel_grid as vg
    from object_nerf_torch.models.embedding import freq_encode
    from object_nerf_torch.ops import fused_mlp, fwd_chain, gather
    from object_nerf_torch.ops import fused_mlp_vjp as fv
    from object_nerf_torch.ops.sampling import stratified_sample
    from object_nerf_torch.render.renderer import (
        RenderDraws, lookup_voxel_raw, render_rays, render_rays_plain,
    )
    from object_nerf_torch.scripts.make_synthetic_dataset import (
        frame_images, make_dataset, write_scannet_boxes,
    )
    from object_nerf_torch.train import __main__ as train_cli
    from object_nerf_torch.train import system as system_mod
    from object_nerf_torch.train.checkpoint import save_checkpoint, save_config_snapshot
    from object_nerf_torch.train.metrics import psnr
    from object_nerf_torch.train.optim import make_optimizer

    def reset_counts():
        fused_mlp.reset_launch_counts()  # every counter of utils/trace.py

    def counts(path):
        return (dict(fused_mlp.launch_counts), _lookups(gather, path),
                vg.build_counts["corner_table"])

    def kernels(**n):
        out = dict.fromkeys(fused_mlp.launch_counts, 0)
        out.update(n)
        return out

    root = _repo_root()
    n_chunks = (W * H) // CHUNK
    paths = {k: {} for k in ("fused_coarse_weights", "fused_render_tiles", "fused_mlp_eval",
                             "fused_mlp_bwd", "fused_sigma_eval", "corner_lookup")}

    def record(path, launched, n_lookup):
        for k, v in launched.items():
            if v:
                paths[k][path] = v
        paths["corner_lookup"][path] = n_lookup

    # the CLIs write logs/ and debug/ under the working directory: a
    # directory of the checkout's (ignored) logs/, removed at the end
    work = os.path.join(root, "logs", "chip_smoke_scenes")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        # -- 20. the desk scene on disk, decoded, and its train buffers ---------------------
        scene = os.path.join(work, "desk")
        t0 = time.perf_counter()
        make_dataset(scene, (W, H), SCENE_FRAMES, filters=[0, 1, 2, 3, 4])
        write_scannet_boxes(scene, SCENE_ID)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        decoded = {}
        for i in range(SCENE_FRAMES):
            for kind in ("", ".depth", ".instance"):
                decoded[i, kind] = png_io.read_png(os.path.join(scene, "full", f"{i}{kind}.png"))
        t_decode = time.perf_counter() - t0
        for i in range(SCENE_FRAMES):
            rgb, zdepth, inst, _ = frame_images(i, (W, H), SCENE_FRAMES)
            for kind, want in (("", rgb), (".depth", zdepth), (".instance", inst)):
                got = decoded[i, kind]
                _expect(got.dtype == want.dtype and np.array_equal(got, want),
                        f"frame {i}{kind}.png does not decode to the array written")
                again = png_io.decode_png(png_io.encode_png(got, [4, 3, 2, 1, 0]))
                _expect(np.array_equal(again, got), f"frame {i}{kind}: re-encoding differs")
        with open(os.path.join(scene, "full", "0.png"), "rb") as f:
            data = f.read()
        import zlib

        idat = b"".join(data[p + 8:p + 8 + int.from_bytes(data[p:p + 4], "big")]
                        for p in range(8, len(data) - 8)
                        if data[p + 4:p + 8] == b"IDAT")
        rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, -1)
        _expect(sorted(set(rows[:, 0].tolist())) == [0, 1, 2, 3, 4],
                "the written frames should use all five row filters")

        desk_args = [
            f"dataset_config={os.path.join(root, 'config', 'synthetic_desk.yml')}",
            f"img_wh=[{W},{H}]", f"dataset_extra.root_dir={scene}",
            f"dataset_extra.split={scene}/split", f"dataset_extra.pcd_path={scene}/pcd.ply",
            f"dataset_extra.bbox_dir={scene}/bbox.json",
            f"dataset_extra.validate_idx={SCENE_FRAMES - 1}"]
        config = load_config(cli_args=desk_args)
        t0 = time.perf_counter()
        ds = dataset_dict[config.dataset_name]("train", img_wh=(W, H),
                                               dataset_extra=config.dataset_extra)
        t_build = time.perf_counter() - t0
        n = W * H
        n_train = len(ds.frames)
        schema = {"rays": ((n_train * n, 8), np.float32), "rgbs": ((n_train * n, 3), np.float32),
                  "depths": ((n_train * n,), np.float32), "valid_mask": ((n_train * n,), bool),
                  "instance_masks": ((n_train * n, 3), bool),
                  "instance_weights": ((n_train * n, 3), np.float32),
                  "pass_through": ((n_train * n, 3), bool),
                  "inst_ids": ((n_train * n, 3), np.int64),
                  "frame_indices": ((n_train * n,), np.int64)}
        for k, (shape, dtype) in schema.items():
            a = getattr(ds, k)
            _expect(a.shape == shape and a.dtype == dtype,
                    f"train buffer {k}: {a.shape} {a.dtype}, expected {shape} {dtype}")
        _expect(n_train == SCENE_FRAMES - 2, f"{n_train} train frames")
        scale, ids = ds.scale_factor, ds.instance_ids
        for j, frame in enumerate(ds.frames):
            i, sl = frame["idx"], slice(j * n, (j + 1) * n)
            pose = np.array(frame["transform_matrix"], np.float64)
            pose[:3, :3] = pose[:3, :3] @ FIX_ROT
            pose = center_pose_from_avg(ds.pose_avg, pose)
            pose[:, 3] /= scale
            rays_o, rays_d = get_rays(ds.directions, pose[:3, :4].astype(np.float32))
            _expect(np.array_equal(ds.rays[sl, :3], rays_o.astype(np.float32))
                    and np.array_equal(ds.rays[sl, 3:6], rays_d.astype(np.float32)),
                    f"frame {i}: rays differ from get_rays of the centred pose")
            _expect((ds.rays[sl, 6] == np.float32(ds.near / scale)).all()
                    and (ds.rays[sl, 7] == np.float32(ds.far / scale)).all(),
                    f"frame {i}: near / far")
            _expect(np.array_equal(ds.rgbs[sl], decoded[i, ""].reshape(-1, 3) / np.float32(255)),
                    f"frame {i}: rgb")
            inst = decoded[i, ".instance"].reshape(-1)
            for k, inst_id in enumerate(ids):
                m = inst == inst_id
                _expect(np.array_equal(ds.instance_masks[sl, k], m)
                        and np.array_equal(ds.instance_weights[sl, k],
                                           np.where(m, np.float32(1.0), np.float32(0.05)))
                        and np.array_equal(ds.pass_through[sl, k], m | (inst == 0))
                        and (ds.inst_ids[sl, k] == inst_id).all(),
                        f"frame {i}, instance {inst_id}: mask, weight or pass-through")
        _expect(ds.instance_masks.any(0).all() and ds.valid_mask.any(), "empty masks")
        print(f"desk scene {W}x{H}, {SCENE_FRAMES} frames: written in {t_write:.2f} s (all five "
              f"PNG row filters), {3 * SCENE_FRAMES} PNGs decoded in {t_decode:.2f} s (bit-equal "
              f"to the arrays written, re-encoding round-trips), {n_train} train frames' buffers "
              f"built in {t_build:.2f} s ({len(ds):,} rays; rays, masks, weights and "
              f"pass-through checked against get_rays and the decoded maps)")
        del ds, decoded

        # -- 21. the train CLI on config/synthetic_desk.yml ---------------------------------
        losses = []
        training_step = system_mod.ObjectNeRFSystem.training_step

        def recording_step(self, np_batch):
            metrics = training_step(self, np_batch)
            losses.append(metrics["train/loss"])
            return metrics

        reset_counts()
        system_mod.ObjectNeRFSystem.training_step = recording_step
        t0 = time.perf_counter()
        try:
            train_cli.main(desk_args + [
                "exp_name=desk", "device=cuda", f"train.batch_size={BATCH}", "train.num_epochs=1",
                f"train.limit_train_batches={SCENE_STEPS}", "train.val_check_interval=1.0",
                f"chunk={CHUNK}", f"train.seed={SEED}"])
        finally:
            system_mod.ObjectNeRFSystem.training_step = training_step
        torch.cuda.synchronize()
        t_cli = time.perf_counter() - t0
        launched, n_lookup, n_build = counts("desk_train_cli")
        losses = [float(x) for x in losses]
        s_ = SCENE_STEPS
        print(f"train CLI, config/synthetic_desk.yml at {W}x{H}, batch {BATCH}: {len(losses)} "
              f"steps and one validation in {t_cli:.1f} s (system build, source snapshot and "
              f"checkpoints included); launches {launched}, corner_lookup {n_lookup}, table builds "
              f"{n_build}; loss " + " ".join(f"{x:.4f}" for x in losses))
        _expect(len(losses) == s_, f"the CLI took {len(losses)} steps, not {s_}")
        _expect(launched == kernels(fused_mlp_eval=2 * s_, fused_mlp_bwd=2 * s_,
                                    fused_coarse_weights=n_chunks, fused_render_tiles=n_chunks)
                and n_lookup == 2 * s_ + 2 * n_chunks and n_build == s_ + 1,
                f"expected 2 + 2 launches, 2 lookups and 1 build per step and {n_chunks} + "
                f"{n_chunks} launches on the validation frame")
        record("desk_train_cli", launched, n_lookup)
        _expect(all(x == x and abs(x) != float("inf") for x in losses), "a desk loss is not finite")
        head, tail = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
        print(f"desk loss: mean of the first five {head:.4f}, of the last five {tail:.4f}")
        _expect(tail < head, "the desk loss did not fall")
        runs = glob.glob(os.path.join(work, "logs", "*_desk"))
        _expect(len(runs) == 1, f"one run directory expected: {runs}")
        run_b = runs[0]
        for f in ("last.ckpt", "epoch_0.ckpt", "run_config_snapshot.yaml",
                  "source_snapshot/object_nerf_torch/data/png_io.py",
                  "source_snapshot/chip_smoke.py"):
            _expect(os.path.isfile(os.path.join(run_b, f)), f"the run lacks {f}")
        print(f"run {os.path.relpath(run_b, work)}: " + ", ".join(sorted(os.listdir(run_b))))

        # -- 22. the scannet-keyed config: one step on the route, kernels vs plain bf16 ------
        scan_args = [
            f"dataset_config={os.path.join(root, 'config', 'scannet_base_0113_multi.yml')}",
            f"img_wh=[{W},{H}]", f"dataset_extra.root_dir={scene}",
            f"dataset_extra.split={scene}/split", f"dataset_extra.scans_dir={scene}/scans",
            f"dataset_extra.bbox_dir={scene}", f"dataset_extra.scene_id={SCENE_ID}",
            f"dataset_extra.pcd_path={scene}/pcd.ply", "dataset_extra.instance_id=[1,2]",
            "dataset_extra.val_instance_id=1", "dataset_extra.bg_instance_id=[0]",
            "dataset_extra.inst_seg_tag=instance", "dataset_extra.scene_center=[0,0,0]",
            f"dataset_extra.validate_idx={SCENE_FRAMES - 1}", f"train.batch_size={BATCH}",
            "model.perturb=1", "model.noise_std=1", "train.optimizer=adam",
            "train.lr_scheduler=poly", f"train.seed={SEED}", "train.nan_check_every=1000000"]
        cfg_val = load_config(cli_args=scan_args)  # the shipped use_bbox_only_for_test: true
        cfg_c = load_config(cli_args=scan_args + ["dataset_extra.use_bbox_only_for_test=false"])
        kw = dict(img_wh=(W, H))
        train_c = dataset_dict[cfg_c.dataset_name]("train", dataset_extra=cfg_c.dataset_extra,
                                                   **kw)
        val = dataset_dict[cfg_val.dataset_name]("val", dataset_extra=cfg_val.dataset_extra, **kw)
        system = system_mod.ObjectNeRFSystem(cfg_c, dataset=train_c, val_dataset=val, device=dev)
        models, settings = system.models, system.settings
        cfg, topo, static = settings.mlp, system.voxel_topo, system.voxel_static
        _expect(settings.rays_in_bbox and system.eval_settings.rays_in_bbox,
                "the scannet-keyed system should be on the rays_in_bbox route")
        with torch.no_grad():  # see DENSITY_BIAS; the route's pdf is the object's
            for m in (models.nerf_coarse, models.nerf_fine):
                m.sigma.bias += DENSITY_BIAS
                m.instance_sigma.bias += DENSITY_BIAS
        batch = system._device_batch(train_c.sample_batch(BATCH, system.batch_rng))
        draws = RenderDraws.sample(settings, BATCH, dev, system.generator)
        with torch.no_grad():
            codes = models.code_library(batch["instance_ids"])
            vctx = (models.voxel_features, topo, static)
            on, off = (render_rays(models, batch["rays"], st, codes, batch["pass_through_mask"],
                                   draws=draws, voxel_ctx=vctx)
                       for st in (settings, dataclasses.replace(settings, rays_in_bbox=False)))
            moved = (on["z_vals_fine"] - off["z_vals_fine"]).abs().amax(-1)
            same = torch.equal(on["rgb_coarse"], off["rgb_coarse"])
        hit = (batch["instance_mask"]).float().mean().item()
        print(f"scannet-keyed batch: {100 * hit:.1f} % of the rays in the box and the "
              f"instance's mask; the route moves the fine z_vals of "
              f"{100 * (moved > 1e-4).float().mean().item():.1f} % of the rays (max "
              f"{moved.max().item():.3e}); coarse scene maps unchanged: {same}")
        _expect(moved.max().item() > 1e-3 and same,
                "the route's fine z_vals should differ from the scene-weight pdf's")
        del on, off
        def compare_step(path, st, kernel_models, kernel_step):
            """One step from the same weights and draws through the kernels
            (`kernel_step` on `kernel_models`), the plain bf16 path and the
            plain f32 path (the control); (launches, loss pair, MLP errors,
            table error, control)."""
            twin, twin32 = copy.deepcopy(kernel_models), copy.deepcopy(kernel_models)
            plain = [system_mod.make_train_step(
                dataclasses.replace(st, matmul_dtype=dt), dict(cfg_c.loss),
                make_optimizer(cfg_c.train, m.parameters()), system.lr_schedule, plain=True)
                for m, dt in ((twin, torch.bfloat16), (twin32, torch.float32))]
            reset_counts()
            m_k = kernel_step(kernel_models, batch, draws=draws, voxel_topo=topo,
                              voxel_static=static)
            torch.cuda.synchronize()
            launches = counts(path)
            m_p = plain[0](twin, batch, draws=draws, voxel_topo=topo, voxel_static=static)
            plain[1](twin32, batch, draws=draws, voxel_topo=topo, voxel_static=static)
            torch.cuda.synchronize()
            e = {k: _rel(p.grad, q.grad) for (k, p), q in zip(kernel_models.named_parameters(),
                                                              twin.parameters())}
            control = {k: _rel(p.grad, q.grad) for (k, p), q in zip(twin.named_parameters(),
                                                                    twin32.parameters())}
            table = "embedding_xyz.embedding_space_ftr.weight"
            return (launches, (float(m_k["train/loss"]), float(m_p["train/loss"])), e,
                    e.pop(table), control[table])

        # the same first step off the route (scene-weight pdf) on copies, for
        # scale: how far the two bf16 computations drift on this grid anyway
        off_models = copy.deepcopy(models)
        off_settings = dataclasses.replace(settings, rays_in_bbox=False)
        off_step = system_mod.make_train_step(
            off_settings, dict(cfg_c.loss), make_optimizer(cfg_c.train, off_models.parameters()),
            system.lr_schedule)
        results = {"route": compare_step("route_train_step", settings, models, system.train_step),
                   "scene pdf": compare_step("scene_pdf_train_step", off_settings, off_models,
                                             off_step)}
        del off_models, off_step
        for label, ((launched, n_lookup, n_build), (loss_k, loss_p), e, e_table,
                    control) in results.items():
            worst = max(e, key=e.get)
            print(f"scannet-keyed step 1 ({label}), kernels vs plain bf16 path: loss "
                  f"{loss_k:.6f} vs {loss_p:.6f} (rel {abs(loss_k - loss_p) / abs(loss_p):.2e}, "
                  f"tol {LOSS_TOL:g}); MLP gradients: worst {e[worst]:.2e} at {worst} (tol "
                  f"{VOX_STEP_GRAD_TOL:g}), median {statistics.median(e.values()):.2e}; table "
                  f"gradient {e_table:.2e} (tol: a quarter of the plain bf16 step's distance to "
                  f"the plain f32 step, {control:.2e}; see ROUTE_TABLE_GRAD); launches "
                  f"{launched}, corner_lookup {n_lookup}, table builds {n_build}")
            _expect(launched == kernels(fused_mlp_eval=2, fused_mlp_bwd=2) and n_lookup == 2
                    and n_build == 1, "a voxel step should launch 2 + 2 kernels, 2 lookups, "
                                      "1 build")
            _expect(abs(loss_k - loss_p) <= LOSS_TOL * abs(loss_p),
                    f"the {label} step's loss disagrees with the plain path's")
            _expect(e[worst] <= VOX_STEP_GRAD_TOL,
                    f"the {label} step's gradients disagree: {e[worst]:.3e} at {worst}")
            _expect(e_table <= ROUTE_TABLE_GRAD * control,
                    f"the {label} step's table gradient disagrees: {e_table:.3e} (plain bf16 "
                    f"vs f32 {control:.3e})")
        record("route_train_step", results["route"][0][0], results["route"][0][1])
        run_c = os.path.join(work, "logs", "scannet_route")
        save_config_snapshot(run_c, cfg_val)
        ckpt_c = save_checkpoint(run_c, system, name="last")

        # -- 23. one 640x480 validation frame on the route ----------------------------------
        batch_v = val.whole_image_batch(0)
        reset_counts()
        out = system.render_image(batch_v, chunk=CHUNK)
        torch.cuda.synchronize()
        launched, n_lookup, n_build = counts("route_val_frame")
        near, far = batch_v["rays"][:, 6], batch_v["rays"][:, 7]
        miss = (near == 0) & (far == 0)
        finite = all(np.isfinite(v).all() and v.shape[0] == n for v in out.values())
        print(f"route frame {W}x{H}: launches {launched}, corner_lookup {n_lookup}, table builds "
              f"{n_build} (expect {n_chunks} fused_mlp_eval, {n_chunks} fused_render_tiles, no "
              f"fused_coarse_weights); {int(miss.sum())} of {n} rays miss the box (near = far = "
              f"0); maps finite: {finite}; the misses' opacity at most "
              f"{np.abs(out['opacity_instance_fine'][miss]).max():.2e} (instance)")
        _expect(launched == kernels(fused_mlp_eval=n_chunks, fused_render_tiles=n_chunks)
                and n_lookup == 2 * n_chunks and n_build == 1,
                "the route frame's launch counts are not those of its path")
        _expect(0 < miss.sum() < n, "the frame should have rays in the box and rays outside")
        _expect(finite, "a route frame map is not finite")
        record("route_val_frame", launched, n_lookup)
        features = models.voxel_features
        with torch.no_grad():
            ctx16 = (features, topo, static, vg.CornerTable(features, topo, static, lowp=True))
            ctx32 = (features, topo, static, vg.CornerTable(features, topo, static, lowp=False))
            ids_v = torch.from_numpy(batch_v["instance_ids"]).to(dev)
            for c in CHECK_CHUNKS:
                sl = slice(c * CHUNK, (c + 1) * CHUNK)
                rays_c = torch.from_numpy(batch_v["rays"][sl]).to(dev)
                codes_c = models.code_library(ids_v[sl])
                got = torch.from_numpy(out["rgb_fine"][sl]).to(dev)
                ref16 = render_rays_plain(models, rays_c, system.eval_settings, codes_c,
                                          matmul_dtype=torch.bfloat16, voxel_ctx=ctx16)
                ref32 = render_rays_plain(models, rays_c, system.eval_settings, codes_c,
                                          matmul_dtype=torch.float32, voxel_ctx=ctx32)
                p16 = psnr(got, ref16["rgb_fine"]).item()
                p32 = psnr(got, ref32["rgb_fine"]).item()
                diffs = ", ".join(
                    f"{k} {(torch.from_numpy(out[k][sl]).to(dev) - v).abs().max().item():.2e}"
                    for k, v in ref16.items())
                print(f"route chunk {c} ({int(miss[sl].sum())} misses): rgb_fine PSNR vs plain "
                      f"bf16 on the same bf16 table {p16:.2f} dB (floor {VOX_PSNR_FLOOR_DB:g}), "
                      f"vs the all-f32 path {p32:.2f} dB (floor {VOX_F32_PSNR_FLOOR_DB:g}); max "
                      f"abs diff vs plain bf16: {diffs}")
                _expect(p16 >= VOX_PSNR_FLOOR_DB, f"route chunk {c}: {p16:.2f} dB from plain bf16")
                _expect(p32 >= VOX_F32_PSNR_FLOOR_DB, f"route chunk {c}: {p32:.2f} dB from f32")
            # row 3 at the route's shape: chunk 0's coarse pass, packed, both branches
            rays_c = torch.from_numpy(batch_v["rays"][:CHUNK]).to(dev)
            codes_c = models.code_library(ids_v[:CHUNK]).contiguous()
            z_c = stratified_sample(rays_c[:, 6:7], rays_c[:, 7:8], N_SAMPLES)
            xyz_c = (rays_c[:, None, 0:3] + rays_c[:, None, 3:6] * z_c[..., None]).contiguous()
            dir_pe = freq_encode(rays_c[:, 3:6], cfg.N_freq_dir).contiguous()
            raw_c = lookup_voxel_raw(system.eval_settings, ctx16, xyz_c)
            packed = fwd_chain.pack_kernel_weights(models.nerf_coarse, cfg, True)

            def run():
                return fv.fused_mlp_eval(models.nerf_coarse, cfg, xyz_c, dir_pe, codes_c,
                                         voxel_raw=raw_c, packed=packed)

            def run_plain():
                return fv.mlp_eval_plain(models.nerf_coarse, cfg, xyz_c, dir_pe, codes_c,
                                         voxel_raw=raw_c)

            got, again, want = run(), run(), run_plain()
            torch.cuda.synchronize()
            _expect(all(torch.equal(a, b) for a, b in zip(got, again)),
                    "two launches of fused_mlp_eval at the route's shape differ")
            names = ("sigma", "rgb", "inst_sigma", "inst_rgb")
            errs = {k: (a - b).abs().max().item() for k, a, b in zip(names, got, want)}
            route_err = max(errs.values())
            _expect(route_err <= KERNEL_TOL,
                    f"fused_mlp_eval at the route's shape disagrees: {route_err:.3e}")
            route_ms = _cuda_ms(run, TIMED_LAUNCHES)
            route_plain_ms = _cuda_ms(run_plain, 3)
            rows = CHUNK * N_SAMPLES
            per_ray = 4 * CHUNK * (cfg.in_channels_dir + cfg.N_obj_code_length)
            nbytes = (rows * (12 + raw_c.element_size() * raw_c.shape[-1] + 32) + per_ray
                      + 2 * packed.w.numel() + 4 * packed.b.numel())
            flop = 2 * _macs_per_sample(cfg, False) * rows
            route_bound, route_by = _bound(flop, nbytes, peak_flops, peak_bytes)
            print(f"fused_mlp_eval {tuple(xyz_c.shape)} (the route's coarse pass: packed, both "
                  f"branches, voxel operand): max |kernel - plain bf16| "
                  + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                  + f" (tol {KERNEL_TOL:g}), relaunch bit-equal; {route_ms:.3f} ms/launch, plain "
                  f"{route_plain_ms:.3f} ms, bound {route_bound:.3f} ms ({route_by}: "
                  f"{flop / 1e12:.3f} TFLOP, {nbytes / 1e6:.1f} MB), "
                  f"{flop / route_ms / 1e9:.1f} TFLOP/s achieved")
            del ctx32, ref16, ref32, got, again, want
        # the frame on the route, and the same frame, model and grid on the
        # scene-weight pdf (fused_coarse_weights for the coarse pass), in turns
        scene_pdf = dataclasses.replace(system.eval_settings, rays_in_bbox=False)
        frames = {
            "route": lambda: system.render_image(batch_v, chunk=CHUNK),
            "scene_pdf": lambda: system_mod.render_image(
                models, scene_pdf, batch_v, chunk=CHUNK, device=dev, voxel_topo=topo,
                voxel_static=static)}
        times = {k: [] for k in frames}
        for _ in range(FRAMES_TIMED):
            for k in ("route", "scene_pdf", "scene_pdf", "route"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                frames[k]()
                torch.cuda.synchronize()
                times[k].append(time.perf_counter() - t0)
        route_frame_ms = statistics.median(times["route"]) * 1e3
        scene_pdf_ms = statistics.median(times["scene_pdf"]) * 1e3
        beside = (f"phase 13's voxel frame (the room) {frame13_ms:.1f} ms"
                  if frame13_ms is not None else "phase 13 not run")
        print(f"route frame: {route_frame_ms:.1f} ms median of {len(times['route'])} (all: "
              f"{', '.join(f'{t * 1e3:.1f}' for t in times['route'])}), "
              f"{n / (route_frame_ms / 1e3):.0f} rays/s; the same frame on the scene-weight pdf "
              f"in turns {scene_pdf_ms:.1f} ms (all: "
              f"{', '.join(f'{t * 1e3:.1f}' for t in times['scene_pdf'])}); {beside}; row 3 at "
              f"the route's shape {n_chunks} x {route_ms:.3f} ms")

        # -- 24. the eval CLI on the route step's checkpoint ------------------------------------
        reset_counts()
        eval_cli.main([f"dataset_config={run_c}/run_config_snapshot.yaml",
                       f"ckpt_path={ckpt_c}", "device=cuda", f"chunk={CHUNK}",
                       f"save_images={work}/eval_images"])
        torch.cuda.synchronize()
        launched, n_lookup, n_build = counts("route_eval_cli")
        _expect(launched == kernels(fused_mlp_eval=n_chunks, fused_render_tiles=n_chunks)
                and n_lookup == 2 * n_chunks and n_build == 1,
                f"the eval CLI's route frame: launches {launched}, lookups {n_lookup}")
        record("route_eval_cli", launched, n_lookup)
        img = png_io.read_png(os.path.join(work, "eval_images", "eval_0000.png"))
        _expect(img.shape == (H, W, 3) and img.dtype == np.uint8 and img.std() > 0,
                f"the eval CLI's PNG reads back as {img.shape} {img.dtype}")
        print(f"eval CLI on the scannet-keyed checkpoint: launches {launched}, corner_lookup "
              f"{n_lookup}; eval_0000.png re-read {img.shape}, mean level {img.mean():.1f}")

        # -- 25. the edit CLI on the desk run's checkpoint ----------------------------------
        reset_counts()
        render_path = edit_cli.main([
            f"config={os.path.join(root, 'config', 'edit_synthetic_desk.yaml')}",
            f"ckpt_path={run_b}/last.ckpt", f"total_frames={SCENE_EDIT_FRAMES}", "device=cuda"])
        torch.cuda.synchronize()
        launched, n_lookup, n_build = counts("desk_edit_cli")
        record("desk_edit_cli", launched, n_lookup)
        pngs = sorted(glob.glob(os.path.join(work, render_path, "render_*.png")))
        shapes = [png_io.read_png(p).shape for p in pngs]
        print(f"edit CLI, {SCENE_EDIT_FRAMES} frames on the desk run: launches {launched}, "
              f"corner_lookup {n_lookup}, table builds {n_build}; PNGs re-read {shapes}")
        _expect(len(pngs) == SCENE_EDIT_FRAMES and all(s == (72, 96, 3) for s in shapes),
                "the edit CLI's PNGs do not read back as 96x72 RGB")
        _expect(launched["fused_sigma_eval"] > 0 and launched["fused_mlp_eval"] > 0,
                "the edit CLI ran no density or MLP kernel")

        # -- 26. phase 21's run under torchrun: NCCL, world size 1 ----------------------------
        import re

        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join([root] + [q for q in env.get("PYTHONPATH", "")
                                                      .split(os.pathsep) if q])
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
             "-m", "object_nerf_torch.train", *desk_args, "exp_name=desk_nccl", "device=cuda",
             f"train.batch_size={BATCH}", "train.num_epochs=1",
             f"train.limit_train_batches={SCENE_STEPS}", "train.val_check_interval=1.0",
             f"chunk={CHUNK}", f"train.seed={SEED}", "tpu.distributed=true"],
            cwd=work, env=env, capture_output=True, text=True, timeout=DP_TIMEOUT_S)
        t_nccl = time.perf_counter() - t0
        _expect(proc.returncode == 0, f"the train CLI under torchrun failed:\n"
                                      f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        epoch = re.search(r"epoch 0: loss=([0-9.]+) psnr=([-0-9.inf]+)", proc.stdout)
        val = re.findall(r"\[val\] epoch 0 it (\d+): psnr", proc.stdout)
        _expect("distributed: rank 0 of 1, backend nccl" in proc.stdout and epoch is not None
                and val == [str(SCENE_STEPS - 1)],
                f"the torchrun run should say rank 0 of 1 on NCCL, one epoch line and one "
                f"validation after step {SCENE_STEPS}:\n{proc.stdout[-3000:]}")
        runs = glob.glob(os.path.join(work, "logs", "*_desk_nccl"))
        _expect(len(runs) == 1, f"one run directory expected from rank 0: {runs}")
        for f in ("last.ckpt", "epoch_0.ckpt", "run_config_snapshot.yaml"):
            _expect(os.path.isfile(os.path.join(runs[0], f)), f"the torchrun run lacks {f}")
        loss_nccl = float(epoch.group(1))
        print(f"{_card()}: train CLI under torchrun, NCCL, world size 1, "
              f"config/synthetic_desk.yml at {W}x{H}, batch {BATCH}: {SCENE_STEPS} steps and "
              f"one validation in {t_nccl:.1f} s wall (torchrun, interpreter start and the "
              f"built library's load included) against phase 21's {t_cli:.1f} s in process; "
              f"last loss {loss_nccl:.4f} (phase 21: {losses[-1]:.4f}; its first five "
              f"{head:.4f}); one run directory: {', '.join(sorted(os.listdir(runs[0])))}")
        _expect(loss_nccl < head, "the loss under torchrun did not fall below phase 21's start")
    finally:
        os.chdir(cwd)
    # phases 28 and 29 work on the same desk and phase 21's run; main removes `work`
    desk = {"work": work, "scene": scene, "args": desk_args, "run": run_b}
    return paths, {"err": route_err, "ms": route_ms, "plain_ms": route_plain_ms,
                   "bound_ms": route_bound, "bound_by": route_by,
                   "frame_ms": route_frame_ms, "scene_pdf_frame_ms": scene_pdf_ms}, desk


def _desk_mesh_phase(torch, dev, desk):
    """Phase 28: the mesh CLI on phase 21's desk checkpoint, then the scene
    viewer CLI with that mesh, the desk's poses and boxes, as a user runs
    them. Returns the sweep's launches of `fused_sigma_eval` and
    `corner_lookup`."""
    import re

    import numpy as np

    from object_nerf_torch.data.ply_io import read_ply
    from object_nerf_torch.models import voxel_grid as vg
    from object_nerf_torch.ops import fused_mlp, gather
    from object_nerf_torch.ops.fused_sigma import sigma_eval_plain
    from object_nerf_torch.tools import extract_mesh, scene_visualizer

    work, args = desk["work"], desk["args"]
    out_dir = os.path.join(work, "desk_mesh")
    mesh_args = args + [f"ckpt_path={desk['run']}/last.ckpt", f"device={dev.type}",
                        f"out_dir={out_dir}", "prefix=desk"]
    sweep = extract_mesh.extract_sigma_grid
    seen = []

    def recording_sweep(*a, **k):  # the CLI's own call, its arguments and grid kept
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = sweep(*a, **k)
        seen.append((a, k, grid, time.perf_counter() - t0))
        return grid

    extract_mesh.extract_sigma_grid = recording_sweep
    try:
        # a first look at the checkpoint's densities on a coarse grid (not
        # counted) gives the threshold: a high quantile of the positive ones
        extract_mesh.main(mesh_args + [f"N_grid={DESK_MESH_PROBE_GRID}"])
        coarse = seen.pop()[2]
        _expect((coarse > 0).any(), "the desk checkpoint has no positive density on the grid")
        level = float(np.quantile(coarse[coarse > 0], DESK_MESH_QUANTILE))
        print(f"desk checkpoint, {DESK_MESH_PROBE_GRID}^3 densities: "
              f"{100 * (coarse > 0).mean():.2f} % above 0, max {coarse.max():.3f}; "
              f"sigma_threshold={level!r} (the {DESK_MESH_QUANTILE:g} quantile of the positive "
              f"ones)")
        fused_mlp.reset_launch_counts()  # every counter of utils/trace.py
        extract_mesh.main(mesh_args + [f"N_grid={DESK_MESH_GRID}", f"sigma_threshold={level!r}"])
        torch.cuda.synchronize()
        launched = dict(fused_mlp.launch_counts)
        n_lookup, n_build = _lookups(gather, "desk_mesh"), vg.build_counts["corner_table"]
    finally:
        extract_mesh.extract_sigma_grid = sweep
    (models, settings, config, obj_id), kw, grid, t_sweep = seen.pop()
    n = DESK_MESH_GRID
    expect = -(-n ** 3 // extract_mesh.CUDA_CHUNK)
    print(f"{_card()}: mesh CLI, phase 21's desk checkpoint, N_grid={n}: sweep "
          f"{t_sweep * 1e3:.1f} ms "
          f"(host clock around the CLI's sweep, the grid's copy to the host included); "
          f"launches {launched}, corner_lookup {n_lookup}, table builds {n_build} (expect "
          f"{expect} of fused_sigma_eval and of corner_lookup, one chunk of "
          f"{extract_mesh.CUDA_CHUNK} points each, and 1 build)")
    _expect(launched == {**dict.fromkeys(launched, 0), "fused_sigma_eval": expect}
            and n_lookup == expect and n_build == 1,
            "the desk mesh sweep's launch counts are not those of its path")
    # two x-slices of the CLI's grid against the plain bf16 path on the same
    # points and the same f32 corner table as the sweep's (and, for scale, the
    # plain f32 path). Phase 14's limit, relative to the grid's largest
    # density: the trained desk's densities reach about 10, the room's random
    # model's about 1, and two bf16 computations differ in proportion
    features, topo, static = kw["voxel_ctx"][:3]
    model = models.nerf_fine
    scale = float(grid.max())
    errs, errs32 = {}, {}
    with torch.no_grad():
        ct = vg.make_corner_table(features, topo, static)
        for i in (n // 2, (3 * n) // 5):
            pts = extract_mesh.grid_points(config, i * n * n, n * n, dev)
            raw, _ = vg.voxel_lookup_raw(features, topo, static, pts, ct=ct)
            got = torch.from_numpy(grid[i]).to(dev).reshape(-1)
            for out, dt in ((errs, torch.bfloat16), (errs32, torch.float32)):
                want = sigma_eval_plain(model, settings.mlp, pts, None, "scene", n * n, raw,
                                        dt).clamp_(min=0.0)
                out[i] = (got - want).abs().max().item() / scale
        del ct
    print(f"mesh CLI grid vs the plain bf16 path on x-slices {list(errs)}: max abs / largest "
          f"density ({scale:.4f}) " + ", ".join(f"{v:.3e}" for v in errs.values())
          + f" (tol {VOX_MESH_F32_TOL:g}, phase 14's limit); vs the plain f32 path "
          + ", ".join(f"{v:.3e}" for v in errs32.values())
          + f" (not gated); densities {grid.min():.4f} .. {scale:.4f}")
    _expect(np.isfinite(grid).all() and scale > 0 and max(errs.values()) <= VOX_MESH_F32_TOL,
            "the desk mesh CLI's grid disagrees with the plain bf16 path")
    ply = os.path.join(out_dir, "extracted_mesh_desk.ply")
    mesh = read_ply(ply)
    n_faces = 0 if mesh["faces"] is None else len(mesh["faces"])
    _expect(n_faces > 0, "the desk mesh is empty")

    # the scene viewer with that mesh, the desk's poses and boxes
    with open(os.path.join(desk["scene"], "transforms_full.json")) as f:
        n_cams = len(json.load(f)["frames"][::10])
    n_pcd = len(read_ply(os.path.join(desk["scene"], "pcd.ply"))["points"])
    n_lines = 12 * 3 + 4 * n_cams + (n_cams - 1)  # boxes, frusta, trajectory
    secs = {}
    for out in ("desk.html", "desk.ply"):
        t0 = time.perf_counter()
        scene_visualizer.main(args + [f"mesh={ply}", f"out={os.path.join(work, out)}"])
        secs[out] = time.perf_counter() - t0
    html = open(os.path.join(work, "desk.html")).read()
    layers = {d["name"]: d for d in json.loads(
        re.search(r"const DATA=(\[.*?\]), LABELS", html).group(1))}
    labels = [d["t"] for d in json.loads(re.search(r"LABELS=(\[.*?\]), CENTER", html).group(1))]
    got = {k: layers[k]["n"] for k in ("points", "lines", "mesh_0")}
    want = {"points": n_pcd, "lines": 2 * n_lines, "mesh_0": 3 * n_faces}
    back = read_ply(os.path.join(work, "desk.ply"))["points"]
    mb = os.path.getsize(os.path.join(work, "desk.html")) / 1e6
    print(f"{_card()}: scene viewer CLI, the desk with its {len(mesh['points'])}-vertex, "
          f"{n_faces}-face mesh: desk.html in {secs['desk.html']:.3f} s host ({mb:.2f} MB; "
          f"layers {got}, expected {want}; labels {labels}), desk.ply in "
          f"{secs['desk.ply']:.3f} s host ({len(back)} points read back)")
    _expect(got == want and labels == ["obj 1", "obj 2", "obj 3"],
            "the viewer's layers or labels are not the desk's")
    _expect(len(back) == n_pcd + 32 * n_lines + len(mesh["points"]),
            "the viewer's PLY does not read back with the expected point count")
    return {"fused_sigma_eval": launched["fused_sigma_eval"], "corner_lookup": n_lookup}


def _data_prep_phase(desk):
    """Phase 29 (host only, no image library): a `.sens` capture of the
    desk's frames written, loaded and exported (depth, poses, intrinsics),
    and a labelled scan of the desk's spheres through the label export."""
    import zlib

    import numpy as np

    from object_nerf_torch.data.ply_io import read_ply, write_ply
    from object_nerf_torch.data.png_io import read_png
    from object_nerf_torch.data_prep import scannet_labels, sens_reader

    root = os.path.join(desk["work"], "data_prep")
    with open(os.path.join(desk["scene"], "transforms_full.json")) as f:
        frames = json.load(f)["frames"]
    focal = 0.7 * W  # the desk writer's focal length
    k = np.array([[focal, 0, W / 2, 0], [0, focal, H / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                 np.float32)
    rng = np.random.RandomState(SEED)
    depths = [(rng.rand(H, W) * 5000).astype(np.uint16) for _ in frames]
    sd = sens_reader.SensorData(
        sensor_name="chip_smoke desk", intrinsic_color=k, extrinsic_color=np.eye(4),
        intrinsic_depth=k, extrinsic_depth=np.eye(4), color_width=W, color_height=H,
        depth_width=W, depth_height=H)
    for i, (fr, d) in enumerate(zip(frames, depths)):
        sd.frames.append(sens_reader.RGBDFrame(
            np.array(fr["transform_matrix"], np.float32), i, i,
            b"colour bytes that nothing decodes %d" % i, zlib.compress(d.tobytes())))
    sens = os.path.join(root, "desk.sens")
    os.makedirs(root)
    t0 = time.perf_counter()
    sens_reader.write_sens(sens, sd)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = sens_reader.SensorData.load(sens)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded.export_depth_images(os.path.join(root, "depth"))
    loaded.export_depth_images(os.path.join(root, "depth_half"), image_size=(H // 2, W // 2))
    loaded.export_poses(os.path.join(root, "pose"))
    loaded.export_intrinsics(os.path.join(root, "intrinsic"))
    t_export = time.perf_counter() - t0

    def text(mat):  # np.savetxt(fmt="%f") of what was written, formatted here
        return "".join(" ".join(f"{v:f}" for v in row) + "\n" for row in np.asarray(mat))

    for i, (fr, d) in enumerate(zip(frames, depths)):
        _expect(np.array_equal(read_png(os.path.join(root, "depth", f"{i}.png")), d)
                and np.array_equal(read_png(os.path.join(root, "depth_half", f"{i}.png")),
                                   d[::2, ::2]),
                f"frame {i}: the exported depth is not the depth written")
        with open(os.path.join(root, "pose", f"{i}.txt")) as f:
            _expect(f.read() == text(np.array(fr["transform_matrix"], np.float32)),
                    f"frame {i}: the exported pose is not the pose written")
    for name, mat in (("intrinsic_color", k), ("intrinsic_depth", k),
                      ("extrinsic_color", np.eye(4)), ("extrinsic_depth", np.eye(4))):
        with open(os.path.join(root, "intrinsic", f"{name}.txt")) as f:
            _expect(f.read() == text(mat.astype(np.float32)), f"{name}.txt differs")
    print(f"{_card()} (host only): .sens capture of the desk's {len(frames)} frames ({W}x{H} "
          f"depth, "
          f"{os.path.getsize(sens) / 1e6:.2f} MB): written in {t_write:.3f} s, loaded in "
          f"{t_load:.3f} s; depth (native and {W // 2}x{H // 2}), poses and intrinsics exported "
          f"in {t_export:.2f} s, bit-equal to what was written")

    # a labelled scan of the desk's spheres: the point cloud's vertices, one
    # segment per sphere (the plane's unlabelled), an identity axisAlignment
    pts = read_ply(os.path.join(desk["scene"], "pcd.ply"))["points"]
    seg = np.zeros(len(pts), np.int64)  # make_dataset: 1500 plane points, then 600 a sphere
    seg[1500:] = 1 + np.arange(len(pts) - 1500) // 600
    scan_id = "scene0113_00"
    scan = os.path.join(root, "scans", scan_id)
    os.makedirs(scan)
    write_ply(os.path.join(scan, f"{scan_id}_vh_clean_2.ply"), pts)
    with open(os.path.join(scan, f"{scan_id}_vh_clean_2.0.010000.segs.json"), "w") as f:
        json.dump({"segIndices": seg.tolist()}, f)
    with open(os.path.join(scan, f"{scan_id}.aggregation.json"), "w") as f:
        json.dump({"segGroups": [{"objectId": j - 1, "label": "ball" if j < 3 else "bowl",
                                   "segments": [j]} for j in (1, 2, 3)]}, f)
    with open(os.path.join(scan, f"{scan_id}.txt"), "w") as f:
        f.write("axisAlignment = " + " ".join(f"{v:g}" for v in np.eye(4).reshape(-1)) + "\n")
    tsv = os.path.join(root, "labels.tsv")
    with open(tsv, "w") as f:
        f.write("raw_category\tnyu40id\nball\t40\nbowl\t39\n")
    t0 = time.perf_counter()
    scannet_labels.main(["--scannet_dir", os.path.join(root, "scans"), "--label_map_file", tsv,
                         "--output_dir", os.path.join(root, "labels")])
    t_labels = time.perf_counter() - t0
    out = os.path.join(root, "labels", scan_id)
    boxes = np.load(out + "_bbox.npy")
    verts, inst = np.load(out + "_vert.npy"), np.load(out + "_ins_label.npy")
    sem = np.load(out + "_sem_label.npy")
    _expect(boxes.shape == (3, 7) and np.array_equal(verts[:, :3], pts.astype(np.float64))
            and np.array_equal(inst, seg) and np.array_equal(sem, np.select(
                [seg == 0, seg < 3], [0, 40], 39).astype(np.uint32)),
            "the label export's vertices, instances or labels are not the scan's")
    for row in boxes:  # centre and size are float32 sums of the vertices: 1e-6 of slack
        j = int(row[6])
        p = verts[inst == j, :3]
        lo, hi = row[:3] - row[3:6] / 2, row[:3] + row[3:6] / 2
        _expect(len(p) == 600 and (p >= lo - 1e-6).all() and (p <= hi + 1e-6).all(),
                f"instance {j}'s box does not contain its vertices")
    print(f"{_card()} (host only): label export of a {len(pts)}-vertex scan of the desk (3 "
          f"instances, a two-row "
          f"label map): parsed and exported in {t_labels:.3f} s; boxes (centre, size, id) "
          + "; ".join(" ".join(f"{v:.3f}" for v in row) for row in boxes)
          + "; each contains its instance's 600 vertices")


def _prune_crossing(torch, system) -> None:
    """Move the fine sigma head's bias of a voxel `system` so that the
    epoch-3 hook has voxels to keep and to drop: the median over the occupied
    voxels of the largest density at PRUNE_CHECK_SPV jittered points of the
    voxel's cube (the hook's statistic, over fewer points) goes to ln 2, the
    density of the hook's alpha threshold (0.5). With DENSITY_BIAS the hook
    drops nothing on the room (phase 18)."""
    import math

    from object_nerf_torch.models import voxel_grid as vg
    from object_nerf_torch.ops.fused_sigma import fused_sigma_eval

    topo, static = system.voxel_topo, system.voxel_static
    dev = topo.occupancy.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.no_grad():
        cells = torch.nonzero(topo.occupancy).squeeze(1)
        idx = torch.stack([cells // (static.shape[1] * static.shape[2]),
                           cells // static.shape[2] % static.shape[1],
                           cells % static.shape[2]], 1)
        centres = idx.float() * topo.voxel_size - topo.voxel_offset
        peaks = []
        for batch in centres.split(1024):
            u = torch.rand(batch.shape[0], PRUNE_CHECK_SPV, 3, generator=gen, device=dev)
            pts = (batch[:, None] + (u - 0.5) * topo.voxel_size).reshape(-1, 3).contiguous()
            raw, _ = vg.voxel_lookup_raw(system.models.voxel_features, topo, static, pts)
            sigma = fused_sigma_eval(system.models.nerf_fine, system.settings.mlp, pts, None,
                                     "scene", PRUNE_CHECK_SPV, voxel_raw=raw.contiguous())
            peaks.append(sigma.reshape(-1, PRUNE_CHECK_SPV).amax(1))
        system.models.nerf_fine.sigma.bias += math.log(2.0) - torch.cat(peaks).median()


def _dp_worker(out_dir: str) -> int:
    """One rank of phase 27, started by `_dp_phase` as `chip_smoke.py
    --dp-worker DIR` with RANK, WORLD_SIZE and LOCAL_RANK set: joins the gloo
    group at `DIR/rendezvous` on the card, and saves to `DIR/rank<r>.pt` what
    it ran: phase 7's system for DP_STEPS steps (the first step's summed
    gradients, every step's time, the parameters after, launch counts, the
    gradient all-reduce alone timed), phase 4's frame, phase 9's edit frame,
    phase 17's voxel system for DP_STEPS steps, the epoch-3 prune (its inputs
    on rank 0, for the single-process prune) and phase 13's voxel frame, the
    frames sharded by chunk; before the prune, `_prune_crossing`."""
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, _repo_root())
    from object_nerf_torch.models import voxel_grid as vg
    from object_nerf_torch.ops import fused_mlp, gather
    from object_nerf_torch.parallel import mesh
    from object_nerf_torch.train.system import render_image

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh.initialize_distributed("file://" + os.path.join(out_dir, "rendezvous"),
                                backend="gloo", device="cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    res = {}

    def reset():
        fused_mlp.reset_launch_counts()  # every counter of utils/trace.py

    def counts():
        return {**fused_mlp.launch_counts, "corner_lookup": gather.launch_counts["corner_lookup"],
                "gather_rows": gather.launch_counts["gather_rows"],
                "corner_table": vg.build_counts["corner_table"]}

    def host(t):
        return t.detach().cpu().clone()

    def train(system):
        before = {k: host(v) for k, v in system.models.state_dict().items()}
        times, losses, grads = [], [], None
        reset()
        for i in range(DP_STEPS):
            np_batch = system.train_dataset.sample_batch(BATCH, system.batch_rng)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = system.training_step(np_batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["train/loss"]))
            if i == 0:
                grads = {k: host(q.grad) for k, q in system.models.named_parameters()}
        launched = counts()
        after = {k: host(v) for k, v in system.models.state_dict().items()}
        params = [q for g in system.optimizer.param_groups for q in g["params"]]
        reduce_ms = []
        for _ in range(DP_ALLREDUCE_TIMED):  # the step's all-reduce alone, on its gradients
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nbytes = mesh.all_reduce_grads(params)
            torch.cuda.synchronize()
            reduce_ms.append((time.perf_counter() - t0) * 1e3)
        return {"times": times, "losses": losses, "grads1": grads, "after": after,
                "moved": {k: not torch.equal(after[k], before[k]) for k in after},
                "launches": launched, "allreduce_ms": reduce_ms, "allreduce_bytes": nbytes}

    def frame(fn):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        maps = fn()
        torch.cuda.synchronize()
        return {"maps": maps, "ms": (time.perf_counter() - t0) * 1e3, "launches": counts()}

    # a rank that raises exits at once (no barrier): `launch` then stops the other
    system = _train_system(torch, dev)
    res["classical"] = train(system)
    del system
    torch.cuda.empty_cache()
    settings, models, _ = _eval_model(torch, dev, voxel=False)
    batch = _frame_batch(voxel=False)
    res["frame"] = frame(lambda: render_image(models, settings, batch, chunk=CHUNK,
                                              device=dev))
    with tempfile.TemporaryDirectory() as tmp:
        renderer, kw = _edit_setup(torch, dev, models, tmp)
    res["edit"] = frame(lambda: renderer.render_edit(**kw))
    res["edit"]["plan"] = dict(renderer.last_chunk_plan)
    del models, renderer
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        system = _voxel_train_system(torch, dev, tmp)
    res["voxel"] = train(system)
    _prune_crossing(torch, system)
    if mesh.rank() == 0:
        res["prune_in"] = {"state": {k: host(v) for k, v in
                                     system.models.state_dict().items()},
                           "topo": vg.topology_to_dict(system.voxel_topo),
                           "generator": system.generator.get_state()}
    n_before = int(system.voxel_topo.n_occupied)
    res["prune"] = frame(lambda: system.on_epoch_start(3))
    res["prune"].update(topo=vg.topology_to_dict(system.voxel_topo), before=n_before)
    del system
    torch.cuda.empty_cache()
    settings, models, (topo, static) = _eval_model(torch, dev, voxel=True)
    batch = _frame_batch(voxel=True)
    res["voxel_frame"] = frame(lambda: render_image(
        models, settings, batch, chunk=CHUNK, device=dev, voxel_topo=topo,
        voxel_static=static))
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank()}.pt"))
    mesh.barrier()
    mesh.destroy()
    return 0


def _dp_phase(torch, dev, first_step, frames, edit_launches):
    """Phase 27: DP_RANKS gloo ranks on the one card (`_dp_worker`), held to
    the single process: the first classical step to phase 7's kernel step,
    the ranks' parameters to each other bit for bit after DP_STEPS classical
    and voxel steps, the epoch-3 prune to the single process's on the same
    weights, grid and draws, and the sharded frames to phases 4, 9 and 13.
    Returns the launches of both ranks by kernel."""
    import tempfile

    import numpy as np

    from object_nerf_torch.models import voxel_grid as vg
    from object_nerf_torch.parallel.dryrun import launch
    from object_nerf_torch.train.metrics import psnr

    card = _card()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        launch([os.path.abspath(__file__), "--dp-worker", tmp], DP_RANKS, DP_TIMEOUT_S, tmp)
        wall = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(DP_RANKS)]
    print(f"{card}: {DP_RANKS} gloo ranks on one card ran phase 27 in {wall:.1f} s wall "
          f"(process start and the library's load included). Two processes that share one "
          f"card measure correctness and overhead, not scaling.")
    r0 = ranks[0]
    total = {}
    for res in ranks:
        for part in ("classical", "frame", "edit", "voxel", "prune", "voxel_frame"):
            for k, v in res[part]["launches"].items():
                total[k] = total.get(k, 0) + v

    # -- the training steps: the first against phase 7's, the ranks bit-equal
    for name in ("classical", "voxel"):
        for r, res in enumerate(ranks[1:], 1):
            _expect(res[name]["losses"] == r0[name]["losses"],
                    f"{name}: rank {r}'s losses differ from rank 0's")
            for k, v in r0[name]["after"].items():
                _expect(torch.equal(res[name]["after"][k], v),
                        f"{name}: rank {r}'s {k} differs from rank 0's after {DP_STEPS} steps")
            for k, v in r0[name]["grads1"].items():
                _expect(torch.equal(res[name]["grads1"][k], v),
                        f"{name}: rank {r}'s summed gradient {k} differs from rank 0's")
        want = {"fused_coarse_weights": 0, "fused_render_tiles": 0,
                "fused_mlp_eval": 2 * DP_STEPS, "fused_mlp_bwd": 2 * DP_STEPS,
                "fused_sigma_eval": 0, "corner_lookup": 2 * DP_STEPS if name == "voxel" else 0,
                "gather_rows": 0,
                "corner_table": DP_STEPS if name == "voxel" else 0}
        for r, res in enumerate(ranks):
            _expect(res[name]["launches"] == want,
                    f"{name}: rank {r} launched {res[name]['launches']}, expected {want}")
        _expect(all(r0[name]["moved"].values()),
                f"{name}: parameters that did not move: "
                f"{[k for k, v in r0[name]['moved'].items() if not v]}")
        for r, res in enumerate(ranks):
            d = res[name]
            print(f"{card}: rank {r}, {name} step at batch {BATCH} ({BATCH // DP_RANKS} rays "
                  f"a rank): {', '.join(f'{t:.2f}' for t in d['times'])} ms (steps 1-"
                  f"{DP_STEPS}); gradient all-reduce alone {d['allreduce_bytes'] / 1e6:.2f} MB "
                  f"in {statistics.median(d['allreduce_ms']):.2f} ms (median of "
                  f"{DP_ALLREDUCE_TIMED}: {', '.join(f'{t:.2f}' for t in d['allreduce_ms'])}); "
                  f"launches {d['launches']}; losses "
                  + " ".join(f"{x:.5f}" for x in d["losses"]))
    loss1 = r0["classical"]["losses"][0]
    e_loss = abs(loss1 - first_step["loss"]) / abs(first_step["loss"])
    e = {k: _rel(r0["classical"]["grads1"][k], v) for k, v in first_step["grads"].items()}
    worst = max(e, key=e.get)
    print(f"data-parallel step 1 vs phase 7's single-process kernel step (same weights, batch "
          f"and draws): loss {loss1:.6f} vs {first_step['loss']:.6f} (rel {e_loss:.2e}, tol "
          f"{LOSS_TOL:g}); summed gradients: worst {e[worst]:.2e} at {worst} (tol {BWD_TOL:g}), "
          f"median {statistics.median(e.values()):.2e}; after {DP_STEPS} steps the ranks' "
          f"parameters (the voxel table's included) are bit-equal")
    _expect(e_loss <= LOSS_TOL, "the data-parallel step's loss disagrees with phase 7's")
    _expect(e[worst] <= BWD_TOL, f"the data-parallel step's gradients disagree: {worst}")

    # -- the epoch-3 prune: the ranks' grid, and the single process's on the same inputs
    for r, res in enumerate(ranks[1:], 1):
        for k, v in r0["prune"]["topo"].items():
            _expect(torch.equal(res["prune"]["topo"][k], v), f"prune: rank {r}'s {k} differs")
    with tempfile.TemporaryDirectory() as tmp:
        single = _voxel_train_system(torch, dev, tmp)
    single.models.load_state_dict(r0["prune_in"]["state"])
    single.voxel_topo = vg.topology_from_dict(
        r0["prune_in"]["topo"], single.models.voxel_features.shape[0], device=dev)
    single.generator.set_state(r0["prune_in"]["generator"])
    single.on_epoch_start(3)
    want = vg.topology_to_dict(single.voxel_topo)
    del single
    for k, v in want.items():
        _expect(torch.equal(r0["prune"]["topo"][k], v),
                f"prune: the ranks' {k} differs from the single process's")
    print(f"{card}: epoch-3 prune on {DP_RANKS} ranks: {r0['prune']['before']} -> "
          f"{int(r0['prune']['topo']['n_occupied'])} voxels, "
          + ", ".join(f"rank {r} {res['prune']['ms']:.1f} ms" for r, res in enumerate(ranks))
          + "; the ranks' grids are bit-equal to each other and to the single process's")

    # -- the sharded frames against the single process's
    n_chunks = (W * H) // CHUNK
    for part, want, shape in (("frame", frames["frame"], (W, H)),
                              ("voxel_frame", frames["voxel_frame"], (W, H)),
                              ("edit", frames["edit"], (EDIT_W, EDIT_H))):
        for r, res in enumerate(ranks):
            got = res[part]["maps"]
            _expect(set(got) == set(want), f"{part}: rank {r}'s maps {sorted(got)}")
            same = all(np.array_equal(got[k], want[k]) for k in want)
            diff = max(float(np.abs(got[k] - want[k]).max()) for k in want)
            p = psnr(torch.from_numpy(got[[k for k in want if k.startswith("rgb")][0]]),
                     torch.from_numpy(want[[k for k in want if k.startswith("rgb")][0]])).item()
            print(f"{card}: rank {r}, sharded {part} {shape[0]}x{shape[1]}: "
                  f"{res[part]['ms']:.1f} ms; launches {res[part]['launches']}; "
                  f"{'bit-equal to' if same else 'differs from'} the single process's frame "
                  f"(max abs {diff:.2e}, rgb {p:.1f} dB)")
            _expect(same or p >= PSNR_FLOOR_DB,
                    f"{part}: rank {r}'s frame is {p:.1f} dB from the single process's")
    for r, res in enumerate(ranks):
        for part, extra in (("frame", {"gather_rows": 0}),
                            ("voxel_frame", {"corner_lookup": n_chunks, "corner_table": 1,
                                             "gather_rows": 0})):
            got = res[part]["launches"]
            _expect(got["fused_coarse_weights"] == got["fused_render_tiles"] == n_chunks // DP_RANKS
                    and all(got[k] == v for k, v in extra.items()),
                    f"{part}: rank {r} launched {got}, expected {n_chunks // DP_RANKS} chunks")
    edit_sum = {k: sum(res["edit"]["launches"][k] for res in ranks) for k in edit_launches}
    _expect(edit_sum == edit_launches and r0["edit"]["plan"] == ranks[1]["edit"]["plan"],
            f"the sharded edit frame launched {edit_sum} over its ranks, phase 9 {edit_launches}")
    GATHER_ROWS_BY_PATH["data_parallel"] = total["gather_rows"]
    _expect(total["gather_rows"] == 0,
            f"the ranks launched {total['gather_rows']} gather_rows; the voxel lookup should "
            f"fetch its rows in corner_lookup")
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, _repo_root())

    from benchmark.flops import peaks
    from object_nerf_torch.models.embedding import freq_encode
    from object_nerf_torch.ops import _build, fused_mlp, fwd_chain
    from object_nerf_torch.ops.sampling import merge_z_vals, sample_pdf, stratified_sample
    from object_nerf_torch.render.renderer import render_rays_plain
    from object_nerf_torch.scripts import profile_mlp as pm
    from object_nerf_torch.train.metrics import psnr
    from object_nerf_torch.train.system import render_image

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
    try:  # the benchmark's table of peaks (NVIDIA data sheets)
        peak_flops, peak_bytes = peaks(kind)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().name})")
    log = _build.library_path().with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "Used " in line or "spill" in line:
                print("  ptxas:", line.strip())

    # -- 3. each kernel against its plain version ------------------------------
    settings, models, _ = _eval_model(torch, dev, voxel=False)
    cfg = settings.mlp
    batch = _frame_batch(voxel=False)

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

        pk_c = fwd_chain.pack_kernel_weights(models.nerf_coarse, cfg, False, sigma_only=True)
        pk_f = fwd_chain.pack_kernel_weights(models.nerf_fine, cfg, True)

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
        again = run_coarse()
        torch.cuda.synchronize()
        if not torch.equal(again, w_k):
            raise SystemExit("two launches of fused_coarse_weights on the same inputs differ")
        del again
        err_c = (w_k - w_plain).abs().max().item()
        print(f"fused_coarse_weights {tuple(xyz_c.shape)}: max |kernel - plain bf16| "
              f"= {err_c:.3e} (tol {KERNEL_TOL:g}; weights sum to "
              f"{w_k.sum(-1).mean().item():.4f} per ray on average); relaunch bit-equal")
        maps_k, maps_p = run_fine(), run_fine_plain()
        again = run_fine()
        torch.cuda.synchronize()
        if not all(torch.equal(again[k], maps_k[k]) for k in maps_k):
            raise SystemExit("two launches of fused_render_tiles on the same inputs differ")
        del again
        errs_f = {k: (maps_k[k] - maps_p[k]).abs().max().item() for k in maps_p}
        err_f = max(errs_f.values())
        print(f"fused_render_tiles {tuple(xyz_f.shape)}: max |kernel - plain bf16| "
              f"= {err_f:.3e} (tol {KERNEL_TOL:g}): "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs_f.items())
              + "; relaunch bit-equal")
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
        # the same functions as chains of torch calls (the library yardstick)
        chain_c = pm.chain_layers(models.nerf_coarse)[0]
        chain_f = pm.chain_layers(models.nerf_fine)[0]
        library = {
            "fused_coarse_weights": _library_turns(
                "fused_coarse_weights", run_coarse,
                lambda: pm.torch_coarse_weights(chain_c, cfg, xyz_c, z_c), w_plain),
            "fused_render_tiles": _library_turns(
                "fused_render_tiles", run_fine,
                lambda: pm.torch_render_tiles(chain_f, cfg, xyz_f, z_f, dir_pe, codes), maps_p),
        }
        del chain_c, chain_f
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
    print(f"fused_render_tiles {tuple(xyz_f.shape)}: "
          + _weight_stream(pk_f, n_f, ms["fused_render_tiles"], "render"))
    print(f"fused_coarse_weights {tuple(xyz_c.shape)}: "
          + _weight_stream(pk_c, n_c, ms["fused_coarse_weights"], "weights"))
    # the chain takes both values of an encoded pair from one sincosf: it must
    # give sinf's and cosf's bits, here over arguments at the encodings' scale
    # (xyz up to 2^9, voxel features up to 2^5 times a few units) and beyond
    gen = torch.Generator().manual_seed(SEED + 3)
    args = torch.cat([torch.randn(1 << 22, generator=gen) * s_
                      for s_ in (1.0, 30.0, 600.0, 2e4)]).to(dev)
    mism = fwd_chain.sincos_mismatches(args)
    print(f"sincosf vs sinf / cosf on the card: {mism} of {args.numel()} arguments differ")
    if mism:
        raise SystemExit("sincosf differs from sinf / cosf: the chain's encoding would too")
    del args

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
    train_entries, chain_build, first_step = _train_phases(torch, dev, peak_flops, peak_bytes)

    # -- 8, 9, 10. the density kernel, the edit frame and the mesh sweep ----------------
    torch.cuda.empty_cache()
    sigma_entry, sigma_ms = _sigma_phase(torch, dev, models, cfg, peak_flops, peak_bytes)
    edit_launches, edit_mlp_err, frame9 = _edit_phase(torch, dev, models, cfg, sigma_ms)
    mesh_launches = _mesh_phase(torch, dev, models, settings)
    sigma_entry.update(chain_build["fused_sigma_eval"])
    sigma_entry["launches_by_path"] = {"edit": edit_launches["fused_sigma_eval"],
                                       "mesh": mesh_launches}
    sigma_entry["launches"] = sum(sigma_entry["launches_by_path"].values())
    for entry in train_entries:
        if entry["name"] == "fused_mlp_eval":
            entry["launches_by_path"] = {"train": entry["launches"],
                                         "edit": edit_launches["fused_mlp_eval"]}
            entry["launches"] = sum(entry["launches_by_path"].values())
            entry["max_abs_err"] = max(entry["max_abs_err"], edit_mlp_err)

    # -- 11 to 15. the voxel-conditioned model and the probes -----------------------------
    frame4 = frame
    del models, frame
    torch.cuda.empty_cache()
    gather_entry, lookup_entry, vox, vox_eval_launches, vox_mesh_launches = _voxel_phases(
        torch, dev, peak_flops, peak_bytes)
    frame13_ms = vox_eval_launches.pop("frame_ms")
    frame13 = vox_eval_launches.pop("frame")
    torch.cuda.empty_cache()
    probe_entries = _probe_phase(torch, dev, peak_flops, peak_bytes, chain_build["pe_probe"])
    sigma_entry["launches_by_path"]["voxel_mesh"] = vox_mesh_launches["fused_sigma_eval"]
    sigma_entry["max_abs_err"] = max(sigma_entry["max_abs_err"], vox["fused_sigma_eval"]["err"])
    for key in ("ms", "plain_ms", "bound_ms"):
        sigma_entry[f"voxel_{key}_by_branch"] = vox["fused_sigma_eval"][key]

    # -- 16 to 19. the voxel model trained, pruned, subdivided and edited ------------------------
    torch.cuda.empty_cache()
    vtrain, vtrain_launches, prune_launches = _voxel_train_phases(
        torch, dev, peak_flops, peak_bytes)
    torch.cuda.empty_cache()
    vedit_launches = _voxel_edit_phase(torch, dev)
    for entry in train_entries:
        name, v = entry["name"], vtrain[entry["name"]]
        entry["launches_by_path"] = {**entry.get("launches_by_path",
                                                 {"train": entry["launches"]}),
                                     "voxel_train": vtrain_launches[name]}
        if name == "fused_mlp_eval":
            entry["launches_by_path"]["voxel_edit"] = vedit_launches[name]
        entry["launches"] = sum(entry["launches_by_path"].values())
        entry["max_abs_err"] = max(entry["max_abs_err"], v["err"])
        entry["voxel_ms"] = sum(v["ms"].values())
        entry["voxel_plain_ms"] = sum(v["plain_ms"].values())
        entry["voxel_bound_ms"] = sum(v["bound_ms"].values())
        entry["voxel_ms_by_samples"] = v["ms"]
        entry["voxel_bound_ms_by_samples"] = v["bound_ms"]
        if name == "fused_mlp_bwd":
            entry["voxel_split_ms_by_samples"] = v["split"]
            entry["voxel_launch_peak_bytes_by_samples"] = v["launch_peak"]
            entry["d_voxel_raw_max_err"] = v["dvox_err"]["max"]
            entry["d_voxel_raw_norm_err"] = v["dvox_err"]["norm"]
            entry["d_voxel_raw_norm_tol"] = VOX_DVOX_NORM_TOL
    sigma_entry["launches_by_path"]["prune"] = prune_launches["fused_sigma_eval"]
    sigma_entry["launches_by_path"]["voxel_edit"] = vedit_launches["fused_sigma_eval"]
    sigma_entry["launches"] = sum(sigma_entry["launches_by_path"].values())
    for path, n in (("voxel_train", vtrain_launches["corner_lookup"]),
                    ("prune", prune_launches["corner_lookup"]),
                    ("voxel_edit", vedit_launches["corner_lookup"])):
        lookup_entry["launches_by_path"][path] = n
    lookup_entry["launches"] = sum(lookup_entry["launches_by_path"].values())

    # -- 20 to 25. the shipped scene configs through the CLIs ---------------------------------
    torch.cuda.empty_cache()
    scene_paths, route, desk = _scene_phases(torch, dev, peak_flops, peak_bytes, frame13_ms)
    for entry in train_entries + [sigma_entry, lookup_entry]:
        name = entry["name"]
        entry["launches_by_path"] = {**entry.get("launches_by_path",
                                                 {"train": entry["launches"]}),
                                     **scene_paths[name]}
        entry["launches"] = sum(entry["launches_by_path"].values())
        if name == "fused_mlp_eval":
            entry["max_abs_err"] = max(entry["max_abs_err"], route["err"])
            for key in ("ms", "plain_ms", "bound_ms", "bound_by"):
                entry[f"route_{key}"] = route[key]
            entry["route_shape"] = [CHUNK, N_SAMPLES]

    # -- 27. data parallel: two gloo ranks on the one card ------------------------------
    torch.cuda.empty_cache()
    dp = _dp_phase(torch, dev, first_step, {"frame": frame4, "voxel_frame": frame13,
                                            "edit": frame9}, edit_launches)
    for entry in train_entries + [sigma_entry, lookup_entry]:
        entry["launches_by_path"]["data_parallel"] = dp[entry["name"]]
        entry["launches"] = sum(entry["launches_by_path"].values())

    # -- 28. the desk checkpoint's mesh drawn in the scene viewer ---------------------------
    torch.cuda.empty_cache()
    desk_mesh = _desk_mesh_phase(torch, dev, desk)
    for entry in (sigma_entry, lookup_entry):
        entry["launches_by_path"]["desk_mesh"] = desk_mesh[entry["name"]]
        entry["launches"] = sum(entry["launches_by_path"].values())

    # -- 29. data preparation on the desk (host only) -----------------------------------
    _data_prep_phase(desk)
    shutil.rmtree(desk["work"], ignore_errors=True)

    # -- 30. the kernels ------------------------------------------------------------
    replaces = {
        "fused_coarse_weights": "object_nerf_tpu/ops/pallas_mlp.py:845",
        "fused_render_tiles": "object_nerf_tpu/ops/pallas_mlp.py:639",
    }
    errs = {"fused_coarse_weights": err_c, "fused_render_tiles": err_f}
    sources = {"fused_coarse_weights": "object_nerf_torch/ops/csrc/fused_mlp_wg.cuh",
               "fused_render_tiles": "object_nerf_torch/ops/csrc/fused_mlp_wg.cuh"}
    unread = set(lookup_entry["launches_by_path"]) - set(GATHER_ROWS_BY_PATH)
    _expect(not unread, f"paths whose gather_rows launches were not read: {sorted(unread)}")
    gather_entry["launches_by_path"] = dict(GATHER_ROWS_BY_PATH)
    gather_entry["launches"] = sum(GATHER_ROWS_BY_PATH.values())
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": sources[k],
         "replaces": replaces[k],
         "launches": (launches[k] + vox_eval_launches[k] + sum(scene_paths[k].values())
                      + dp[k]),
         "launches_by_path": {"eval": launches[k], "voxel_eval": vox_eval_launches[k],
                              **scene_paths[k], "data_parallel": dp[k]},
         "max_abs_err": max(errs[k], vox[k]["err"]),
         "tol": KERNEL_TOL, "err_is": "max abs", "ms": ms[k], "plain_ms": plain_ms[k],
         "bound_ms": bound_ms[k], "bound_by": bound_by[k], **library[k],
         "voxel_ms": vox[k]["ms"], "voxel_plain_ms": vox[k]["plain_ms"],
         "voxel_bound_ms": vox[k]["bound_ms"],
         **chain_build[k]}
        for k in replaces
    ] + train_entries + [sigma_entry, gather_entry, lookup_entry] + probe_entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(_dp_worker(sys.argv[2]))
    sys.exit(main())
