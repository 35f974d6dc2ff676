// Point-wise density for Hopper (sm_90a), bf16 tensor cores.
//
//   fwd_chain_kernel<VOX, FWD_SIGMA_SCENE>, <VOX, FWD_SIGMA_OBJ>
//                      replace _sigma_kernel / fused_sigma_eval
//                      (object_nerf_tpu/ops/pallas_mlp.py:971, :997): the raw
//                      density (before any ReLU) of N arbitrary points
//                      through ONE branch: xyz positional encoding -> scene
//                      trunk -> sigma head, or [PE | latent code] -> object
//                      trunk -> sigma head, the code shared by each run of
//                      `per_row` consecutive points (a "pseudo-row"). No
//                      direction input, no rgb heads, no compositing scan.
//                      It is the density query of the mesh-extraction sweep,
//                      of the voxel prune and of the multi-object edit
//                      render's coarse pass.
//
// What bounds it: the tensor cores. A point costs 0.49 M multiply-adds in
// the scene branch and 0.08 M in the object branch, against 12 bytes read
// and 4 written, far past the card's operations-per-byte balance point.
//
// What the design does about it: the two point-wise modes of the forward
// chain (fused_mlp_wg.cuh), with its persistent grid, TMA weight ring and
// wgmma warpgroups. A tile's rows are consecutive points, not whole rays: a
// point's code row is `point / per_row`, so any per_row >= 1 is taken (a
// warpgroup stages the codes of the up to 64 runs its rows span), and the
// ragged last tile is masked (rows past N read zeros and store nothing).
// The last trunk layer feeds the sigma head from registers and is not
// stored; the density goes to device memory from the head's registers. The
// input tile holds the branch's own columns only (the scene's 64 / 320, the
// object's 128 / 448), which sets the depth of the weight ring.
//
// A voxel-conditioned model (`vox` given) gets the VOX instantiations: the
// raw voxel features (N, 16 + 8) are one more operand, encoded by the block
// itself into the wider input tile ([svox | PE(svox) | xyz | PE(xyz)], then
// [ivox | PE(ivox) | code] for the object branch).
//
// Numerics as in fused_mlp.cu: matmul operands rounded to bf16, f32
// accumulation, bias and LeakyReLU in f32, sincosf encoding in the reference
// channel order.

#include "fused_mlp_wg.cuh"

// launched by onerf_fwd_chain (fused_mlp.cu)
FWD_CHAIN_INSTANCE(false, FWD_SIGMA_SCENE);
FWD_CHAIN_INSTANCE(true, FWD_SIGMA_SCENE);
FWD_CHAIN_INSTANCE(false, FWD_SIGMA_OBJ);
FWD_CHAIN_INSTANCE(true, FWD_SIGMA_OBJ);
