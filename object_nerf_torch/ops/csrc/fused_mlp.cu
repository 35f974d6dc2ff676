// Fused ObjectNeRF eval kernels for Hopper (sm_90a), bf16 tensor cores.
//
// Two modes of the forward chain (fused_mlp_wg.cuh), each a hand-written
// replacement of a Pallas TPU kernel of object_nerf_tpu/ops/pallas_mlp.py:
//
//   fwd_chain_kernel<VOX, FWD_WEIGHTS>
//                          replaces _weights_kernel / fused_coarse_weights
//                          (pallas_mlp.py:845, :874): xyz positional
//                          encoding -> scene trunk -> sigma head ->
//                          alpha -> exclusive transmittance -> weights.
//   fwd_chain_kernel<VOX, FWD_RENDER>
//                          replaces _render_kernel / fused_render_tiles
//                          (pallas_mlp.py:639, :705): both MLP branches
//                          (trunk, sigma, final, view-direction head,
//                          sigmoid rgb) and the scene + instance
//                          compositing -> per-ray maps.
//
// What bounds them: the tensor cores. Per sample the coarse pass does
// ~0.49 M multiply-adds and the fine pass ~0.70 M, against ~12 bytes of
// xyz read from device memory, so the work is three orders of magnitude
// past the card's operations-per-byte balance point.
//
// Both run on the forward chain that fused_mlp_eval shares (a persistent
// grid, a TMA producer warpgroup streaming the weights through a ring, two
// consumer warpgroups on wgmma; its file comment says how). After a tile's
// products one warp per (ray, branch) composites S samples: a multiplicative
// exclusive scan over S/32 samples per lane with __shfl_up_sync. The coarse
// mode runs the scene trunk and its sigma head alone: its input tile holds
// the scene branch's columns only, which leaves room for a deeper weight
// ring, and its scan writes the weights and reads no rgb.
//
// A voxel-conditioned model (`vox` given) gets the VOX instantiation of each
// mode: the raw voxel features (n, S, 16 + 8) are one more operand, the
// block frequency-encodes them itself (sincosf in f32, then bf16) and its
// input tile is [svox | PE(svox) | xyz | PE(xyz)] for the scene branch (271
// columns, read as 320 with zero weight rows) and that followed by
// [ivox | PE(ivox) | code] for the object branch (439, read as 448).
//
// Numerics follow the TPU kernels and the plain PyTorch versions
// (object_nerf_torch/ops/fused_mlp.py): every matmul operand is rounded
// to bf16 and accumulated in f32; bias and LeakyReLU run in f32 before the
// cast to bf16 for the next layer; sigmoid, the positional encoding
// (full-precision sincosf, reference channel order) and the compositing run
// in f32.
//
// This source instantiates those two modes and holds the chain's one entry
// point, onerf_fwd_chain, which launches each of the five modes (eval in
// fused_mlp_train.cu, the densities in fused_sigma.cu).
//
// Built with nvcc for sm_90a by object_nerf_torch/ops/_build.py and bound
// with ctypes: plain C entry points, every pointer a device pointer, the
// stream PyTorch's current stream. The kernels allocate nothing.

#include "fused_mlp_wg.cuh"

namespace {

// sincosf against sinf and cosf, bit for bit: mism[0] += the arguments where
// either value differs (the chain's input build takes both from one sincosf).
__global__ void sincos_check_kernel(const float* __restrict__ x, long long n,
                                    unsigned int* __restrict__ mism) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float sn, cs;
    sincosf(x[i], &sn, &cs);
    if (__float_as_uint(sn) != __float_as_uint(sinf(x[i])) ||
        __float_as_uint(cs) != __float_as_uint(cosf(x[i])))
      atomicAdd(mism, 1u);
  }
}

// The branches a launch runs fit its mode: the render runs the scene branch,
// the coarse weights and the scene density the scene branch alone, the
// object density the object branch alone; the eval one or both.
bool branches_fit(int mode, const FwdArgs& a) {
  const bool inst = a.forward_instance != 0, scene = a.compute_scene != 0;
  if (mode == FWD_EVAL) return true;
  if (mode == FWD_RENDER) return scene;
  return mode == FWD_SIGMA_OBJ ? inst && !scene : scene && !inst;
}

// The ring depth and the dynamic shared memory of one instantiation.
template <bool VOX, int MODE>
void chain_layout(int* stages, int* smem_bytes) {
  *stages = FwdCfg<VOX, MODE>::STAGES;
  *smem_bytes = FwdCfg<VOX, MODE>::BYTES;
}

}  // namespace

FWD_CHAIN_INSTANCE(false, FWD_RENDER);
FWD_CHAIN_INSTANCE(true, FWD_RENDER);
FWD_CHAIN_INSTANCE(false, FWD_WEIGHTS);
FWD_CHAIN_INSTANCE(true, FWD_WEIGHTS);

extern "C" {

const char* onerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The forward chain in `mode` (FWD_*: 0 eval, 1 render, 2 coarse weights, 3
// scene density, 4 object density) over the launch `a` describes
// (fwd_chain.launch fills it), for the voxel-conditioned model (`vox` != 0,
// with a->vox the raw voxel features) or the classical one (a->vox null).
// `scene_tab` and `obj_tab` are the packing's offset tables (obj_tab null
// unless the object branch runs), `wmap_tab` and `chunks` the chain's weight
// maps and the chunk order of one tile (fwd_chain.forward_launch_tables).
// Returns cudaGetLastError() after the launch (0 on success).
int onerf_fwd_chain(int vox, int mode, const FwdArgs* a, const int* scene_tab,
                    const int* obj_tab, const int* wmap_tab, const int* chunks, int n_chunks,
                    void* stream) {
  typedef int (*Launch)(const int*, const int*, int, const int*, const int*, const FwdArgs&,
                        cudaStream_t);
  static const Launch launches[2][5] = {
      {launch_fwd_chain<false, FWD_EVAL>, launch_fwd_chain<false, FWD_RENDER>,
       launch_fwd_chain<false, FWD_WEIGHTS>, launch_fwd_chain<false, FWD_SIGMA_SCENE>,
       launch_fwd_chain<false, FWD_SIGMA_OBJ>},
      {launch_fwd_chain<true, FWD_EVAL>, launch_fwd_chain<true, FWD_RENDER>,
       launch_fwd_chain<true, FWD_WEIGHTS>, launch_fwd_chain<true, FWD_SIGMA_SCENE>,
       launch_fwd_chain<true, FWD_SIGMA_OBJ>}};
  if (mode < 0 || mode > FWD_SIGMA_OBJ || a == nullptr || (a->vox != nullptr) != (vox != 0) ||
      !branches_fit(mode, *a))
    return (int)cudaErrorInvalidValue;
  return launches[vox != 0][mode](wmap_tab, chunks, n_chunks, scene_tab, obj_tab, *a,
                                  (cudaStream_t)stream);
}

// The forward chain's layout (FwdCfg) in fwd_chain_kernel<vox, mode>, mode
// one of FWD_* (0 eval, 1 render, 2 coarse weights, 3 scene density, 4
// object density): the weight ring's stages and the block's dynamic shared
// memory in bytes, into two host ints. Launches nothing.
int onerf_fwd_chain_layout(int vox, int mode, int* stages, int* smem_bytes) {
  typedef void (*Layout)(int*, int*);
  static const Layout layouts[2][5] = {
      {chain_layout<false, FWD_EVAL>, chain_layout<false, FWD_RENDER>,
       chain_layout<false, FWD_WEIGHTS>, chain_layout<false, FWD_SIGMA_SCENE>,
       chain_layout<false, FWD_SIGMA_OBJ>},
      {chain_layout<true, FWD_EVAL>, chain_layout<true, FWD_RENDER>,
       chain_layout<true, FWD_WEIGHTS>, chain_layout<true, FWD_SIGMA_SCENE>,
       chain_layout<true, FWD_SIGMA_OBJ>}};
  if (mode < 0 || mode > FWD_SIGMA_OBJ || stages == nullptr || smem_bytes == nullptr)
    return (int)cudaErrorInvalidValue;
  layouts[vox != 0][mode](stages, smem_bytes);
  return (int)cudaSuccess;
}

// mism[0] += the n arguments x (device pointers) at which sincosf differs from
// sinf / cosf in any bit.
int onerf_sincos_check(const float* x, long long n, unsigned int* mism, void* stream) {
  sincos_check_kernel<<<264, 256, 0, (cudaStream_t)stream>>>(x, n, mism);
  return (int)cudaGetLastError();
}

}  // extern "C"
