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

// The ring depth and the dynamic shared memory of one instantiation.
template <bool VOX, int MODE>
void chain_layout(int* stages, int* smem_bytes) {
  *stages = FwdCfg<VOX, MODE>::STAGES;
  *smem_bytes = FwdCfg<VOX, MODE>::BYTES;
}

}  // namespace

extern "C" {

const char* onerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// `vox` is the raw voxel feature operand (n_rays, S, c_svox + c_ivox) of a
// voxel-conditioned model, or null for a classical one (then the three widths
// are unused). `wmap_tab` and `chunks`: the chain's weight maps and the
// sigma-only chunk order of one tile (fused_mlp_vjp.forward_launch_tables).
// Returns cudaGetLastError() after the launch (0 on success).
int onerf_coarse_weights(const float* xyz, const float* z, const float* vox,
                         const void* w, const float* b, const int* scene_tab,
                         const int* wmap_tab, const int* chunks, int n_chunks,
                         float* weights, int n_rays, int S, int n_freq,
                         int last_delta_inf, int c_svox, int c_ivox, int n_freq_vox,
                         void* stream) {
  FwdArgs a = {xyz, z, nullptr, nullptr, vox, static_cast<const bf16*>(w), b, nullptr,
               nullptr, weights, {c_svox, c_ivox, n_freq_vox}, n_rays, S, n_freq, 0, 0, 0, 1,
               last_delta_inf};
  const cudaStream_t st = (cudaStream_t)stream;
  if (vox != nullptr)
    return launch_fwd_chain<true, FWD_WEIGHTS>(wmap_tab, chunks, n_chunks, scene_tab, nullptr,
                                               a, st);
  return launch_fwd_chain<false, FWD_WEIGHTS>(wmap_tab, chunks, n_chunks, scene_tab, nullptr,
                                              a, st);
}

// `wmap_tab` and `chunks`: the chain's weight maps and the chunk order of
// one tile (fused_mlp_vjp.forward_launch_tables).
int onerf_render_tiles(const float* xyz, const float* z, const float* dir_pe,
                       const float* codes, const float* vox, const void* w,
                       const float* b, const int* scene_tab, const int* obj_tab,
                       const int* wmap_tab, const int* chunks, int n_chunks,
                       float* maps, float* weights, int n_rays, int S, int n_freq,
                       int c_dir, int code_len, int forward_instance,
                       int last_delta_inf, int c_svox, int c_ivox, int n_freq_vox,
                       void* stream) {
  FwdArgs a = {xyz, z, dir_pe, codes, vox, static_cast<const bf16*>(w), b, nullptr, maps,
               weights, {c_svox, c_ivox, n_freq_vox}, n_rays, S, n_freq, c_dir, code_len,
               forward_instance, 1, last_delta_inf};
  const cudaStream_t st = (cudaStream_t)stream;
  if (vox != nullptr)
    return launch_fwd_chain<true, FWD_RENDER>(wmap_tab, chunks, n_chunks, scene_tab, obj_tab,
                                              a, st);
  return launch_fwd_chain<false, FWD_RENDER>(wmap_tab, chunks, n_chunks, scene_tab, obj_tab, a,
                                             st);
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
