// Fused ObjectNeRF eval kernels for Hopper (sm_90a), bf16 tensor cores.
//
// Two kernels, each a hand-written replacement of a Pallas TPU kernel of
// object_nerf_tpu/ops/pallas_mlp.py:
//
//   coarse_weights_kernel  replaces _weights_kernel / fused_coarse_weights
//                          (pallas_mlp.py:845, :874): xyz positional
//                          encoding -> scene trunk -> sigma head ->
//                          alpha -> exclusive transmittance -> weights.
//   fwd_chain_kernel<VOX, true>
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
// The render is the forward chain of fused_mlp_wg.cuh (a persistent grid, a
// TMA producer warp streaming the weights through a ring, two consumer
// warpgroups on wgmma; its file comment says how), shared with
// fused_mlp_eval; after a tile's products one warp per (ray, branch)
// composites S samples: a multiplicative exclusive scan over S/32 samples
// per lane with __shfl_up_sync.
//
// The coarse kernel is still the first, simple design: nvcuda::wmma
// 16x16x16 on one block of 8 warps per tile of 128 sample rows made of whole
// rays, activations in shared memory as bf16, weights staged from device
// memory in 64-row K chunks (fused_mlp_common.cuh).
//
// A voxel-conditioned model (`vox` given) gets the VOX instantiation of each
// kernel: the raw voxel features (n, S, 16 + 8) are one more operand, the
// block frequency-encodes them itself (sinf/cosf in f32, then bf16) and its
// input tile is [svox | PE(svox) | xyz | PE(xyz)] for the scene branch (271
// columns, read as 320 with zero weight rows) and that followed by
// [ivox | PE(ivox) | code] for the object branch (439, read as 448).
//
// Numerics follow the TPU kernels and the plain PyTorch versions
// (object_nerf_torch/ops/fused_mlp.py): every matmul operand is rounded
// to bf16 and accumulated in f32; bias and LeakyReLU run in f32 before the
// cast to bf16 for the next layer; sigmoid, the positional encoding
// (sinf/cosf, reference channel order) and the compositing run in f32.
//
// Built with nvcc for sm_90a by object_nerf_torch/ops/_build.py and bound
// with ctypes: plain C entry points, every pointer a device pointer, the
// stream PyTorch's current stream. The kernels allocate nothing.

#include "fused_mlp_wg.cuh"

namespace {

template <bool VOX>
__global__ void __launch_bounds__(THREADS, 1)
coarse_weights_kernel(const float* __restrict__ xyz, const float* __restrict__ z,
                      const float* __restrict__ vox, VoxDims vd,
                      const bf16* __restrict__ w, const float* __restrict__ b,
                      BranchTab scene, float* __restrict__ weights, int n_rays,
                      int S, int n_freq, int last_delta_inf) {
  extern __shared__ __align__(128) unsigned char smem[];
  Smem s = VOX ? carve_vox(smem) : carve(smem);
  const int R = ROWS / S;
  if (VOX) {
    // the staging reuses the H buffer, free until the first layer's epilogue
    load_inputs_vox(blockIdx.x, xyz, z, vox, nullptr, (long long)n_rays * S, S, n_freq, vd,
                    0, false, scene.v[T_K0], s.X, s.zs, reinterpret_cast<float*>(s.H));
    run_trunk<WS, LDX_V>(scene, w, b, s.X, s.H, s.wst, s.scratch);
  } else {
    // the xyz staging reuses the scratch tile (384 floats of its 2048)
    load_inputs(blockIdx.x, xyz, z, nullptr, n_rays, S, n_freq, 0, s.X, s.zs, s.scratch);
    run_trunk<WS>(scene, w, b, s.X, s.H, s.wst, s.scratch);
  }
  head_sigma(s.H, WS, w + scene.v[T_SIGW], b[scene.v[T_SIGB]], s.sig);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp < R) {
    const int ray = blockIdx.x * R + warp;
    if (ray < n_rays) {
      float out[5];
      composite_ray(s.sig + warp * S, s.rgb + warp * S * 3, s.zs + warp * S, S,
                    last_delta_inf ? 1e10f : 0.f, weights + (size_t)ray * S, out);
    }
  }
}

template <bool VOX>
int launch_coarse(const float* xyz, const float* z, const float* vox, VoxDims vd,
                  const void* w, const float* b, const int* scene_tab, float* weights,
                  int n_rays, int S, int n_freq, int last_delta_inf, void* stream) {
  constexpr int BYTES = VOX ? SMEM_BYTES_V : SMEM_BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      coarse_weights_kernel<VOX>, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (e != cudaSuccess) return (int)e;
  const int R = ROWS / S;
  dim3 grid((n_rays + R - 1) / R);
  coarse_weights_kernel<VOX><<<grid, THREADS, BYTES, (cudaStream_t)stream>>>(
      xyz, z, vox, vd, static_cast<const bf16*>(w), b, to_tab(scene_tab), weights, n_rays,
      S, n_freq, last_delta_inf);
  return (int)cudaGetLastError();
}

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

}  // namespace

extern "C" {

const char* onerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// `vox` is the raw voxel feature operand (n_rays, S, c_svox + c_ivox) of a
// voxel-conditioned model, or null for a classical one (then the three widths
// are unused). Returns cudaGetLastError() after the launch (0 on success).
int onerf_coarse_weights(const float* xyz, const float* z, const float* vox,
                         const void* w, const float* b, const int* scene_tab,
                         float* weights, int n_rays, int S, int n_freq,
                         int last_delta_inf, int c_svox, int c_ivox, int n_freq_vox,
                         void* stream) {
  const VoxDims vd = {c_svox, c_ivox, n_freq_vox};
  if (vox != nullptr)
    return launch_coarse<true>(xyz, z, vox, vd, w, b, scene_tab, weights, n_rays, S,
                               n_freq, last_delta_inf, stream);
  return launch_coarse<false>(xyz, z, vox, vd, w, b, scene_tab, weights, n_rays, S,
                              n_freq, last_delta_inf, stream);
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
    return launch_fwd_chain<true, true>(wmap_tab, chunks, n_chunks, scene_tab, obj_tab, a, st);
  return launch_fwd_chain<false, true>(wmap_tab, chunks, n_chunks, scene_tab, obj_tab, a, st);
}

// mism[0] += the n arguments x (device pointers) at which sincosf differs from
// sinf / cosf in any bit.
int onerf_sincos_check(const float* x, long long n, unsigned int* mism, void* stream) {
  sincos_check_kernel<<<264, 256, 0, (cudaStream_t)stream>>>(x, n, mism);
  return (int)cudaGetLastError();
}

}  // extern "C"
