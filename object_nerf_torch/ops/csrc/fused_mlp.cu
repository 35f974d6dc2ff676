// Fused ObjectNeRF eval kernels for Hopper (sm_90a), bf16 tensor cores.
//
// Two kernels, each a hand-written replacement of a Pallas TPU kernel of
// object_nerf_tpu/ops/pallas_mlp.py:
//
//   coarse_weights_kernel  replaces _weights_kernel / fused_coarse_weights
//                          (pallas_mlp.py:845, :874): xyz positional
//                          encoding -> scene trunk -> sigma head ->
//                          alpha -> exclusive transmittance -> weights.
//   render_tiles_kernel    replaces _render_kernel / fused_render_tiles
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
// What the design does about it (the simple first version): every
// product runs on the bf16 tensor cores (nvcuda::wmma 16x16x16, f32
// accumulators), and no activation ever leaves the SM. One block of 8
// warps owns a tile of 128 sample rows made of whole rays (R = 128 / S
// rays). The tile's activations live in shared memory as bf16; the warps
// hold a whole layer's output (64 rows x N/4 columns each) in registers
// across the K loop, so the next layer's activations overwrite the
// previous ones in place and one activation buffer suffices. Weights are
// streamed from device memory (L2-resident: ~1.4 MB for both branches) in
// 64-row K chunks staged in shared memory and shared by all 8 warps.
// Compositing runs one warp per (ray, branch): a multiplicative
// exclusive scan over S/32 samples per lane with __shfl_up_sync.
// Left for later work: wgmma, TMA, warp specialisation, more blocks per SM.
//
// A voxel-conditioned model (`vox` given) gets the VOX instantiation of each
// kernel: the raw voxel features (n, S, 16 + 8) are one more operand, the
// block frequency-encodes them itself (sinf/cosf in f32, then bf16) and its
// input tile is [svox | PE(svox) | xyz | PE(xyz)] for the scene branch (271
// columns, read as 320 with zero weight rows) and that followed by
// [ivox | PE(ivox) | code] for the object branch (439, read as 448). The
// wider tile has its own shared-memory layout (fused_mlp_common.cuh); the
// classical instantiation keeps its layout and its inner loops: the width
// is a template parameter, not a run-time branch.
//
// Numerics follow the TPU kernels and the plain PyTorch versions
// (object_nerf_torch/ops/fused_mlp.py): every matmul operand is rounded
// to bf16 and accumulated in f32; bias and LeakyReLU run in f32 before the
// cast to bf16 for the next layer; sigmoid, the positional encoding
// (sinf/cosf, reference channel order) and the compositing run in f32.
//
// The tile, the tensor-core products, the trunk, the heads and the scan are
// in fused_mlp_common.cuh, shared with the training kernels
// (fused_mlp_train.cu).
//
// Built with nvcc for sm_90a by object_nerf_torch/ops/_build.py and bound
// with ctypes: plain C entry points, every pointer a device pointer, the
// stream PyTorch's current stream. The kernels allocate nothing.

#include "fused_mlp_common.cuh"

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
__global__ void __launch_bounds__(THREADS, 1)
render_tiles_kernel(const float* __restrict__ xyz, const float* __restrict__ z,
                    const float* __restrict__ dir_pe, const float* __restrict__ codes,
                    const float* __restrict__ vox, VoxDims vd,
                    const bf16* __restrict__ w, const float* __restrict__ b,
                    BranchTab scene, BranchTab obj, float* __restrict__ maps,
                    float* __restrict__ weights, int n_rays, int S, int n_freq,
                    int c_dir, int code_len, int forward_instance,
                    int last_delta_inf) {
  extern __shared__ __align__(128) unsigned char smem[];
  Smem s = VOX ? carve_vox(smem) : carve(smem);
  const int R = ROWS / S;
  constexpr int LD = VOX ? LDX_V : LDX;
  if (VOX)
    load_inputs_vox(blockIdx.x, xyz, z, vox, codes, (long long)n_rays * S, S, n_freq, vd,
                    code_len, forward_instance != 0,
                    forward_instance ? obj.v[T_K0] : scene.v[T_K0], s.X, s.zs,
                    reinterpret_cast<float*>(s.H));
  else
    load_inputs(blockIdx.x, xyz, z, forward_instance ? codes : nullptr, n_rays, S, n_freq,
                code_len, s.X, s.zs, s.scratch);
  dir_bias(blockIdx.x, scene, w, b, WS / 2, dir_pe, c_dir, n_rays, R, s.dbs);
  if (forward_instance)
    dir_bias(blockIdx.x, obj, w, b, WO / 2, dir_pe, c_dir, n_rays, R, s.dbo);
  run_trunk<WS, LD>(scene, w, b, s.X, s.H, s.wst, s.scratch);
  run_heads<WS>(scene, w, b, s.H, s.wst, s.scratch, s.dbs, S, s.sig, s.rgb);
  if (forward_instance) {
    run_trunk<WO, LD>(obj, w, b, s.X, s.H, s.wst, s.scratch);
    run_heads<WO>(obj, w, b, s.H, s.wst, s.scratch, s.dbo, S, s.isig, s.irgb);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tasks = forward_instance ? 2 * R : R;
  for (int task = warp; task < n_tasks; task += THREADS / 32) {
    const int rho = task % R, inst = task / R;
    const int ray = blockIdx.x * R + rho;
    if (ray >= n_rays) continue;
    float out[5];
    float* m = maps + (size_t)ray * 16;
    if (!inst) {
      composite_ray(s.sig + rho * S, s.rgb + rho * S * 3, s.zs + rho * S, S,
                    last_delta_inf ? 1e10f : 0.f,
                    weights != nullptr ? weights + (size_t)ray * S : nullptr, out);
      if (lane == 0) {
        for (int c = 0; c < 5; ++c) m[c] = out[c];
        for (int c = forward_instance ? 10 : 5; c < 16; ++c) m[c] = 0.f;
      }
    } else {
      // instance pass: last delta 0, rgb always white-backed
      composite_ray(s.isig + rho * S, s.irgb + rho * S * 3, s.zs + rho * S, S,
                    0.f, nullptr, out);
      if (lane == 0) {
        for (int c = 0; c < 3; ++c) m[5 + c] = out[c] + (1.f - out[4]);
        m[8] = out[3];
        m[9] = out[4];
      }
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

template <bool VOX>
int launch_render(const float* xyz, const float* z, const float* dir_pe,
                  const float* codes, const float* vox, VoxDims vd, const void* w,
                  const float* b, const int* scene_tab, const int* obj_tab, float* maps,
                  float* weights, int n_rays, int S, int n_freq, int c_dir, int code_len,
                  int forward_instance, int last_delta_inf, void* stream) {
  constexpr int BYTES = VOX ? SMEM_BYTES_V : SMEM_BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      render_tiles_kernel<VOX>, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (e != cudaSuccess) return (int)e;
  const int R = ROWS / S;
  dim3 grid((n_rays + R - 1) / R);
  render_tiles_kernel<VOX><<<grid, THREADS, BYTES, (cudaStream_t)stream>>>(
      xyz, z, dir_pe, codes, vox, vd, static_cast<const bf16*>(w), b, to_tab(scene_tab),
      to_tab(obj_tab), maps, weights, n_rays, S, n_freq, c_dir, code_len,
      forward_instance, last_delta_inf);
  return (int)cudaGetLastError();
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

int onerf_render_tiles(const float* xyz, const float* z, const float* dir_pe,
                       const float* codes, const float* vox, const void* w,
                       const float* b, const int* scene_tab, const int* obj_tab,
                       float* maps, float* weights, int n_rays, int S, int n_freq,
                       int c_dir, int code_len, int forward_instance,
                       int last_delta_inf, int c_svox, int c_ivox, int n_freq_vox,
                       void* stream) {
  const VoxDims vd = {c_svox, c_ivox, n_freq_vox};
  if (vox != nullptr)
    return launch_render<true>(xyz, z, dir_pe, codes, vox, vd, w, b, scene_tab, obj_tab,
                               maps, weights, n_rays, S, n_freq, c_dir, code_len,
                               forward_instance, last_delta_inf, stream);
  return launch_render<false>(xyz, z, dir_pe, codes, vox, vd, w, b, scene_tab, obj_tab,
                              maps, weights, n_rays, S, n_freq, c_dir, code_len,
                              forward_instance, last_delta_inf, stream);
}

}  // extern "C"
