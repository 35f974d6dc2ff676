// Point-wise density kernel for Hopper (sm_90a), bf16 tensor cores.
//
//   sigma_eval_kernel  replaces _sigma_kernel / fused_sigma_eval
//                      (object_nerf_tpu/ops/pallas_mlp.py:971, :997): the raw
//                      density (before any ReLU) of N arbitrary points
//                      through ONE branch: xyz positional encoding -> scene
//                      trunk -> sigma head, or [PE | latent code] -> object
//                      trunk -> sigma head, the code shared by each run of
//                      `per_row` consecutive points (a "pseudo-row"). No
//                      direction input, no rgb heads, no compositing scan.
//                      It is the density query of the mesh-extraction sweep
//                      and the coarse pass of the multi-object edit render.
//
// What bounds it: the tensor cores. A point costs 0.49 M multiply-adds in
// the scene branch and 0.08 M in the object branch, against 12 bytes read
// and 4 written, far past the card's operations-per-byte balance point.
//
// What the design does about it (the simple first version, as
// fused_mlp.cu): a block of 8 warps owns 128 consecutive points; their
// activations stay in shared memory as bf16 from the encoding to the sigma
// head, every product runs on the bf16 tensor cores (wmma, f32 sums), and
// the weights stream from L2 in 64-row chunks. Unlike the render kernels the
// tile is not made of whole rays: a point's code row is `point / per_row`,
// computed per point, so any per_row >= 1 is taken, and the ragged last tile
// is masked here (rows past N read zeros and store nothing). Left for later
// work: wgmma, TMA, several tiles per block so that the weights are staged
// once for more rows, and an object-branch tile that fills the SM better
// than 128 x 128.
//
// A voxel-conditioned model (`vox` given) gets the VOX instantiation: the raw
// voxel features (N, 16 + 8) are one more operand, encoded by the block
// itself into the wider input tile of fused_mlp_common.cuh ([svox | PE(svox) |
// xyz | PE(xyz)], then [ivox | PE(ivox) | code] for the object branch).
//
// Numerics as in fused_mlp.cu: matmul operands rounded to bf16, f32
// accumulation, bias and LeakyReLU in f32, sinf/cosf encoding in the
// reference channel order. The tile, the products, the trunk and the sigma
// head are in fused_mlp_common.cuh.

#include "fused_mlp_common.cuh"

namespace {

// X = [PE(point) | code of the point's pseudo-row | 0] as bf16 for the 128
// points of tile `tile`; rows of points past n_pts are zero.
__device__ void load_points(int tile, const float* __restrict__ pts,
                            const float* __restrict__ codes, int n_pts, int per_row,
                            int n_freq, int code_len, bf16* X, float* xyz_s) {
  const int p0 = tile * ROWS;
  for (int e = threadIdx.x; e < ROWS * 3; e += THREADS)
    xyz_s[e] = p0 + e / 3 < n_pts ? pts[(size_t)p0 * 3 + e] : 0.f;
  __syncthreads();
  const int pe = 3 * (2 * n_freq + 1);
  for (int e = threadIdx.x; e < ROWS * XCOLS; e += THREADS) {
    const int r = e / XCOLS, c = e % XCOLS;
    const int p = p0 + r;
    float v = 0.f;
    if (p < n_pts)
      v = input_value(xyz_s + r * 3, c, pe,
                      codes != nullptr ? codes + (size_t)(p / per_row) * code_len : nullptr,
                      code_len);
    X[r * LDX + c] = __float2bfloat16(v);
  }
}

template <int N, bool VOX>
__global__ void __launch_bounds__(THREADS, 1)
sigma_eval_kernel(const float* __restrict__ pts, const float* __restrict__ codes,
                  const float* __restrict__ vox, VoxDims vd,
                  const bf16* __restrict__ w, const float* __restrict__ b,
                  BranchTab branch, float* __restrict__ sigma, int n_pts, int per_row,
                  int n_freq, int code_len) {
  extern __shared__ __align__(128) unsigned char smem[];
  Smem s = VOX ? carve_vox(smem) : carve(smem);
  if (VOX) {
    // the staging reuses the H buffer, free until the first layer's epilogue
    load_inputs_vox(blockIdx.x, pts, nullptr, vox, codes, n_pts, per_row, n_freq, vd,
                    code_len, codes != nullptr, branch.v[T_K0], s.X, s.zs,
                    reinterpret_cast<float*>(s.H));
    run_trunk<N, LDX_V>(branch, w, b, s.X, s.H, s.wst, s.scratch);
  } else {
    // the xyz staging reuses the scratch tile (384 floats of its 2048)
    load_points(blockIdx.x, pts, codes, n_pts, per_row, n_freq, code_len, s.X, s.scratch);
    run_trunk<N>(branch, w, b, s.X, s.H, s.wst, s.scratch);
  }
  head_sigma(s.H, N, w + branch.v[T_SIGW], b[branch.v[T_SIGB]], s.sig);
  __syncthreads();
  for (int r = threadIdx.x; r < ROWS; r += THREADS) {
    const int p = blockIdx.x * ROWS + r;
    if (p < n_pts) sigma[p] = s.sig[r];
  }
}

template <int N, bool VOX>
int launch(const float* pts, const float* codes, const float* vox, VoxDims vd,
           const void* w, const float* b, const int* tab, float* sigma, int n_pts,
           int per_row, int n_freq, int code_len, void* stream) {
  constexpr int BYTES = VOX ? SMEM_BYTES_V : SMEM_BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      sigma_eval_kernel<N, VOX>, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((n_pts + ROWS - 1) / ROWS);
  sigma_eval_kernel<N, VOX><<<grid, THREADS, BYTES, (cudaStream_t)stream>>>(
      pts, codes, vox, vd, static_cast<const bf16*>(w), b, to_tab(tab), sigma, n_pts,
      per_row, n_freq, code_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// `tab` is the offset table of the branch to run: the scene's when
// `instance` is 0 (codes unused), the object's otherwise (codes holds
// ceil(n_pts / per_row) rows of code_len). `vox` is the raw voxel feature
// operand (n_pts, c_svox + c_ivox) of a voxel-conditioned model, or null for
// a classical one. Returns cudaGetLastError().
int onerf_sigma_eval(const float* pts, const float* codes, const float* vox,
                     const void* w, const float* b, const int* tab, float* sigma,
                     int n_pts, int per_row, int n_freq, int code_len, int instance,
                     int c_svox, int c_ivox, int n_freq_vox, void* stream) {
  const VoxDims vd = {c_svox, c_ivox, n_freq_vox};
  if (!instance) {
    codes = nullptr;
    code_len = 0;
  }
  if (vox != nullptr) {
    if (instance)
      return launch<WO, true>(pts, codes, vox, vd, w, b, tab, sigma, n_pts, per_row,
                              n_freq, code_len, stream);
    return launch<WS, true>(pts, codes, vox, vd, w, b, tab, sigma, n_pts, per_row, n_freq,
                            code_len, stream);
  }
  if (instance)
    return launch<WO, false>(pts, codes, vox, vd, w, b, tab, sigma, n_pts, per_row,
                             n_freq, code_len, stream);
  return launch<WS, false>(pts, codes, vox, vd, w, b, tab, sigma, n_pts, per_row, n_freq,
                           code_len, stream);
}

}  // extern "C"
