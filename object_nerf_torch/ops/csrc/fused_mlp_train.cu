// Fused ObjectNeRF training kernels for Hopper (sm_90a), bf16 tensor cores.
//
// Hand-written replacements of two Pallas TPU kernels:
//
//   mlp_eval_kernel  replaces _mlp_kernel / fused_mlp_eval
//                    (object_nerf_tpu/ops/pallas_mlp.py:287, :495): xyz
//                    positional encoding -> scene trunk -> sigma, `final`,
//                    view-direction head, sigmoid rgb; the object branch
//                    on [PE, code]; per sample row [sigma, rgb, sigma_inst,
//                    rgb_inst] (raw sigma: noise and ReLU are the caller's).
//   mlp_bwd_kernel   replaces _bwd_kernel / _run_bwd
//                    (object_nerf_tpu/ops/pallas_mlp_vjp.py:72, :417): given
//                    the per-row cotangent g (n*S, 8) it recomputes the
//                    forward per tile and sweeps back: every weight and
//                    bias gradient, and the per-ray code gradient. xyz and
//                    the view direction get no gradient.
//   reduce_partials_kernel  sums the backward's per-block partial gradients
//                    in block order (deterministic).
//
// What bounds them: the tensor cores by count (0.70 M multiply-adds per row
// forward, about 2.07 M backward, against 12 + 32 bytes of input per row).
// This first backward is in fact held back by memory traffic of its own
// making, which the design keeps simple and correct:
//
// * The forward kernel is the eval render's tile (fused_mlp_common.cuh): one
//   block of 8 warps owns 128 sample rows of whole rays, activations stay in
//   shared memory as bf16, weights stream from L2 in 64-row chunks.
// * The backward's stash does not fit an SM: per 128-row tile the reverse
//   sweep needs the scene branch's 8 trunk activations, `final` and the
//   direction-head activation (608 KB in bf16; the object branch's 176 KB
//   reuses the space). The grid is persistent (one block per SM, each
//   walking tiles blockIdx.x, blockIdx.x + gridDim.x, ...), and every block
//   has a stash of its own in a device-memory workspace that the wrapper
//   allocates. Each stashed activation is written once and read back once
//   (the direction-head activation is still in shared memory when the sweep
//   starts): about 6.1 KB written and 5.9 KB read per sample row, 3.2 GB
//   per 262,144-row launch.
// * Weight gradients contract over rows: dW = act^T @ d_pre is the stash
//   tile read as a col_major matrix_a. A branch's gradients (2.4 MB in f32
//   for the scene) fit neither registers nor shared memory across tiles, so
//   each block accumulates into its own f32 partial in device memory: the
//   accumulator fragments are loaded from the partial, the tile's product is
//   added, and they are stored back (no atomics). That read-modify-write is
//   about 5.6 MB per tile, 11.5 GB per 262,144-row launch, the largest
//   traffic of the kernel. reduce_partials_kernel then adds the partials in
//   block order, so two launches on the same inputs give the same bits.
// * Only what needs a gradient is formed: the scene branch's input gradient
//   is never computed, the object branch's only for its layer 0 and skip
//   layer, of which the code columns are summed over each ray's rows inside
//   the block (the tile holds whole rays) and written once per ray.
// * Rows of rays past n_rays carry g = 0, so every cotangent of such a row
//   is zero and it adds nothing to any sum.
// Left for later work: wgmma, TMA, keeping a layer's dW in registers across
// several tiles, recomputing from a checkpoint instead of stashing.
//
// Rounding follows the TPU kernel and mlp_bwd_plain
// (object_nerf_torch/ops/fused_mlp_vjp.py): activations are stashed in bf16;
// every d_pre is rounded to bf16 for both its weight-gradient and its
// input-gradient product; bias gradients are f32 column sums of the
// unrounded d_pre; the LeakyReLU cotangent takes the sign of the rounded
// post-activation with >= 0; the sigmoid cotangent uses the f32 output.
//
// The gradient buffers mirror the packed weight layout of
// pack_kernel_weights: the weight gradient of a matrix sits at the matrix's
// own element offset in an f32 buffer as long as the bf16 weight buffer, the
// bias gradients at the bias offsets.

#include "fused_mlp_common.cuh"

namespace {

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;

constexpr int LDT = KC + 8;  // leading dimension of a transposed weight chunk
constexpr int GROUPS = ROWS / 16;

// backward kernel: dynamic shared memory layout (bytes, multiples of 128)
constexpr int SB_X = 0;
constexpr int SB_H = SB_X + ROWS * LDX * 2;
constexpr int SB_G = SB_H + ROWS * LDH * 2;
constexpr int SB_W = SB_G + ROWS * LDH * 2;
constexpr int SB_SCR = SB_W + WS * LDT * 2;               // >= KC * LDWST * 2
constexpr int SB_RGB = SB_SCR + (THREADS / 32) * 256 * 4;  // rgb (128, 3) f32
constexpr int SB_GB = SB_RGB + ROWS * 3 * 4;               // g of the branch (128, 4)
constexpr int SB_DPR = SB_GB + ROWS * 4 * 4;               // d_pre of the rgb head (128, 3)
constexpr int SB_DB = SB_DPR + ROWS * 3 * 4;               // dir bias / per-ray sums
constexpr int SB_P = SB_DB + MAX_R * (WS / 2) * 4;         // input-gradient sums (8, 128)
constexpr int SMEM_BWD = SB_P + GROUPS * XCOLS * 4;
static_assert(WS * LDT >= KC * LDWST, "weight staging holds both chunk shapes");
static_assert(SMEM_BWD <= 232448, "a block has 227 KB of shared memory");

// stash of one block, in bf16 elements: trunk activations, `final`, dir head
constexpr size_t STASH_ELEMS = (size_t)ROWS * (9 * WS + WS / 2);

// acc += A[0:128, 0:Kc] @ Wg[0:NOUT, 0:Kc]^T. A is bf16 in shared memory; Wg
// is bf16 row-major (NOUT, ldw) in device memory, staged through `wst` as
// (NOUT, 64)-column chunks that the tensor cores read as col_major B.
template <int NOUT>
__device__ __forceinline__ void gemm_nt(Acc<NOUT>& acc, const bf16* A, int lda,
                                        const bf16* __restrict__ Wg, int ldw, int Kc,
                                        bf16* wst) {
  constexpr int FN = NOUT / 64;
  constexpr int VPR = KC / 8;
  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  for (int k0 = 0; k0 < Kc; k0 += KC) {
    __syncthreads();
    for (int v = threadIdx.x; v < NOUT * VPR; v += THREADS) {
      const int r = v / VPR, c = (v % VPR) * 8;
      *reinterpret_cast<uint4*>(wst + r * LDT + c) =
          __ldg(reinterpret_cast<const uint4*>(Wg + (size_t)r * ldw + k0 + c));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      FragA a[4];
      FragBT b[FN];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], A + (wr * 64 + i * 16) * lda + k0 + kk, lda);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], wst + (wc * (NOUT / 4) + j * 16) * LDT + kk, LDT);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc.f[i][j], a[i], b[j], acc.f[i][j]);
    }
  }
}

// dst[0:M, 0:N] (f32, row-major, leading dimension N, device memory)
//   = (first ? 0 : dst) + A[0:128, 0:M]^T @ G[0:128, 0:N].
// A and G are bf16 tiles in shared memory. M is a multiple of 64. Each warp
// owns a 64 x N/4 share of every 128-row chunk of dst.
template <int N>
__device__ __forceinline__ void gemm_tn_acc(float* dst, const bf16* A, int lda, int M,
                                            const bf16* G, bool first) {
  constexpr int FN = N / 64;
  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  __syncthreads();  // A and G are complete
  for (int m0 = wr * 64; m0 < M; m0 += 128) {
    Acc<N> acc;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        if (first)
          wmma::fill_fragment(acc.f[i][j], 0.0f);
        else
          wmma::load_matrix_sync(acc.f[i][j],
                                 dst + (size_t)(m0 + i * 16) * N + wc * (N / 4) + j * 16, N,
                                 wmma::mem_row_major);
      }
#pragma unroll
    for (int kk = 0; kk < ROWS; kk += 16) {
      FragAT a[4];
      FragB b[FN];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], A + kk * lda + m0 + i * 16, lda);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], G + kk * LDH + wc * (N / 4) + j * 16, LDH);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc.f[i][j], a[i], b[j], acc.f[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(dst + (size_t)(m0 + i * 16) * N + wc * (N / 4) + j * 16,
                                acc.f[i][j], N, wmma::mem_row_major);
  }
}

// f(row, col, value) -> d_pre over the warp's accumulators, like `epilogue`,
// and the f32 column sums of what f returns, added to dbias[0:N] in device
// memory. `colbuf` (2 x N floats of shared memory, free during an epilogue)
// joins the two row halves in a fixed order.
template <int N, typename F>
__device__ __forceinline__ void epilogue_colsum(Acc<N>& acc, float* scratch_all,
                                                float* colbuf, float* dbias, bool first,
                                                F f) {
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp >> 2, wc = warp & 3;
  float* scratch = scratch_all + warp * 256;
  const int c = lane & 15, half = lane >> 4;
#pragma unroll
  for (int j = 0; j < N / 64; ++j) {
    float cs = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wmma::store_matrix_sync(scratch, acc.f[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int rr = half * 8; rr < half * 8 + 8; ++rr)
        cs += f(wr * 64 + i * 16 + rr, wc * (N / 4) + j * 16 + c, scratch[rr * 16 + c]);
      __syncwarp();
    }
    cs += __shfl_xor_sync(0xffffffffu, cs, 16);
    if (half == 0) colbuf[wr * N + wc * (N / 4) + j * 16 + c] = cs;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < N; k += THREADS)
    dbias[k] = (first ? 0.f : dbias[k]) + colbuf[k] + colbuf[N + k];
}

// The code columns of an input gradient, summed over each 16-row group:
// P[group, col] (+)= sum over the group's rows of acc[row, col].
__device__ __forceinline__ void epilogue_groupsum(Acc<XCOLS>& acc, float* scratch_all,
                                                  float* P, bool add) {
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp >> 2, wc = warp & 3;
  float* scratch = scratch_all + warp * 256;
  const int c = lane & 15, half = lane >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < XCOLS / 64; ++j) {
      wmma::store_matrix_sync(scratch, acc.f[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      float s = 0.f;
      for (int rr = half * 8; rr < half * 8 + 8; ++rr) s += scratch[rr * 16 + c];
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      float* p = P + (wr * 4 + i) * XCOLS + wc * (XCOLS / 4) + j * 16 + c;
      if (half == 0) *p = add ? *p + s : s;
      __syncwarp();
    }
}

// Copy a (128, ncols) bf16 tile between shared memory (leading dimension
// LDH) and a dense tile of the block's stash in device memory.
__device__ __forceinline__ void tile_store(const bf16* H, bf16* dst, int ncols) {
  __syncthreads();
  const int vpr = ncols / 8;
  for (int v = threadIdx.x; v < ROWS * vpr; v += THREADS) {
    const int r = v / vpr, c = (v % vpr) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)r * ncols + c) =
        *reinterpret_cast<const uint4*>(H + r * LDH + c);
  }
}

__device__ __forceinline__ void tile_load(bf16* H, const bf16* src, int ncols) {
  __syncthreads();  // earlier readers of H are done; the stash is written
  const int vpr = ncols / 8;
  for (int v = threadIdx.x; v < ROWS * vpr; v += THREADS) {
    const int r = v / vpr, c = (v % vpr) * 8;
    *reinterpret_cast<uint4*>(H + r * LDH + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * ncols + c);
  }
  __syncthreads();
}

__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

struct SmemB {
  bf16 *X, *H, *G, *wst;
  float *scratch, *rgb, *gb, *dpr, *db, *P;
};

// One branch of one tile: recompute the forward with every activation
// stashed, then the reverse sweep. `branch` is 0 (scene) or 1 (object);
// gw / gb are this block's partial weight / bias gradients.
template <int N>
__device__ void branch_backward(int tile, int branch, const BranchTab& t,
                                const bf16* __restrict__ w, const float* __restrict__ b,
                                const float* __restrict__ dir_pe,
                                const float* __restrict__ g, float* gw, float* gbias,
                                bf16* stash, const SmemB& s, int n_rays, int S, int c_dir,
                                bool first) {
  constexpr int ND = N / 2;
  const int R = ROWS / S;
  const int depth = t.v[T_DEPTH], k0 = t.v[T_K0];
  bf16* st_final = stash + (size_t)depth * ROWS * N;
  bf16* st_denc = st_final + (size_t)ROWS * N;
  const int tid = threadIdx.x;

  // ---- forward recompute -------------------------------------------------
  dir_bias(tile, t, w, b, ND, dir_pe, c_dir, n_rays, R, s.db);
  // this branch's cotangent rows [g_sigma, g_rgb]; zero past n_rays
  for (int e = tid; e < ROWS * 4; e += THREADS) {
    const int r = e >> 2;
    const int ray = tile * R + r / S;
    s.gb[e] = ray < n_rays ? g[((size_t)tile * ROWS + r) * 8 + branch * 4 + (e & 3)] : 0.f;
  }
  for (int i = 0; i < depth; ++i) {
    Acc<N> acc;
    acc_zero(acc);
    const bf16* wl = w + t.v[T_TW + i];
    if (i == 0) {
      gemm<N>(acc, s.X, LDX, wl, k0, s.wst);
    } else if ((t.v[T_SKIPS] >> i) & 1) {
      gemm<N>(acc, s.X, LDX, wl, k0, s.wst);
      gemm<N>(acc, s.H, LDH, wl + (size_t)k0 * N, N, s.wst);
    } else {
      gemm<N>(acc, s.H, LDH, wl, N, s.wst);
    }
    const float* bl = b + t.v[T_TB + i];
    epilogue<N>(acc, s.scratch, [&](int r, int c, float v) {
      s.H[r * LDH + c] = __float2bfloat16(lrelu(v + bl[c]));
    });
    tile_store(s.H, stash + (size_t)i * ROWS * N, N);
  }
  {
    Acc<N> acc;
    acc_zero(acc);
    gemm<N>(acc, s.H, LDH, w + t.v[T_FINW], N, s.wst);
    const float* bl = b + t.v[T_FINB];
    epilogue<N>(acc, s.scratch, [&](int r, int c, float v) {
      s.H[r * LDH + c] = __float2bfloat16(v + bl[c]);
    });
    tile_store(s.H, st_final, N);
  }
  {
    Acc<ND> acc;
    acc_zero(acc);
    gemm<ND>(acc, s.H, LDH, w + t.v[T_DIRWH], N, s.wst);
    epilogue<ND>(acc, s.scratch, [&](int r, int c, float v) {
      s.H[r * LDH + c] = __float2bfloat16(lrelu(v + s.db[(r / S) * ND + c]));
    });
    tile_store(s.H, st_denc, ND);
  }
  head_rgb(s.H, ND, w + t.v[T_RGBW], b + t.v[T_RGBB], s.rgb);
  __syncthreads();

  // ---- rgb head (H holds the direction-head activation) -------------------
  for (int e = tid; e < ROWS * 3; e += THREADS) {
    const float o = s.rgb[e];
    s.dpr[e] = s.gb[(e / 3) * 4 + 1 + e % 3] * o * (1.f - o);
  }
  __syncthreads();
  {
    const bf16* wr_ = w + t.v[T_RGBW];
    float* gwr = gw + t.v[T_RGBW];
    for (int e = tid; e < 3 * ND; e += THREADS) {
      const int c = e / ND, k = e % ND;
      float acc = 0.f;
      for (int r = 0; r < ROWS; ++r)
        acc += __bfloat162float(s.H[r * LDH + k]) * rbf(s.dpr[r * 3 + c]);
      gwr[e] = (first ? 0.f : gwr[e]) + acc;
    }
    if (tid < 3) {
      float acc = 0.f;
      for (int r = 0; r < ROWS; ++r) acc += s.dpr[r * 3 + tid];
      float* p = gbias + t.v[T_RGBB] + tid;
      *p = (first ? 0.f : *p) + acc;
    }
    if (tid == 32) {  // sigma head's bias
      float acc = 0.f;
      for (int r = 0; r < ROWS; ++r) acc += s.gb[r * 4];
      float* p = gbias + t.v[T_SIGB];
      *p = (first ? 0.f : *p) + acc;
    }
    // d_pre of the direction layer -> G (bf16), its column sums, and the sums
    // over each ray's rows of the rounded values (for the direction weights)
    for (int k = tid; k < ND; k += THREADS) {
      const float w0 = __bfloat162float(wr_[k]), w1 = __bfloat162float(wr_[ND + k]),
                  w2 = __bfloat162float(wr_[2 * ND + k]);
      float colsum = 0.f;
      for (int rho = 0; rho < R; ++rho) {
        float raysum = 0.f;
        for (int r = rho * S; r < (rho + 1) * S; ++r) {
          float d = rbf(s.dpr[r * 3]) * w0 + rbf(s.dpr[r * 3 + 1]) * w1 +
                    rbf(s.dpr[r * 3 + 2]) * w2;
          if (!(__bfloat162float(s.H[r * LDH + k]) >= 0.f)) d *= LEAKY;
          const bf16 dr = __float2bfloat16(d);
          s.G[r * LDH + k] = dr;
          colsum += d;
          raysum += __bfloat162float(dr);
        }
        s.db[rho * ND + k] = raysum;  // the direction bias is spent
      }
      float* p = gbias + t.v[T_DIRB] + k;
      *p = (first ? 0.f : *p) + colsum;
    }
  }
  __syncthreads();
  {  // direction part of the direction layer: (32, ND) rows, c_dir of them real
    float* gwd = gw + t.v[T_DIRWD];
    for (int e = tid; e < 32 * ND; e += THREADS) {
      const int c = e / ND, k = e % ND;
      float acc = 0.f;
      if (c < c_dir)
        for (int rho = 0; rho < R; ++rho) {
          const int ray = tile * R + rho;
          if (ray < n_rays) acc += rbf(dir_pe[(size_t)ray * c_dir + c]) * s.db[rho * ND + k];
        }
      gwd[e] = (first ? 0.f : gwd[e]) + acc;
    }
  }

  // ---- direction layer's hidden part, `final` and the sigma head ------------
  tile_load(s.H, st_final, N);
  gemm_tn_acc<ND>(gw + t.v[T_DIRWH], s.H, LDH, N, s.G, first);
  {
    Acc<N> acc;
    acc_zero(acc);
    gemm_nt<N>(acc, s.G, LDH, w + t.v[T_DIRWH], ND, ND, s.wst);
    epilogue_colsum<N>(acc, s.scratch, reinterpret_cast<float*>(s.wst),
                       gbias + t.v[T_FINB], first, [&](int r, int c, float v) {
                         s.G[r * LDH + c] = __float2bfloat16(v);
                         return v;
                       });
  }
  tile_load(s.H, stash + (size_t)(depth - 1) * ROWS * N, N);
  gemm_tn_acc<N>(gw + t.v[T_FINW], s.H, LDH, N, s.G, first);
  {
    float* gws = gw + t.v[T_SIGW];
    for (int k = tid; k < N; k += THREADS) {
      float acc = 0.f;
      for (int r = 0; r < ROWS; ++r)
        acc += __bfloat162float(s.H[r * LDH + k]) * rbf(s.gb[r * 4]);
      gws[k] = (first ? 0.f : gws[k]) + acc;
    }
  }
  Acc<N> acc;
  acc_zero(acc);
  gemm_nt<N>(acc, s.G, LDH, w + t.v[T_FINW], N, N, s.wst);

  // ---- trunk, last layer first ----------------------------------------------
  // Entering step i: `acc` holds d_h of layer i (before the sigma head's
  // part for the last layer) and H holds layer i's activation.
  const bf16* wsig = w + t.v[T_SIGW];
  bool have_dcat = false;
  for (int i = depth - 1; i >= 0; --i) {
    const bool last = i == depth - 1;
    epilogue_colsum<N>(acc, s.scratch, reinterpret_cast<float*>(s.wst),
                       gbias + t.v[T_TB + i], first, [&](int r, int c, float v) {
                         if (last) v += rbf(s.gb[r * 4]) * __bfloat162float(wsig[c]);
                         if (!(__bfloat162float(s.H[r * LDH + c]) >= 0.f)) v *= LEAKY;
                         s.G[r * LDH + c] = __float2bfloat16(v);
                         return v;
                       });
    float* gwl = gw + t.v[T_TW + i];
    const bf16* wl = w + t.v[T_TW + i];
    const bool skip = i > 0 && ((t.v[T_SKIPS] >> i) & 1);
    if (i == 0 || skip) {
      gemm_tn_acc<N>(gwl, s.X, LDX, k0, s.G, first);
      if (branch == 1) {  // input gradient, for the code columns
        Acc<XCOLS> dcat;
        acc_zero(dcat);
        gemm_nt<XCOLS>(dcat, s.G, LDH, wl, N, N, s.wst);
        epilogue_groupsum(dcat, s.scratch, s.P, have_dcat);
        have_dcat = true;
      }
      if (i == 0) break;
      gwl += (size_t)k0 * N;
      wl += (size_t)k0 * N;
    }
    tile_load(s.H, stash + (size_t)(i - 1) * ROWS * N, N);
    gemm_tn_acc<N>(gwl, s.H, LDH, N, s.G, first);
    acc_zero(acc);
    gemm_nt<N>(acc, s.G, LDH, wl, N, N, s.wst);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1)
mlp_eval_kernel(const float* __restrict__ xyz, const float* __restrict__ dir_pe,
                const float* __restrict__ codes, const bf16* __restrict__ w,
                const float* __restrict__ b, BranchTab scene, BranchTab obj,
                float* __restrict__ out, int n_rays, int S, int n_freq, int c_dir,
                int code_len, int forward_instance, int compute_scene) {
  extern __shared__ __align__(128) unsigned char smem[];
  Smem s = carve(smem);
  const int R = ROWS / S;
  load_inputs(blockIdx.x, xyz, nullptr, forward_instance ? codes : nullptr, n_rays, S,
              n_freq, code_len, s.X, nullptr, s.scratch);
  if (compute_scene) {
    dir_bias(blockIdx.x, scene, w, b, WS / 2, dir_pe, c_dir, n_rays, R, s.dbs);
    run_trunk<WS>(scene, w, b, s.X, s.H, s.wst, s.scratch);
    run_heads<WS>(scene, w, b, s.H, s.wst, s.scratch, s.dbs, S, s.sig, s.rgb);
  }
  if (forward_instance) {
    dir_bias(blockIdx.x, obj, w, b, WO / 2, dir_pe, c_dir, n_rays, R, s.dbo);
    run_trunk<WO>(obj, w, b, s.X, s.H, s.wst, s.scratch);
    run_heads<WO>(obj, w, b, s.H, s.wst, s.scratch, s.dbo, S, s.isig, s.irgb);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < ROWS * 8; e += THREADS) {
    const int r = e >> 3, c = e & 7;
    if (blockIdx.x * R + r / S >= n_rays) continue;
    float v = 0.f;
    if (c < 4) {
      if (compute_scene) v = c == 0 ? s.sig[r] : s.rgb[r * 3 + c - 1];
    } else if (forward_instance) {
      v = c == 4 ? s.isig[r] : s.irgb[r * 3 + c - 5];
    }
    out[(size_t)blockIdx.x * ROWS * 8 + e] = v;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
mlp_bwd_kernel(const float* __restrict__ xyz, const float* __restrict__ dir_pe,
               const float* __restrict__ codes, const float* __restrict__ g,
               const bf16* __restrict__ w, const float* __restrict__ b,
               BranchTab scene, BranchTab obj, float* __restrict__ partials,
               int partial_stride, int bias_offset, bf16* __restrict__ stash_all,
               float* __restrict__ d_codes, int n_rays, int S, int n_freq, int c_dir,
               int code_len, int forward_instance) {
  extern __shared__ __align__(128) unsigned char smem[];
  SmemB s;
  s.X = reinterpret_cast<bf16*>(smem + SB_X);
  s.H = reinterpret_cast<bf16*>(smem + SB_H);
  s.G = reinterpret_cast<bf16*>(smem + SB_G);
  s.wst = reinterpret_cast<bf16*>(smem + SB_W);
  s.scratch = reinterpret_cast<float*>(smem + SB_SCR);
  s.rgb = reinterpret_cast<float*>(smem + SB_RGB);
  s.gb = reinterpret_cast<float*>(smem + SB_GB);
  s.dpr = reinterpret_cast<float*>(smem + SB_DPR);
  s.db = reinterpret_cast<float*>(smem + SB_DB);
  s.P = reinterpret_cast<float*>(smem + SB_P);

  const int R = ROWS / S;
  const int n_tiles = (n_rays + R - 1) / R;
  float* gw = partials + (size_t)blockIdx.x * partial_stride;
  float* gbias = gw + bias_offset;
  bf16* stash = stash_all + (size_t)blockIdx.x * STASH_ELEMS;
  const int pe = 3 * (2 * n_freq + 1);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    __syncthreads();  // the previous tile is done with X and the scratch
    load_inputs(tile, xyz, nullptr, forward_instance ? codes : nullptr, n_rays, S, n_freq,
                code_len, s.X, nullptr, s.scratch);
    branch_backward<WS>(tile, 0, scene, w, b, dir_pe, g, gw, gbias, stash, s, n_rays, S,
                        c_dir, first);
    if (forward_instance) {
      branch_backward<WO>(tile, 1, obj, w, b, dir_pe, g, gw, gbias, stash, s, n_rays, S,
                          c_dir, first);
      // d_codes[ray] = the code columns of the input gradient, summed over
      // the ray's 16-row groups in order
      const int gpr = S / 16;
      for (int e = threadIdx.x; e < R * code_len; e += THREADS) {
        const int rho = e / code_len, c = e % code_len;
        const int ray = tile * R + rho;
        if (ray >= n_rays) continue;
        float acc = 0.f;
        for (int q = rho * gpr; q < (rho + 1) * gpr; ++q) acc += s.P[q * XCOLS + pe + c];
        d_codes[(size_t)ray * code_len + c] = acc;
      }
    }
  }
}

__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       float* __restrict__ out, int n, int stride,
                                       int n_parts) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int p = 0; p < n_parts; ++p) acc += partials[(size_t)p * stride + e];
  out[e] = acc;
}

}  // namespace

extern "C" {

// bf16 elements of stash workspace one block of the backward needs
long long onerf_bwd_stash_elems() { return (long long)STASH_ELEMS; }

// Every launcher returns cudaGetLastError() after the launch (0 on success).
int onerf_mlp_eval(const float* xyz, const float* dir_pe, const float* codes,
                   const void* w, const float* b, const int* scene_tab,
                   const int* obj_tab, float* out, int n_rays, int S, int n_freq,
                   int c_dir, int code_len, int forward_instance, int compute_scene,
                   void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      mlp_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int R = ROWS / S;
  dim3 grid((n_rays + R - 1) / R);
  mlp_eval_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      xyz, dir_pe, codes, static_cast<const bf16*>(w), b, to_tab(scene_tab),
      to_tab(obj_tab), out, n_rays, S, n_freq, c_dir, code_len, forward_instance,
      compute_scene);
  return (int)cudaGetLastError();
}

// n_blocks blocks walk the tiles; `partials` holds n_blocks x partial_stride
// floats (weight gradients in the packed weight layout, then, from
// bias_offset, the bias gradients), `stash` n_blocks x onerf_bwd_stash_elems()
// bf16 elements. `grads` (partial_stride floats) receives the sum.
int onerf_mlp_bwd(const float* xyz, const float* dir_pe, const float* codes,
                  const float* g, const void* w, const float* b, const int* scene_tab,
                  const int* obj_tab, float* partials, float* grads, int partial_stride,
                  int bias_offset, void* stash, float* d_codes, int n_blocks, int n_rays,
                  int S, int n_freq, int c_dir, int code_len, int forward_instance,
                  void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      mlp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BWD);
  if (e != cudaSuccess) return (int)e;
  mlp_bwd_kernel<<<n_blocks, THREADS, SMEM_BWD, (cudaStream_t)stream>>>(
      xyz, dir_pe, codes, g, static_cast<const bf16*>(w), b, to_tab(scene_tab),
      to_tab(obj_tab), partials, partial_stride, bias_offset, static_cast<bf16*>(stash),
      d_codes, n_rays, S, n_freq, c_dir, code_len, forward_instance);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_partials_kernel<<<(partial_stride + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      partials, grads, partial_stride, partial_stride, n_blocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
