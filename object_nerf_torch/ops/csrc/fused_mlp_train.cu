// Fused ObjectNeRF training kernels for Hopper (sm_90a), bf16 tensor cores.
//
// Hand-written replacements of two Pallas TPU kernels:
//
//   fwd_chain_kernel<VOX, false>
//                    replaces _mlp_kernel / fused_mlp_eval
//                    (object_nerf_tpu/ops/pallas_mlp.py:287, :495): xyz
//                    positional encoding -> scene trunk -> sigma, `final`,
//                    view-direction head, sigmoid rgb; the object branch
//                    on [PE, code]; per sample row [sigma, rgb, sigma_inst,
//                    rgb_inst] (raw sigma: noise and ReLU are the caller's).
//   fused_mlp_bwd    replaces _bwd_kernel / _run_bwd
//                    (object_nerf_tpu/ops/pallas_mlp_vjp.py:72, :417): given
//                    the per-row cotangent g (n*S, 8), every weight and bias
//                    gradient and the per-ray code gradient (xyz and the
//                    view direction get no gradient), in three launches:
//     mlp_bwd_kernel          the tile sweep: the forward recompute and the
//                             d_pre chain of 128-row tiles;
//     wgrad_kernel            every dW = act^T @ d_pre, contracted over all
//                             rows of the launch (wgmma, operands by TMA);
//     reduce_segments_kernel  the partial sums of both, added in a fixed
//                             order (deterministic, no atomics).
//
// What bounds them: the tensor cores by count (0.70 M multiply-adds per row
// forward, about 2.07 M backward, against 12 + 32 bytes of input per row).
//
// * The forward is the chain of fused_mlp_wg.cuh, shared with the eval
//   render: a persistent, warp-specialised grid (a TMA producer warp, two
//   consumer warpgroups of 64 rows on wgmma), storing each row's outputs
//   from the heads' registers.
// * The sweep keeps the 128-row tile of whole rays and computes on wgmma: its
//   two warpgroups own
//   64 rows each; the A operand (input tile, activation or d_pre, padded
//   row-major bf16 in shared memory) enters through ldmatrix as registers,
//   B (a 64-row chunk of the weights, 32 KB at most) comes by TMA in the
//   128-byte swizzle that wgmma reads (MN-major for the forward's W, K-major
//   for the d_pre chain's W^T) through a ring of two stages: the 32 KB stage
//   and whichever of X and G is free (G during the forward recompute, X
//   during the reverse sweep), so the copy of the next chunk overlaps the
//   current product. The epilogues read the accumulators in wgmma's
//   register layout. Every function that issues wgmma is inlined: a call
//   between two wgmma makes ptxas serialize all of them.
// * A weight gradient contracts over rows, and a branch's gradients (2.4 MB
//   in f32 for the scene) fit no block's registers or shared memory across
//   tiles. On the TPU the sum lived in VMEM across a sequential grid; blocks
//   that run in parallel would have to read, add and write a partial in
//   device memory per tile (5.6 MB per tile). Instead the sweep writes what
//   the contraction reads, once per row, into a row-major bf16 workspace
//   over all rows of the launch: each layer's product input (the input tile,
//   the trunk activations, `final`) and each rounded d_pre (12.4 KB per row
//   for the classical model, 13.1 KB with the voxel tile; the column offsets
//   are bwd_workspace_layout's in fused_mlp_vjp.py). The sweep reads the
//   activations back for the LeakyReLU masks.
// * wgrad_kernel is a split-K GEMM over a work list (wgrad_work_list): one
//   block per item (matrix, 128 input rows of dW, all its output columns, a
//   slice of the workspace rows). A producer warp keeps a 4-stage ring of
//   64-row boxes in flight with TMA (128-byte swizzle); two consumer
//   warpgroups issue wgmma.m64n64k16 on them, each for 64 rows of dW. Both
//   operands are MN-major in shared memory (act is read as A^T, d_pre as
//   B): with one 64-wide block of M or N per instruction only the stride of
//   the 8-row groups (1024 bytes) enters the descriptors. Each item writes
//   its own f32 partial; the slices add up in the reduction.
// * The small products (sigma head, rgb head, the direction part of the
//   direction layer) and the bias column sums stay in the sweep, per block
//   of a persistent grid (one block per SM, each walking tiles blockIdx.x,
//   blockIdx.x + gridDim.x, ...) in a compact f32 partial (41 KB).
// * Only what needs a gradient is formed: the scene branch's input gradient
//   is never computed, the object branch's only for its layer 0 and skip
//   layer, of which the code columns are summed over each ray's rows inside
//   the block (the tile holds whole rays) and written once per ray.
// * Rows of rays past n_rays carry g = 0, so every d_pre of such a row is
//   zero and it adds nothing to any sum.
//
// A voxel-conditioned model (`vox` given) gets the VOX instantiation of the
// forward and of the sweep: the raw voxel features (n*S, 16 + 8) are one more
// operand and the input tile is the eval kernels' [svox | PE(svox) | xyz |
// PE(xyz)] (271 columns, read as 320) followed by [ivox | PE(ivox) | code]
// (439, read as 448). The forward takes the chain's voxel layout
// (fused_mlp_wg.cuh). The sweep cannot: the 116,736-byte tile, H, G and
// the weight stage exceed a block's shared memory. Its tile is built once per
// tile into the tile's rows of the workspace (where wgrad_kernel reads it
// too) and staged into the classical X buffer 128 columns at a time wherever
// layer 0 or a skip layer reads it. The sweep also forms the input gradient
// of both branches (JAX: need_cat_grad=use_voxel, pallas_mlp_vjp.py:322-342),
// but only of layer 0 and the skip layers and only 128 output columns at a
// time: each (128, 128) f32 chunk of G @ W_in^T lands in the H buffer (dead
// at that point of the sweep), and is reduced at once into the (128, C) f32
// d_vox tile through the encoding's chain, in f32 with full-precision sincosf
// (a sin(2^k x) column adds 2^k cos(2^k x) times its cotangent to channel x,
// a cos column -2^k sin(2^k x) times its cotangent), and into per-ray sums of
// the code columns. Every (row, channel) of d_vox is owned by one thread, its
// layers are added in a fixed order and the row is written once: no atomics,
// two launches on the same inputs give the same bits.
//
// Rounding follows the TPU kernel and mlp_bwd_plain
// (object_nerf_torch/ops/fused_mlp_vjp.py): activations are kept in bf16;
// every d_pre is rounded to bf16 for both its weight-gradient and its
// input-gradient product; bias gradients are f32 column sums of the
// unrounded d_pre; the LeakyReLU cotangent takes the sign of the rounded
// post-activation with >= 0; the sigmoid cotangent uses the f32 output.
//
// The gradient buffer mirrors the packed weight layout of
// pack_kernel_weights: the weight gradient of a matrix sits at the matrix's
// own element offset in an f32 buffer as long as the bf16 weight buffer, the
// bias gradients after it at the bias offsets.

#include "fused_mlp_wg.cuh"

namespace {

constexpr int GROUPS = ROWS / 16;
// the sweep's weight stage: a 64-row chunk of a weight matrix in the
// wgmma operand layout (128-byte swizzle), at most 256 x 64 bf16
constexpr int WST_BYTES = 32768;
// the weight ring's state: an mbarrier per stage, then the parity word
constexpr int RING_BYTES = 32;

// backward kernel: dynamic shared memory layout (bytes; the weight stage
// and the X and G buffers, the ring's other stage, 1024-byte aligned for
// the swizzle)
constexpr int SB_X = 0;
constexpr int SB_H = SB_X + ROWS * LDX * 2;
constexpr int SB_G = SB_H + ROWS * LDH * 2;
constexpr int SB_W = SB_G + ROWS * LDH * 2;
constexpr int SB_RGB = SB_W + WST_BYTES;                   // rgb (128, 3) f32
constexpr int SB_GB = SB_RGB + ROWS * 3 * 4;               // g of the branch (128, 4)
constexpr int SB_DPR = SB_GB + ROWS * 4 * 4;               // d_pre of the rgb head (128, 3)
constexpr int SB_DB = SB_DPR + ROWS * 3 * 4;               // dir bias / per-ray sums
constexpr int SB_P = SB_DB + MAX_R * (WS / 2) * 4;         // input-gradient sums (8, 128)
constexpr int SB_RING = SB_P + GROUPS * XCOLS * 4;
constexpr int SMEM_BWD = SB_RING + RING_BYTES;
static_assert(SB_W % 1024 == 0 && SB_G % 1024 == 0 && SB_X % 1024 == 0,
              "the ring's stages must be 1024-byte aligned");
static_assert(ROWS * LDX * 2 >= WST_BYTES && ROWS * LDH * 2 >= WST_BYTES,
              "X and G each hold a stage");
static_assert(SMEM_BWD <= 232448, "a block has 227 KB of shared memory");

// The voxel backward's layout: X is the staging buffer of 128-column chunks
// of the tile (which lives in the workspace); per-ray code sums and the
// d_vox tile take the room of the classical layout's group sums.
constexpr int SBV_X = 0;
constexpr int SBV_H = SBV_X + ROWS * LDX * 2;
constexpr int SBV_G = SBV_H + ROWS * LDH * 2;
constexpr int SBV_W = SBV_G + ROWS * LDH * 2;
constexpr int SBV_RGB = SBV_W + WST_BYTES;
constexpr int SBV_GB = SBV_RGB + ROWS * 3 * 4;
constexpr int SBV_DPR = SBV_GB + ROWS * 4 * 4;
constexpr int SBV_DB = SBV_DPR + ROWS * 3 * 4;
constexpr int SBV_P = SBV_DB + MAX_R * (WS / 2) * 4;       // per-ray code sums (4, 128)
constexpr int SBV_DV = SBV_P + MAX_R * XCOLS * 4;          // d_vox tile (128, MAX_VOX) f32
constexpr int SBV_RING = SBV_DV + ROWS * MAX_VOX * 4;
constexpr int SMEM_BWD_V = SBV_RING + RING_BYTES;
static_assert(SBV_W % 1024 == 0 && SBV_G % 1024 == 0 && SBV_X % 1024 == 0,
              "the ring's stages must be 1024-byte aligned");
static_assert(SMEM_BWD_V <= 232448, "voxel backward exceeds a block's shared memory");
static_assert(ROWS * XCOLS * 4 <= ROWS * LDH * 2, "an f32 input-gradient chunk exceeds H");
static_assert((THREADS / 32) * WS * 4 <= WST_BYTES, "the column sums exceed the stage");

// The workspace table (bwd_workspace_layout(...).tab() in fused_mlp_vjp.py):
// the columns of a workspace row, the first column and the width of the
// input tile, then per branch the first columns of its trunk activations
// (layer i at act + i N), `final`, the rounded trunk d_pre (layer i at
// g + i N), `final`'s d_pre and the direction layer's d_pre.
enum { W_COLS = 0, W_X = 1, W_XC = 2, W_BR = 3, W_PER_BRANCH = 5, W_LEN = 13 };
struct WsTab { int v[W_LEN]; };
struct BranchWs { int act, fin, g, gfin, gdir; };

WsTab to_ws(const int* v) {
  WsTab t;
  memcpy(t.v, v, sizeof(t.v));
  return t;
}

__device__ __forceinline__ BranchWs branch_ws(const WsTab& t, int branch) {
  const int o = W_BR + W_PER_BRANCH * branch;
  return {t.v[o], t.v[o + 1], t.v[o + 2], t.v[o + 3], t.v[o + 4]};
}

// ---- the sweep's products: wgmma, two warpgroups of 64 rows each ----------------
// A (the input tile, an activation or a d_pre: bf16 in shared memory,
// row-major with padded rows) enters through ldmatrix as registers; B, a
// 64-row chunk of the weights, comes by TMA into a stage of the ring in the
// 128-byte swizzle and is read by wgmma from there. Warp w holds rows
// [16 w, 16 w + 16) of the tile: in accumulator register r of column block
// j, row 16 w + lane / 4 + 8 ((r / 2) % 2) and column
// 64 j + 8 (r / 4) + 2 (lane % 4) + r % 2.

// The weight ring: two stages of one chunk each (the 32 KB stage `w`, and
// the X or G buffer, whichever the caller names free), an mbarrier per stage
// that the TMA copies complete, and in shared memory the parities that the
// stages' barriers complete next (bit s for stage s), kept from one product
// to the next. Thread 0 issues the copy of chunk c + 1 before the block
// waits for chunk c, so each copy overlaps the product before it.
struct Ring {
  uint32_t w, x, g;  // shared addresses of the stages
  uint32_t bar;      // two mbarriers, 8 bytes apart
  uint32_t* phase;
};

// The start of a product on the ring: returns the parities it waits for.
__device__ __forceinline__ uint32_t ring_begin(const Ring& rg) {
  fence_proxy_async();  // generic accesses to either stage come before the copies
  __syncthreads();      // earlier readers of both stages are done
  return *rg.phase;
}

// Wait for the chunk in stage q; the warp converges again for wgmma.
__device__ __forceinline__ void ring_wait(const Ring& rg, uint32_t& ph, int q) {
  mbar_wait(rg.bar + 8 * q, (ph >> q) & 1);
  ph ^= 1u << q;
  __syncwarp();
}

// The parities for the next product, which every thread reads after its
// first barrier (this product's last barrier is behind every read).
__device__ __forceinline__ void ring_end(const Ring& rg, uint32_t ph) {
  if (threadIdx.x == 0) *rg.phase = ph;
}

// rows [r, r + 64) of a (K, N) matrix, MN-major: N / 64 boxes
template <int N>
__device__ __forceinline__ void ring_load_mn(uint32_t dst, uint32_t bar, const CUtensorMap* map,
                                             int r) {
  mbar_expect_tx(bar, N * 128);
#pragma unroll
  for (int j = 0; j < N / 64; ++j) tma_load_2d(dst + j * 8192, map, 64 * j, r, bar);
}

// columns [c, c + 64) of rows [r, r + NOUT), K-major: NOUT / 64 boxes
template <int NOUT>
__device__ __forceinline__ void ring_load_k(uint32_t dst, uint32_t bar, const CUtensorMap* map,
                                            int c, int r) {
  mbar_expect_tx(bar, NOUT * 128);
#pragma unroll
  for (int i = 0; i < NOUT / 64; ++i) tma_load_2d(dst + i * 8192, map, c, r + 64 * i, bar);
}

template <int N>
struct WAcc {
  float d[N / 64][32];
};

template <int N>
__device__ __forceinline__ void wacc_zero(WAcc<N>& a) {
#pragma unroll
  for (int j = 0; j < N / 64; ++j)
#pragma unroll
    for (int r = 0; r < 32; ++r) a.d[j][r] = 0.f;
}

// f(row, col, value) over this thread's accumulators
template <int N, typename F>
__device__ __forceinline__ void wacc_for_each(WAcc<N>& a, F f) {
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < N / 64; ++j)
#pragma unroll
    for (int r = 0; r < 32; ++r)
      f(r0 + 8 * ((r >> 1) & 1), 64 * j + 8 * (r >> 2) + c0 + (r & 1), a.d[j][r]);
}

// acc += A[0:128, k0:k0 + 64] @ B, B the chunk in the stage at b0 (TB:
// MN-major rows of K, else K-major rows of N), column block j at j * 8 KB
template <int N, int TB>
__device__ __forceinline__ void wg_mma_chunk(WAcc<N>& acc, const bf16* A, int lda, int k0,
                                             uint32_t b0) {
  const int lane = threadIdx.x & 31;
  const bf16* arow = A + (16 * (threadIdx.x >> 5) + (lane & 7) + 8 * ((lane >> 3) & 1)) * lda +
                     k0 + 8 * (lane >> 4);
  uint32_t a[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
                 : "r"(smem_u32(arow + 16 * kk)));
#pragma unroll
  for (int j = 0; j < N / 64; ++j) fence_acc(acc.d[j]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < N / 64; ++j) {
      const uint32_t addr = b0 + j * 8192 + (TB ? kk * 2048 : kk * 32);
      wgmma_rs<TB>(acc.d[j], a[kk], TB ? desc_mn(addr) : desc_k(addr));
    }
  wgmma_commit_wait();
#pragma unroll
  for (int j = 0; j < N / 64; ++j) fence_acc(acc.d[j]);
}

// acc += A[0:128, 0:K] @ W[r0:r0 + K, 0:N], W the (rows, N) matrix of
// `map`, staged 64 rows at a time MN-major through the ring, whose second
// stage is `other`. K is a multiple of 64.
template <int N>
__device__ __forceinline__ void wg_gemm(WAcc<N>& acc, const bf16* A, int lda,
                                        const CUtensorMap* map, int r0, int K, const Ring& rg,
                                        uint32_t other) {
  uint32_t ph = ring_begin(rg);
  const int n = K / 64;
  if (threadIdx.x == 0) ring_load_mn<N>(rg.w, rg.bar, map, r0);
  for (int c = 0; c < n; ++c) {
    const int q = c & 1;
    if (threadIdx.x == 0 && c + 1 < n)
      ring_load_mn<N>(q ? rg.w : other, rg.bar + 8 * (q ^ 1), map, r0 + 64 * (c + 1));
    ring_wait(rg, ph, q);
    wg_mma_chunk<N, 1>(acc, A, lda, 64 * c, q ? other : rg.w);
    __syncthreads();  // both warpgroups are done with stage q
  }
  ring_end(rg, ph);
}

// acc += A[0:128, 0:Kc] @ W[r0:r0 + NOUT, 0:Kc]^T, W the matrix of `map`,
// staged 64 columns at a time K-major through the ring. Kc is a multiple
// of 64.
template <int NOUT>
__device__ __forceinline__ void wg_gemm_nt(WAcc<NOUT>& acc, const bf16* A, int lda,
                                           const CUtensorMap* map, int r0, int Kc,
                                           const Ring& rg, uint32_t other) {
  uint32_t ph = ring_begin(rg);
  const int n = Kc / 64;
  if (threadIdx.x == 0) ring_load_k<NOUT>(rg.w, rg.bar, map, 0, r0);
  for (int c = 0; c < n; ++c) {
    const int q = c & 1;
    if (threadIdx.x == 0 && c + 1 < n)
      ring_load_k<NOUT>(q ? rg.w : other, rg.bar + 8 * (q ^ 1), map, 64 * (c + 1), r0);
    ring_wait(rg, ph, q);
    wg_mma_chunk<NOUT, 0>(acc, A, lda, 64 * c, q ? other : rg.w);
    __syncthreads();  // both warpgroups are done with stage q
  }
  ring_end(rg, ph);
}

// f(row, col, value) over the accumulators. Starts with a block barrier, so
// f may overwrite the A operand of the product that produced `acc`.
template <int N, typename F>
__device__ __forceinline__ void wepilogue(WAcc<N>& acc, F f) {
  __syncthreads();
  wacc_for_each(acc, f);
}

// f(row, col, value) -> d_pre over the accumulators, like `wepilogue`, and
// the f32 column sums of what f returns, added to dbias[0:N] (the block's
// partial): per warp over its 16 rows by shuffles, then over the 8 warps in
// warp order through `colbuf` (8 x N floats of the stage, free after the
// product).
template <int N, typename F>
__device__ __forceinline__ void wepilogue_colsum(WAcc<N>& acc, float* colbuf, float* dbias,
                                                 bool first, F f) {
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < N / 64; ++j)
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 64 * j + 8 * q + c0 + h;
        float cs = f(r0, c, acc.d[j][4 * q + h]) + f(r0 + 8, c, acc.d[j][4 * q + 2 + h]);
        cs += __shfl_xor_sync(0xffffffffu, cs, 4);
        cs += __shfl_xor_sync(0xffffffffu, cs, 8);
        cs += __shfl_xor_sync(0xffffffffu, cs, 16);
        if (lane < 4) colbuf[warp * N + c] = cs;
      }
  __syncthreads();
  for (int k = threadIdx.x; k < N; k += THREADS) {
    float t = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) t += colbuf[w * N + k];
    dbias[k] = (first ? 0.f : dbias[k]) + t;
  }
}

// The code columns of an input gradient, summed over each 16-row group (one
// warp's rows): P[group, col] (+)= sum over the group's rows of acc[row, col].
__device__ __forceinline__ void wepilogue_groupsum(WAcc<XCOLS>& acc, float* P, bool add) {
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < XCOLS / 64; ++j)
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float cs = acc.d[j][4 * q + h] + acc.d[j][4 * q + 2 + h];
        cs += __shfl_xor_sync(0xffffffffu, cs, 4);
        cs += __shfl_xor_sync(0xffffffffu, cs, 8);
        cs += __shfl_xor_sync(0xffffffffu, cs, 16);
        float* p = P + warp * XCOLS + 64 * j + 8 * q + c0 + h;
        if (lane < 4) *p = add ? *p + cs : cs;
      }
}

// Copy a (128, ncols) bf16 tile from shared memory (leading dimension lds)
// to the tile's rows of the workspace (leading dimension ld). Starts with a
// barrier: the tile is complete.
__device__ __forceinline__ void tile_store(const bf16* src, int lds, bf16* dst, int ld,
                                           int ncols) {
  __syncthreads();
  const int vpr = ncols / 8;
  for (int v = threadIdx.x; v < ROWS * vpr; v += THREADS) {
    const int r = v / vpr, c = (v % vpr) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)r * ld + c) =
        *reinterpret_cast<const uint4*>(src + r * lds + c);
  }
}

// dst[0:128, 0:ncols] (leading dimension ldd) = a (128, ncols) tile of the
// workspace (leading dimension ld) that this block wrote.
__device__ __forceinline__ void tile_load(bf16* dst, int ldd, const bf16* src, int ld,
                                          int ncols) {
  __syncthreads();  // earlier readers of dst are done; the workspace rows are written
  const int vpr = ncols / 8;
  for (int v = threadIdx.x; v < ROWS * vpr; v += THREADS) {
    const int r = v / vpr, c = (v % vpr) * 8;
    cp_async16(dst + r * ldd + c, src + (size_t)r * ld + c);
  }
  cp_async_wait_all();
  __syncthreads();
}

__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

struct SmemB {
  bf16 *X, *H, *G, *wst;
  float *rgb, *gb, *dpr, *db, *P, *dv;
  Ring ring;
};

// The voxel operand of one backward tile: the tile's input columns in the
// workspace, the raw features of its rows (device memory, tile row 0 first)
// and the column layout of the input row.
struct VoxTile {
  const bf16* xg;     // (ROWS, ld) bf16
  int ld;
  const float* raw;   // (rows of the tile, c_s + c_i) f32
  VoxDims d;
  int o_ivox, o_code, code_len;  // first columns of [ivox | PE(ivox)] and of the code
};

// Stage columns [c0, c0 + w) of the voxel input tile into xs (leading
// dimension LDX). Starts with a barrier: earlier readers of xs are done.
__device__ __forceinline__ void stage_x(bf16* xs, const VoxTile& vt, int c0, int w) {
  __syncthreads();
  const int vpr = w / 8;
  for (int v = threadIdx.x; v < ROWS * vpr; v += THREADS) {
    const int r = v / vpr, c = (v % vpr) * 8;
    cp_async16(xs + r * LDX + c, vt.xg + (size_t)r * vt.ld + c0 + c);
  }
  cp_async_wait_all();
}

// acc += X[:, 0:k0] @ W[0:k0, :] (W the matrix of `map`): the shared tile,
// or the voxel tile staged 128 columns at a time. A forward product: G is
// the ring's second stage.
template <int N, bool VOX>
__device__ __forceinline__ void gemm_in(WAcc<N>& acc, const SmemB& s, const VoxTile& vt,
                                        const CUtensorMap* map, int k0) {
  if (!VOX) {
    wg_gemm<N>(acc, s.X, LDX, map, 0, k0, s.ring, s.ring.g);
    return;
  }
  for (int c0 = 0; c0 < k0; c0 += XCOLS) {
    const int w = min(XCOLS, k0 - c0);
    stage_x(s.X, vt, c0, w);
    wg_gemm<N>(acc, s.X, LDX, map, c0, w, s.ring, s.ring.g);
  }
}

// D[0:128, 0:NOUT] (f32, leading dimension XCOLS, shared) = G @ W[r0:r0 +
// NOUT, :]^T, W the matrix of `map`. X (spent in the reverse sweep of a
// voxel tile) is the ring's second stage.
template <int N, int NOUT>
__device__ __forceinline__ void input_grad_chunk(float* D, const SmemB& s,
                                                 const CUtensorMap* map, int r0) {
  WAcc<NOUT> a;
  wacc_zero(a);
  wg_gemm_nt<NOUT>(a, s.G, LDH, map, r0, N, s.ring, s.ring.x);
  wacc_for_each(a, [&](int r, int c, float v) { D[r * XCOLS + c] = v; });
  __syncthreads();
}

// Reduce the input-gradient columns [c0, c0 + w) in D into the d_vox tile
// (identity column plus the encoding's chain, f32) and, for the object
// branch, into the per-ray sums of the code columns. Rows of rays past
// n_rays are skipped (their cotangent is zero).
__device__ void reduce_input_grad(const float* D, int c0, int w, int branch, const SmemB& s,
                                  const VoxTile& vt, int tile, int n_rays, int S) {
  const VoxDims d = vt.d;
  const int cv = d.c_s + d.c_i, R = ROWS / S;
  for (int e = threadIdx.x; e < ROWS * cv; e += THREADS) {
    const int r = e / cv, ch = e % cv;
    const bool inst = ch >= d.c_s;
    if ((inst && branch == 0) || tile * R + r / S >= n_rays) continue;
    const int C = inst ? d.c_i : d.c_s, q = inst ? ch - d.c_s : ch;
    const int base = inst ? vt.o_ivox : 0;
    const float* Dr = D + r * XCOLS;
    float acc = 0.f;
    if (base + q >= c0 && base + q < c0 + w) acc += Dr[base + q - c0];
    const float x = vt.raw[(size_t)r * cv + ch];
    for (int k = 0; k < d.n_fv; ++k) {
      const int cs = base + C + 2 * C * k + q, cc = cs + C;
      const bool hs = cs >= c0 && cs < c0 + w, hc = cc >= c0 && cc < c0 + w;
      if (!hs && !hc) continue;
      const float f = (float)(1 << k);
      float sn, cs_;
      sincosf(x * f, &sn, &cs_);  // full precision: x * f reaches 32 x 3.5
      if (hs) acc += Dr[cs - c0] * (f * cs_);
      if (hc) acc -= Dr[cc - c0] * (f * sn);
    }
    s.dv[r * MAX_VOX + ch] += acc;
  }
  if (branch == 1) {
    for (int e = threadIdx.x; e < R * vt.code_len; e += THREADS) {
      const int rho = e / vt.code_len, c = e % vt.code_len;
      const int col = vt.o_code + c;
      if (col < c0 || col >= c0 + w) continue;
      float acc = 0.f;
      for (int r = rho * S; r < (rho + 1) * S; ++r) acc += D[r * XCOLS + col - c0];
      s.P[rho * XCOLS + c] += acc;
    }
  }
  __syncthreads();
}

// The voxel input gradient of one trunk layer that reads the tile: the
// columns with a consumer (the scene voxel piece of either branch; the
// instance piece and the code of the object branch), 128 at a time through H.
template <int N>
__device__ void vox_input_grad(int branch, const CUtensorMap* map, int k0, const SmemB& s,
                               const VoxTile& vt, int tile, int n_rays, int S) {
  float* D = reinterpret_cast<float*>(s.H);  // layer i's activation is spent
  const int hi = branch == 0 ? vt.d.c_s * (1 + 2 * vt.d.n_fv) : vt.o_code + vt.code_len;
  for (int c0 = 0; c0 < hi && c0 < k0; c0 += XCOLS) {
    const int w = min(XCOLS, k0 - c0);
    if (w == XCOLS)
      input_grad_chunk<N, XCOLS>(D, s, map, c0);
    else
      input_grad_chunk<N, 64>(D, s, map, c0);
    reduce_input_grad(D, c0, w, branch, s, vt, tile, n_rays, S);
  }
}

// One branch of one tile: recompute the forward, writing each activation
// that a weight gradient reads into the tile's workspace rows `wsr`
// (leading dimension ld, columns `o`), then the reverse sweep, writing each
// rounded d_pre there too. `branch` is 0 (scene) or 1 (object); gp is this
// block's compact partial of the bias and small-head gradients, at the
// offsets of `gt`; `maps` are the branch's WM_PER_BRANCH weight maps. VOX:
// the input tile is `vt`'s, and the input gradient goes to the d_vox tile
// and the per-ray code sums (vox_input_grad). The forward's products take G
// as the ring's second stage, the reverse sweep's X.
template <int N, bool VOX>
__device__ void branch_backward(int tile, int branch, const BranchTab& t, const BranchTab& gt,
                                const CUtensorMap* maps,
                                const bf16* __restrict__ w, const float* __restrict__ b,
                                const float* __restrict__ dir_pe,
                                const float* __restrict__ g, float* gp, bf16* wsr, int ld,
                                const BranchWs o, const SmemB& s, const VoxTile& vt,
                                int n_rays, int S, int c_dir, bool first) {
  constexpr int ND = N / 2;
  const int R = ROWS / S;
  const int depth = t.v[T_DEPTH], k0 = t.v[T_K0];
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
    WAcc<N> acc;
    wacc_zero(acc);
    if (i == 0) {
      gemm_in<N, VOX>(acc, s, vt, maps + i, k0);
    } else if ((t.v[T_SKIPS] >> i) & 1) {
      gemm_in<N, VOX>(acc, s, vt, maps + i, k0);
      wg_gemm<N>(acc, s.H, LDH, maps + i, k0, N, s.ring, s.ring.g);
    } else {
      wg_gemm<N>(acc, s.H, LDH, maps + i, 0, N, s.ring, s.ring.g);
    }
    const float* bl = b + t.v[T_TB + i];
    wepilogue(acc, [&](int r, int c, float v) {
      s.H[r * LDH + c] = __float2bfloat16(lrelu(v + bl[c]));
    });
    tile_store(s.H, LDH, wsr + o.act + i * N, ld, N);
  }
  {
    WAcc<N> acc;
    wacc_zero(acc);
    wg_gemm<N>(acc, s.H, LDH, maps + WM_FIN, 0, N, s.ring, s.ring.g);
    const float* bl = b + t.v[T_FINB];
    wepilogue(acc, [&](int r, int c, float v) {
      s.H[r * LDH + c] = __float2bfloat16(v + bl[c]);
    });
    tile_store(s.H, LDH, wsr + o.fin, ld, N);
  }
  {
    WAcc<ND> acc;
    wacc_zero(acc);
    wg_gemm<ND>(acc, s.H, LDH, maps + WM_DIR, 0, N, s.ring, s.ring.g);
    wepilogue(acc, [&](int r, int c, float v) {
      s.H[r * LDH + c] = __float2bfloat16(lrelu(v + s.db[(r / S) * ND + c]));
    });
  }
  head_rgb(s.H, ND, w + t.v[T_RGBW], b + t.v[T_RGBB], s.rgb);
  __syncthreads();

  // ---- rgb head (H holds the direction-head activation) -------------------
  for (int e = tid; e < ROWS * 3; e += THREADS) {
    const float o_ = s.rgb[e];
    s.dpr[e] = s.gb[(e / 3) * 4 + 1 + e % 3] * o_ * (1.f - o_);
  }
  __syncthreads();
  {
    const bf16* wr_ = w + t.v[T_RGBW];
    float* gwr = gp + gt.v[T_RGBW];
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
      float* p = gp + gt.v[T_RGBB] + tid;
      *p = (first ? 0.f : *p) + acc;
    }
    if (tid == 32) {  // sigma head's bias
      float acc = 0.f;
      for (int r = 0; r < ROWS; ++r) acc += s.gb[r * 4];
      float* p = gp + gt.v[T_SIGB];
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
      float* p = gp + gt.v[T_DIRB] + k;
      *p = (first ? 0.f : *p) + colsum;
    }
  }
  __syncthreads();
  {  // direction part of the direction layer: (32, ND) rows, c_dir of them real
    float* gwd = gp + gt.v[T_DIRWD];
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
  tile_store(s.G, LDH, wsr + o.gdir, ld, ND);

  // ---- `final` and the sigma head ---------------------------------------------
  {
    WAcc<N> acc;
    wacc_zero(acc);
    wg_gemm_nt<N>(acc, s.G, LDH, maps + WM_DIR, 0, ND, s.ring, s.ring.x);
    wepilogue_colsum(acc, reinterpret_cast<float*>(s.wst), gp + gt.v[T_FINB], first,
                     [&](int r, int c, float v) {
                       s.G[r * LDH + c] = __float2bfloat16(v);
                       return v;
                     });
  }
  tile_store(s.G, LDH, wsr + o.gfin, ld, N);
  tile_load(s.H, LDH, wsr + o.act + (depth - 1) * N, ld, N);
  {
    float* gws = gp + gt.v[T_SIGW];
    for (int k = tid; k < N; k += THREADS) {
      float acc = 0.f;
      for (int r = 0; r < ROWS; ++r)
        acc += __bfloat162float(s.H[r * LDH + k]) * rbf(s.gb[r * 4]);
      gws[k] = (first ? 0.f : gws[k]) + acc;
    }
  }
  WAcc<N> acc;
  wacc_zero(acc);
  wg_gemm_nt<N>(acc, s.G, LDH, maps + WM_FIN, 0, N, s.ring, s.ring.x);

  // ---- trunk, last layer first ----------------------------------------------
  // Entering step i: `acc` holds d_h of layer i (before the sigma head's
  // part for the last layer) and H holds layer i's activation.
  const bf16* wsig = w + t.v[T_SIGW];
  bool have_dcat = false;
  for (int i = depth - 1; i >= 0; --i) {
    const bool last = i == depth - 1;
    wepilogue_colsum(acc, reinterpret_cast<float*>(s.wst), gp + gt.v[T_TB + i], first,
                     [&](int r, int c, float v) {
                       if (last) v += rbf(s.gb[r * 4]) * __bfloat162float(wsig[c]);
                       if (!(__bfloat162float(s.H[r * LDH + c]) >= 0.f)) v *= LEAKY;
                       s.G[r * LDH + c] = __float2bfloat16(v);
                       return v;
                     });
    tile_store(s.G, LDH, wsr + o.g + i * N, ld, N);
    const bool skip = i > 0 && ((t.v[T_SKIPS] >> i) & 1);
    if (i == 0 || skip) {
      if constexpr (VOX) {  // input gradient of both branches: voxel and code columns
        vox_input_grad<N>(branch, maps + i, k0, s, vt, tile, n_rays, S);
      } else if (branch == 1) {  // input gradient, for the code columns
        WAcc<XCOLS> dcat;
        wacc_zero(dcat);
        wg_gemm_nt<XCOLS>(dcat, s.G, LDH, maps + i, 0, N, s.ring, s.ring.x);
        wepilogue_groupsum(dcat, s.P, have_dcat);
        have_dcat = true;
      }
      if (i == 0) break;
    }
    tile_load(s.H, LDH, wsr + o.act + (i - 1) * N, ld, N);
    wacc_zero(acc);
    // the hidden rows of layer i: after the input rows for a skip layer
    wg_gemm_nt<N>(acc, s.G, LDH, maps + i, skip ? k0 : 0, N, s.ring, s.ring.x);
  }
  __syncthreads();
}

// The tile sweep of the backward. `ws` is the workspace (rows of all tiles,
// wt.v[W_COLS] bf16 columns each); `small` holds small_stride floats per
// block: the block's bias and small-head gradients at the offsets of
// gscene / gobj; `maps` the weight matrices' tensor maps.
template <bool VOX>
__global__ void __launch_bounds__(THREADS, 1)
mlp_bwd_kernel(const __grid_constant__ SweepMaps maps, const float* __restrict__ xyz,
               const float* __restrict__ dir_pe,
               const float* __restrict__ codes, const float* __restrict__ vox, VoxDims vd,
               const float* __restrict__ g, const bf16* __restrict__ w,
               const float* __restrict__ b, BranchTab scene, BranchTab obj, BranchTab gscene,
               BranchTab gobj, WsTab wt, bf16* __restrict__ ws, float* __restrict__ small,
               int small_stride, float* __restrict__ d_codes, float* __restrict__ d_vox,
               int n_rays, int S, int n_freq, int c_dir, int code_len, int forward_instance) {
  extern __shared__ __align__(128) unsigned char smem[];
  SmemB s;
  if (VOX) {
    s.X = reinterpret_cast<bf16*>(smem + SBV_X);
    s.H = reinterpret_cast<bf16*>(smem + SBV_H);
    s.G = reinterpret_cast<bf16*>(smem + SBV_G);
    s.wst = reinterpret_cast<bf16*>(smem + SBV_W);
    s.rgb = reinterpret_cast<float*>(smem + SBV_RGB);
    s.gb = reinterpret_cast<float*>(smem + SBV_GB);
    s.dpr = reinterpret_cast<float*>(smem + SBV_DPR);
    s.db = reinterpret_cast<float*>(smem + SBV_DB);
    s.P = reinterpret_cast<float*>(smem + SBV_P);
    s.dv = reinterpret_cast<float*>(smem + SBV_DV);
    s.ring.bar = smem_u32(smem + SBV_RING);
  } else {
    s.X = reinterpret_cast<bf16*>(smem + SB_X);
    s.H = reinterpret_cast<bf16*>(smem + SB_H);
    s.G = reinterpret_cast<bf16*>(smem + SB_G);
    s.wst = reinterpret_cast<bf16*>(smem + SB_W);
    s.rgb = reinterpret_cast<float*>(smem + SB_RGB);
    s.gb = reinterpret_cast<float*>(smem + SB_GB);
    s.dpr = reinterpret_cast<float*>(smem + SB_DPR);
    s.db = reinterpret_cast<float*>(smem + SB_DB);
    s.P = reinterpret_cast<float*>(smem + SB_P);
    s.dv = nullptr;
    s.ring.bar = smem_u32(smem + SB_RING);
  }
  s.ring.w = smem_u32(s.wst);
  s.ring.x = smem_u32(s.X);
  s.ring.g = smem_u32(s.G);
  s.ring.phase = reinterpret_cast<uint32_t*>(smem + (VOX ? SBV_RING : SB_RING) + 16);

  if (threadIdx.x == 0) {
    if ((smem_u32(smem) & 1023u) != 0) __trap();  // the stages' swizzle needs 1 KB alignment
    mbar_init(s.ring.bar, 1);
    mbar_init(s.ring.bar + 8, 1);
    *s.ring.phase = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int R = ROWS / S;
  const int n_tiles = (n_rays + R - 1) / R;
  const int ld = wt.v[W_COLS];
  const BranchWs o_scene = branch_ws(wt, 0), o_obj = branch_ws(wt, 1);
  float* gp = small + (size_t)blockIdx.x * small_stride;
  const int pe = 3 * (2 * n_freq + 1);
  const int cv = vd.c_s + vd.c_i;
  VoxTile vt;
  vt.xg = nullptr;
  vt.ld = ld;
  vt.raw = nullptr;
  vt.d = vd;
  vt.o_ivox = vd.c_s * (1 + 2 * vd.n_fv) + pe;
  vt.o_code = vt.o_ivox + vd.c_i * (1 + 2 * vd.n_fv);
  vt.code_len = code_len;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    bf16* wsr = ws + (size_t)tile * ROWS * ld;
    __syncthreads();  // the previous tile is done with X, H and its sums
    if (VOX) {
      // the tile into the workspace (staged through H, free until the first
      // epilogue); the object branch reads the scene's columns too
      vt.xg = wsr + wt.v[W_X];
      load_inputs_vox(tile, xyz, nullptr, vox, codes, (long long)n_rays * S, S, n_freq, vd,
                      code_len, forward_instance != 0, wt.v[W_XC], wsr + wt.v[W_X], nullptr,
                      reinterpret_cast<float*>(s.H), ld);
      vt.raw = vox + (size_t)tile * ROWS * cv;
      for (int e = threadIdx.x; e < ROWS * MAX_VOX; e += THREADS) s.dv[e] = 0.f;
      for (int e = threadIdx.x; e < MAX_R * XCOLS; e += THREADS) s.P[e] = 0.f;
    } else {
      // xyz staged through H, free until the first epilogue
      load_inputs(tile, xyz, nullptr, forward_instance ? codes : nullptr, n_rays, S, n_freq,
                  code_len, s.X, nullptr, reinterpret_cast<float*>(s.H));
      tile_store(s.X, LDX, wsr + wt.v[W_X], ld, wt.v[W_XC]);
    }
    branch_backward<WS, VOX>(tile, 0, scene, gscene, &maps.m[0], w, b, dir_pe, g, gp, wsr, ld,
                             o_scene, s, vt, n_rays, S, c_dir, first);
    if (forward_instance) {
      // the scene's reverse sweep staged weights in X: the tile again
      if (!VOX) tile_load(s.X, LDX, wsr + wt.v[W_X], ld, wt.v[W_XC]);
      branch_backward<WO, VOX>(tile, 1, obj, gobj, &maps.m[WM_PER_BRANCH], w, b, dir_pe, g, gp,
                               wsr, ld, o_obj, s, vt, n_rays, S, c_dir, first);
      // d_codes[ray] = the code columns of the input gradient, summed over the
      // ray's rows (in 16-row groups in order, or per ray for VOX)
      const int gpr = S / 16;
      for (int e = threadIdx.x; e < R * code_len; e += THREADS) {
        const int rho = e / code_len, c = e % code_len;
        const int ray = tile * R + rho;
        if (ray >= n_rays) continue;
        float acc = 0.f;
        if (VOX)
          acc = s.P[rho * XCOLS + c];
        else
          for (int q = rho * gpr; q < (rho + 1) * gpr; ++q) acc += s.P[q * XCOLS + pe + c];
        d_codes[(size_t)ray * code_len + c] = acc;
      }
    }
    if (VOX) {  // each row of d_vox written once
      for (int e = threadIdx.x; e < ROWS * cv; e += THREADS) {
        const int r = e / cv, ch = e % cv;
        if (tile * R + r / S >= n_rays) continue;
        d_vox[((size_t)tile * ROWS + r) * cv + ch] = s.dv[r * MAX_VOX + ch];
      }
    }
  }
}

// ---- the weight-gradient GEMM (wgmma, operands by TMA) -------------------------

constexpr int WG_BK = 64;     // workspace rows per pipeline stage
constexpr int WG_STAGES = 4;
constexpr int WG_BOX = 64;    // a TMA box: 64 columns (128 bytes) x WG_BK rows
constexpr int WG_BOX_BYTES = WG_BOX * WG_BK * 2;
constexpr int WG_STAGE_BYTES = 6 * WG_BOX_BYTES;  // up to two boxes of act, four of d_pre
constexpr int WG_THREADS = 288;                   // consumer warpgroups 0, 1; producer warp 8
constexpr int WG_SMEM = 1024 + WG_STAGES * WG_STAGE_BYTES + 2 * WG_STAGES * 8;
static_assert(WG_SMEM <= 232448, "the weight-gradient ring exceeds a block's shared memory");
// an item of the work list (wgrad_work_list in fused_mlp_vjp.py), 8 ints:
// workspace columns of its act block and of its d_pre block, the output
// columns n (64, 128 or 256), the dW rows m (64 or 128), its rows [k0, k1)
// of the workspace, and the offset of its (m, n) f32 partial
enum { I_A = 0, I_G = 1, I_N = 2, I_M = 3, I_K0 = 4, I_K1 = 5, I_PART = 6, I_LEN = 8 };

// One item of the work list per block: partial[0:m, 0:n] = act[k0:k1, a:a+m]^T
// @ d_pre[k0:k1, g:g+n] over the workspace rows. Warp 8 loads, one 64-row
// stage at a time, the item's act boxes and d_pre boxes into a ring of
// WG_STAGES stages (full[s]: the bytes landed; empty[s]: the 8 consumer warps
// are done with it). Consumer warpgroup c owns dW rows [64 c, 64 c + 64) and
// idles (keeping the barriers' counts) when m is 64.
__global__ void __launch_bounds__(WG_THREADS, 1)
wgrad_kernel(__grid_constant__ const CUtensorMap tmap, const int* __restrict__ items,
             float* __restrict__ parts) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const int* item = items + (size_t)blockIdx.x * I_LEN;
  const int a_col = item[I_A], g_col = item[I_G], n = item[I_N], m = item[I_M];
  const int k0 = item[I_K0], iters = (item[I_K1] - k0) / WG_BK;
  const int na = m / 64, nb = n / 64;
  const uint32_t base = (smem_u32(wg_smem) + 1023u) & ~1023u;  // 128-byte swizzle: 1 KB aligned
  const uint32_t full = base + WG_STAGES * WG_STAGE_BYTES, empty = full + 8 * WG_STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // the producer
    if (lane == 0) {
      for (int i = 0; i < iters; ++i) {
        const int s = i % WG_STAGES;
        mbar_wait(empty + 8 * s, ((i / WG_STAGES) & 1) ^ 1);  // a fresh stage passes
        const uint32_t st = base + s * WG_STAGE_BYTES, bar = full + 8 * s;
        mbar_expect_tx(bar, (na + nb) * WG_BOX_BYTES);
        const int row = k0 + i * WG_BK;
        for (int c = 0; c < na; ++c)
          tma_load_2d(st + c * WG_BOX_BYTES, &tmap, a_col + WG_BOX * c, row, bar);
        for (int j = 0; j < nb; ++j)
          tma_load_2d(st + (2 + j) * WG_BOX_BYTES, &tmap, g_col + WG_BOX * j, row, bar);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const bool active = wg < na;
  float acc[4][32];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[j][r] = 0.f;
  for (int i = 0; i < iters; ++i) {
    const int s = i % WG_STAGES;
    mbar_wait(full + 8 * s, (i / WG_STAGES) & 1);
    __syncwarp();  // converged again for the warpgroup-wide instructions
    if (active) {
      const uint32_t st = base + s * WG_STAGE_BYTES;
#pragma unroll
      for (int j = 0; j < 4; ++j) fence_acc(acc[j]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {  // 16 rows: two 8-row groups, 2 KB
        const uint64_t da = desc_mn(st + wg * WG_BOX_BYTES + kk * 2048);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < nb)
            wgmma_ss_tt(acc[j], da, desc_mn(st + (2 + j) * WG_BOX_BYTES + kk * 2048));
      }
      wgmma_commit_wait();
#pragma unroll
      for (int j = 0; j < 4; ++j) fence_acc(acc[j]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
  if (!active) return;

  // the accumulator layout of m64nNk16: warp w of the group holds rows
  // 16 w + lane / 4 (+ 8), two adjacent columns per 8-column group
  float* out = parts + item[I_PART];
  const int row0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= nb) continue;
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      const int row = row0 + 8 * ((r >> 1) & 1);
      const int col = WG_BOX * j + 8 * (r >> 2) + 2 * (lane & 3);
      *reinterpret_cast<float2*>(out + (size_t)row * n + col) =
          make_float2(acc[j][r], acc[j][r + 1]);
    }
  }
}

// out[dst + j] = sum over p < n_parts, in order, of parts[src + p * stride + j]
// for j < len, one segment (5 ints: dst, len, src, stride, n_parts) per
// blockIdx.y: the K slices of a weight-gradient tile, or the sweep blocks'
// partials of a bias or small head.
__global__ void reduce_segments_kernel(const float* __restrict__ parts,
                                       const int* __restrict__ segs, float* __restrict__ out) {
  const int* sg = segs + blockIdx.y * 5;
  const int dst = sg[0], len = sg[1], src = sg[2], stride = sg[3], n_parts = sg[4];
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < len; j += gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int p = 0; p < n_parts; ++p) acc += parts[(size_t)src + (size_t)p * stride + j];
    out[dst + j] = acc;
  }
}

// The weight-gradient kernel over a (rows, cols) bf16 workspace: the tensor
// map of its 64 x 64 boxes, then one block per item.
int launch_wgrad(const void* ws, int rows, int cols, const int* items, int n_items,
                 float* parts, cudaStream_t st) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {WG_BOX, WG_BK}, unit[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ws), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  cudaError_t e =
      cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (e != cudaSuccess) return (int)e;
  wgrad_kernel<<<n_items, WG_THREADS, WG_SMEM, st>>>(map, items, parts);
  return (int)cudaGetLastError();
}

template <bool VOX>
int launch_mlp_bwd(const float* xyz, const float* dir_pe, const float* codes,
                   const float* vox, VoxDims vd, const float* g, const void* w,
                   const float* b, const int* scene_tab, const int* obj_tab,
                   const int* gscene_tab, const int* gobj_tab, const int* ws_tab,
                   const int* wmap_tab, void* ws, int ws_rows, float* small, int small_stride,
                   const int* items, int n_items, float* parts, const int* segs, int n_segs,
                   float* grads, float* d_codes, float* d_vox, int n_blocks, int n_rays, int S,
                   int n_freq, int c_dir, int code_len, int forward_instance, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const WsTab wt = to_ws(ws_tab);
  SweepMaps maps;
  cudaError_t e = (cudaError_t)encode_sweep_maps(w, wmap_tab, &maps);
  if (e != cudaSuccess) return (int)e;
  constexpr int BYTES = VOX ? SMEM_BWD_V : SMEM_BWD;
  e = cudaFuncSetAttribute(mlp_bwd_kernel<VOX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           BYTES);
  if (e != cudaSuccess) return (int)e;
  mlp_bwd_kernel<VOX><<<n_blocks, THREADS, BYTES, st>>>(
      maps, xyz, dir_pe, codes, vox, vd, g, static_cast<const bf16*>(w), b, to_tab(scene_tab),
      to_tab(obj_tab), to_tab(gscene_tab), to_tab(gobj_tab), wt, static_cast<bf16*>(ws), small,
      small_stride, d_codes, d_vox, n_rays, S, n_freq, c_dir, code_len, forward_instance);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = (cudaError_t)launch_wgrad(ws, ws_rows, wt.v[W_COLS], items, n_items, parts, st);
  if (e != cudaSuccess) return (int)e;
  reduce_segments_kernel<<<dim3(32, n_segs), 256, 0, st>>>(parts, segs, grads);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every launcher returns cudaGetLastError() after the launch (0 on success).
// `vox` is the raw voxel feature operand (n_rays * S, c_svox + c_ivox) of a
// voxel-conditioned model, or null for a classical one (then the three
// widths are unused). `wmap_tab` and `chunks`: the forward chain's weight
// maps and the chunk order of one tile (fused_mlp_vjp.forward_launch_tables).
int onerf_mlp_eval(const float* xyz, const float* dir_pe, const float* codes,
                   const float* vox, const void* w, const float* b, const int* scene_tab,
                   const int* obj_tab, const int* wmap_tab, const int* chunks, int n_chunks,
                   float* out, int n_rays, int S, int n_freq, int c_dir, int code_len,
                   int forward_instance, int compute_scene, int c_svox, int c_ivox,
                   int n_freq_vox, void* stream) {
  FwdArgs a = {xyz, nullptr, dir_pe, codes, vox, static_cast<const bf16*>(w), b, out,
               nullptr, nullptr, {c_svox, c_ivox, n_freq_vox}, n_rays, S, n_freq, c_dir,
               code_len, forward_instance, compute_scene, 0};
  const cudaStream_t st = (cudaStream_t)stream;
  if (vox != nullptr)
    return launch_fwd_chain<true, false>(wmap_tab, chunks, n_chunks, scene_tab, obj_tab, a, st);
  return launch_fwd_chain<false, false>(wmap_tab, chunks, n_chunks, scene_tab, obj_tab, a, st);
}

// The backward in three launches (fused_mlp_bwd in fused_mlp_vjp.py builds
// every table): the sweep on n_blocks blocks, reading the weights through
// the tensor maps of wmap_tab (WM_LEN x 3 ints), writing the workspace `ws`
// (ws_rows rows, ws_tab's layout) and each block's small partial (`small`,
// small_stride floats per block, at the offsets of gscene_tab / gobj_tab);
// the weight-gradient GEMM, one block per item of `items` (n_items x 8
// ints), writing its partial into `parts`; the reduction of the segments of
// `segs` (n_segs x 5 ints) from `parts` (which holds `small` too) into
// `grads` (the packed weight layout, then the biases). d_codes (n_rays,
// code_len); d_vox (n_rays * S, c_svox + c_ivox) when `vox` is given.
int onerf_mlp_bwd(const float* xyz, const float* dir_pe, const float* codes,
                  const float* vox, const float* g, const void* w, const float* b,
                  const int* scene_tab, const int* obj_tab, const int* gscene_tab,
                  const int* gobj_tab, const int* ws_tab, const int* wmap_tab, void* ws,
                  int ws_rows, float* small, int small_stride, const int* items, int n_items,
                  float* parts,
                  const int* segs, int n_segs, float* grads, float* d_codes, float* d_vox,
                  int n_blocks, int n_rays, int S, int n_freq, int c_dir, int code_len,
                  int forward_instance, int c_svox, int c_ivox, int n_freq_vox,
                  void* stream) {
  const VoxDims vd = {c_svox, c_ivox, n_freq_vox};
  if (vox != nullptr)
    return launch_mlp_bwd<true>(xyz, dir_pe, codes, vox, vd, g, w, b, scene_tab, obj_tab,
                                gscene_tab, gobj_tab, ws_tab, wmap_tab, ws, ws_rows, small,
                                small_stride, items, n_items, parts, segs, n_segs, grads,
                                d_codes, d_vox, n_blocks, n_rays, S, n_freq, c_dir, code_len,
                                forward_instance, stream);
  return launch_mlp_bwd<false>(xyz, dir_pe, codes, vox, vd, g, w, b, scene_tab, obj_tab,
                               gscene_tab, gobj_tab, ws_tab, wmap_tab, ws, ws_rows, small,
                               small_stride, items, n_items, parts, segs, n_segs, grads,
                               d_codes, d_vox, n_blocks, n_rays, S, n_freq, c_dir, code_len,
                               forward_instance, stream);
}

// The weight-gradient kernel alone (fused_mlp_bwd's second launch): for each
// of the n_items items (8 ints each) its f32 partial act^T @ d_pre over its
// rows of the (rows, cols) bf16 workspace `ws`, into `parts`.
int onerf_wgrad(const void* ws, int rows, int cols, const int* items, int n_items,
                float* parts, void* stream) {
  return launch_wgrad(ws, rows, cols, items, n_items, parts, (cudaStream_t)stream);
}

}  // extern "C"
