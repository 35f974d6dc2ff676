// Fused ObjectNeRF training kernels for Hopper (sm_90a), bf16 tensor cores.
//
// Hand-written replacements of two Pallas TPU kernels:
//
//   fwd_chain_kernel<VOX, FWD_EVAL>
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
// * The sweep keeps the 128-row tile of whole rays and computes on wgmma,
//   on the forward chain's pipeline: a persistent grid (one block per SM), a
//   producer warpgroup whose lanes stream 16 KB weight chunks by TMA through
//   a ring (7 stages classical, 6 voxel: SweepCfg; sweep_layout in
//   fused_mlp_vjp.py reads them) in the order the consumers take them
//   (sweep_chunks in fused_mlp_vjp.py: per branch the forward's products by
//   W, rows of W with all their columns, MN-major, then the reverse sweep's
//   products by W^T, 64 columns of 128 rows of W, K-major), so it runs ahead
//   across products, layers, branches and tiles; two consumer warpgroups of
//   64 rows each take every chunk and release its stage on their own (full /
//   empty mbarrier per stage). Nothing in a product waits for the other
//   warpgroup: they meet at the ring's barriers and once per tile, for the
//   per-ray code sums. The forward recompute is the chain's: A is the input
//   tile X (swizzled, shared memory) for layer 0 and a skip layer's input
//   rows, and otherwise the previous layer's output in registers, rounded to
//   bf16 pairs (fwd_gemm_rs), which the epilogue also stores into the
//   workspace. In the reverse sweep A is the warpgroup's d_pre tile G
//   (swizzled, shared memory), each LeakyReLU mask is loaded from the
//   workspace into registers while the product before its epilogue runs, and
//   each rounded d_pre goes from registers into G and the workspace.
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
//   direction layer) and the bias column sums stay in the sweep, per
//   consumer warpgroup in a compact f32 partial (41 KB; two per block).
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
// (fused_mlp_wg.cuh). The sweep cannot: the 116,736-byte tile beside G
// and the ring exceeds a block's shared memory. Its tile is built once per
// tile into the tile's rows of the workspace (where wgrad_kernel reads it
// too; one item per thread by a table of the items, each sine and cosine
// pair from one full-precision sincosf) and staged into X 128 columns at a
// time wherever layer 0 or a skip layer reads it. The sweep also forms the input gradient of both
// branches (JAX: need_cat_grad=use_voxel, pallas_mlp_vjp.py:322-342), but
// only of layer 0 and the skip layers and only 64 output columns at a time:
// each warpgroup's (64, 64) f32 chunk of G @ W_in^T lands in its X (spent in
// the reverse sweep), and is reduced at once into its (64, C) f32 d_vox rows
// through the encoding's chain, in f32 with full-precision sincosf (a sin(2^k
// x) column adds 2^k cos(2^k x) times its cotangent to channel x, a cos
// column -2^k sin(2^k x) times its cotangent), and into per-ray sums of the
// code columns. Every (row, channel) of d_vox is owned by one thread, its
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

// ---- the sweep's layout ----------------------------------------------------------

constexpr int SW_THREADS = 384;      // warpgroup 0 the producer, 1 and 2 the consumers
constexpr int SW_XT = 64 * XCOLS * 2;  // a warpgroup's input tile: 64 rows x 128 columns
constexpr int SW_GT = 64 * WS * 2;     // a warpgroup's d_pre tile: 64 rows x 256 columns
constexpr int SW_D = 64;               // columns of a voxel input-gradient chunk

// Per model: STAGES stages of FWD_STAGE bytes (one weight chunk each), as many
// as shared memory holds beside what the sweep keeps there. Per consumer
// warpgroup, in the 128-byte swizzle: its input tile X (classical: the tile;
// voxel: 128 columns of it at a time, staged from the workspace, and in the
// reverse sweep the f32 input-gradient chunk D and the column sums) and its
// d_pre tile G; then, in floats, its 4 warps' column sums (classical), the
// rgb head's d_pre, the direction biases (two rays at most), the code sums
// per 16-row group and the d_vox rows (voxel);
// the voxel tile's item table. The depth follows from the model alone, at
// compile time: 7 stages classical, 6 voxel.
template <bool VOX>
struct SweepCfg {
  static constexpr int STAGE = FWD_STAGE;
  static constexpr int NCOL = VOX ? 0 : 4 * WS;
  static constexpr int NDPR = 64 * 3;
  static constexpr int NDB = 2 * (WS / 2);
  static constexpr int NP = 4 * XCOLS;
  static constexpr int NDV = VOX ? 64 * MAX_VOX : 0;
  static constexpr int NCT = VOX ? XCOLS_V : 0;
  static constexpr int FIXED =
      2 * SW_XT + 2 * SW_GT + 2 * 4 * (NCOL + NDPR + NDB + NP + NDV) + 4 * NCT;
  // as many stages as shared memory holds beside the rest, the two barriers
  // per stage and the alignment slack
  static constexpr int STAGES = (232448 - FIXED - 1024) / (FWD_STAGE + 16);
  // dynamic shared memory (bytes from a 1024-byte aligned base)
  static constexpr int RING = 0;
  static constexpr int X = RING + STAGES * STAGE;
  static constexpr int G = X + 2 * SW_XT;
  static constexpr int COL = G + 2 * SW_GT;
  static constexpr int DPR = COL + 2 * 4 * NCOL;
  static constexpr int DB = DPR + 2 * 4 * NDPR;
  static constexpr int P = DB + 2 * 4 * NDB;
  static constexpr int DV = P + 2 * 4 * NP;
  static constexpr int CT = DV + 2 * 4 * NDV;
  static constexpr int BAR = CT + 4 * NCT;  // full, empty per stage
  static constexpr int BYTES = BAR + 16 * STAGES + 1024;
  // producer lanes, chunks in turn (FwdCfg::PRODUCERS says why at most STAGES)
  static constexpr int PRODUCERS = STAGES < 4 ? STAGES : 4;
  static_assert(STAGES >= 4, "the sweep's ring needs at least 4 stages");
  static_assert(BYTES <= 232448, "the sweep exceeds a block's shared memory");
  static_assert(X % 1024 == 0 && G % 1024 == 0, "the swizzled tiles need 1024-byte alignment");
  static_assert(!VOX || (64 * SW_D * 4 <= SW_XT && 4 * WS * 4 <= SW_XT &&
                         64 * (3 + MAX_VOX) * 4 <= SW_XT),
                "D, the column sums and the input staging each fit a warpgroup's input tile");
};

// The producer's plan: the sweep's weight maps, read in boxes of 64 columns x
// FWD_STAGE / (2 C) rows (C the map's columns), as the forward chain reads
// them, and their columns.
struct SweepPlan {
  SweepMaps maps;
  unsigned short cols[WM_LEN];
};

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

__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ---- the producer ------------------------------------------------------------------

// The producer warpgroup's work: lane 0 of its first C::PRODUCERS warps,
// chunks in turn, streams the chunk order `chunks` (sweep_chunks in
// fused_mlp_vjp.py) once per tile of the block by TMA into the ring, each
// chunk into the next stage once the 8 consumer warps have released it. A
// chunk is `slot | x / 64 << 5 | y / 16 << 8 | (nx - 1) << 19 | (ny - 1) <<
// 21`: nx x ny boxes of the map in `slot` from column x, row y, box (bx, by)
// at (x + 64 bx, y + by box_rows), stored (bx ny + by) boxes into the stage:
// rows of W with all their columns (a product by W, MN-major), or 64 columns
// of rows of W (a product by W^T, K-major: ny boxes one under the other, nx
// such blocks for the next 64 columns). Every chunk is FWD_STAGE bytes.
template <class C>
__device__ __forceinline__ void sweep_produce(const SweepPlan& plan,
                                              const unsigned* __restrict__ chunks, int n_chunks,
                                              int n_tiles, uint32_t ring, uint32_t full,
                                              uint32_t empty) {
  const int pw = threadIdx.x >> 5;
  if ((threadIdx.x & 31) != 0 || pw >= C::PRODUCERS) return;
  for (int i = 0; i < WM_LEN; ++i)
    if (plan.cols[i] > 0)
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&plan.maps.m[i]))
                   : "memory");
  int gj = 0;  // the block's chunks so far
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    for (int j = 0; j < n_chunks; ++j, ++gj) {
      if (gj % C::PRODUCERS != pw) continue;
      const unsigned c = __ldg(chunks + j);
      const int slot = c & 31, x = 64 * ((c >> 5) & 7), y = 16 * ((c >> 8) & 2047);
      const int nx = ((c >> 19) & 3) + 1, ny = ((c >> 21) & 3) + 1;
      const int box_rows = FWD_STAGE / 2 / plan.cols[slot], box = 128 * box_rows;
      const int stage = gj % C::STAGES, phase = (gj / C::STAGES) & 1;
      mbar_wait(empty + 8 * stage, phase ^ 1);  // a fresh stage passes
      const uint32_t dst = ring + stage * C::STAGE, bar = full + 8 * stage;
      mbar_expect_tx(bar, FWD_STAGE);
      for (int bx = 0; bx < nx; ++bx)
        for (int by = 0; by < ny; ++by)
          tma_load_2d(dst + (bx * ny + by) * box, &plan.maps.m[slot], x + 64 * bx,
                      y + box_rows * by, bar);
    }
  }
}

// ---- a consumer warpgroup's products ---------------------------------------------
// Each consumer warpgroup owns 64 rows of the tile and takes every chunk of
// the ring (FwdPipe: wait for `full`, release by `empty`); the two meet only
// at the ring's barriers and once per tile for the per-ray code sums. The
// forward's products are the chain's: fwd_gemm (A the input tile X in shared
// memory) and fwd_gemm_rs (A the previous layer's output in registers).

// acc += A[0:64, 0:K] @ W[r0:r0 + NOUT, 0:K]^T over the next chunks of the
// ring, A the warpgroup's d_pre tile (K-major, swizzled, at shared address
// a), NOUT = 2 L: for NOUT >= 128 a chunk is 128 rows of W by 64 columns
// (NOUT / 128 chunks per 64 columns of K, each on its 128 output columns),
// for NOUT 64 a chunk is two blocks of 64 rows by 64 columns (128 columns
// of K). Unrolled as fwd_gemm: each chunk's K steps one group, wait_group 1
// releases the chunk before.
template <class C, int K, int L>
__device__ __forceinline__ void bwd_gemm(float (&acc)[L], uint32_t a, FwdPipe<C>& p) {
  constexpr int NOUT = 2 * L, HALVES = NOUT >= 128 ? NOUT / 128 : 1;
  constexpr int NCH = NOUT >= 128 ? K / 64 * HALVES : K / 128;
  static_assert(NOUT == 64 || NOUT % 128 == 0, "128 output columns a chunk, or 64");
  static_assert(K % (NOUT >= 128 ? 64 : 128) == 0, "a product is whole chunks");
  int prev = 0;  // the stage of the chunk before
  fence_acc(acc);
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const uint32_t st = p.next();
    wgmma_fence();
    if constexpr (NOUT >= 128) {
      const int kb = c / HALVES, half = c % HALVES;
      float (&d)[64] = *reinterpret_cast<float(*)[64]>(acc + 64 * half);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_kn<0>(d, desc_k(a + kb * 8192 + kk * 32), desc_k(st + kk * 32));
    } else {
#pragma unroll
      for (int sub = 0; sub < 2; ++sub)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_kn<0>(acc, desc_k(a + (2 * c + sub) * 8192 + kk * 32),
                      desc_k(st + sub * 8192 + kk * 32));
    }
    wgmma_commit();
    if (c > 0) {  // the chunk before has finished
      wgmma_wait<1>();
      p.release(prev);
    }
    prev = p.stage;
    p.advance();
  }
  wgmma_wait<0>();
  p.release(prev);
  fence_acc(acc);
}

// A consumer warpgroup's rows (rows [64 wg, 64 wg + 64) of the tile) and its
// buffers in one tile.
struct SwWg {
  int t, bar;          // the thread in the warpgroup (0..127), its named barrier
  int real;            // its rows of rays before n_rays: [0, real)
  long long g0;        // its first row in the launch
  bf16* ws;            // its first workspace row
  uint32_t xs, gs;     // shared addresses of its input tile and d_pre tile
  unsigned char *xg, *gg;
  float *col, *dpr, *db, *P, *dv;
};

// The sweep's inputs.
struct SweepIn {
  const float *xyz, *dir_pe, *codes, *vox, *g;
  const bf16* w;
  const float* b;
  const int* ct;  // the voxel tile's item table
  VoxDims vd;
  int n_rays, S, n_freq, c_dir, code_len, ld, x0;  // ld, x0: the workspace's columns, the tile's first
};

// The voxel operand: first columns of [ivox | PE(ivox)] and of the code in
// the input row.
struct VoxCols {
  int o_ivox, o_code;
};

// The K0 input columns of a branch (input_tile_columns in fwd_chain.py).
template <bool VOX, int N>
__host__ __device__ constexpr int branch_k0() {
  return N == WS ? (VOX ? 320 : 64) : (VOX ? 448 : 128);
}

// this thread's two accumulator rows (r0, r0 + 8) and first column pair
__device__ __forceinline__ int acc_row0() {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
}
__device__ __forceinline__ int acc_col0() { return 2 * (threadIdx.x & 3); }

// The column sums of the warpgroup's rows: `cs` (this thread's sum of its two
// rows for column c) over the warp's 16 rows by shuffles into the warp's row
// of `col` (4 x n floats).
__device__ __forceinline__ void put_colsum(float cs, float* col, int n, int c) {
  cs += __shfl_xor_sync(0xffffffffu, cs, 4);
  cs += __shfl_xor_sync(0xffffffffu, cs, 8);
  cs += __shfl_xor_sync(0xffffffffu, cs, 16);
  if ((threadIdx.x & 31) < 4) col[((threadIdx.x >> 5) & 3) * n + c] = cs;
}

// out[0:n] (+)= the sums of the 4 warps' rows of `col`, in warp order. Starts
// with the warpgroup's barrier; `col` is free again after its next barrier.
template <int N>
__device__ __forceinline__ void sum_colsum(const SwWg& w, float* out, bool first) {
  float prior[N / 128];
#pragma unroll
  for (int q = 0; q < N / 128; ++q) prior[q] = first ? 0.f : out[w.t + 128 * q];
  wg_bar(w.bar);
#pragma unroll
  for (int q = 0; q < N / 128; ++q) {
    const int k = w.t + 128 * q;
    out[k] = prior[q] + (w.col[k] + w.col[N + k] + w.col[2 * N + k] + w.col[3 * N + k]);
  }
}

// this thread's bf16 pairs (rows r0, r0 + 8 of the 8-column groups) of N
// columns of the warpgroup's workspace rows from `rows`: m[2 g + u] the pair
// of row r0 + 8 u, columns 8 g + c0, + 1 (the layout of an m64nN accumulator)
template <int N>
__device__ __forceinline__ void load_pairs(uint32_t (&m)[N / 4], const bf16* rows, int ld) {
  const int r0 = acc_row0(), c0 = acc_col0();
#pragma unroll
  for (int g = 0; g < N / 8; ++g)
#pragma unroll
    for (int u = 0; u < 2; ++u)
      m[2 * g + u] =
          *reinterpret_cast<const uint32_t*>(rows + (size_t)(r0 + 8 * u) * ld + 8 * g + c0);
}

// Copy the warp's 16 rows of columns [0, ncols) of the warpgroup's swizzled
// tile at `t` (generic; the warp's own stmatrix stores, so a __syncwarp
// orders them) to its workspace rows from column `col`, 16 bytes a lane at a
// time: a row's 128-byte pieces go out whole.
__device__ __forceinline__ void warp_rows_store(const SwWg& w, const unsigned char* t, int ld,
                                                int col, int ncols) {
  __syncwarp();
  const int lane = threadIdx.x & 31, row0 = 16 * ((threadIdx.x >> 5) & 3);
  const int vpr = ncols / 8;
  for (int v = lane; v < 16 * vpr; v += 32) {
    const int r = row0 + v / vpr, c = (v % vpr) * 8;
    *reinterpret_cast<uint4*>(w.ws + (size_t)r * ld + col + c) =
        *reinterpret_cast<const uint4*>(t + swz(r, c));
  }
}

// The d_pre of a product's accumulators (d_h of a layer, N columns): v =
// acc, plus the sigma head's part rbf(g_sigma) w_sig (SIG), times the
// LeakyReLU slope of the layer's rounded activation (MASK: its pairs `m`).
// Its f32 column sums go to `dbias` (the warpgroup's partial), its bf16
// rounding into the d_pre tile (the next products' A) and into the
// workspace rows at column `col`.
template <int N, bool MASK, bool SIG>
__device__ __forceinline__ void dpre_epilogue(const float (&acc)[N / 2],
                                              const uint32_t (&m)[WS / 4], const float (&gsig)[2],
                                              const bf16* __restrict__ wsig, const SwWg& w,
                                              int ld, int col, float* dbias, bool first) {
  const int c0 = acc_col0();
  float prior[N / 128];  // the partial's sums so far, loaded before they are needed
#pragma unroll
  for (int q = 0; q < N / 128; ++q) prior[q] = first ? 0.f : dbias[w.t + 128 * q];
  wg_bar(w.bar);  // every warp's product is done reading the d_pre tile
#pragma unroll
  for (int g2 = 0; g2 < N / 16; ++g2) {
    uint32_t d[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = 2 * g2 + h, c = 8 * g + c0;
      float v[2][2];
      float s0 = 0.f, s1 = 0.f;
      if (SIG) {
        s0 = __bfloat162float(wsig[c]);
        s1 = __bfloat162float(wsig[c + 1]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        v[u][0] = acc[4 * g + 2 * u];
        v[u][1] = acc[4 * g + 2 * u + 1];
        if (SIG) {
          v[u][0] += gsig[u] * s0;
          v[u][1] += gsig[u] * s1;
        }
        if (MASK) {
          const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&m[2 * g + u]);
          if (!(__low2float(a) >= 0.f)) v[u][0] *= LEAKY;
          if (!(__high2float(a) >= 0.f)) v[u][1] *= LEAKY;
        }
        d[2 * h + u] = pack_bf16(v[u][0], v[u][1]);
      }
      put_colsum(v[0][0] + v[1][0], w.col, N, c);
      put_colsum(v[0][1] + v[1][1], w.col, N, c + 1);
    }
    store_pairs(w.gs, 2 * g2, d);
  }
  fence_proxy_async();  // the d_pre tile is complete for the products' reads
  warp_rows_store(w, w.gg, ld, col, N);
  wg_bar(w.bar);
#pragma unroll
  for (int q = 0; q < N / 128; ++q) {
    const int k = w.t + 128 * q;
    dbias[k] = prior[q] + (w.col[k] + w.col[N + k] + w.col[2 * N + k] + w.col[3 * N + k]);
  }
}

// Copy columns [0, ncols) of the warpgroup's swizzled tile at `t` (generic)
// to its workspace rows from column `col`, 16 bytes a thread at a time.
__device__ __forceinline__ void tile_store(const SwWg& w, const unsigned char* t, int ld,
                                           int col, int ncols) {
  const int vpr = ncols / 8;
  for (int v = w.t; v < 64 * vpr; v += 128) {
    const int r = v / vpr, c = (v % vpr) * 8;
    *reinterpret_cast<uint4*>(w.ws + (size_t)r * ld + col + c) =
        *reinterpret_cast<const uint4*>(t + swz(r, c));
  }
}

// Stage columns [c0, c0 + ncols) of the warpgroup's rows of the voxel input
// tile (in the workspace) into its swizzled input tile X for the products.
__device__ __forceinline__ void stage_x(const SwWg& w, int ld, int x0, int c0, int ncols) {
  wg_bar(w.bar);  // the warpgroup's earlier readers of X are done
  const int vpr = ncols / 8;
  for (int v = w.t; v < 64 * vpr; v += 128) {
    const int r = v / vpr, c = (v % vpr) * 8;
    cp_async16(w.xg + swz(r, c), w.ws + (size_t)r * ld + x0 + c0 + c);
  }
  cp_async_wait_all();
  fence_proxy_async();  // X is complete for the products' reads
  wg_bar(w.bar);
}

// acc += X[:, 0:K0] @ W[0:K0, :] for layer 0 or a skip layer's input rows:
// the classical tile in X, or the voxel tile staged 128 columns at a time.
template <class C, bool VOX, int N, int L>
__device__ __forceinline__ void x_product(float (&acc)[L], const SwWg& w, int ld, int x0,
                                          FwdPipe<C>& p) {
  constexpr int K0 = branch_k0<VOX, N>();
  if constexpr (!VOX) {
    fwd_gemm<C, K0, L>(acc, w.xs, p);
  } else {
#pragma unroll
    for (int c0 = 0; c0 < K0; c0 += XCOLS) {
      stage_x(w, ld, x0, c0, K0 - c0 >= XCOLS ? XCOLS : K0 - c0);
      if (K0 - c0 >= XCOLS)
        fwd_gemm<C, XCOLS, L>(acc, w.xs, p);
      else
        fwd_gemm<C, K0 % XCOLS, L>(acc, w.xs, p);
    }
  }
}

// ---- the input tile ---------------------------------------------------------------

// Item i of the voxel input tile, in column order: a raw value, a sine /
// cosine pair of one octave (the cosine C columns after the sine), a code
// column or a zero column, as voxel_input_value orders them. Bits 0-8 the
// (sine's) column, 9-11 the kind (0 a raw value, 1 a pair, 3 a code column,
// 4 zero), 12-19 the index (the value in the staged row [xyz (3) | raw voxel
// features], or the code's column), 20-23 the octave, 24-29 C.
__device__ int vox_item(int i, VoxDims d, int n_freq, bool inst, int code_len) {
  auto enc = [](int col, int kind, int idx, int oct, int C) {
    return col | kind << 9 | idx << 12 | oct << 20 | C << 24;
  };
  int col = 0, out = 0;
  // a piece of C values: its raw columns, then n octaves of [sin (C) | cos (C)]
  auto piece = [&](int C, int n, int base) {
    if (i < C) {
      out = enc(col + i, 0, base + i, 0, 0);
      return true;
    }
    i -= C;
    col += C;
    if (i < C * n) {
      const int k = i / C, q = i % C;
      out = enc(col + 2 * C * k + q, 1, base + q, k, C);
      return true;
    }
    i -= C * n;
    col += 2 * C * n;
    return false;
  };
  if (piece(d.c_s, d.n_fv, 3) || piece(3, n_freq, 0)) return out;
  if (inst) {
    if (piece(d.c_i, d.n_fv, 3 + d.c_s)) return out;
    if (i < code_len) return enc(col + i, 3, i, 0, 0);
    i -= code_len;
    col += code_len;
  }
  return enc(col + i, 4, 0, 0, 0);
}

// The warpgroup's rows of the voxel input tile into its workspace rows
// (columns [0, ncols)): xyz and the raw features staged in X (f32), then one
// item of the item table per thread at a time over the 64 rows (the rows
// independent of each other), each pair's sine and cosine from one
// full-precision sincosf, as the forward chain builds its tile. Ends with the
// warpgroup's barrier: the rows are written for stage_x.
__device__ __forceinline__ void build_vox(const SweepIn& in, const SwWg& w, int ncols,
                                          bool inst) {
  const VoxDims d = in.vd;
  const int cv = d.c_s + d.c_i, sr = 3 + cv;
  float* st = reinterpret_cast<float*>(w.xg);
  for (int e = w.t; e < 64 * 3; e += 128)
    st[(e / 3) * sr + e % 3] = e / 3 < w.real ? in.xyz[w.g0 * 3 + e] : 0.f;
  for (int e = w.t; e < 64 * cv; e += 128)
    st[(e / cv) * sr + 3 + e % cv] = e / cv < w.real ? in.vox[w.g0 * cv + e] : 0.f;
  wg_bar(w.bar);
  const long long ray0 = w.g0 / in.S;
  const int off = (int)(w.g0 - ray0 * in.S);
  const int n_items = ncols - d.c_s * d.n_fv - 3 * in.n_freq - (inst ? d.c_i * d.n_fv : 0);
  for (int it = w.t; it < n_items; it += 128) {
    const int e = in.ct[it], col = e & 511, kind = (e >> 9) & 7, idx = (e >> 12) & 255;
    const int C = (e >> 24) & 63;
    const float f = (float)(1 << ((e >> 20) & 15));
    bf16* out = w.ws + in.x0 + col;
#pragma unroll 8
    for (int r = 0; r < 64; ++r) {
      float x = 0.f, y = 0.f;
      if (r < w.real) {
        if (kind <= 1) {
          const float v = st[r * sr + idx];
          if (kind == 0)
            x = v;
          else
            sincosf(v * f, &x, &y);  // v * f exact
        } else if (kind == 3) {
          x = in.codes[(ray0 + (off + r) / in.S) * in.code_len + idx];
        }
      }
      out[(size_t)r * in.ld] = __float2bfloat16(x);
      if (kind == 1) out[(size_t)r * in.ld + C] = __float2bfloat16(y);
    }
  }
  wg_bar(w.bar);
}

// The warpgroup's rows of the classical input tile [PE(xyz) | code | 0]
// into X (swizzled; one column per thread and row) and into its workspace
// rows (columns [0, ncols)). xyz is staged in the rgb head's buffer.
__device__ void build_classical(const SweepIn& in, const SwWg& w, int ncols, bool inst) {
  float* xs = w.dpr;
  for (int e = w.t; e < 64 * 3; e += 128) xs[e] = e / 3 < w.real ? in.xyz[w.g0 * 3 + e] : 0.f;
  wg_bar(w.bar);
  const int pe = 3 * (2 * in.n_freq + 1);
#pragma unroll 4
  for (int r = 0; r < 64; ++r) {
    const long long g = w.g0 + r;
    float v = 0.f;
    if (r < w.real)
      v = input_value(xs + 3 * r, w.t, pe, inst ? in.codes + (g / in.S) * in.code_len : nullptr,
                      in.code_len);
    *reinterpret_cast<bf16*>(w.xg + swz(r, w.t)) = __float2bfloat16(v);
  }
  fence_proxy_async();  // X is complete for the products' reads
  wg_bar(w.bar);
  tile_store(w, w.xg, in.ld, in.x0, ncols);
}

// ---- the reverse sweep's small heads and input gradient ------------------------------

// The direction part of the direction layer's weight gradient over the
// warpgroup's rays: gwd[c, k] (+)= sum over its nr rays of dirs[ray, c] db[ray,
// k] (the staged, rounded encodings, MAX_DIR a ray, zero past c_dir; the rays'
// sums of the rounded d_pre), thread t taking entries t, t + 128, ...
template <int ND>
__device__ __forceinline__ void dir_weight_grad(float* __restrict__ gwd,
                                                const float* __restrict__ dirs,
                                                const float* __restrict__ db, int nr, int t,
                                                bool first) {
  constexpr int PER = MAX_DIR * ND / 128;
  float prior[PER];  // the partial's entries so far, every load issued before the first use
#pragma unroll
  for (int m = 0; m < PER; ++m) prior[m] = first ? 0.f : gwd[t + 128 * m];
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int e = t + 128 * m, c = e / ND, k = e % ND;
    float a = dirs[c] * db[k];
    for (int lr = 1; lr < nr; ++lr) a += dirs[lr * MAX_DIR + c] * db[lr * ND + k];
    gwd[e] = prior[m] + a;
  }
}

// The direction biases of the warpgroup's rays: db[lr * ND + j] = b_dir[j] +
// dir_pe[ray, :] . W_dir[:, j] (bf16 operands, f32 sum; the bias alone past
// n_rays), nr = max(1, 64 / S) rays.
__device__ void wg_dir_bias(const SweepIn& in, const BranchTab& t, int ND, const SwWg& w) {
  const bf16* wd = in.w + t.v[T_DIRWD];
  const float* bd = in.b + t.v[T_DIRB];
  const int nr = in.S >= 64 ? 1 : 64 / in.S;
  const long long ray0 = w.g0 / in.S;
  for (int e = w.t; e < nr * ND; e += 128) {
    const int lr = e / ND, j = e % ND;
    const long long ray = ray0 + lr;
    float s = 0.f;
    if (ray < in.n_rays)
      for (int c = 0; c < in.c_dir; ++c)
        s += rbf(in.dir_pe[ray * in.c_dir + c]) * __bfloat162float(wd[c * ND + j]);
    w.db[e] = s + bd[j];
  }
}

// Reduce the input-gradient columns [c0, c0 + SW_D) in D (the warpgroup's 64
// rows, f32, column c of row r at (c ^ 8 (r % 8))) into its d_vox rows
// (identity column plus the encoding's chain, f32) and, for the object
// branch, into its 16-row group sums of the code columns (`first`: the
// branch's first layer sets them). Thread t takes channel t % 32 of the 16
// rows of group t / 32, so that a channel's columns and octaves are found
// once and its rows are independent of each other; each (row, channel) of
// d_vox is summed by one thread, in a fixed order. Rows of rays past n_rays
// are skipped (their cotangent is zero).
__device__ void reduce_input_grad(const float* __restrict__ D, float* __restrict__ dv, int c0,
                                  int branch, const SweepIn& in, const VoxCols& vc,
                                  const SwWg& w, bool first) {
  const VoxDims d = in.vd;
  const int cv = d.c_s + d.c_i, ch = w.t & 31, r0 = 16 * (w.t >> 5);
  const bool inst = ch >= d.c_s;
  if (ch < cv && !(inst && branch == 0)) {
    const int C = inst ? d.c_i : d.c_s, q = inst ? ch - d.c_s : ch;
    const int base = inst ? vc.o_ivox : 0;
    const int id = base + q - c0;  // the raw value's own column in the chunk
    // the octaves with a sine or a cosine column in the chunk: j0 + 2 C k in
    // [c0 - C, c0 + SW_D), j0 the sine column of octave 0
    const int j0 = base + C + q;
    const int k_lo = max(0, (c0 - C - j0 + 2 * C - 1) / (2 * C));
    const int k_hi = min(d.n_fv - 1, c0 + SW_D - 1 - j0 >= 0 ? (c0 + SW_D - 1 - j0) / (2 * C) : -1);
    const int rows = min(16, w.real - r0);
    // the raw values of the channel's rows, then every row's sum, then the
    // d_vox updates: no store comes between two loads
    float xs[16], acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) xs[i] = i < rows ? in.vox[(w.g0 + r0 + i) * cv + ch] : 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = r0 + i, sw = (r & 7) << 3;
      const float* Dr = D + r * SW_D;
      acc[i] = id >= 0 && id < SW_D ? Dr[id ^ sw] : 0.f;
      for (int k = k_lo; k <= k_hi; ++k) {
        const int cs = j0 + 2 * C * k - c0, cc = cs + C;
        const float f = (float)(1 << k);
        float sn, cs_;
        sincosf(xs[i] * f, &sn, &cs_);  // full precision: x * f reaches 32 x 3.5
        if (cs >= 0 && cs < SW_D) acc[i] += Dr[cs ^ sw] * (f * cs_);
        if (cc >= 0 && cc < SW_D) acc[i] -= Dr[cc ^ sw] * (f * sn);
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < rows) dv[(r0 + i) * MAX_VOX + ch] += acc[i];
  }
  if (branch == 1) {  // per 16-row group, as the classical sweep's code sums
    for (int e = w.t; e < 4 * in.code_len; e += 128) {
      const int grp = e / in.code_len, c = e % in.code_len;
      const int col = vc.o_code + c;
      if (col < c0 || col >= c0 + SW_D) continue;
      float acc = 0.f;
      for (int r = 16 * grp; r < 16 * grp + 16; ++r)
        acc += D[r * SW_D + ((col - c0) ^ ((r & 7) << 3))];
      float* pp = w.P + grp * XCOLS + c;
      *pp = first ? acc : *pp + acc;
    }
  }
}

// The voxel input gradient of one trunk layer that reads the tile: the
// columns with a consumer (the scene voxel piece of either branch; the
// instance piece and the code of the object branch), SW_D at a time: D = G @
// W[c0:c0 + SW_D, :]^T into the warpgroup's input tile (spent in the reverse
// sweep), then its reduction.
template <class C, int N>
__device__ __forceinline__ void vox_input_grad(int branch, const SweepIn& in, const VoxCols& vc,
                                               const SwWg& w, bool first, FwdPipe<C>& p,
                                               FwdRegs& regs) {
  constexpr int K0 = branch_k0<true, N>();
  float* D = reinterpret_cast<float*>(w.xg);
  float (&a)[SW_D / 2] = *reinterpret_cast<float(*)[SW_D / 2]>(&regs.acc);
  const int r0 = acc_row0(), c0l = acc_col0();
  const int hi = branch == 0 ? vc.o_ivox - 3 * (2 * in.n_freq + 1) : vc.o_code + in.code_len;
  for (int c0 = 0; c0 < hi && c0 < K0; c0 += SW_D) {
#pragma unroll
    for (int r = 0; r < SW_D / 2; ++r) a[r] = 0.f;
    bwd_gemm<C, N, SW_D / 2>(a, w.gs, p);
    if (c0 == 0) wg_bar(w.bar);  // the column sums are read (a chunk's D is, at its end)
#pragma unroll
    for (int r = 0; r < SW_D / 2; ++r) {
      const int row = r0 + 8 * ((r >> 1) & 1), col = 8 * (r >> 2) + c0l + (r & 1);
      D[row * SW_D + (col ^ ((row & 7) << 3))] = a[r];
    }
    wg_bar(w.bar);
    reduce_input_grad(D, w.dv, c0, branch, in, vc, w, first);
    wg_bar(w.bar);  // D is read
  }
}

// One branch of the warpgroup's rows of one tile: recompute the forward,
// writing each activation that a weight gradient reads into the workspace
// rows (from registers: each layer's output, rounded to bf16, is the next
// product's A operand as it stands), then the reverse sweep, writing each
// rounded d_pre there too. `branch` is 0 (scene) or 1 (object); gp is the
// warpgroup's compact partial of the bias and small-head gradients, at the
// offsets of `gt`. VOX: the input gradient goes to the d_vox rows and the
// per-ray code sums (vox_input_grad); classical: the object branch's code
// columns to the 16-row group sums.
template <int N, bool VOX, class C>
__device__ __forceinline__ void branch_backward(int branch, const BranchTab& t,
                                                const BranchTab& gt, const SweepIn& in,
                                                const VoxCols& vc, const BranchWs o,
                                                const SwWg& w, float* gp, bool first,
                                                FwdPipe<C>& p, FwdRegs& regs) {
  constexpr int L = N / 2, ND = N / 2;
  const int lane = threadIdx.x & 31;
  const int r0 = acc_row0(), c0 = acc_col0();
  const int depth = t.v[T_DEPTH], ld = in.ld;
  uint32_t (&h)[N / 4] = *reinterpret_cast<uint32_t(*)[N / 4]>(&regs.h);
  float (&acc)[L] = *reinterpret_cast<float(*)[L]>(&regs.acc);
  const int nr = in.S >= 64 ? 1 : 64 / in.S, rows = in.S >= 64 ? 64 : in.S;
  const long long ray0 = w.g0 / in.S;
  float gsig[2];  // rbf(g_sigma) of this thread's two rows
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const long long gr = w.g0 + r0 + 8 * u;
    gsig[u] = r0 + 8 * u < w.real ? rbf(in.g[gr * 8 + branch * 4]) : 0.f;
  }

  // ---- forward recompute ---------------------------------------------------------
  wg_dir_bias(in, t, ND, w);
  for (int i = 0; i <= depth; ++i) {  // the trunk, then `final`
    const bool fin = i == depth;
#pragma unroll
    for (int r = 0; r < L; ++r) acc[r] = 0.f;
    if (i == 0 || (!fin && ((t.v[T_SKIPS] >> i) & 1))) x_product<C, VOX, N, L>(acc, w, ld, in.x0, p);
    if (i > 0) fwd_gemm_rs<C, N, L>(acc, h, p);
    const float* bl = in.b + (fin ? t.v[T_FINB] : t.v[T_TB + i]);
#pragma unroll
    for (int g = 0; g < N / 8; ++g) {
      const float b0 = __ldg(bl + 8 * g + c0), b1 = __ldg(bl + 8 * g + c0 + 1);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float v0 = acc[4 * g + 2 * u] + b0, v1 = acc[4 * g + 2 * u + 1] + b1;
        if (!fin) {
          v0 = lrelu(v0);
          v1 = lrelu(v1);
        }
        h[2 * g + u] = pack_bf16(v0, v1);
      }
    }
    // into the workspace through the warp's rows of the d_pre tile (free in
    // the forward): stmatrix, then whole 128-byte pieces of each row
    __syncwarp();  // the warp's previous copy is done reading them
#pragma unroll
    for (int n2 = 0; n2 < N / 16; ++n2)
      store_pairs(w.gs, 2 * n2, *reinterpret_cast<const uint32_t(*)[4]>(&h[4 * n2]));
    warp_rows_store(w, w.gg, ld, fin ? o.fin : o.act + i * N, N);
  }
  wg_bar(w.bar);  // the direction biases are in
  {
    // the direction layer from the per-ray biases; its rounded activation
    // into the d_pre tile's columns [128, 128 + ND), and the rgb head
    float (&accd)[ND / 2] = *reinterpret_cast<float(*)[ND / 2]>(&regs.acc);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float* dr = w.db + ((r0 + 8 * u) / rows) * ND;
#pragma unroll
      for (int n8 = 0; n8 < ND / 8; ++n8) {
        accd[4 * n8 + 2 * u] = dr[8 * n8 + c0];
        accd[4 * n8 + 2 * u + 1] = dr[8 * n8 + c0 + 1];
      }
    }
    fwd_gemm_rs<C, N, ND / 2>(accd, h, p);
    const bf16* wrgb = in.w + t.v[T_RGBW];
    float q[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
    __syncwarp();  // the warp's copy of `final` is done reading its rows
#pragma unroll
    for (int n2 = 0; n2 < ND / 16; ++n2) {
      uint32_t dp[4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int n8 = 2 * n2 + hh, c = 8 * n8 + c0;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          dp[2 * hh + u] = pack_bf16(lrelu(accd[4 * n8 + 2 * u]), lrelu(accd[4 * n8 + 2 * u + 1]));
          const __nv_bfloat162 dv = *reinterpret_cast<const __nv_bfloat162*>(&dp[2 * hh + u]);
          const float d0 = __low2float(dv), d1 = __high2float(dv);
#pragma unroll
          for (int k = 0; k < 3; ++k)
            q[u][k] += d0 * __bfloat162float(wrgb[k * ND + c]) +
                       d1 * __bfloat162float(wrgb[k * ND + c + 1]);
        }
      }
      store_pairs(w.gs, 16 + 2 * n2, dp);
    }
    const float* br = in.b + t.v[T_RGBB];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const long long gr = w.g0 + r0 + 8 * u;
      const bool real = r0 + 8 * u < w.real;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float v = q[u][k];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const float o_ = 1.f / (1.f + expf(-(v + __ldg(br + k))));
        const float gk = real ? in.g[gr * 8 + branch * 4 + 1 + k] : 0.f;
        if ((lane & 3) == 0) w.dpr[(r0 + 8 * u) * 3 + k] = gk * o_ * (1.f - o_);
      }
    }
  }
  wg_bar(w.bar);  // the rgb head's d_pre and the direction activation are in

  // ---- rgb head, then the direction layer's d_pre into G[:, 0:ND] ------------------
  auto denc = [&](int r, int k) {
    return __bfloat162float(*reinterpret_cast<const bf16*>(w.gg + swz(r, 128 + k)));
  };
  {
    if (w.t < 3) {
      float a = 0.f;
      for (int r = 0; r < 64; ++r) a += w.dpr[r * 3 + w.t];
      float* pb = gp + gt.v[T_RGBB] + w.t;
      *pb = (first ? 0.f : *pb) + a;
    }
    if (w.t < 64) {  // sigma head's bias: rows summed in warps 0 and 1
      float a = w.t < w.real ? in.g[(w.g0 + w.t) * 8 + branch * 4] : 0.f;
      a = warp_sum(a);
      if ((w.t & 31) == 0) w.col[w.t >> 5] = a;  // free until the reverse sweep
    }
    // per column k of the direction layer, one pass over the rows: the rgb
    // head's weight gradient (denc^T rbf(d_pre_rgb)), the direction layer's
    // d_pre -> G (bf16), its column sums, and the sums over each ray's rows
    // of the rounded values (for the direction weights)
    const bf16* wr_ = in.w + t.v[T_RGBW];
    float* gwr = gp + gt.v[T_RGBW];
    for (int k = w.t; k < ND; k += 128) {
      const float w0 = __bfloat162float(wr_[k]), w1 = __bfloat162float(wr_[ND + k]),
                  w2 = __bfloat162float(wr_[2 * ND + k]);
      float colsum = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f;
      for (int lr = 0; lr < nr; ++lr) {
        float raysum = 0.f;
#pragma unroll 4
        for (int r = lr * rows; r < (lr + 1) * rows; ++r) {
          const float p0 = rbf(w.dpr[r * 3]), p1 = rbf(w.dpr[r * 3 + 1]),
                      p2 = rbf(w.dpr[r * 3 + 2]);
          const float x = denc(r, k);
          a0 += x * p0;
          a1 += x * p1;
          a2 += x * p2;
          float d = p0 * w0 + p1 * w1 + p2 * w2;
          if (!(x >= 0.f)) d *= LEAKY;
          const bf16 dr = __float2bfloat16(d);
          *reinterpret_cast<bf16*>(w.gg + swz(r, k)) = dr;
          colsum += d;
          raysum += __bfloat162float(dr);
        }
        w.db[lr * ND + k] = raysum;  // the direction bias is spent
      }
      gwr[k] = (first ? 0.f : gwr[k]) + a0;
      gwr[ND + k] = (first ? 0.f : gwr[ND + k]) + a1;
      gwr[2 * ND + k] = (first ? 0.f : gwr[2 * ND + k]) + a2;
      float* pb = gp + gt.v[T_DIRB] + k;
      *pb = (first ? 0.f : *pb) + colsum;
    }
  }
  // the rays' direction encodings, rounded, staged for the direction weights
  float* dirs = w.col + 8;  // the column sums' buffer is free here
  for (int e = w.t; e < nr * MAX_DIR; e += 128) {
    const int lr = e / MAX_DIR, c = e % MAX_DIR;
    dirs[e] = c < in.c_dir && ray0 + lr < in.n_rays
                  ? rbf(in.dir_pe[(ray0 + lr) * in.c_dir + c]) : 0.f;
  }
  wg_bar(w.bar);
  if (w.t == 0) {
    float* pb = gp + gt.v[T_SIGB];
    *pb = (first ? 0.f : *pb) + (w.col[0] + w.col[1]);
  }
  dir_weight_grad<ND>(gp + gt.v[T_DIRWD], dirs, w.db, nr, w.t, first);
  tile_store(w, w.gg, ld, o.gdir, ND);
  fence_proxy_async();  // G[:, 0:ND] is complete for the product's reads
  wg_bar(w.bar);

  // ---- `final` and the sigma head ------------------------------------------------------
  const bf16* wsig = in.w + t.v[T_SIGW];
  load_pairs<N>(h, w.ws + o.act + (depth - 1) * N, ld);  // the last trunk activation
#pragma unroll
  for (int r = 0; r < L; ++r) acc[r] = 0.f;
  bwd_gemm<C, ND, L>(acc, w.gs, p);
  dpre_epilogue<N, false, false>(acc, regs.h, gsig, wsig, w, ld, o.gfin, gp + gt.v[T_FINB],
                                 first);
#pragma unroll
  for (int r = 0; r < L; ++r) acc[r] = 0.f;
  bwd_gemm<C, N, L>(acc, w.gs, p);
  // the sigma head's weight: column sums of act_last rbf(g_sigma)
  wg_bar(w.bar);  // the column sums' buffer is read
#pragma unroll
  for (int g = 0; g < N / 8; ++g)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&h[2 * g + u]);
        s += (e ? __high2float(a) : __low2float(a)) * gsig[u];
      }
      put_colsum(s, w.col, N, 8 * g + c0 + e);
    }
  sum_colsum<N>(w, gp + gt.v[T_SIGW], first);

  // ---- trunk, last layer first ----------------------------------------------------------
  // Entering step i: `acc` holds d_h of layer i (before the sigma head's
  // part for the last layer) and h layer i's rounded activation.
  bool first_code = true;
  for (int i = depth - 1; i >= 0; --i) {
    if (i == depth - 1)
      dpre_epilogue<N, true, true>(acc, regs.h, gsig, wsig, w, ld, o.g + i * N,
                                   gp + gt.v[T_TB + i], first);
    else
      dpre_epilogue<N, true, false>(acc, regs.h, gsig, wsig, w, ld, o.g + i * N,
                                    gp + gt.v[T_TB + i], first);
    const bool skip = i > 0 && ((t.v[T_SKIPS] >> i) & 1);
    if (i == 0 || skip) {
      if constexpr (VOX) {  // input gradient of both branches: voxel and code columns
        vox_input_grad<C, N>(branch, in, vc, w, first_code, p, regs);
        first_code = false;
      } else if (branch == 1) {  // input gradient, for the code columns
        float (&a)[XCOLS / 2] = *reinterpret_cast<float(*)[XCOLS / 2]>(&regs.acc);
#pragma unroll
        for (int r = 0; r < XCOLS / 2; ++r) a[r] = 0.f;
        bwd_gemm<C, N, XCOLS / 2>(a, w.gs, p);
        // summed over each 16-row group (one warp's rows)
        float* P = w.P + ((threadIdx.x >> 5) & 3) * XCOLS;
#pragma unroll
        for (int g = 0; g < XCOLS / 8; ++g)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float cs = a[4 * g + e] + a[4 * g + 2 + e];
            cs += __shfl_xor_sync(0xffffffffu, cs, 4);
            cs += __shfl_xor_sync(0xffffffffu, cs, 8);
            cs += __shfl_xor_sync(0xffffffffu, cs, 16);
            float* pp = P + 8 * g + c0 + e;
            if (lane < 4) *pp = first_code ? cs : *pp + cs;
          }
        first_code = false;
      }
      if (i == 0) break;
    }
    load_pairs<N>(h, w.ws + o.act + (i - 1) * N, ld);  // layer i - 1's activation
#pragma unroll
    for (int r = 0; r < L; ++r) acc[r] = 0.f;
    // the hidden rows of layer i: after the input rows for a skip layer
    bwd_gemm<C, N, L>(acc, w.gs, p);
  }
}

// The tile sweep of the backward: a persistent grid (one block per SM, each
// walking tiles blockIdx.x, blockIdx.x + gridDim.x, ...), the producer
// warpgroup streaming the chunk order `chunks` of every tile through the
// ring, each consumer warpgroup sweeping its 64 rows of the tile. `ws` is the
// workspace (rows of all tiles, wt.v[W_COLS] bf16 columns each); `small`
// holds small_stride floats per warpgroup (block b's at 2 b and 2 b + 1): its
// bias and small-head gradients at the offsets of gscene / gobj.
template <bool VOX>
__global__ void __launch_bounds__(SW_THREADS, 1)
mlp_bwd_kernel(const __grid_constant__ SweepPlan plan, const unsigned* __restrict__ chunks,
               int n_chunks, const float* __restrict__ xyz, const float* __restrict__ dir_pe,
               const float* __restrict__ codes, const float* __restrict__ vox, VoxDims vd,
               const float* __restrict__ g, const bf16* __restrict__ w,
               const float* __restrict__ b, BranchTab scene, BranchTab obj, BranchTab gscene,
               BranchTab gobj, WsTab wt, bf16* __restrict__ ws, float* __restrict__ small,
               int small_stride, float* __restrict__ d_codes, float* __restrict__ d_vox,
               int n_rays, int S, int n_freq, int c_dir, int code_len, int forward_instance) {
  using C = SweepCfg<VOX>;
  extern __shared__ __align__(1024) unsigned char sw_smem[];
  const uint32_t raw = smem_u32(sw_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle needs 1 KB alignment
  unsigned char* sm = sw_smem + (base - raw);
  const uint32_t full = base + C::BAR, empty = full + 8 * C::STAGES;
  int* ct = reinterpret_cast<int*>(sm + C::CT);
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (VOX)
    for (int c = threadIdx.x; c < XCOLS_V; c += SW_THREADS)
      ct[c] = vox_item(c, vd, n_freq, forward_instance != 0, code_len);
  __syncthreads();
  const int R = ROWS / S;
  const int n_tiles = (n_rays + R - 1) / R;

  if (threadIdx.x < 128) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    sweep_produce<C>(plan, chunks, n_chunks, n_tiles, base + C::RING, full, empty);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int wg = (threadIdx.x >> 7) - 1;
  SwWg wk;
  wk.t = threadIdx.x & 127;
  wk.bar = 1 + wg;
  wk.xs = base + C::X + wg * SW_XT;
  wk.gs = base + C::G + wg * SW_GT;
  wk.xg = sm + C::X + wg * SW_XT;
  wk.gg = sm + C::G + wg * SW_GT;
  // voxel: the column sums in the input tile, spent in the reverse sweep
  wk.col = VOX ? reinterpret_cast<float*>(wk.xg)
               : reinterpret_cast<float*>(sm + C::COL) + wg * C::NCOL;
  wk.dpr = reinterpret_cast<float*>(sm + C::DPR) + wg * C::NDPR;
  wk.db = reinterpret_cast<float*>(sm + C::DB) + wg * C::NDB;
  wk.P = reinterpret_cast<float*>(sm + C::P) + wg * C::NP;
  wk.dv = reinterpret_cast<float*>(sm + C::DV) + wg * C::NDV;
  SweepIn in{xyz, dir_pe, codes, vox, g, w, b, ct, vd, n_rays, S, n_freq, c_dir, code_len,
             wt.v[W_COLS], wt.v[W_X]};
  const int pe = 3 * (2 * n_freq + 1);
  VoxCols vc;
  vc.o_ivox = vd.c_s * (1 + 2 * vd.n_fv) + pe;
  vc.o_code = vc.o_ivox + vd.c_i * (1 + 2 * vd.n_fv);
  const BranchWs o_scene = branch_ws(wt, 0), o_obj = branch_ws(wt, 1);
  const int cv = vd.c_s + vd.c_i;
  float* gp = small + (size_t)(2 * blockIdx.x + wg) * small_stride;
  FwdPipe<C> p{base + C::RING, full, empty, 0, 0};
  FwdRegs regs;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    wk.g0 = (long long)tile * ROWS + 64 * wg;
    wk.real = (int)max(0LL, min(64LL, (long long)n_rays * S - wk.g0));
    wk.ws = ws + (size_t)wk.g0 * in.ld;
    wg_bar(wk.bar);  // the warpgroup's previous tile is done with its buffers
    if (VOX) {
      build_vox(in, wk, wt.v[W_XC], forward_instance != 0);
      for (int e = wk.t; e < 64 * cv; e += 128) wk.dv[(e / cv) * MAX_VOX + e % cv] = 0.f;
    } else {
      build_classical(in, wk, wt.v[W_XC], forward_instance != 0);
    }
    branch_backward<WS, VOX, C>(0, scene, gscene, in, vc, o_scene, wk, gp, first, p, regs);
    if (forward_instance) {
      branch_backward<WO, VOX, C>(1, obj, gobj, in, vc, o_obj, wk, gp, first, p, regs);
      // d_codes[ray] = the code columns of the input gradient, summed over the
      // ray's rows (in 16-row groups in order, or per ray and warpgroup): the
      // other warpgroup's sums too. The ring keeps the warpgroups within
      // C::STAGES chunks of each other, far less than a tile's before the
      // next write of the sums.
      asm volatile("bar.sync 3, 256;" ::: "memory");
      const float* P = reinterpret_cast<const float*>(sm + C::P);
      const int gpr = S / 16;
      for (int e = threadIdx.x - 128; e < R * code_len; e += 256) {
        const int rho = e / code_len, c = e % code_len;
        const int ray = tile * R + rho;
        if (ray >= n_rays) continue;
        float acc = 0.f;
        for (int q = rho * gpr; q < (rho + 1) * gpr; ++q) acc += P[q * XCOLS + (VOX ? 0 : pe) + c];
        d_codes[(size_t)ray * code_len + c] = acc;
      }
    }
    if (VOX) {  // each row of d_vox written once
      wg_bar(wk.bar);  // every thread's sums are in
      for (int e = wk.t; e < 64 * cv; e += 128) {
        const int r = e / cv, ch = e % cv;
        if (r < wk.real) d_vox[(wk.g0 + r) * cv + ch] = wk.dv[r * MAX_VOX + ch];
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
                   const int* wmap_tab, const unsigned* chunks, int n_chunks, void* ws,
                   int ws_rows, float* small, int small_stride, const int* items, int n_items,
                   float* parts, const int* segs, int n_segs, float* grads, float* d_codes,
                   float* d_vox, int n_blocks, int n_rays, int S, int n_freq, int c_dir,
                   int code_len, int forward_instance, void* stream) {
  using C = SweepCfg<VOX>;
  const cudaStream_t st = (cudaStream_t)stream;
  const WsTab wt = to_ws(ws_tab);
  // the products' input widths are compiled in; a warpgroup's 64 rows hold
  // whole rays or whole halves of one (S in {32, 64, 128})
  if (scene_tab[T_K0] != branch_k0<VOX, WS>() ||
      (forward_instance && (obj_tab == nullptr || obj_tab[T_K0] != branch_k0<VOX, WO>())) ||
      S < 32 || ROWS % S != 0 || n_chunks <= 0 || chunks == nullptr ||
      (VOX && vd.c_s + vd.c_i > MAX_VOX))
    return (int)cudaErrorInvalidValue;
  SweepPlan plan;
  cudaError_t e = (cudaError_t)encode_sweep_maps(w, wmap_tab, &plan.maps, FWD_STAGE);
  if (e != cudaSuccess) return (int)e;
  for (int i = 0; i < WM_LEN; ++i) plan.cols[i] = (unsigned short)wmap_tab[3 * i + 2];
  e = cudaFuncSetAttribute(mlp_bwd_kernel<VOX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::BYTES);
  if (e != cudaSuccess) return (int)e;
  mlp_bwd_kernel<VOX><<<n_blocks, SW_THREADS, C::BYTES, st>>>(
      plan, chunks, n_chunks, xyz, dir_pe, codes, vox, vd, g, static_cast<const bf16*>(w), b,
      to_tab(scene_tab), to_tab(obj_tab), to_tab(gscene_tab), to_tab(gobj_tab), wt,
      static_cast<bf16*>(ws), small, small_stride, d_codes, d_vox, n_rays, S, n_freq, c_dir,
      code_len, forward_instance);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = (cudaError_t)launch_wgrad(ws, ws_rows, wt.v[W_COLS], items, n_items, parts, st);
  if (e != cudaSuccess) return (int)e;
  reduce_segments_kernel<<<dim3(32, n_segs), 256, 0, st>>>(parts, segs, grads);
  return (int)cudaGetLastError();
}

}  // namespace

// the forward, launched by onerf_fwd_chain (fused_mlp.cu)
FWD_CHAIN_INSTANCE(false, FWD_EVAL);
FWD_CHAIN_INSTANCE(true, FWD_EVAL);

extern "C" {

// Every launcher returns cudaGetLastError() after the launch (0 on success).

// The backward in three launches (fused_mlp_bwd in fused_mlp_vjp.py builds
// every table): the sweep on n_blocks blocks, reading the weights through
// the tensor maps of wmap_tab (WM_LEN x 3 ints) in the chunk order `chunks`
// (n_chunks per tile, device memory; sweep_chunks), writing the workspace
// `ws` (ws_rows rows, ws_tab's layout) and each warpgroup's small partial
// (`small`, small_stride floats per warpgroup, two per block, at the offsets
// of gscene_tab / gobj_tab); the weight-gradient GEMM, one block per item of
// `items` (n_items x 8 ints), writing its partial into `parts`; the
// reduction of the segments of `segs` (n_segs x 5 ints) from `parts` (which
// holds `small` too) into `grads` (the packed weight layout, then the
// biases). d_codes (n_rays, code_len); d_vox (n_rays * S, c_svox + c_ivox)
// when `vox` is given.
int onerf_mlp_bwd(const float* xyz, const float* dir_pe, const float* codes,
                  const float* vox, const float* g, const void* w, const float* b,
                  const int* scene_tab, const int* obj_tab, const int* gscene_tab,
                  const int* gobj_tab, const int* ws_tab, const int* wmap_tab,
                  const unsigned* chunks, int n_chunks, void* ws, int ws_rows, float* small,
                  int small_stride, const int* items, int n_items, float* parts,
                  const int* segs, int n_segs, float* grads, float* d_codes, float* d_vox,
                  int n_blocks, int n_rays, int S, int n_freq, int c_dir, int code_len,
                  int forward_instance, int c_svox, int c_ivox, int n_freq_vox,
                  void* stream) {
  const VoxDims vd = {c_svox, c_ivox, n_freq_vox};
  if (vox != nullptr)
    return launch_mlp_bwd<true>(xyz, dir_pe, codes, vox, vd, g, w, b, scene_tab, obj_tab,
                                gscene_tab, gobj_tab, ws_tab, wmap_tab, chunks, n_chunks, ws,
                                ws_rows, small, small_stride, items, n_items, parts, segs,
                                n_segs, grads, d_codes, d_vox, n_blocks, n_rays, S, n_freq,
                                c_dir, code_len, forward_instance, stream);
  return launch_mlp_bwd<false>(xyz, dir_pe, codes, vox, vd, g, w, b, scene_tab, obj_tab,
                               gscene_tab, gobj_tab, ws_tab, wmap_tab, chunks, n_chunks, ws,
                               ws_rows, small, small_stride, items, n_items, parts, segs,
                               n_segs, grads, d_codes, d_vox, n_blocks, n_rays, S, n_freq,
                               c_dir, code_len, forward_instance, stream);
}

// The sweep's layout (SweepCfg) in mlp_bwd_kernel<vox>: its weight-ring
// stages (FWD_STAGE bytes each) and its dynamic shared memory.
int onerf_bwd_sweep_layout(int vox, int* stages, int* smem_bytes) {
  *stages = vox ? SweepCfg<true>::STAGES : SweepCfg<false>::STAGES;
  *smem_bytes = vox ? SweepCfg<true>::BYTES : SweepCfg<false>::BYTES;
  return 0;
}

// The weight-gradient kernel alone (fused_mlp_bwd's second launch): for each
// of the n_items items (8 ints each) its f32 partial act^T @ d_pre over its
// rows of the (rows, cols) bf16 workspace `ws`, into `parts`.
int onerf_wgrad(const void* ws, int rows, int cols, const int* items, int n_items,
                float* parts, void* stream) {
  return launch_wgrad(ws, rows, cols, items, n_items, parts, (cudaStream_t)stream);
}

}  // extern "C"
