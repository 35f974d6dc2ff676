// Hopper building blocks of the port's fused MLP kernels, and the forward
// chain that fused_mlp_eval, fused_render_tiles, fused_coarse_weights and
// fused_sigma_eval share: one entry point, onerf_fwd_chain (fused_mlp.cu),
// launches each of its modes, and object_nerf_torch/ops/fwd_chain.py builds
// its arguments and tables.
//
// The building blocks (the backward's sweep and weight-gradient kernel use
// them too): the TMA tensor maps of the packed weight matrices, mbarriers,
// shared-memory descriptors of wgmma operands in the 128-byte swizzle, and
// the wgmma instructions. pe_probe (probes.cu) runs on the chain's own parts
// as well: its plan (fwd_plan), producer (fwd_produce), ring (FwdPipe),
// products from shared memory (fwd_gemm) and stmatrix stores.
//
// The forward chain, in five modes (FWD_*, below). fused_mlp_eval and
// fused_render_tiles compute, per sample row, both MLP branches (trunk,
// sigma head, `final`, view-direction layer, sigmoid rgb head) on the bf16
// tensor cores; fused_render_tiles then composites the rows of each ray.
// fused_coarse_weights computes the scene trunk and sigma head, then the
// pdf weights of each ray; fused_sigma_eval one branch's trunk and sigma
// head per point. What bounds them is the tensor cores (0.49-0.70 M
// multiply-adds per row against 12 bytes of xyz). The design:
// * A persistent grid: one block per SM walks 128-row tiles blockIdx.x,
//   blockIdx.x + gridDim.x, ... (whole rays: S in {32, 64, 128}; in the
//   point-wise modes consecutive points).
// * Warp-specialised: warpgroup 0 is the producer. Lane 0 of up to four of
//   its warps (chunks in turn: one thread alone issued too slowly) streams
//   the weights by TMA through a ring of 16 KB stages (full / empty mbarrier
//   per stage) in a fixed chunk order that does not depend on the data
//   (fwd_chain.forward_chunks builds it: per branch, layer 0, the trunk
//   with each skip layer's input rows and hidden rows, then, unless the mode
//   stops at the sigma head, `final` and the direction layer), so it runs
//   ahead across layers, branches and tiles. A chunk is 32 K rows of a
//   256-column matrix, 64 of a 128-column one, 128 of the object's 64-column
//   direction layer. The ring takes what shared memory leaves beside the
//   input tiles, the render's row buffers and the direction biases (FwdCfg):
//   classical 11 stages (eval, render), 12 (coarse weights), 13 (scene
//   density), 12 (object density); voxel, beside its 448-column input tile,
//   6, 8, 9 and 7. A measured trade: 8 KB chunks ran slower, and waiting
//   with a deeper wait_group did not help.
//   Warpgroups 1 and 2 consume the same chunks, each for its own 64 rows of
//   the tile, with its own input tile X; they meet only at the ring's
//   barriers (a stage is refilled when the 8 consumer warps have released
//   it) and, in the render, at the tile's compositing. Inside a warpgroup,
//   named barriers (bar.sync id, 128) around the input build alone; nothing
//   in the layer loop is a barrier. setmaxnreg gives the consumers 232
//   registers.
// * Products: wgmma m64nNk16 with N the layer's whole width (256 scene, 128
//   object and scene direction layer, 64 object direction layer), B (a chunk
//   of the packed (K, N) row-major weights, N / 64 boxes of 64 columns)
//   MN-major in the 128-byte swizzle from shared memory. A is the input tile
//   X (K-major, the same swizzle, from shared memory) for layer 0 and the
//   input rows of a skip layer, and the previous layer's output, from
//   registers, for every other product: the accumulators of an m64nN
//   product, rounded to bf16 pairs, are the A fragments of the next
//   product's K steps as they stand (fwd_gemm_rs). A chunk's K steps are
//   committed as one group and the consumer waits with wait_group 1, so the
//   next chunk queues behind the current one; the chunk before is released
//   then. Each product is unrolled: no loop carries a wgmma in flight (ptxas
//   serialized that).
// * Epilogues in registers: the layer's bias and LeakyReLU in f32, then bf16
//   pairs packed into the warpgroup's activation registers, which the next
//   product reads. The sigma head (after the last trunk layer) and the
//   sigmoid rgb head (after the direction layer, whose accumulators start
//   from the per-ray biases) are dot products over each thread's accumulator
//   columns, reduced over the four lanes of a row by shuffles. No activation
//   reaches shared memory.
// * The input tile is built per warpgroup before its first product: each
//   thread prefetches its row's xyz, raw voxel features and code into L1,
//   stages the rays' direction encodings (with the heads), the direction
//   biases are 32-term dot products with all loads issued first, and each
//   (value, octave) pair's sine and cosine come from one full-precision
//   sincosf. Classical: 128 columns [PE(xyz) | code | 0]; voxel: 448
//   columns [svox | PE(svox) | xyz | PE(xyz) | ivox | PE(ivox) | code | 0];
//   the scene-only modes stop at the scene's 64 / 320 columns.
// * The compositing (render, coarse weights): one warp per (ray, branch),
//   by the second consumer warpgroup once the first has signalled (an
//   mbarrier per tile parity) that its rows are written; the row buffers
//   alternate by tile parity, and the ring keeps the first warpgroup less
//   than a tile ahead.
// Rows past the launch's end are zero on input and never stored.
//
// Numerics as the plain versions: bf16 operands, f32 sums; bias, LeakyReLU,
// sigmoid, the encoding and the compositing in f32.

#pragma once

#include "fused_mlp_common.cuh"

#include <cuda.h>  // CUtensorMap and the types of cuTensorMapEncodeTiled

namespace {

// The weight matrices the sweep multiplies by, as TMA tensor maps
// (sweep_weight_maps in fwd_chain.py gives each one's element offset in
// the packed weights, rows and columns): per branch, trunk layer i at slot
// i, `final` at WM_FIN, the direction layer's hidden part at WM_DIR; each a
// row-major bf16 view read in boxes of 64 columns in the 128-byte swizzle,
// as many rows as make a row of boxes across the matrix one ring stage
// (FWD_STAGE bytes: 32 rows of a 256-column matrix, 64 of a 128-column one).
enum { WM_FIN = 8, WM_DIR = 9, WM_PER_BRANCH = 10, WM_LEN = 2 * WM_PER_BRANCH };
struct SweepMaps {
  CUtensorMap m[WM_LEN];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory without passing through
// registers: a thread issues all its copies of a tile before it waits for
// any, so a tile costs one round trip to L2, not one per copy.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// this thread's generic shared-memory accesses are ordered before those of
// the async proxy (wgmma's reads, TMA's writes)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait for the phase of `parity` to complete. A wait that outlasts 2^26
// polls (seconds, where a stage takes microseconds) traps: a protocol fault
// ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0, polls = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++polls == (1u << 26)) __trap();
  }
}

// a (64 rows, 64 columns) box at column c0, row c1 of the tensor map
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Shared-memory descriptors of a bf16 wgmma operand in the 128-byte swizzle
// (the layout TMA's CU_TENSOR_MAP_SWIZZLE_128B writes, and the sweep's
// staging below): 128-byte rows, XOR-swizzled in groups of 8 rows that lie
// 1024 bytes apart; the start address 1024-byte aligned but for the offset
// of a K step inside a row.
// MN-major (64 values along M or N per row, one row per K): each instruction
// reads one 64-wide block, so only the 8-row-group stride is used; it goes
// into both byte-offset fields (bits 16-29 and 32-45).
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// K-major (64 values along K per row, one row per N): the 8-row groups along
// N lie 1024 bytes apart (stride field); the leading field is unused.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

template <int L>
__device__ __forceinline__ void fence_acc(float (&d)[L]) {
#pragma unroll
  for (int r = 0; r < L; ++r) asm volatile("" : "+f"(d[r])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

#define WG_ACC32(d)                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define WG_REGS32                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] += A^T B on one warpgroup: A (16 K rows x 64 M) and B (16 K
// rows x 64 N) both MN-major in shared memory (transpose bits set)
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
               ", %32, %33, p, 1, 1, 1, 1;\n}\n"
               : WG_ACC32(d)
               : "l"(da), "l"(db), "r"(1));
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the driver, fetched through the runtime, so the
// library links against nothing but the CUDA runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// The sweep's weight maps over the packed weights `w`: `tab` holds WM_LEN
// (element offset, rows, columns) triples, rows 0 for a slot no matrix
// takes (its map stays zero and is never read); boxes of 64 columns x as
// many rows as make a row of boxes across the matrix `row_bytes` bytes.
int encode_sweep_maps(const void* w, const int* tab, SweepMaps* maps, int row_bytes) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  memset(maps, 0, sizeof(*maps));
  for (int i = 0; i < WM_LEN; ++i) {
    const int off = tab[3 * i], rows = tab[3 * i + 1], cols = tab[3 * i + 2];
    if (rows == 0) continue;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
    const int box_rows = row_bytes / 2 / cols;
    const cuuint32_t box[2] = {64, (cuuint32_t)box_rows}, unit[2] = {1, 1};
    if (encode(&maps->m[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
               const_cast<bf16*>(static_cast<const bf16*>(w)) + off, dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaSuccess;
}

// ---- the forward chain ------------------------------------------------------------

constexpr int FWD_THREADS = 384;     // warpgroup 0 the producer, 1 and 2 the consumers
constexpr int FWD_MAX_CHUNKS = 320;  // weight chunks per tile (both branches)
constexpr int FWD_STAGE = 16384;      // bytes of one chunk, one stage of the weight ring
constexpr int FWD_ROWBUF = 9 * ROWS;  // a tile's sig, rgb, isig, irgb, z (floats)
constexpr int MAX_DIR = 32;           // direction-encoding channels at most
constexpr int FWD_DB = 2 * (WS / 2 + WO / 2);  // a warpgroup's direction biases (<= 2 rays)

// The chain's modes, what one launch computes:
// * FWD_EVAL (fused_mlp_eval): both branches with their heads, per row
//   [sigma, rgb, sigma_inst, rgb_inst];
// * FWD_RENDER (fused_render_tiles): the same, composited per ray into maps;
// * FWD_WEIGHTS (fused_coarse_weights): the scene trunk and sigma head, then
//   the per-ray scan into the pdf weights; no direction input, no maps;
// * FWD_SIGMA_SCENE, FWD_SIGMA_OBJ (fused_sigma_eval): one branch's trunk and
//   sigma head, the raw density of each point. Rows are points, not whole
//   rays: a "ray" of this mode is a run of S points that share a code.
enum { FWD_EVAL = 0, FWD_RENDER = 1, FWD_WEIGHTS = 2, FWD_SIGMA_SCENE = 3, FWD_SIGMA_OBJ = 4 };

// The producer's work: the weight maps of both branches (slots as
// SweepMaps; a map of C columns is read in boxes of 64 columns x
// FWD_STAGE / (2 C) rows, so that a row of boxes, one chunk, is FWD_STAGE
// bytes) and the chunk order of one tile, each chunk `slot | row / 16 << 5`:
// rows [row, row + FWD_STAGE / (2 C)) of the map.
struct FwdPlan {
  SweepMaps maps;
  unsigned short cols[WM_LEN];  // the maps' columns
  int n_chunks;
  unsigned short chunk[FWD_MAX_CHUNKS];
};

}  // namespace

// The inputs and outputs of one launch, filled by the host (fwd_chain.FwdArgs
// mirrors it field by field): `out` (n_rays * S, 8) rows for FWD_EVAL and
// (n_rays * S,) densities for the point-wise modes; `maps` (n_rays, 16) and
// `weights` (n_rays, S) or null for FWD_RENDER; `weights` for FWD_WEIGHTS.
// In the point-wise modes a "ray" is a run of S points that share a code.
// Outside the unnamed namespace: onerf_fwd_chain (fused_mlp.cu) passes it to
// the launches that the other sources compile.
struct FwdArgs {
  const float *xyz, *z, *dir_pe, *codes, *vox;
  const bf16* w;
  const float* b;
  float *out, *maps, *weights;
  VoxDims vd;
  int n_rays, S, n_freq, c_dir, code_len, forward_instance, compute_scene, last_delta_inf;
};

namespace {

// Per model and mode: STAGES stages of FWD_STAGE bytes, as many as shared
// memory holds beside what the instantiation keeps there; XKB 64-column
// blocks of the input tile (the columns the launch's branches read: the
// scene branch's alone in the scene-only modes). The activations live in
// registers, so a mode holds only its two input tiles, the row buffers of
// the modes that composite, and with the heads the direction biases and the
// staged direction encodings: classical 11 stages (EVAL, RENDER), 12
// (WEIGHTS), 13 (SIGMA_SCENE), 12 (SIGMA_OBJ); voxel 6, 6, 8, 9, 7. The
// depth follows from the model and the mode alone, at compile time.
template <bool VOX, int MODE>
struct FwdCfg {
  // both heads (and the direction layer), or the sigma head alone
  static constexpr bool HEADS = MODE == FWD_EVAL || MODE == FWD_RENDER;
  // input columns of the scene and the object branch (input_tile_columns in
  // fwd_chain.py)
  static constexpr int K0S = VOX ? 320 : 64, K0O = VOX ? 448 : 128;
  static constexpr int XKB = (MODE == FWD_WEIGHTS || MODE == FWD_SIGMA_SCENE ? K0S : K0O) / 64;
  static constexpr int STAGE = FWD_STAGE;
  // floats of a tile parity's row buffer (the modes that composite; the
  // others store from registers), of a warpgroup's direction biases and of
  // its staged direction encodings (two rays of MAX_DIR)
  static constexpr int NROW = MODE == FWD_RENDER || MODE == FWD_WEIGHTS ? FWD_ROWBUF : 0;
  static constexpr int NDB = HEADS ? FWD_DB : 0;
  static constexpr int NDIR = HEADS ? 2 * MAX_DIR : 0;
  // as many stages as shared memory holds beside the tiles, the row buffers,
  // the direction biases and encodings, the two rows barriers and the
  // alignment slack
  static constexpr int STAGES =
      (232448 - 2 * XKB * 8192 - 2 * NROW * 4 - 2 * NDB * 4 - 2 * NDIR * 4 - 16 - 1024) /
      (FWD_STAGE + 16);
  // dynamic shared memory (bytes from a 1024-byte aligned base)
  static constexpr int RING = 0;
  static constexpr int X = RING + STAGES * STAGE;       // 2 warpgroups x XKB x 8 KB
  static constexpr int ROW = X + 2 * XKB * 8192;        // 2 tile parities x NROW
  static constexpr int DB = ROW + 2 * NROW * 4;         // 2 warpgroups x NDB
  static constexpr int DIR = DB + 2 * NDB * 4;          // 2 warpgroups x NDIR
  static constexpr int BAR = DIR + 2 * NDIR * 4;        // full, empty per stage; rows x 2
  static constexpr int BYTES = BAR + 8 * (2 * STAGES + 2) + 1024;  // + alignment
  // producer threads, each issuing every PRODUCERS-th chunk. A thread waits
  // for a stage's release by the parity of its phase, which also passes on
  // the phase before the previous one: so its own previous chunk, PRODUCERS
  // earlier, must have waited for that one, i.e. PRODUCERS <= STAGES.
  static constexpr int PRODUCERS = STAGES < 4 ? STAGES : 4;
  // a warpgroup still holds the stage of the chunk before when it waits for
  // the next one
  static_assert(STAGES >= 2, "the ring needs a stage beyond the one in use");
  static_assert(BYTES <= 232448, "the forward chain exceeds a block's shared memory");
  static_assert(X % 1024 == 0, "the swizzled tiles need 1024-byte alignment");
};

// the rows of a tile's row buffer
enum { RB_SIG = 0, RB_RGB = ROWS, RB_ISIG = 4 * ROWS, RB_IRGB = 5 * ROWS, RB_Z = 8 * ROWS };

// Byte offset of (row, col) in a warpgroup's K-major bf16 tile of 64 rows
// (an input tile; pe_probe's activations) in the 128-byte swizzle:
// 64-column blocks of 8 KB; row r of a block at 128 r, its 16-byte pieces
// XOR-ed with r % 8.
__device__ __forceinline__ int swz(int row, int col) {
  return (col >> 6) * 8192 + row * 128 + ((((col >> 3) & 7) ^ (row & 7)) << 4) + (col & 7) * 2;
}

__device__ __forceinline__ void wg_bar(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// MN-major B of more than 64 columns: the 64-column blocks lie `nblock`
// bytes apart (leading field), the 8-row groups of K 1024 (stride field).
__device__ __forceinline__ uint64_t desc_mn_wide(uint32_t addr, uint32_t nblock) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(nblock >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define WG_ACC8(d, o)                                                                   \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),         \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define WG_ACC64(d)                                                                     \
  WG_ACC8(d, 0), WG_ACC8(d, 8), WG_ACC8(d, 16), WG_ACC8(d, 24), WG_ACC8(d, 32),         \
      WG_ACC8(d, 40), WG_ACC8(d, 48), WG_ACC8(d, 56)
#define WG_ACC128(d)                                                                    \
  WG_ACC64(d), WG_ACC8(d, 64), WG_ACC8(d, 72), WG_ACC8(d, 80), WG_ACC8(d, 88),          \
      WG_ACC8(d, 96), WG_ACC8(d, 104), WG_ACC8(d, 112), WG_ACC8(d, 120)
#define WG_REGS64                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "    \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "    \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define WG_REGS128                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "    \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "    \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "    \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "    \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "    \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "    \
  "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "       \
  "%123, %124, %125, %126, %127}"

// d[64 x N] += A B on one warpgroup: A (64 x 16) K-major and B (16 x N)
// MN-major (TB 1) or K-major (TB 0: N rows of 16 K values, the backward's
// products by W^T), both in shared memory; N = 2 x the accumulator registers
template <int TB = 1>
__device__ __forceinline__ void wgmma_kn(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WG_REGS128
               ", %128, %129, p, 1, 1, 0, %131;\n}\n"
               : WG_ACC128(d)
               : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB = 1>
__device__ __forceinline__ void wgmma_kn(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS64
               ", %64, %65, p, 1, 1, 0, %67;\n}\n"
               : WG_ACC64(d)
               : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB = 1>
__device__ __forceinline__ void wgmma_kn(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
               ", %32, %33, p, 1, 1, 0, %35;\n}\n"
               : WG_ACC32(d)
               : "l"(da), "l"(db), "r"(1), "n"(TB));
}

// d[64 x N] += A B on one warpgroup: A (64 x 16) in registers, the bf16
// pairs a[0..3] of the wgmma A fragment (rows r, r + 8 of columns 2 c, 2 c
// + 1, then of 2 c + 8, 2 c + 9: the layout of an m64nN accumulator's two
// 8-column groups), B (16 x N) MN-major in shared memory
__device__ __forceinline__ void wgmma_rkn(float (&d)[128], const uint32_t* a, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WG_REGS128
               ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
               : WG_ACC128(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rkn(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS64
               ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
               : WG_ACC64(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rkn(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
               : WG_ACC32(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the registers stay as they are up to here: a wgmma that reads them from
// registers may still be running until its wait_group
template <int L>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[L]) {
#pragma unroll
  for (int r = 0; r < L; ++r) asm volatile("" : "+r"(a[r])::"memory");
}

// A consumer warpgroup's end of the weight ring (C: the launch's FwdCfg): the
// stage and parity of the next chunk.
template <class C>
struct FwdPipe {
  uint32_t ring, full, empty;
  int stage, phase;

  // wait for the next chunk; returns its stage's shared address
  __device__ __forceinline__ uint32_t next() {
    mbar_wait(full + 8 * stage, phase);
    __syncwarp();  // converged again for the warpgroup-wide instructions
    return ring + stage * C::STAGE;
  }
  __device__ __forceinline__ void advance() {
    if (++stage == C::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  // the warp is done with stage s (8 consumer warps release a stage)
  __device__ __forceinline__ void release(int s) {
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * s);
  }
};

// acc += A[0:64, 0:K] @ (the next K / KCH chunks of the ring), A the
// warpgroup's K-major tile at shared address `a`; N = 2 L output columns, a
// chunk KCH = FWD_STAGE / (2 N) rows of B (N / 64 boxes of KCH x 64, the
// 64-column blocks KCH x 128 bytes apart). The chunks are unrolled:
// each one's K steps are committed as a group, then wait_group 1 lets the
// chunk before it finish (its stage is released) while this one runs; the
// product ends with wait_group 0. No loop carries a product in flight, so
// ptxas keeps the wgmma pipeline (a loop-carried accumulator made it
// serialize them, C7515).
template <class C, int K, int L>
__device__ __forceinline__ void fwd_gemm(float (&acc)[L], uint32_t a, FwdPipe<C>& p) {
  constexpr int KCH = FWD_STAGE / 2 / (2 * L), NCH = K / KCH;
  static_assert(K % KCH == 0 && KCH % 16 == 0, "a product is whole chunks of whole K steps");
  int prev = 0;  // the stage of the chunk before
  fence_acc(acc);
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const uint32_t st = p.next();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KCH / 16; ++kk) {
      const int col = c * KCH + 16 * kk;
      wgmma_kn(acc, desc_k(a + (col >> 6) * 8192 + (col & 63) * 2),
               desc_mn_wide(st + kk * 2048, KCH * 128));
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

// acc += A[0:64, 0:K] @ (the next K / KCH chunks of the ring), as fwd_gemm,
// with A the previous layer's output in registers: h[4 ks .. 4 ks + 3] the
// A fragment of K step ks (rows r, r + 8 of columns 16 ks + 2 c, + 1, then
// 16 ks + 8 + 2 c, + 1), which is where that layer's epilogue packed its
// accumulators of 8-column groups 2 ks and 2 ks + 1.
template <class C, int K, int L>
__device__ __forceinline__ void fwd_gemm_rs(float (&acc)[L], uint32_t (&h)[K / 4],
                                            FwdPipe<C>& p) {
  constexpr int KCH = FWD_STAGE / 2 / (2 * L), NCH = K / KCH;
  static_assert(K % KCH == 0 && KCH % 16 == 0, "a product is whole chunks of whole K steps");
  int prev = 0;  // the stage of the chunk before
  fence_acc(acc);
  fence_frag(h);
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const uint32_t st = p.next();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KCH / 16; ++kk)
      wgmma_rkn(acc, h + 4 * (c * KCH / 16 + kk), desc_mn_wide(st + kk * 2048, KCH * 128));
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
  fence_frag(h);
}

// Where a warpgroup's head outputs go: row r's sigma at sig[r * stride], its
// rgb at rgb[r * stride + k]; rows >= valid are not written.
struct HeadOut {
  float *sig, *rgb;
  int stride, rgb_stride, valid;
};

// Store this thread's accumulators of two 8-column groups (n8, n8 + 1), as
// bf16 pairs p[0..3] = (rows g, g + 8 of group n8; rows g, g + 8 of group
// n8 + 1), into the warpgroup's swizzled tile at shared address `t`: one
// stmatrix of four 8 x 8 blocks, lane l giving the address of row l % 8 of
// block l / 8.
__device__ __forceinline__ void store_pairs(uint32_t t, int n8, const uint32_t (&p)[4]) {
  const int lane = threadIdx.x & 31, m = lane >> 3;
  const int row = 16 * ((threadIdx.x >> 5) & 3) + 8 * (m & 1) + (lane & 7);
  const int col = 8 * (n8 + (m >> 1));
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(
                   t + swz(row, col)),
               "r"(p[0]), "r"(p[1]), "r"(p[2]), "r"(p[3])
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A consumer thread's registers for the products: the accumulators of the
// widest layer and the A fragments of its output. Both branches run on the
// one set (the object branch on its first half): with a set each, the two
// branches' modes ran out of registers and ptxas serialized their wgmma
// (C7512).
struct FwdRegs {
  float acc[WS / 2];
  uint32_t h[WS / 4];
};

// One branch over the warpgroup's 64 rows: the trunk, the sigma head and,
// when C::HEADS, `final`, the direction layer (direction part from the
// per-ray biases `db`, ND per ray) and the sigmoid rgb head. X is the
// warpgroup's input tile (shared address). The epilogues add the bias and
// apply LeakyReLU in f32 and round to bf16 pairs in `h`, the A fragments of
// the next product; the direction layer's accumulators start from the
// per-ray biases. Without the heads the last trunk layer feeds the sigma
// head alone.
template <int N, class C>
__device__ __forceinline__ void fwd_branch(const BranchTab& t, const bf16* __restrict__ w,
                                           const float* __restrict__ b, uint32_t X,
                                           const float* db, int S, FwdPipe<C>& p, HeadOut ho,
                                           FwdRegs& regs) {
  constexpr int L = N / 2, ND = N / 2;
  constexpr int K0 = N == WS ? C::K0S : C::K0O;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2), c0 = 2 * (lane & 3);
  const int depth = t.v[T_DEPTH];
  const bf16* ws = w + t.v[T_SIGW];
  // the last layer's output: h[2 g + u] the bf16 pair of rows r0 + 8 u,
  // columns 8 g + c0, + 1
  uint32_t (&h)[N / 4] = *reinterpret_cast<uint32_t(*)[N / 4]>(&regs.h);
  float (&acc)[L] = *reinterpret_cast<float(*)[L]>(&regs.acc);
  // the trunk, then `final` (i == depth) when the heads follow
  for (int i = 0; i < (C::HEADS ? depth + 1 : depth); ++i) {
    const bool fin = i == depth, last = i == depth - 1;
#pragma unroll
    for (int r = 0; r < L; ++r) acc[r] = 0.f;
    // layer 0 and a skip layer's input rows read X, the hidden rows h
    if (i == 0 || (i < depth && ((t.v[T_SKIPS] >> i) & 1))) fwd_gemm<C, K0>(acc, X, p);
    if (i > 0) fwd_gemm_rs<C, N>(acc, h, p);
    const float* bl = b + (fin ? t.v[T_FINB] : t.v[T_TB + i]);
    float s[2] = {0.f, 0.f};
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
        if (last) {
          const int c = 8 * g + c0;
          const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&h[2 * g + u]);
          s[u] += __low2float(hv) * __bfloat162float(ws[c]) +
                  __high2float(hv) * __bfloat162float(ws[c + 1]);
        }
      }
    }
    if (last) {
      const float bs = __ldg(b + t.v[T_SIGB]);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float v = s[u];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const int r = r0 + 8 * u;
        if ((lane & 3) == 0 && r < ho.valid) ho.sig[r * ho.stride] = v + bs;
      }
    }
  }
  if constexpr (C::HEADS) {
    // the direction layer (from the per-ray biases) and the rgb head, from registers
    float (&accd)[ND / 2] = *reinterpret_cast<float(*)[ND / 2]>(&regs.acc);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float* dr = db + ((r0 + 8 * u) / S) * ND;
#pragma unroll
      for (int n8 = 0; n8 < ND / 8; ++n8) {
        accd[4 * n8 + 2 * u] = dr[8 * n8 + c0];
        accd[4 * n8 + 2 * u + 1] = dr[8 * n8 + c0 + 1];
      }
    }
    fwd_gemm_rs<C, N>(accd, h, p);
    const bf16* wr = w + t.v[T_RGBW];
    float q[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
    for (int n8 = 0; n8 < ND / 8; ++n8) {
      const int c = 8 * n8 + c0;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const __nv_bfloat162 dv = __floats2bfloat162_rn(lrelu(accd[4 * n8 + 2 * u]),
                                                        lrelu(accd[4 * n8 + 2 * u + 1]));
        const float d0 = __low2float(dv), d1 = __high2float(dv);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          q[u][k] += d0 * __bfloat162float(wr[k * ND + c]) +
                     d1 * __bfloat162float(wr[k * ND + c + 1]);
      }
    }
    const float* br = b + t.v[T_RGBB];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r0 + 8 * u;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float v = q[u][k];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if ((lane & 3) == 0 && r < ho.valid)
          ho.rgb[r * ho.rgb_stride + k] = 1.f / (1.f + expf(-(v + __ldg(br + k))));
      }
    }
  }
}

// The direction biases of one branch for the warpgroup's nr rays: db[lr, j]
// = b_dir[j] + dir_pe[ray0 + lr, :] . W_dir[:, j] (bf16 operands, f32 sum in
// channel order), dir_pe staged in `dirs` (nr rows of MAX_DIR, zero past
// c_dir). All 32 terms of a dot product are loaded before the first is
// added: a guard on c_dir made the loads wait on one another.
template <int ND>
__device__ __forceinline__ void fwd_dir_bias(const BranchTab& t, const bf16* __restrict__ w,
                                             const float* __restrict__ b, const float* dirs,
                                             int nr, float* db) {
  const bf16* wd = w + t.v[T_DIRWD];
  const float* bd = b + t.v[T_DIRB];
  for (int e = threadIdx.x & 127; e < nr * ND; e += 128) {
    const int lr = e / ND, j = e % ND;
    const float* d = dirs + lr * MAX_DIR;
    float s = 0.f;  // W_dir's rows past c_dir are zero, and so is d there
#pragma unroll
    for (int c = 0; c < MAX_DIR; ++c)
      s += __bfloat162float(__float2bfloat16(d[c])) * __bfloat162float(wd[c * ND + j]);
    db[e] = s + bd[j];
  }
}

// One encoded piece of an input row: C channels at p (device memory),
// written from column `col` as [x (C) | sin 2^0 x (C) | cos 2^0 x (C) | sin
// 2^1 x ...].
struct EncPiece {
  const float* p;
  int C, nf, col;
};

// Ask L1 for the n floats at p (device memory), a 32-byte sector at a time,
// without waiting: the loads that follow find them there.
__device__ __forceinline__ void prefetch_l1(const float* p, int n) {
  for (int o = 0; o < n; o += 8)
    asm volatile("prefetch.L1 [%0];" ::"l"(reinterpret_cast<uint64_t>(p + o)));
}

// Build the warpgroup's rows of the input tile (rows g0 .. g0 + 63 of the
// launch, `valid` of them real). Each thread first asks L1 for what its row
// reads (xyz, the raw voxel features, the code of its ray or run of S
// points), so that the encoding's loads wait on L1, not on L2; with the
// heads, the rays' direction encodings are staged in `dirs` (two rays of
// MAX_DIR) and the per-ray direction biases of the branches that run
// computed from them. The z values go into `zrow` when it is given. Then X:
// the encoded pieces (one item per channel: its column and the sine and
// cosine of each octave, both from one full-precision sincosf), the code
// (when `inst`) and zeros up to XKB * 64 columns, as bf16 in the swizzle.
template <bool VOX, int MODE>
__device__ __forceinline__ void fwd_build(const FwdArgs& a, const BranchTab& scene,
                                          const BranchTab& obj, long long g0, int valid,
                                          bool inst, unsigned char* Xg, float* dirs,
                                          float* zrow, float* db, int bar) {
  using C = FwdCfg<VOX, MODE>;
  const int cv = VOX ? a.vd.c_s + a.vd.c_i : 0;
  // lane l of warps 2 h and 2 h + 1 takes row 32 h + l, each warp every
  // other item of the row in turn. Within a warp every lane takes the same
  // kind of item.
  const int w4 = (threadIdx.x >> 5) & 3, half = w4 & 1;
  const int r = (threadIdx.x & 31) + 32 * (w4 >> 1);
  const bool real = r < valid;
  const long long g = g0 + r;
  const float* xr = a.xyz + g * 3;
  const float* vr = VOX ? a.vox + g * cv : nullptr;
  // the row's code: its ray's, or in the point-wise modes its run's
  const float* cr = inst ? a.codes + (g / a.S) * a.code_len : nullptr;
  if (real) {
    prefetch_l1(xr, 3);
    if (VOX) prefetch_l1(vr, cv);
    if (inst) prefetch_l1(cr, a.code_len);
  }
  if (zrow != nullptr && (threadIdx.x & 127) < 64) {  // read once the tile's rows are written
    const int e = threadIdx.x & 127;
    zrow[e] = e < valid ? __ldg(a.z + g0 + e) : 0.f;
  }
  if constexpr (C::HEADS) {
    // the warpgroup's rays (two at most: the launcher takes S >= 32)
    const int ray0 = (int)(g0 / a.S), nr = a.S >= 64 ? 1 : 64 / a.S;
    const int rays = max(0, min(nr, a.n_rays - ray0));  // real rays of the warpgroup
    for (int e = threadIdx.x & 127; e < nr * MAX_DIR; e += 128) {  // padded to MAX_DIR
      const int lr = e / MAX_DIR, c = e % MAX_DIR;
      dirs[e] = lr < rays && c < a.c_dir ? a.dir_pe[(size_t)(ray0 + lr) * a.c_dir + c] : 0.f;
    }
    wg_bar(bar);
    if (a.compute_scene) fwd_dir_bias<WS / 2>(scene, a.w, a.b, dirs, nr, db);
    if (inst) fwd_dir_bias<WO / 2>(obj, a.w, a.b, dirs, nr, db + 2 * (WS / 2));
  }

  EncPiece pc[3];
  int np;
  if constexpr (VOX) {
    const int o1 = a.vd.c_s * (1 + 2 * a.vd.n_fv);
    pc[0] = {vr, a.vd.c_s, a.vd.n_fv, 0};
    pc[1] = {xr, 3, a.n_freq, o1};
    pc[2] = {vr + a.vd.c_s, a.vd.c_i, a.vd.n_fv, o1 + 3 * (1 + 2 * a.n_freq)};
    np = inst ? 3 : 2;
  } else {
    pc[0] = {xr, 3, a.n_freq, 0};
    pc[1] = pc[2] = pc[0];
    np = 1;
  }
  auto put = [&](int col, float v) {
    *reinterpret_cast<bf16*>(Xg + swz(r, col)) = __float2bfloat16(real ? v : 0.f);
  };
  int it = half;  // the row's items this warp takes: it, it + 2, ...
  int col_end = 0;
#pragma unroll
  for (int k = 0; k < (VOX ? 3 : 1); ++k) {
    if (k < np) {
      const EncPiece e = pc[k];
      for (; it < e.C; it += 2) {
        const float v = real ? __ldg(e.p + it) : 0.f;
        put(e.col + it, v);
        for (int oct = 0; oct < e.nf; ++oct) {
          float sn, cs;
          sincosf(v * (float)(1 << oct), &sn, &cs);  // 2^oct x is exact
          const int col = e.col + e.C + 2 * e.C * oct + it;
          put(col, sn);
          put(col + e.C, cs);
        }
      }
      it -= e.C;
      col_end = e.col + e.C * (1 + 2 * e.nf);
    }
  }
  if (inst) {
#pragma unroll 4
    for (; it < a.code_len; it += 2) put(col_end + it, real ? __ldg(cr + it) : 0.f);
    it -= a.code_len;
    col_end += a.code_len;
  }
  for (int col = col_end + it; col < C::XKB * 64; col += 2) put(col, 0.f);
  fence_proxy_async();  // X is complete for the products' reads
  wg_bar(bar);
}

// The producer warpgroup's work (C: the launch's FwdCfg or another layout with
// STAGES stages of STAGE bytes at RING and PRODUCERS lanes): lane 0 of its
// first C::PRODUCERS warps, chunks in turn, streams the plan's chunk order
// once per tile of the block by TMA into the ring, each chunk into the next
// stage once the 8 consumer warps have released it.
template <class C>
__device__ __forceinline__ void fwd_produce(const FwdPlan& plan, int n_tiles, uint32_t base,
                                            uint32_t full, uint32_t empty) {
  const int pw = threadIdx.x >> 5;
  if ((threadIdx.x & 31) != 0 || pw >= C::PRODUCERS) return;
  for (int i = 0; i < WM_LEN; ++i)
    if (plan.cols[i] > 0)
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&plan.maps.m[i]))
                   : "memory");
  int gj = 0;  // the block's chunks so far
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    for (int j = 0; j < plan.n_chunks; ++j, ++gj) {
      if (gj % C::PRODUCERS != pw) continue;
      const int c = plan.chunk[j];
      const int slot = c & 31, row = (c >> 5) * 16;
      const int cols = plan.cols[slot], box = 64 * (FWD_STAGE / 2 / cols) * 2;
      const int stage = gj % C::STAGES, phase = (gj / C::STAGES) & 1;
      mbar_wait(empty + 8 * stage, phase ^ 1);  // a fresh stage passes
      const uint32_t dst = base + C::RING + stage * C::STAGE, bar = full + 8 * stage;
      mbar_expect_tx(bar, FWD_STAGE);
      for (int x = 0; x < cols / 64; ++x)
        tma_load_2d(dst + x * box, &plan.maps.m[slot], 64 * x, row, bar);
    }
  }
}

// The forward chain over the launch's tiles (see the file comment), in mode
// MODE (FWD_*).
template <bool VOX, int MODE>
__global__ void __launch_bounds__(FWD_THREADS, 1)
fwd_chain_kernel(const __grid_constant__ FwdPlan plan, BranchTab scene, BranchTab obj,
                 FwdArgs a) {
  using C = FwdCfg<VOX, MODE>;
  constexpr bool RENDER = MODE == FWD_RENDER, WEIGHTS = MODE == FWD_WEIGHTS;
  constexpr bool POINTS = MODE == FWD_SIGMA_SCENE || MODE == FWD_SIGMA_OBJ;
  extern __shared__ __align__(1024) unsigned char fwd_smem[];
  const uint32_t raw = smem_u32(fwd_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle needs 1 KB alignment
  unsigned char* sm = fwd_smem + (base - raw);
  const uint32_t full = base + C::BAR, empty = full + 8 * C::STAGES,
                 rows_bar = empty + 8 * C::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    mbar_init(rows_bar, 1);
    mbar_init(rows_bar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const long long n_rows = (long long)a.n_rays * a.S;
  const int n_tiles = (int)((n_rows + ROWS - 1) / ROWS);

  if (threadIdx.x < 128) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    fwd_produce<C>(plan, n_tiles, base, full, empty);
  } else {  // two consumer warpgroups of 64 rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = (threadIdx.x >> 7) - 1, bar = 1 + wg;
    const int w4 = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const uint32_t Xs = base + C::X + wg * C::XKB * 8192;
    unsigned char* Xg = sm + C::X + wg * C::XKB * 8192;
    float* db = reinterpret_cast<float*>(sm + C::DB) + wg * C::NDB;
    float* dirs = reinterpret_cast<float*>(sm + C::DIR) + wg * C::NDIR;
    // the tile holds the object branch's columns (its code included)
    const bool inst = MODE == FWD_SIGMA_OBJ || (C::HEADS && a.forward_instance != 0);
    FwdPipe<C> p{base + C::RING, full, empty, 0, 0};
    FwdRegs regs;
    int iter = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++iter) {
      float* rb = reinterpret_cast<float*>(sm + C::ROW) + (iter & 1) * C::NROW;
      const long long g0 = (long long)tile * ROWS + 64 * wg;
      const int valid = (int)max(0LL, min(64LL, n_rows - g0));
      wg_bar(bar);  // the previous tile's readers of X and the biases are done
      fwd_build<VOX, MODE>(a, scene, obj, g0, valid, inst, Xg, dirs,
                           RENDER || WEIGHTS ? rb + RB_Z + 64 * wg : nullptr, db, bar);
      if constexpr (POINTS) {  // the raw density of each real row
        const HeadOut ho = {a.out + g0, nullptr, 1, 0, valid};
        if constexpr (MODE == FWD_SIGMA_SCENE)
          fwd_branch<WS, C>(scene, a.w, a.b, Xs, nullptr, a.S, p, ho, regs);
        else
          fwd_branch<WO, C>(obj, a.w, a.b, Xs, nullptr, a.S, p, ho, regs);
      } else {
        HeadOut ho;
        if (RENDER || WEIGHTS) {
          ho = {rb + RB_SIG + 64 * wg, rb + RB_RGB + 3 * 64 * wg, 1, 3, 64};
        } else {
          ho = {a.out + g0 * 8, a.out + g0 * 8 + 1, 8, 8, valid};
        }
        if (a.compute_scene) fwd_branch<WS, C>(scene, a.w, a.b, Xs, db, a.S, p, ho, regs);
        if (inst) {
          if (RENDER) {
            ho.sig = rb + RB_ISIG + 64 * wg;
            ho.rgb = rb + RB_IRGB + 3 * 64 * wg;
          } else {
            ho.sig += 4;
            ho.rgb += 4;
          }
          fwd_branch<WO, C>(obj, a.w, a.b, Xs, db + 2 * (WS / 2), a.S, p, ho, regs);
        }
        if (!RENDER && !WEIGHTS) {  // zeros for a branch that is off
          const int tid = threadIdx.x & 127;
          for (int e = tid; e < valid * 4; e += 128) {
            float* o = a.out + (g0 + e / 4) * 8 + e % 4;
            if (!a.compute_scene) o[0] = 0.f;
            if (!inst) o[4] = 0.f;
          }
          continue;
        }
        wg_bar(bar);  // the warpgroup's rows are written
        if (wg == 0) {
          if (threadIdx.x == 128) mbar_arrive(rows_bar + 8 * (iter & 1));
          continue;
        }
        mbar_wait(rows_bar + 8 * (iter & 1), (iter >> 1) & 1);  // and the other's
        const int S = a.S, R = ROWS / S;
        const int n_tasks = inst ? 2 * R : R;
        for (int task = w4; task < n_tasks; task += 4) {
          const int rho = task % R, is_inst = task / R;
          const int ray = tile * R + rho;
          if (ray >= a.n_rays) continue;
          float out[5];
          float* m = a.maps + (size_t)ray * 16;
          const float* zs = rb + RB_Z + rho * S;
          if (WEIGHTS) {  // the pdf weights alone
            composite_ray<false>(rb + RB_SIG + rho * S, nullptr, zs, S,
                                 a.last_delta_inf ? 1e10f : 0.f, a.weights + (size_t)ray * S,
                                 out);
          } else if (!is_inst) {
            composite_ray(rb + RB_SIG + rho * S, rb + RB_RGB + rho * S * 3, zs, S,
                          a.last_delta_inf ? 1e10f : 0.f,
                          a.weights != nullptr ? a.weights + (size_t)ray * S : nullptr, out);
            if (lane == 0) {
              for (int c = 0; c < 5; ++c) m[c] = out[c];
              for (int c = inst ? 10 : 5; c < 16; ++c) m[c] = 0.f;
            }
          } else {
            // instance pass: last delta 0, rgb always white-backed
            composite_ray(rb + RB_ISIG + rho * S, rb + RB_IRGB + rho * S * 3, zs, S, 0.f,
                          nullptr, out);
            if (lane == 0) {
              for (int c = 0; c < 3; ++c) m[5 + c] = out[c] + (1.f - out[4]);
              m[8] = out[3];
              m[9] = out[4];
            }
          }
        }
      }
    }
  }
}

// The SMs of the current device, asked once.
int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
}

// The producer's plan over the packed weights `w`: the weight maps of
// `wmap_tab` (WM_LEN x 3 ints, as encode_sweep_maps takes them) in boxes of
// FWD_STAGE bytes per row of boxes, and the chunk order `chunks` (n_chunks x
// 3 ints: slot, first row, boxes), each chunk checked to lie inside its map.
int fwd_plan(const void* w, const int* wmap_tab, const int* chunks, int n_chunks,
             FwdPlan* plan) {
  if (n_chunks < 0 || n_chunks > FWD_MAX_CHUNKS) return (int)cudaErrorInvalidValue;
  const int e = encode_sweep_maps(w, wmap_tab, &plan->maps, FWD_STAGE);
  if (e != (int)cudaSuccess) return e;
  for (int i = 0; i < WM_LEN; ++i) plan->cols[i] = (unsigned short)wmap_tab[3 * i + 2];
  plan->n_chunks = n_chunks;
  for (int j = 0; j < n_chunks; ++j) {
    const int slot = chunks[3 * j], row = chunks[3 * j + 1], boxes = chunks[3 * j + 2];
    if (slot < 0 || slot >= WM_LEN) return (int)cudaErrorInvalidValue;
    const int rows = wmap_tab[3 * slot + 1], cols = wmap_tab[3 * slot + 2];
    const int k_rows = cols > 0 ? FWD_STAGE / 2 / cols : 0;
    if (cols <= 0 || cols % 64 != 0 || boxes != cols / 64 || k_rows % 16 != 0 || row < 0 ||
        row % k_rows != 0 || row + k_rows > rows || row / 16 >= 2048)
      return (int)cudaErrorInvalidValue;
    plan->chunk[j] = (unsigned short)(slot | row / 16 << 5);
  }
  return (int)cudaSuccess;
}

}  // namespace

// Launch the forward chain in mode MODE: the weight maps of `wmap_tab`
// (WM_LEN x 3 ints, as encode_sweep_maps takes them) in boxes of FWD_STAGE
// bytes per row of boxes, the chunk order `chunks` (n_chunks x 3 ints: slot,
// first row, boxes), one block per SM or per tile, whichever is fewer. The
// branch tables the mode runs must be given (the scene's always).
template <bool VOX, int MODE>
int launch_fwd_chain(const int* wmap_tab, const int* chunks, int n_chunks,
                     const int* scene_tab, const int* obj_tab, const FwdArgs& a,
                     cudaStream_t st) {
  using C = FwdCfg<VOX, MODE>;
  if (scene_tab == nullptr ||
      scene_tab[T_K0] != C::K0S || (obj_tab != nullptr && obj_tab[T_K0] != C::K0O) ||
      (MODE == FWD_SIGMA_OBJ && obj_tab == nullptr) || a.n_rays < 0 || a.S < 1)
    return (int)cudaErrorInvalidValue;
  // a tile of whole rays, S in {32, 64, 128}: with the heads a warpgroup's 64
  // rows span two rays at most (their direction encodings are staged), and
  // the compositing takes S / 32 samples a lane
  if ((C::HEADS || MODE == FWD_WEIGHTS) && (a.S < 32 || ROWS % a.S != 0))
    return (int)cudaErrorInvalidValue;
  FwdPlan plan;
  cudaError_t e = (cudaError_t)fwd_plan(a.w, wmap_tab, chunks, n_chunks, &plan);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(fwd_chain_kernel<VOX, MODE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (e != cudaSuccess) return (int)e;
  const long long n_rows = (long long)a.n_rays * a.S;
  const int n_tiles = (int)((n_rows + ROWS - 1) / ROWS), n_sm = sm_count();
  if (n_sm == 0) return (int)cudaErrorNoDevice;
  fwd_chain_kernel<VOX, MODE><<<min(n_tiles, n_sm), FWD_THREADS, C::BYTES, st>>>(
      plan, to_tab(scene_tab), to_tab(obj_tab), a);
  return (int)cudaGetLastError();
}

// Each (model, mode) is compiled by one source, which instantiates it: fused_mlp.cu
// the render and the coarse weights, fused_mlp_train.cu the eval, fused_sigma.cu
// the two densities, so that their compilers build the ten kernels side by side.
#define FWD_CHAIN_INSTANCE(VOX, MODE)                                                      \
  template int launch_fwd_chain<VOX, MODE>(const int*, const int*, int, const int*,        \
                                           const int*, const FwdArgs&, cudaStream_t)
extern FWD_CHAIN_INSTANCE(false, FWD_EVAL);
extern FWD_CHAIN_INSTANCE(true, FWD_EVAL);
extern FWD_CHAIN_INSTANCE(false, FWD_RENDER);
extern FWD_CHAIN_INSTANCE(true, FWD_RENDER);
extern FWD_CHAIN_INSTANCE(false, FWD_WEIGHTS);
extern FWD_CHAIN_INSTANCE(true, FWD_WEIGHTS);
extern FWD_CHAIN_INSTANCE(false, FWD_SIGMA_SCENE);
extern FWD_CHAIN_INSTANCE(true, FWD_SIGMA_SCENE);
extern FWD_CHAIN_INSTANCE(false, FWD_SIGMA_OBJ);
extern FWD_CHAIN_INSTANCE(true, FWD_SIGMA_OBJ);
