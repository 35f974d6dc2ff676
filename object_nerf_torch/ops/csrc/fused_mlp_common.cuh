// Device functions shared by the port's fused MLP kernels (fused_mlp.cu,
// fused_mlp_train.cu, fused_sigma.cu): the 128-row tile, the tensor-core products over it
// (nvcuda::wmma 16x16x16 bf16, f32 accumulators), the branch trunk and heads,
// the input tile (classical, and the wider voxel-conditioned one), the per-ray
// direction bias and the compositing scan. The file comments of the sources
// say what each kernel does with them.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <string.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int ROWS = 128;     // sample rows per block (R whole rays x S samples)
constexpr int THREADS = 256;  // 8 warps
constexpr int KC = 64;        // K rows of a weight matrix staged per step
constexpr int WS = 256;       // scene width
constexpr int WO = 128;       // object width
constexpr int XCOLS = 128;    // input tile columns: [PE | code | 0 pad]
constexpr int LDX = XCOLS + 8;
constexpr int LDH = WS + 8;
constexpr int LDWST = WS + 8;
constexpr int MAX_R = 4;      // rays per block (S >= 32)
constexpr float LEAKY = 0.01f;
constexpr float T_EPS = 1e-10f;

// Offsets of one branch's weights (bf16 buffer) and biases (f32 buffer), in
// elements. The layout is written by pack_kernel_weights in fused_mlp.py:
// trunk layer i is a (K, N) row-major matrix ("in, out"); a skip layer
// holds the input rows [0, K0) and then the hidden rows [K0, K0 + N); the
// sigma and rgb heads are stored (out, in); the view-direction layer is
// split into its hidden part (N, N/2) and its direction part
// (32, N/2), of which the kernel reads the first c_dir rows.
enum {
  T_DEPTH = 0, T_SKIPS = 1, T_K0 = 2, T_TW = 3, T_TB = 11,
  T_SIGW = 19, T_SIGB = 20, T_FINW = 21, T_FINB = 22,
  T_DIRWH = 23, T_DIRWD = 24, T_DIRB = 25, T_RGBW = 26, T_RGBB = 27,
  T_LEN = 28  // trunk tables hold up to 8 layers
};
struct BranchTab { int v[T_LEN]; };

// dynamic shared memory layout (bytes; every offset a multiple of 128)
constexpr int SM_X = 0;
constexpr int SM_H = SM_X + ROWS * LDX * 2;
constexpr int SM_W = SM_H + ROWS * LDH * 2;
constexpr int SM_SCR = SM_W + KC * LDWST * 2;
constexpr int SM_ROW = SM_SCR + (THREADS / 32) * 256 * 4;  // 9 floats per row
constexpr int SM_DB = SM_ROW + ROWS * 9 * 4;                // dir biases
constexpr int SMEM_BYTES = SM_DB + MAX_R * (WS / 2 + WO / 2) * 4;

// The voxel-conditioned eval kernels' layout. Their input tile is wider:
// [svox | PE(svox) | xyz | PE(xyz)] is 271 columns at the default widths and
// the object branch appends [ivox | PE(ivox) | code] to 439, padded to 448.
// With that tile the classical layout would need 233,984 bytes, more than
// the 232,448 a block may have, so here the epilogue's f32 staging tile
// shares the weight stage: every product ends before the epilogue's first
// barrier and the next product starts with one, so the two are never live
// together. The classical kernels keep their own layout above.
constexpr int XCOLS_V = 448;
constexpr int LDX_V = XCOLS_V + 8;
constexpr int MAX_VOX = 32;   // raw voxel channels per sample (16 + 8 by default)
constexpr int SV_X = 0;
constexpr int SV_H = SV_X + ROWS * LDX_V * 2;
constexpr int SV_W = SV_H + ROWS * LDH * 2;      // weight stage and scratch
constexpr int SV_ROW = SV_W + KC * LDWST * 2;
constexpr int SV_DB = SV_ROW + ROWS * 9 * 4;
constexpr int SMEM_BYTES_V = SV_DB + MAX_R * (WS / 2 + WO / 2) * 4;
static_assert(SMEM_BYTES_V <= 232448, "voxel layout exceeds a block's shared memory");
static_assert((THREADS / 32) * 256 * 4 <= KC * LDWST * 2, "scratch exceeds the stage");
static_assert(ROWS * (3 + MAX_VOX) * 4 <= ROWS * LDH * 2, "input staging exceeds H");

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;

// A warp's share of a 128 x N layer output: rows [64*wr, 64*wr + 64),
// columns [N/4*wc, N/4*wc + N/4) with wr = warp / 4, wc = warp % 4.
template <int N>
struct Acc {
  FragC f[4][N / 64];
};

template <int N>
__device__ __forceinline__ void acc_zero(Acc<N>& a) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < N / 64; ++j) wmma::fill_fragment(a.f[i][j], 0.0f);
}

// acc += A[0:128, 0:K] @ Wg[0:K, 0:N]. A is bf16 in shared memory (leading
// dimension lda); Wg is bf16 row-major (K, N) in device memory, staged
// through `wst` KC rows at a time. K must be a multiple of KC.
template <int N>
__device__ __forceinline__ void gemm(Acc<N>& acc, const bf16* A, int lda,
                                     const bf16* __restrict__ Wg, int K,
                                     bf16* wst) {
  constexpr int LDW = N + 8;
  constexpr int FN = N / 64;
  constexpr int VPR = N / 8;  // 16-byte vectors per weight row
  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();  // the previous chunk (and any earlier reader) is done
    for (int v = threadIdx.x; v < KC * VPR; v += THREADS) {
      const int r = v / VPR, c = (v % VPR) * 8;
      *reinterpret_cast<uint4*>(wst + r * LDW + c) =
          __ldg(reinterpret_cast<const uint4*>(Wg + (size_t)(k0 + r) * N + c));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      FragA a[4];
      FragB b[FN];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], A + (wr * 64 + i * 16) * lda + k0 + kk, lda);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], wst + kk * LDW + wc * (N / 4) + j * 16, LDW);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc.f[i][j], a[i], b[j], acc.f[i][j]);
    }
  }
}

// f(row, col, value) over the warp's accumulators, through a per-warp f32
// staging tile. Starts with a block barrier, so f may overwrite the A
// operand of the product that produced `acc`.
template <int N, typename F>
__device__ __forceinline__ void epilogue(Acc<N>& acc, float* scratch_all, F f) {
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp >> 2, wc = warp & 3;
  float* scratch = scratch_all + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < N / 64; ++j) {
      wmma::store_matrix_sync(scratch, acc.f[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32)
        f(wr * 64 + i * 16 + (e >> 4), wc * (N / 4) + j * 16 + (e & 15), scratch[e]);
      __syncwarp();
    }
  }
}

__device__ __forceinline__ float lrelu(float x) { return x >= 0.f ? x : LEAKY * x; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The branch trunk: H[0:128, 0:N] = the output of the last trunk layer. LD is
// the input tile's leading dimension (LDX, or LDX_V for the voxel tile).
template <int N, int LD = LDX>
__device__ void run_trunk(const BranchTab& t, const bf16* __restrict__ w,
                          const float* __restrict__ b, const bf16* X, bf16* H,
                          bf16* wst, float* scratch) {
  const int k0 = t.v[T_K0];
  for (int i = 0; i < t.v[T_DEPTH]; ++i) {
    Acc<N> acc;
    acc_zero(acc);
    const bf16* wl = w + t.v[T_TW + i];
    if (i == 0) {
      gemm<N>(acc, X, LD, wl, k0, wst);
    } else if ((t.v[T_SKIPS] >> i) & 1) {  // [input, h] @ W
      gemm<N>(acc, X, LD, wl, k0, wst);
      gemm<N>(acc, H, LDH, wl + (size_t)k0 * N, N, wst);
    } else {
      gemm<N>(acc, H, LDH, wl, N, wst);
    }
    const float* bl = b + t.v[T_TB + i];
    epilogue<N>(acc, scratch, [&](int r, int c, float v) {
      H[r * LDH + c] = __float2bfloat16(lrelu(v + bl[c]));
    });
  }
}

// out[r] = H[r, 0:K] . wv[0:K] + bias for the 128 rows; one warp per 16 rows.
__device__ void head_sigma(const bf16* H, int K, const bf16* __restrict__ wv,
                           float bias, float* out) {
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    float s = 0.f;
    for (int k = lane; k < K; k += 32)
      s += __bfloat162float(H[r * LDH + k]) * __bfloat162float(wv[k]);
    s = warp_sum(s);
    if (lane == 0) out[r] = s + bias;
  }
}

// out[r, c] = sigmoid(H[r, 0:K] . wr[c, 0:K] + bias[c]) for c < 3.
__device__ void head_rgb(const bf16* H, int K, const bf16* __restrict__ wr,
                         const float* __restrict__ bias, float* out) {
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float h = __bfloat162float(H[r * LDH + k]);
      s0 += h * __bfloat162float(wr[k]);
      s1 += h * __bfloat162float(wr[K + k]);
      s2 += h * __bfloat162float(wr[2 * K + k]);
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      out[r * 3 + 0] = 1.f / (1.f + expf(-(s0 + bias[0])));
      out[r * 3 + 1] = 1.f / (1.f + expf(-(s1 + bias[1])));
      out[r * 3 + 2] = 1.f / (1.f + expf(-(s2 + bias[2])));
    }
  }
}

// Column c of a row of the input tile [PE(p) | code | 0], before rounding:
// p is the row's xyz, pe = 3 (2 n_freq + 1) the width of its encoding in the
// reference channel order, code_row the row's latent code (or nullptr).
__device__ __forceinline__ float input_value(const float* p, int c, int pe,
                                             const float* __restrict__ code_row,
                                             int code_len) {
  if (c < 3) return p[c];
  if (c < pe) {
    const int j = c - 3, k = j / 6, q = j % 6;
    const float x = p[q % 3] * (float)(1 << k);  // exact
    return q < 3 ? sinf(x) : cosf(x);
  }
  if (code_row != nullptr && c < pe + code_len) return code_row[c - pe];
  return 0.f;
}

// Fill the input tile of tile number `tile`: z values (when z is given), and
// X = [PE(xyz) | code | 0] as bf16. Rows of rays past n_rays are zero.
__device__ void load_inputs(int tile, const float* __restrict__ xyz,
                            const float* __restrict__ z,
                            const float* __restrict__ codes, int n_rays, int S,
                            int n_freq, int code_len, bf16* X, float* zs,
                            float* xyz_s) {
  const int R = ROWS / S;
  const int ray0 = tile * R;
  for (int e = threadIdx.x; e < ROWS * 3; e += THREADS) {
    const int r = e / 3;
    const int ray = ray0 + r / S;
    xyz_s[e] = ray < n_rays ? xyz[(size_t)ray0 * S * 3 + e] : 0.f;
  }
  if (z != nullptr) {
    for (int r = threadIdx.x; r < ROWS; r += THREADS) {
      const int ray = ray0 + r / S;
      zs[r] = ray < n_rays ? z[(size_t)ray0 * S + r] : 0.f;
    }
  }
  __syncthreads();
  const int pe = 3 * (2 * n_freq + 1);
  for (int e = threadIdx.x; e < ROWS * XCOLS; e += THREADS) {
    const int r = e / XCOLS, c = e % XCOLS;
    const int ray = ray0 + r / S;
    float v = 0.f;
    if (ray < n_rays)
      v = input_value(xyz_s + r * 3, c, pe,
                      codes != nullptr ? codes + (size_t)ray * code_len : nullptr, code_len);
    X[r * LDX + c] = __float2bfloat16(v);
  }
}

// Widths of the voxel operand: scene and instance channels of a raw feature
// row, and the octaves of their encoding.
struct VoxDims { int c_s, c_i, n_fv; };

// Column j of the encoding of a C-channel piece v, in the reference channel
// order [sin f0 (C), cos f0 (C), sin f1 (C), ...], f_k = 2^k. sinf / cosf in
// full precision: a trilinear blend of N(0, 1) features times 2^5 is far
// outside the range where the fast intrinsics hold.
__device__ __forceinline__ float pe_piece(const float* v, int C, int j) {
  const int k = j / (2 * C), q = j % (2 * C);
  const float x = v[q % C] * (float)(1 << k);  // exact
  return q < C ? sinf(x) : cosf(x);
}

// Column c of a row of the voxel input tile, before rounding:
// [svox | PE(svox) | xyz | PE(xyz)] (the scene branch's input), then, when
// `inst`, [ivox | PE(ivox) | code]; zero beyond. `vox` is the row's raw
// feature row [svox c_s | ivox c_i], p its xyz.
__device__ __forceinline__ float voxel_input_value(
    const float* p, const float* vox, int c, VoxDims d, int n_freq, bool inst,
    const float* __restrict__ code_row, int code_len) {
  int o = d.c_s;
  if (c < o) return vox[c];
  int w = 2 * d.n_fv * d.c_s;
  if (c < o + w) return pe_piece(vox, d.c_s, c - o);
  o += w;
  if (c < o + 3) return p[c - o];
  o += 3;
  w = 6 * n_freq;
  if (c < o + w) return pe_piece(p, 3, c - o);
  o += w;
  if (!inst) return 0.f;
  if (c < o + d.c_i) return vox[d.c_s + c - o];
  o += d.c_i;
  w = 2 * d.n_fv * d.c_i;
  if (c < o + w) return pe_piece(vox + d.c_s, d.c_i, c - o);
  o += w;
  if (code_row != nullptr && c < o + code_len) return code_row[c - o];
  return 0.f;
}

// Fill the voxel input tile of tile number `tile`: rows are the flat samples
// tile * 128 .. + 127 of n_rows (rows past the end are zero), row g takes the
// code row g / per_code (per_code = S for a tile of whole rays). Columns
// [0, ncols) of X (leading dimension ldx) are written; `stage` is
// ROWS * (3 + c_s + c_i) floats that nothing else uses until the tile is
// built (the H buffer). z values go to zs when z is given. `ldx`: X's
// leading dimension when X is not a shared-memory tile.
__device__ void load_inputs_vox(int tile, const float* __restrict__ xyz,
                                const float* __restrict__ z,
                                const float* __restrict__ vox,
                                const float* __restrict__ codes, long long n_rows,
                                int per_code, int n_freq, VoxDims d, int code_len,
                                bool inst, int ncols, bf16* X, float* zs, float* stage,
                                int ldx = LDX_V) {
  const long long g0 = (long long)tile * ROWS;
  const int cv = d.c_s + d.c_i;
  float* xyz_s = stage;
  float* vox_s = stage + ROWS * 3;
  for (int e = threadIdx.x; e < ROWS * 3; e += THREADS)
    xyz_s[e] = g0 + e / 3 < n_rows ? xyz[g0 * 3 + e] : 0.f;
  for (int e = threadIdx.x; e < ROWS * cv; e += THREADS)
    vox_s[e] = g0 + e / cv < n_rows ? vox[g0 * cv + e] : 0.f;
  if (z != nullptr)
    for (int r = threadIdx.x; r < ROWS; r += THREADS)
      zs[r] = g0 + r < n_rows ? z[g0 + r] : 0.f;
  __syncthreads();
  for (int e = threadIdx.x; e < ROWS * ncols; e += THREADS) {
    const int r = e / ncols, c = e % ncols;
    const long long g = g0 + r;
    float v = 0.f;
    if (g < n_rows)
      v = voxel_input_value(
          xyz_s + r * 3, vox_s + r * cv, c, d, n_freq, inst,
          inst && codes != nullptr ? codes + (size_t)(g / per_code) * code_len : nullptr,
          code_len);
    X[(size_t)r * ldx + c] = __float2bfloat16(v);
  }
}

// dbias[rho, j] = b_dir[j] + dir_pe[ray, :] . W_dir[:, j] (operands in bf16,
// f32 sum): the view-direction input is constant along a ray, so its part
// of the direction layer is a per-ray bias.
__device__ void dir_bias(int tile, const BranchTab& t, const bf16* __restrict__ w,
                         const float* __restrict__ b, int ND,
                         const float* __restrict__ dir_pe, int c_dir,
                         int n_rays, int R, float* dbias) {
  const bf16* wd = w + t.v[T_DIRWD];
  const float* bd = b + t.v[T_DIRB];
  for (int e = threadIdx.x; e < R * ND; e += THREADS) {
    const int rho = e / ND, j = e % ND;
    const int ray = tile * R + rho;
    float s = 0.f;
    if (ray < n_rays)
      for (int c = 0; c < c_dir; ++c)
        s += __bfloat162float(__float2bfloat16(dir_pe[(size_t)ray * c_dir + c])) *
             __bfloat162float(wd[c * ND + j]);
    dbias[e] = s + bd[j];
  }
}

// One warp composites one ray of S samples (S/32 consecutive samples per
// lane): alpha = 1 - exp(-delta relu(sigma)), exclusive transmittance
// T_i = prod_{j<i} (1 - alpha_j + 1e-10), w_i = alpha_i T_i. Returns
// (rgb, depth, opacity) in lane 0; writes w to w_out when it is given.
__device__ void composite_ray(const float* sig, const float* rgb, const float* zs,
                              int S, float last_delta, float* w_out, float out[5]) {
  const int lane = threadIdx.x & 31;
  const int P = S / 32;
  float a[4], t[4];
  float prod = 1.f;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    if (p < P) {
      const int i = lane * P + p;
      const float delta = i < S - 1 ? zs[i + 1] - zs[i] : last_delta;
      a[p] = 1.f - expf(-delta * fmaxf(sig[i], 0.f));
      t[p] = 1.f - a[p] + T_EPS;
      prod *= t[p];
    }
  }
  float incl = prod;  // inclusive scan of the lanes' products
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl *= up;
  }
  float T = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) T = 1.f;
  float op = 0.f, dep = 0.f, r0 = 0.f, r1 = 0.f, r2 = 0.f;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    if (p < P) {
      const int i = lane * P + p;
      const float wi = a[p] * T;
      T *= t[p];
      op += wi;
      dep += wi * zs[i];
      r0 += wi * rgb[i * 3 + 0];
      r1 += wi * rgb[i * 3 + 1];
      r2 += wi * rgb[i * 3 + 2];
      if (w_out != nullptr) w_out[i] = wi;
    }
  }
  out[0] = warp_sum(r0);
  out[1] = warp_sum(r1);
  out[2] = warp_sum(r2);
  out[3] = warp_sum(dep);
  out[4] = warp_sum(op);
}

struct Smem {
  bf16 *X, *H, *wst;
  float *scratch, *sig, *rgb, *isig, *irgb, *zs, *dbs, *dbo;
};

__device__ Smem carve(unsigned char* base) {
  Smem s;
  s.X = reinterpret_cast<bf16*>(base + SM_X);
  s.H = reinterpret_cast<bf16*>(base + SM_H);
  s.wst = reinterpret_cast<bf16*>(base + SM_W);
  s.scratch = reinterpret_cast<float*>(base + SM_SCR);
  float* row = reinterpret_cast<float*>(base + SM_ROW);
  s.sig = row;
  s.rgb = row + ROWS;
  s.isig = row + 4 * ROWS;
  s.irgb = row + 5 * ROWS;
  s.zs = row + 8 * ROWS;
  s.dbs = reinterpret_cast<float*>(base + SM_DB);
  s.dbo = s.dbs + MAX_R * (WS / 2);
  return s;
}

__device__ Smem carve_vox(unsigned char* base) {
  Smem s;
  s.X = reinterpret_cast<bf16*>(base + SV_X);
  s.H = reinterpret_cast<bf16*>(base + SV_H);
  s.wst = reinterpret_cast<bf16*>(base + SV_W);
  s.scratch = reinterpret_cast<float*>(base + SV_W);  // shared with the stage
  float* row = reinterpret_cast<float*>(base + SV_ROW);
  s.sig = row;
  s.rgb = row + ROWS;
  s.isig = row + 4 * ROWS;
  s.irgb = row + 5 * ROWS;
  s.zs = row + 8 * ROWS;
  s.dbs = reinterpret_cast<float*>(base + SV_DB);
  s.dbo = s.dbs + MAX_R * (WS / 2);
  return s;
}

BranchTab to_tab(const int* v) {
  BranchTab t;
  memset(&t, 0, sizeof(t));
  if (v != nullptr) memcpy(t.v, v, sizeof(t.v));
  return t;
}

}  // namespace
