// Two probe kernels for Hopper (sm_90a): what the voxel path's in-kernel
// positional encoding costs, and a trivial kernel to put beside a gather.
//
//   pe_probe_kernel    replaces make_kernel (scripts/profile_pe_micro.py:53):
//                      per row of 27 raw channels [xyz 3 | scene voxel 16 |
//                      instance voxel 8], the encoding sin(x @ S) by one of
//                      eight modes, the concatenation [x | PE] of 375 columns,
//                      an 8-layer 256-wide ReLU chain without biases, and the
//                      sum of the last layer's row.
//   scale_copy_kernel  replaces dummy_pallas (scripts/profile_voxel_split.py:130):
//                      out = 2 x.
//
// What bounds them. pe_probe: the tensor cores (0.55 M multiply-adds per row
// in the chain against 108 bytes read and 4 written); the question it is
// built to answer is how much the encoding adds on top of the chain, so the
// encoding's own arithmetic (up to 27 x 348 multiply-adds and 348 sines per
// row, on the ordinary f32 units) is the subject, not an overhead to hide.
// scale_copy: bytes (each element read once and written once).
//
// What the design does about it (simple first versions). pe_probe: a block of
// 8 warps owns 128 rows; the raw channels and the S matrices (rounded to bf16,
// as the reference's products take them) are staged in shared memory, each
// thread computes encoded columns with an f32 sum over the piece's own
// channels ("split": 3, 16 or 8 terms; "combined": all 27) and applies the
// mode's sine (sinf, none, or the degree-11 polynomial in turns copied from
// the script), the row [x | PE | 0] is stored as bf16 and the chain runs on
// the bf16 tensor cores through the shared 128-row tile code
// (fused_mlp_common.cuh: gemm, epilogue), weights streamed from L2.
// scale_copy: one float4 per thread.

#include "fused_mlp_common.cuh"

namespace {

constexpr int P_IN = 27;              // raw channels
constexpr int P_PE = 348;             // encoded columns: 60 + 192 + 96
constexpr int P_CAT = P_IN + P_PE;    // 375
constexpr int P_COLS = 384;           // padded to a multiple of KC
constexpr int P_LDX = P_COLS + 8;
constexpr int P_LAYERS = 8;

constexpr int PSM_X = 0;
constexpr int PSM_H = PSM_X + ROWS * P_LDX * 2;
constexpr int PSM_W = PSM_H + ROWS * LDH * 2;
constexpr int PSM_SCR = PSM_W + KC * LDWST * 2;
constexpr int PSM_BYTES = PSM_SCR + (THREADS / 32) * 256 * 4;
// the staged inputs of the encoding live in the H buffer until the first layer
static_assert((P_IN * P_PE + ROWS * P_IN) * 4 <= ROWS * LDH * 2, "staging exceeds H");

// modes (ops/probes.py MODES, the script's names)
enum { M_NONE = 0, M_XYZ_ONLY, M_SPLIT, M_SPLIT_NOSIN, M_SPLIT_POLYSIN,
       M_COMBINED, M_COMBINED_NOSIN, M_COMBINED_POLYSIN };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// sin(2 pi u): one round + subtract range reduction and a degree-11 odd
// polynomial on [-0.5, 0.5] (scripts/profile_pe_micro.py:34-50).
__device__ __forceinline__ float sin_turns(float u) {
  const float z = u - rintf(u);
  const float w = z * z;
  float p = -12.27205003f;
  p = p * w + 41.20590088f;
  p = p * w - 76.58021788f;
  p = p * w + 81.59619567f;
  p = p * w - 41.34142188f;
  p = p * w + 6.28318282f;
  return p * z;
}

__global__ void __launch_bounds__(THREADS, 1)
pe_probe_kernel(const float* __restrict__ x, const float* __restrict__ s_xyz,
                const float* __restrict__ s_svox, const float* __restrict__ s_ivox,
                const float* __restrict__ s_all, const bf16* __restrict__ trunk,
                float* __restrict__ out, int n_rows, int mode) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem + PSM_X);
  bf16* H = reinterpret_cast<bf16*>(smem + PSM_H);
  bf16* wst = reinterpret_cast<bf16*>(smem + PSM_W);
  float* scratch = reinterpret_cast<float*>(smem + PSM_SCR);
  float* S = reinterpret_cast<float*>(smem + PSM_H);  // (27, 348), bf16-rounded
  float* xs = S + P_IN * P_PE;                        // (128, 27), bf16-rounded

  const int row0 = blockIdx.x * ROWS;
  const bool combined = mode >= M_COMBINED;
  const bool encode = mode != M_NONE;
  for (int e = threadIdx.x; e < ROWS * P_IN; e += THREADS)
    xs[e] = row0 + e / P_IN < n_rows ? bf16_round(x[(size_t)row0 * P_IN + e]) : 0.f;
  if (encode) {
    // S[k][c]: the matrix entry that multiplies raw channel k in column c
    for (int e = threadIdx.x; e < P_IN * P_PE; e += THREADS) {
      const int k = e / P_PE, c = e % P_PE;
      float v = 0.f;
      if (combined) v = s_all[e];
      else if (c < 60) { if (k < 3) v = s_xyz[k * 60 + c]; }
      else if (c < 252) { if (k >= 3 && k < 19) v = s_svox[(k - 3) * 192 + c - 60]; }
      else if (k >= 19) v = s_ivox[(k - 19) * 96 + c - 252];
      S[e] = bf16_round(v);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < ROWS * P_COLS; e += THREADS) {
    const int r = e / P_COLS, c = e % P_COLS;
    const float* xr = xs + r * P_IN;
    float v = 0.f;
    if (c < P_IN) {
      v = xr[c];
    } else if (c < P_CAT && encode) {
      const int j = c - P_IN;
      int k0 = 0, k1 = P_IN;
      if (!combined) {  // the piece's own channels only
        if (j < 60) k1 = 3;
        else if (j < 252) { k0 = 3; k1 = 19; }
        else k0 = 19;
      }
      if (mode != M_XYZ_ONLY || j < 60) {
        float acc = 0.f;
        for (int k = k0; k < k1; ++k) acc += xr[k] * S[k * P_PE + j];
        if (mode == M_SPLIT_NOSIN || mode == M_COMBINED_NOSIN) v = acc;
        else if (mode == M_SPLIT_POLYSIN || mode == M_COMBINED_POLYSIN) v = sin_turns(acc);
        else v = sinf(acc);
      }
    }
    X[r * P_LDX + c] = __float2bfloat16(v);
  }
  // gemm's first barrier orders the tile's writes before its reads, and the
  // first epilogue's barrier the last read of S / xs before H is overwritten
  for (int i = 0; i < P_LAYERS; ++i) {
    Acc<WS> acc;
    acc_zero(acc);
    if (i == 0)
      gemm<WS>(acc, X, P_LDX, trunk, P_COLS, wst);
    else
      gemm<WS>(acc, H, LDH, trunk + (size_t)P_COLS * WS + (size_t)(i - 1) * WS * WS, WS, wst);
    epilogue<WS>(acc, scratch, [&](int r, int c, float v) {
      H[r * LDH + c] = __float2bfloat16(fmaxf(v, 0.f));
    });
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    float s = 0.f;
    for (int k = lane; k < WS; k += 32) s += __bfloat162float(H[r * LDH + k]);
    s = warp_sum(s);
    if (lane == 0 && row0 + r < n_rows) out[row0 + r] = s;
  }
}

__global__ void __launch_bounds__(256)
scale_copy_kernel(const float* __restrict__ x, float* __restrict__ out, long long n) {
  const long long i = ((long long)blockIdx.x * 256 + threadIdx.x) * 4;
  if (i + 3 < n) {
    float4 v = __ldg(reinterpret_cast<const float4*>(x + i));
    v.x *= 2.f; v.y *= 2.f; v.z *= 2.f; v.w *= 2.f;
    *reinterpret_cast<float4*>(out + i) = v;
  } else {
    for (long long j = i; j < n; ++j) out[j] = 2.f * x[j];
  }
}

}  // namespace

extern "C" {

// x (n_rows, 27) f32; s_* f32 (3, 60), (16, 192), (8, 96), (27, 348); trunk
// bf16: (384, 256) with rows 375.. zero, then 7 x (256, 256), all (in, out);
// out (n_rows,) f32. Returns cudaGetLastError().
int onerf_pe_probe(const float* x, const float* s_xyz, const float* s_svox,
                   const float* s_ivox, const float* s_all, const void* trunk, float* out,
                   int n_rows, int mode, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      pe_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PSM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((n_rows + ROWS - 1) / ROWS);
  pe_probe_kernel<<<grid, THREADS, PSM_BYTES, (cudaStream_t)stream>>>(
      x, s_xyz, s_svox, s_ivox, s_all, static_cast<const bf16*>(trunk), out, n_rows, mode);
  return (int)cudaGetLastError();
}

// x and out 16-byte aligned, n elements.
int onerf_scale_copy(const float* x, float* out, long long n, void* stream) {
  const long long blocks = (n + 1023) / 1024;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  scale_copy_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(x, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
