// Device functions shared by the port's fused MLP kernels (fused_mlp_wg.cuh,
// fused_mlp_train.cu, and through fused_mlp_wg.cuh probes.cu): the 128-row
// tile and its widths, the packed weights' offset table, a column of the
// classical input tile (the backward sweep's) and the compositing scan of
// the forward chain. The file comments of the sources say what each kernel
// does with them.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

typedef __nv_bfloat16 bf16;

// Widths of the voxel operand: scene and instance channels of a raw feature
// row, and the octaves of their encoding. Outside the unnamed namespace: the
// forward chain's FwdArgs holds it, and FwdArgs crosses the sources.
struct VoxDims { int c_s, c_i, n_fv; };

namespace {

constexpr int ROWS = 128;     // sample rows per block (R whole rays x S samples)
constexpr int WS = 256;       // scene width
constexpr int WO = 128;       // object width
constexpr int XCOLS = 128;    // input tile columns: [PE | code | 0 pad]
constexpr float LEAKY = 0.01f;
constexpr float T_EPS = 1e-10f;

// Offsets of one branch's weights (bf16 buffer) and biases (f32 buffer), in
// elements. The layout is written by pack_kernel_weights in fwd_chain.py:
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

// The voxel-conditioned model's input tile is wider: [svox | PE(svox) | xyz
// | PE(xyz)] is 271 columns at the default widths and the object branch
// appends [ivox | PE(ivox) | code] to 439, padded to 448.
constexpr int XCOLS_V = 448;
constexpr int MAX_VOX = 32;   // raw voxel channels per sample (16 + 8 by default)

__device__ __forceinline__ float lrelu(float x) { return x >= 0.f ? x : LEAKY * x; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// One warp composites one ray of S samples (S/32 consecutive samples per
// lane): alpha = 1 - exp(-delta relu(sigma)), exclusive transmittance
// T_i = prod_{j<i} (1 - alpha_j + 1e-10), w_i = alpha_i T_i. Writes w to
// w_out when it is given. With RGB, returns (rgb, depth, opacity) in lane 0;
// without, it computes the weights alone and reads no rgb.
template <bool RGB = true>
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
      if constexpr (RGB) {
        op += wi;
        dep += wi * zs[i];
        r0 += wi * rgb[i * 3 + 0];
        r1 += wi * rgb[i * 3 + 1];
        r2 += wi * rgb[i * 3 + 2];
      }
      if (w_out != nullptr) w_out[i] = wi;
    }
  }
  if constexpr (RGB) {
    out[0] = warp_sum(r0);
    out[1] = warp_sum(r1);
    out[2] = warp_sum(r2);
    out[3] = warp_sum(dep);
    out[4] = warp_sum(op);
  }
}

BranchTab to_tab(const int* v) {
  BranchTab t;
  memset(&t, 0, sizeof(t));
  if (v != nullptr) memcpy(t.v, v, sizeof(t.v));
  return t;
}

}  // namespace
