// Two probe kernels for Hopper (sm_90a): what the voxel path's in-kernel
// positional encoding costs, and a trivial kernel to put beside a gather.
//
//   pe_probe_wg_kernel replaces make_kernel (scripts/profile_pe_micro.py:53):
//                      per row of 27 raw channels [xyz 3 | scene voxel 16 |
//                      instance voxel 8], the encoding act(x @ S) by one of
//                      eight modes, the concatenation [x | PE] of 375 columns,
//                      an 8-layer 256-wide ReLU chain without biases, and the
//                      sum of the last layer's row.
//   scale_copy_kernel  replaces dummy_pallas (scripts/profile_voxel_split.py:130):
//                      out = 2 x.
//
// What bounds them. pe_probe: the tensor cores (0.55 M multiply-adds per row
// in the chain against 108 bytes read and 4 written); the question it is
// built to answer is how much the encoding adds on top of the chain.
// scale_copy: bytes (each element read once and written once).
//
// What the design does about it. pe_probe runs on the forward chain's
// building blocks (fused_mlp_wg.cuh): a persistent grid (one block per SM
// walks 128-row tiles), warpgroup 0 the producer (fwd_produce: TMA streams
// the packed trunk through a ring of 16 KB stages, 68 chunks a tile in the
// order of probes.probe_chunks: 12 chunks of 32 K rows of layer 0's (384,
// 256), then 8 of each (256, 256) layer), warpgroups 1 and 2 the consumers
// of 64 rows each, on wgmma m64n256k16 (fwd_gemm), epilogues by stmatrix.
// The encoding is a tensor-core product too: the wrapper packs the mode's
// E = [I_27 | S_mode | 0] (32 x 384, bf16; probes.pack_probe_encoding),
// staged in shared memory once per block, so that bf16(x) @ E gives the raw
// channels exactly (times 1, plus exact zeros) and every encoded column's sum
// in one product; the epilogue applies the mode's activation (sinf, none, or
// the degree-11 polynomial in turns copied from the script) to columns
// 27-374 and stores the row [x | PE | 0] as bf16 into the warpgroup's input
// tile. The product runs in 64-column slices, a slice's 32 accumulators at a
// time, in a loop: one copy of the epilogue's sines in the code, not 192.
// The activations H of layers 1-6 overwrite the input tile's first four
// blocks in place; the last layer is not stored: ReLU, bf16 and the row sum
// from registers, reduced over the four lanes of a row by shuffles.
// scale_copy: one float4 per thread.
//
// Numerics as the plain version: bf16 operands, f32 sums; the activation in
// f32 before its bf16 rounding.

#include "fused_mlp_wg.cuh"

namespace {

constexpr int P_IN = 27;                   // raw channels
constexpr int P_CAT = 375;                 // [x | PE]: 27 + 348 columns
constexpr int P_K0 = 384;                  // layer 0's rows, zero-padded
constexpr int P_ENC_K = 32;                // the encoding's K: the raw channels, padded
constexpr int P_ENC_W = 64;                // columns of one slice of the encoding product
constexpr int P_LAYERS = 8;
constexpr int P_XKB = P_K0 / 64;           // 64-column blocks of the input tile
constexpr int P_RAW = P_XKB - 1;           // the block that holds the raw channels first
constexpr int P_KCH = FWD_STAGE / 2 / WS;  // K rows of a chunk: 32
constexpr int P_CHUNKS = P_K0 / P_KCH + (P_LAYERS - 1) * WS / P_KCH;  // 68 a tile

// the encoding's activation (probes.probe_activation)
enum { ACT_SIN = 0, ACT_NONE = 1, ACT_POLY = 2 };

// Shared memory: the ring, two warpgroups' input tiles X (6 blocks of 8 KB;
// their first four blocks are also the activations H), E (6 boxes of 32
// rows x 64 columns in the 128-byte swizzle, 4 KB apart), the ring's
// barriers; as many stages as that leaves (6).
struct ProbeCfg {
  static constexpr int STAGE = FWD_STAGE;
  static constexpr int XB = P_XKB * 8192;
  static constexpr int EB = P_XKB * P_ENC_K * 128;
  static constexpr int STAGES = (232448 - 2 * XB - EB - 1024) / (FWD_STAGE + 16);
  static constexpr int RING = 0;
  static constexpr int X = RING + STAGES * STAGE;
  static constexpr int E = X + 2 * XB;
  static constexpr int BAR = E + EB;                  // full, empty per stage
  static constexpr int BYTES = BAR + 16 * STAGES + 1024;  // + alignment
  static constexpr int PRODUCERS = STAGES < 4 ? STAGES : 4;  // see FwdCfg
  static_assert(STAGES >= 2, "the ring needs a stage beyond the one in use");
  static_assert(BYTES <= 232448, "pe_probe exceeds a block's shared memory");
  static_assert(X % 1024 == 0 && E % 1024 == 0, "the swizzled tiles need 1024-byte alignment");
};

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

template <int ACT>
__device__ __forceinline__ float enc_act(float u) {
  if constexpr (ACT == ACT_SIN) return sinf(u);
  else if constexpr (ACT == ACT_POLY) return sin_turns(u);
  else return u;
}

// Store the encoding slice at column col0 from its accumulators into the
// warpgroup's input tile (shared address Xs) by stmatrix: a raw channel
// (column < 27) as the product gives it, an encoded column the activation of
// its sum, 0 past column 375.
template <int ACT>
__device__ __forceinline__ void enc_store(const float (&e)[P_ENC_W / 2], uint32_t Xs, int col0) {
  const int c0 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int n8 = 0; n8 < P_ENC_W / 8; n8 += 2) {
    uint32_t q[4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = col0 + 8 * (n8 + u) + c0 + j;
          const float a = e[4 * (n8 + u) + 2 * h + j];
          v[j] = col < P_IN ? a : (col < P_CAT ? enc_act<ACT>(a) : 0.f);
        }
        q[2 * u + h] = pack_bf16(v[0], v[1]);
      }
    store_pairs(Xs, col0 / 8 + n8, q);
  }
}

// ReLU, bf16 and stmatrix of a 256-column layer output into H (shared Hs)
__device__ __forceinline__ void relu_store(const float (&acc)[WS / 2], uint32_t Hs) {
#pragma unroll
  for (int n8 = 0; n8 < WS / 8; n8 += 2) {
    uint32_t q[4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        q[2 * u + h] = pack_bf16(fmaxf(acc[4 * (n8 + u) + 2 * h], 0.f),
                                 fmaxf(acc[4 * (n8 + u) + 2 * h + 1], 0.f));
    store_pairs(Hs, n8, q);
  }
}

// pe_probe over the launch's tiles (see the file comment). x (n_rows, 27)
// f32, enc E (32, 384) bf16 row-major, out (n_rows,) f32; `act` the mode's
// activation (ACT_*), the same for every thread.
__global__ void __launch_bounds__(FWD_THREADS, 1)
pe_probe_wg_kernel(const __grid_constant__ FwdPlan plan, const float* __restrict__ x,
                   const bf16* __restrict__ enc, float* __restrict__ out, int n_rows, int act) {
  using C = ProbeCfg;
  extern __shared__ __align__(1024) unsigned char probe_smem[];
  const uint32_t raw = smem_u32(probe_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle needs 1 KB alignment
  unsigned char* sm = probe_smem + (base - raw);
  const uint32_t full = base + C::BAR, empty = full + 8 * C::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // E into its boxes, 16 bytes a copy: row k of box n / 64 at 128 k, its
  // 16-byte pieces XOR-ed with k % 8
  for (int v = threadIdx.x; v < P_ENC_K * P_K0 / 8; v += FWD_THREADS) {
    const int k = v / (P_K0 / 8), n = (v % (P_K0 / 8)) * 8;
    *reinterpret_cast<uint4*>(sm + C::E + (n >> 6) * (P_ENC_K * 128) + k * 128 +
                              ((((n >> 3) & 7) ^ (k & 7)) << 4)) =
        __ldg(reinterpret_cast<const uint4*>(enc + k * P_K0 + n));
  }
  fence_proxy_async();  // E is complete for the products' reads
  __syncthreads();
  const int n_tiles = (int)(((long long)n_rows + ROWS - 1) / ROWS);

  if (threadIdx.x < 128) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    fwd_produce<C>(plan, n_tiles, base, full, empty);
    return;
  }
  // two consumer warpgroups of 64 rows each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int wg = (threadIdx.x >> 7) - 1, bar = 1 + wg;
  const int tid = threadIdx.x & 127, lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const uint32_t Xs = base + C::X + wg * C::XB, Es = base + C::E;
  unsigned char* Xraw = sm + C::X + wg * C::XB + P_RAW * 8192;
  FwdPipe<C> p{base + C::RING, full, empty, 0, 0};
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long g0 = (long long)tile * ROWS + 64 * wg;
    const int valid = (int)max(0LL, min(64LL, n_rows - g0));
    // the raw channels (64 x 32, zero past 27 channels and the real rows) as
    // bf16 into the last block, all of a thread's loads in flight. The
    // previous tile's last readers of that block (layer 0) are long done.
    float v[16];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = 2 * (tid + 128 * u), r = e >> 5, k = e & 31;
      const float* src = x + (g0 + r) * P_IN + k;
      v[2 * u] = r < valid && k < P_IN ? __ldg(src) : 0.f;
      v[2 * u + 1] = r < valid && k + 1 < P_IN ? __ldg(src + 1) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = 2 * (tid + 128 * u);
      *reinterpret_cast<uint32_t*>(Xraw + swz(e >> 5, e & 31)) = pack_bf16(v[2 * u], v[2 * u + 1]);
    }
    fence_proxy_async();
    wg_bar(bar);  // the raw block is written, and the previous tile's last product has read H
    // the encoding, 64 columns a slice: e = bf16(x) @ E[:, slice], then the
    // activation into X; the last slice overwrites the raw block
    for (int sl = 0; sl < P_K0 / P_ENC_W; ++sl) {
      float e[P_ENC_W / 2];
#pragma unroll
      for (int r = 0; r < P_ENC_W / 2; ++r) e[r] = 0.f;
      fence_acc(e);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < P_ENC_K / 16; ++kk)
        wgmma_kn(e, desc_k(Xs + P_RAW * 8192 + 32 * kk),
                 desc_mn_wide(Es + sl * (P_ENC_W / 64) * (P_ENC_K * 128) + kk * 2048,
                              P_ENC_K * 128));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(e);
      // the slice that overwrites the raw block: every warp's product has read it
      if ((sl + 1) * P_ENC_W > P_RAW * 64) wg_bar(bar);
      if (act == ACT_SIN) enc_store<ACT_SIN>(e, Xs, sl * P_ENC_W);
      else if (act == ACT_POLY) enc_store<ACT_POLY>(e, Xs, sl * P_ENC_W);
      else enc_store<ACT_NONE>(e, Xs, sl * P_ENC_W);
    }
    fence_proxy_async();  // X is complete for layer 0's reads
    wg_bar(bar);
    // the chain: layer 0 reads X, layers 1-7 read H (X's first four blocks)
    float acc[WS / 2];
    for (int i = 0; i < P_LAYERS; ++i) {
#pragma unroll
      for (int r = 0; r < WS / 2; ++r) acc[r] = 0.f;
      if (i == 0) fwd_gemm<C, P_K0>(acc, Xs, p);
      else fwd_gemm<C, WS>(acc, Xs, p);
      if (i == P_LAYERS - 1) break;
      wg_bar(bar);  // every warp's product has read X / H
      relu_store(acc, Xs);
      fence_proxy_async();  // H is complete for the next product's reads
      wg_bar(bar);
    }
    // the last layer: ReLU, bf16 and the sum of each row's 256 values (rows
    // r0 and r0 + 8: this thread's 64 columns, then the row's four lanes)
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int n8 = 0; n8 < WS / 8; ++n8)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 hv = __floats2bfloat162_rn(fmaxf(acc[4 * n8 + 2 * h], 0.f),
                                                        fmaxf(acc[4 * n8 + 2 * h + 1], 0.f));
        s[h] += __low2float(hv) + __high2float(hv);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t = s[h];
      t += __shfl_xor_sync(0xffffffffu, t, 1);
      t += __shfl_xor_sync(0xffffffffu, t, 2);
      const int r = r0 + 8 * h;
      if ((lane & 3) == 0 && r < valid) out[g0 + r] = t;
    }
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

// x (n_rows, 27) f32; enc the mode's E (32, 384) bf16, 16-byte aligned; trunk
// bf16 (probes.pack_probe_trunk): (384, 256) with rows 375.. zero, then 7 x
// (256, 256), all (in, out); wmap_tab and chunks the trunk's weight maps and
// chunk order (probes.probe_weight_maps, probe_chunks: the order the
// consumers read, P_CHUNKS a tile); out (n_rows,) f32; act ACT_*. Returns
// cudaGetLastError().
int onerf_pe_probe(const float* x, const void* enc, const void* trunk, const int* wmap_tab,
                   const int* chunks, int n_chunks, float* out, int n_rows, int act,
                   void* stream) {
  if (n_rows < 0 || act < ACT_SIN || act > ACT_POLY || n_chunks != P_CHUNKS)
    return (int)cudaErrorInvalidValue;
  FwdPlan plan;
  cudaError_t e = (cudaError_t)fwd_plan(trunk, wmap_tab, chunks, n_chunks, &plan);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(pe_probe_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           ProbeCfg::BYTES);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (int)(((long long)n_rows + ROWS - 1) / ROWS), n_sm = sm_count();
  if (n_sm == 0) return (int)cudaErrorNoDevice;
  if (n_tiles == 0) return (int)cudaSuccess;
  pe_probe_wg_kernel<<<min(n_tiles, n_sm), FWD_THREADS, ProbeCfg::BYTES,
                       (cudaStream_t)stream>>>(plan, x, static_cast<const bf16*>(enc), out,
                                               n_rows, act);
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
