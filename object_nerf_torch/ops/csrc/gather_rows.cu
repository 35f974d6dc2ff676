// Row gather and the voxel corner-table lookup for Hopper (sm_90a).
//
//   gather_rows_kernel    replaces dma_gather (scripts/profile_dma_gather.py:39):
//                         out[i, :] = table[idx[i], :], the row fetch of the
//                         voxel corner table, one 384-byte (bf16) or 768-byte
//                         (f32) row of 8 x 24 channels per sample, 0.5 to 1
//                         million random rows per render chunk.
//   corner_lookup_kernel  the whole dense-route trilinear lookup of a corner
//                         table (models/voxel_grid.py: the addressing of
//                         `corner_index_weights`, the row fetch and the f32
//                         8-corner sum) in one launch; on the main path it
//                         takes the place of gather_rows and the torch chain
//                         around it.
//
// gather_rows_kernel. What bounds it: bytes. Every row is read once and
// written once and nothing is computed, so the least time is (2 x rows x row
// bytes + 4 x rows) over the memory rate. The reads are random rows of a table
// that need not fit the 50 MB L2, so what matters is how many row reads are in
// flight. The rows are cut into 16-byte vectors, one thread copies one vector
// (uint4 load through the read-only path, uint4 store), neighbouring threads
// take neighbouring vectors of a row, so a row is read by 24 or 48 consecutive
// lanes in full 32-byte sectors and the output is written fully coalesced.
// Each thread issues UNROLL independent loads before its first store, so a
// block of 256 threads keeps 1024 vector loads in flight, and the grid covers
// the whole index list at once. The TPU kernel's index tile in scalar memory
// and its ring of DMA semaphores have no counterpart: a block reads its own
// indices (each index is read by the lanes of its row through L1). Indices
// must lie in [0, n_table_rows): the wrapper checks them (or its caller clips
// them by construction); the kernel does not.
//
// corner_lookup_kernel. What bounds it: bytes, and the latency of random row
// reads. Per sample it reads 12 bytes of xyz and one corner-table row (8 C
// channels) and writes C f32 sums; the gathered row never reaches device
// memory (the torch chain wrote it, widened it to f32, multiplied it by the
// weights and reduced it: about six times the traffic). Distinct rows are read
// once from device memory at best; a 44 MB bf16 table largely stays in L2.
// Layout: one thread per (sample, 8-channel slice), so C = 24 takes three
// threads a sample. Each thread computes the sample's addressing itself (a few
// dozen f32 and int32 operations, the same ones in the same order as the torch
// chain, so the row index, the weights and the flag are bit-equal to it), then
// issues its 8 corner loads (16 bytes each from a bf16 table, 2 x 16 from an
// f32 one) before the first product, sums the weighted corners in f32 in the
// order of torch's own reduction on the card (so the sums too are bit-equal
// to the chain's there), and writes its 8 sums as two float4 stores:
// neighbouring threads write neighbouring 32-byte pieces of `out`. The thread of slice 0 also writes the sample's `invalid` flag and,
// when asked (a trainable table's backward saves them), its row index and its
// 8 weights. No shape tensor, no host synchronisation: the grid's shape comes
// in as kernel arguments, the voxel offset and size by pointer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G_THREADS = 256;
constexpr int G_UNROLL = 4;

__global__ void __launch_bounds__(G_THREADS)
gather_rows_kernel(const uint4* __restrict__ table, const int* __restrict__ idx,
                   uint4* __restrict__ out, long long n_vec, int row_vecs) {
  const long long base = (long long)blockIdx.x * (G_THREADS * G_UNROLL) + threadIdx.x;
  uint4 v[G_UNROLL];
#pragma unroll
  for (int u = 0; u < G_UNROLL; ++u) {
    const long long t = base + (long long)u * G_THREADS;
    if (t < n_vec) {
      const long long row = t / row_vecs;
      const int vec = (int)(t - row * row_vecs);
      v[u] = __ldg(table + (long long)__ldg(idx + row) * row_vecs + vec);
    }
  }
#pragma unroll
  for (int u = 0; u < G_UNROLL; ++u) {
    const long long t = base + (long long)u * G_THREADS;
    if (t < n_vec) out[t] = v[u];
  }
}

constexpr int L_THREADS = 256;

// 8 channels of a corner block as f32: one 16-byte load of bf16, two of f32.
template <typename T> struct CornerSlice;

template <> struct CornerSlice<uint16_t> {  // bf16 bits
  uint4 v;
  __device__ __forceinline__ void load(const uint16_t* p) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ float at(int j) const {
    const unsigned w = j < 2 ? v.x : j < 4 ? v.y : j < 6 ? v.z : v.w;
    return __uint_as_float((j & 1 ? w >> 16 : w & 0xffffu) << 16);  // exact widening
  }
};

template <> struct CornerSlice<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ float at(int j) const {
    const float4& h = j < 4 ? a : b;
    const int k = j & 3;
    return k == 0 ? h.x : k == 1 ? h.y : k == 2 ? h.z : h.w;
  }
};

// `corner_index_weights` (ops/gather.py) for one sample, operation by
// operation: xyz_scaled = (xyz + offset) / size (IEEE division), base =
// floor, q0 = int32(base) (cvt.rzi: saturating, as torch's cast on the card),
// valid = all(-1 <= q0 <= shape - 1), pb = min(max(q0 + 1, 0), shape) (the
// int32 add wraps, as torch's), the fractions xyz_scaled - base; then the 8
// weights of `_trilinear_weights` in _CORNERS order, each times 1 or 0.
__device__ __forceinline__ void corner_addressing(
    const float* __restrict__ xyz, const float* __restrict__ voxel_offset,
    const float* __restrict__ voxel_size, unsigned i, int gx, int gy, int gz,
    int& flat, float (&wt)[8], bool& valid) {
  const float vs = __ldg(voxel_size);
  const int dims[3] = {gx, gy, gz};
  float frac[3];
  int pb[3];
  valid = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float x = __ldg(xyz + 3 * (long long)i + d);
    const float xs = __fdiv_rn(__fadd_rn(x, __ldg(voxel_offset + d)), vs);
    const float base = floorf(xs);
    const int q0 = __float2int_rz(base);
    valid = valid && q0 >= -1 && q0 <= dims[d] - 1;
    pb[d] = min(max((int)((unsigned)q0 + 1u), 0), dims[d]);
    frac[d] = __fsub_rn(xs, base);
  }
  flat = (pb[0] * (gy + 1) + pb[1]) * (gz + 1) + pb[2];
  const float u = frac[0], v = frac[1], w = frac[2];
  const float lu = __fsub_rn(1.0f, u), lv = __fsub_rn(1.0f, v), lw = __fsub_rn(1.0f, w);
  const float uv[4] = {__fmul_rn(lu, lv), __fmul_rn(lu, v), __fmul_rn(u, lv), __fmul_rn(u, v)};
  const float m = valid ? 1.0f : 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    wt[2 * k] = __fmul_rn(__fmul_rn(uv[k], lw), m);
    wt[2 * k + 1] = __fmul_rn(__fmul_rn(uv[k], w), m);
  }
}

template <typename T>
__global__ void __launch_bounds__(L_THREADS)
corner_lookup_kernel(const T* __restrict__ ct, const float* __restrict__ xyz,
                     const float* __restrict__ voxel_offset,
                     const float* __restrict__ voxel_size, float* __restrict__ out,
                     unsigned char* __restrict__ invalid, int* __restrict__ flat_out,
                     float* __restrict__ wts_out, unsigned n_threads, int channels,
                     int gx, int gy, int gz) {
  const unsigned t = blockIdx.x * L_THREADS + threadIdx.x;
  if (t >= n_threads) return;
  const unsigned slices = (unsigned)channels / 8;
  const unsigned i = t / slices;
  const int s = (int)(t - i * slices);
  int flat;
  float wt[8];
  bool valid;
  corner_addressing(xyz, voxel_offset, voxel_size, i, gx, gy, gz, flat, wt, valid);

  const T* row = ct + (long long)flat * 8 * channels + 8 * s;
  CornerSlice<T> c[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) c[k].load(row + k * channels);  // all 8 in flight
  // The 8 products summed as ATen's reduction over the corner axis of an
  // (N, 8, C) f32 tensor sums them on the card (four accumulators from +0,
  // corners k and k + 4 into the k-th, then combined in order), so `out` is
  // bit-equal to the plain chain there. ATen does not promise that order:
  // any order stays within 1e-6 of the terms' magnitude, which the tests
  // hold first. No fused multiply-add.
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float part[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      part[k] = __fadd_rn(__fadd_rn(0.0f, __fmul_rn(c[k].at(j), wt[k])),
                          __fmul_rn(c[k + 4].at(j), wt[k + 4]));
    acc[j] = __fadd_rn(__fadd_rn(__fadd_rn(part[0], part[1]), part[2]), part[3]);
  }
  float4* o = reinterpret_cast<float4*>(out + (long long)i * channels + 8 * s);
  o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);

  if (s == 0) {
    invalid[i] = valid ? 0 : 1;
    if (flat_out) flat_out[i] = flat;
    if (wts_out) {
      float4* w4 = reinterpret_cast<float4*>(wts_out + 8 * (long long)i);
      w4[0] = make_float4(wt[0], wt[1], wt[2], wt[3]);
      w4[1] = make_float4(wt[4], wt[5], wt[6], wt[7]);
    }
  }
}

}  // namespace

extern "C" {

// table (R, row_bytes) and out (n_idx, row_bytes) as raw bytes, row_bytes a
// multiple of 16, both 16-byte aligned. Returns cudaGetLastError().
int onerf_gather_rows(const void* table, const int* idx, void* out, long long n_idx,
                      int row_bytes, void* stream) {
  const int row_vecs = row_bytes / 16;
  const long long n_vec = n_idx * row_vecs;
  const long long per_block = G_THREADS * G_UNROLL;
  const long long blocks = (n_vec + per_block - 1) / per_block;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  gather_rows_kernel<<<(unsigned)blocks, G_THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(table), idx, static_cast<uint4*>(out), n_vec, row_vecs);
  return (int)cudaGetLastError();
}

// The dense-route lookup of n samples: ct ((gx+1)(gy+1)(gz+1), 8 channels),
// bf16 (ct_bf16 = 1) or f32, 16-byte aligned; xyz (n, 3), voxel_offset (3,),
// voxel_size () f32 on the device; out (n, channels) f32 and invalid (n,)
// bytes always, flat (n,) int32 and wts (n, 8) f32 where not null; channels a
// multiple of 8 and n x channels / 8 under 2^32. Returns cudaGetLastError().
int onerf_corner_lookup(const void* ct, int ct_bf16, const float* xyz, const float* voxel_offset,
                        const float* voxel_size, float* out, unsigned char* invalid, int* flat,
                        float* wts, long long n, int channels, int gx, int gy, int gz,
                        void* stream) {
  if (channels <= 0 || channels % 8) return (int)cudaErrorInvalidValue;
  const long long n_threads = n * (channels / 8);
  if (n_threads >= (1LL << 32) - L_THREADS) return (int)cudaErrorInvalidConfiguration;
  if (n_threads == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((n_threads + L_THREADS - 1) / L_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  if (ct_bf16)
    corner_lookup_kernel<uint16_t><<<blocks, L_THREADS, 0, st>>>(
        static_cast<const uint16_t*>(ct), xyz, voxel_offset, voxel_size, out, invalid, flat, wts,
        (unsigned)n_threads, channels, gx, gy, gz);
  else
    corner_lookup_kernel<float><<<blocks, L_THREADS, 0, st>>>(
        static_cast<const float*>(ct), xyz, voxel_offset, voxel_size, out, invalid, flat, wts,
        (unsigned)n_threads, channels, gx, gy, gz);
  return (int)cudaGetLastError();
}

}  // extern "C"
