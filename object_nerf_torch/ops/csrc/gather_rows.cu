// Row gather for Hopper (sm_90a): out[i, :] = table[idx[i], :].
//
//   gather_rows_kernel  replaces dma_gather (scripts/profile_dma_gather.py:39):
//                       the row fetch of the voxel corner table, one 384-byte
//                       (bf16) or 768-byte (f32) row of 8 x 24 channels per
//                       sample, 0.5 to 1 million random rows per render chunk.
//
// What bounds it: bytes. Every row is read once and written once and nothing
// is computed, so the least time is (2 x rows x row bytes + 4 x rows) over
// the memory rate. The reads are random rows of a table that need not fit the
// 50 MB L2, so what matters is how many row reads are in flight.
//
// What the design does about it (the simple first version): the rows are cut
// into 16-byte vectors, one thread copies one vector (uint4 load through the
// read-only path, uint4 store), neighbouring threads take neighbouring
// vectors of a row, so a row is read by 24 or 48 consecutive lanes in full
// 32-byte sectors and the output is written fully coalesced. Each thread
// issues UNROLL independent loads before its first store, so a block of 256
// threads keeps 1024 vector loads in flight, and the grid covers the whole
// index list at once. The TPU kernel's index tile in scalar memory and its
// ring of DMA semaphores have no counterpart: a block reads its own indices
// (each index is read by the lanes of its row through L1). Left for later
// work: cp.async / TMA gather into shared memory, and fusing the trilinear
// 8-corner sum so that the gathered rows never reach device memory.
//
// Indices must lie in [0, n_table_rows): the wrapper checks them (or its
// caller clips them by construction); the kernel does not.

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

}  // extern "C"
