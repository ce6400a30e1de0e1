// Degree count (vertex-id histogram, the paper's §5.1 calibration algorithm)
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/degree_count/degree_count.py::degree_count_pallas
// (body _degree_count_kernel), which counts ids already reduced mod the
// counter-array size with one-hot compare tiles, -1 never counted. This
// kernel computes the same exact int32 histogram.
//
// What bounds it on the H100: bytes. Each id is read once (4 B, coalesced)
// and becomes one int32 atomic increment on the counter array, which at
// 2^20 counters (4 MiB) stays resident in the 50 MB L2.
//
// Design: one thread per id in a grid-stride loop, int32 atomicAdd straight
// into the global counters. The counter array is larger than a block's
// shared memory, so this simple form skips privatisation; integer atomics
// are exact, so the result is the same on every run. The kernel adds into a
// caller-zeroed output, so several launches (the gang-width slices of one
// range) accumulate into one tensor on the device. Ids outside
// [0, num_counters) — the -1 padding — are skipped.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int64_t kMaxBlocks = 4096;

__global__ void __launch_bounds__(kBlock) degree_count_kernel(
    const int32_t* __restrict__ ids, int64_t n, int64_t rows, int64_t row_stride,
    int32_t* __restrict__ counts, int32_t num_counters) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kBlock;
  for (int64_t r = 0; r < rows; ++r) {
    const int32_t* row = ids + r * row_stride;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x; i < n;
         i += stride) {
      const int32_t id = __ldg(row + i);
      if (static_cast<uint32_t>(id) < static_cast<uint32_t>(num_counters)) {
        atomicAdd(counts + id, 1);
      }
    }
  }
}

}  // namespace

// counts[id] += 1 for every id of rows [0, rows) of `ids` (row r starts at
// ids + r * row_stride and holds n ids) with 0 <= id < num_counters.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int degree_count(const void* ids, int64_t n, int64_t rows, int64_t row_stride,
                            void* counts, int32_t num_counters, void* stream) {
  if (n > 0 && rows > 0) {
    int64_t blocks = (n + kBlock - 1) / kBlock;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    degree_count_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(ids), n, rows, row_stride,
        static_cast<int32_t*>(counts), num_counters);
  }
  return static_cast<int>(cudaGetLastError());
}
