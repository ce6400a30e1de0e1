// Ragged dst-tiled SpMV for PageRank-pull aggregation and BFS frontier
// expansion, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/spmv/spmv.py::spmv_pallas (body _spmv_kernel).
// That kernel sums contrib[src(e)] for every target of a 512-target tile with
// a one-hot matmul over the tile's edge chunk, each chunk padded to the
// fullest tile's edge count. This kernel computes the same per-target sums,
// rows past the last vertex included (they come out 0).
//
// What bounds it on the H100: bytes. Per edge it reads one 4 B source id
// (coalesced) and gathers one 4 B contribution (random, mostly served by the
// 50 MB L2, which holds the 4 MiB vector of a 2^20-vertex graph); per row one
// 8 B offset and one 4 B store. There is one add per 8 bytes moved.
//
// Design: the ragged layout (edges stably sorted by target, int64 row
// offsets, int32 source ids) keeps work and memory O(E + V) where the padded
// chunk tables grow to ~10x the edge count on RMAT graphs. One warp per row:
// lanes stride over the row's edges, a shuffle reduction in a fixed order
// sums them, lane 0 stores once. Rows longer than kLongRow edges (RMAT hubs
// with tens of thousands of in-edges) would serialize one warp, so the host
// lists them and each gets a whole block, reduced through shared memory in a
// fixed order. No floating-point atomics anywhere: the same inputs give the
// same bits on every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kBlock = 256;
constexpr int kWarpsPerBlock = kBlock / kWarp;
// rows with more edges get a whole block; equals LONG_ROW in kernels/spmv/spmv.py,
// by which the host lists them
constexpr int64_t kLongRow = 4096;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Blocks [0, n_warp_blocks) give one warp to each row (skipping long rows);
// blocks after that give one block to each listed long row.
__global__ void __launch_bounds__(kBlock) spmv_rows_kernel(
    const int64_t* __restrict__ row_ptr, int64_t n_rows,
    const int32_t* __restrict__ src, const float* __restrict__ contrib,
    float* __restrict__ out, const int32_t* __restrict__ long_rows,
    int64_t row_base, int64_t n_warp_blocks) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  if (blockIdx.x < n_warp_blocks) {
    const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
    if (row >= n_rows) return;                  // uniform across the warp
    const int64_t b = row_ptr[row], e = row_ptr[row + 1];
    if (e - b > kLongRow) return;               // a whole block takes it below
    float acc = 0.f;
#pragma unroll 4
    for (int64_t i = b + lane; i < e; i += kWarp) acc += __ldg(contrib + __ldg(src + i));
    acc = warp_sum(acc);
    if (lane == 0) out[row] = acc;
    return;
  }
  __shared__ float partial[kWarpsPerBlock];
  const int64_t row = static_cast<int64_t>(long_rows[blockIdx.x - n_warp_blocks]) - row_base;
  const int64_t b = row_ptr[row], e = row_ptr[row + 1];
  float acc = 0.f;
#pragma unroll 4
  for (int64_t i = b + threadIdx.x; i < e; i += kBlock) acc += __ldg(contrib + __ldg(src + i));
  acc = warp_sum(acc);
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kWarpsPerBlock; ++w) total += partial[w];
    out[row] = total;
  }
}

}  // namespace

// out[r] = sum of contrib[src[i]] for i in [row_ptr[r], row_ptr[r+1]), for
// r in [0, n_rows). row_ptr holds n_rows + 1 offsets into src. long_rows
// lists (as row_base + r, ascending) exactly the rows with more than
// kLongRow edges. Launches on `stream`; returns cudaGetLastError().
extern "C" int spmv_rows(const void* row_ptr, int64_t n_rows, const void* src,
                         const void* contrib, void* out, const void* long_rows,
                         int64_t n_long, int64_t row_base, void* stream) {
  const int64_t n_warp_blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t grid = n_warp_blocks + n_long;
  if (grid > 0) {
    spmv_rows_kernel<<<static_cast<unsigned>(grid), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(row_ptr), n_rows, static_cast<const int32_t*>(src),
        static_cast<const float*>(contrib), static_cast<float*>(out),
        static_cast<const int32_t*>(long_rows), row_base, n_warp_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
