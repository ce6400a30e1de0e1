// Ragged dst-tiled SpMV for PageRank-pull aggregation and BFS frontier
// expansion, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/spmv/spmv.py::spmv_pallas (body _spmv_kernel).
// That kernel sums contrib[src(e)] for every target of a 512-target tile with
// a one-hot matmul over the tile's edge chunk, each chunk padded to the
// fullest tile's edge count. This kernel computes the same per-target sums,
// rows past the last vertex included (they come out 0).
//
// What bounds it on the H100: bytes, and how many gathers are in flight. Per
// edge it reads one 4 B source id (coalesced) and gathers one 4 B
// contribution (random: a 32 B sector out of the 50 MB L2, which holds the
// 4 MiB vector of a 2^20-vertex graph); per row one 8 B offset and one 4 B
// store. There is one add per 8 bytes moved.
//
// Design: the ragged layout (edges stably sorted by target, int64 row
// offsets, int32 source ids) keeps work and memory O(E + V). On an RMAT
// graph half the rows are empty and a few hold tens of thousands of edges,
// so work is cut by edges, not rows: kernels/spmv/ops.py::build_tiles groups
// consecutive rows of one 512-row tile into blocks of at most kBlockEdges
// edges, and cuts each row longer than that into pieces of kBlockEdges. One
// CTA takes one block. It loads the block's source ids (streaming, evict
// first) and gathers their contributions into shared memory, every thread
// with kBlockEdges / kBlock loads in flight; then it sums each row from
// shared memory in edge order, a thread per row of up to 32 edges and a warp
// per longer row. Empty rows cost one store of 0. A CTA on a piece of a long
// row sums it in a fixed order into a partial; the last of the row's CTAs to
// finish (an integer counter) adds the row's partials in piece order and
// resets the counter. No floating-point atomics anywhere: the same inputs
// give the same bits on every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kBlock = 256;
constexpr int kWarpsPerBlock = kBlock / kWarp;
// edges per row block and per piece of a long row; equals BLOCK_EDGES in
// kernels/spmv/spmv.py, by which the host cuts the rows. 1024 from an A/B
// over 512 to 4096: most of the graph path's launches cover 2-8 tiles,
// where smaller blocks keep more SMs busy (3.9 us against 7.2 at 4096 on
// an H100), for 5% on a full sweep.
constexpr int kBlockEdges = 1024;
constexpr int kPerThread = kBlockEdges / kBlock;
constexpr int kTileRows = 512;  // DST_TILE: a block never crosses a tile

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Source ids are read once: stream them with the evict-first hint
// (ld.global.cs) so they do not push the contributions out of L2.
__device__ __forceinline__ int32_t load_streaming(const int32_t* p) { return __ldcs(p); }

// contrib[src[e0 + t]] for t = threadIdx.x + u * kBlock < n, all loads of a
// thread issued before any is used.
__device__ __forceinline__ void gather(const int32_t* __restrict__ src, int64_t e0, int n,
                                       const float* __restrict__ contrib, float (&v)[kPerThread]) {
  int32_t s[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int t = threadIdx.x + u * kBlock;
    s[u] = t < n ? load_streaming(src + e0 + t) : 0;
  }
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int t = threadIdx.x + u * kBlock;
    v[u] = t < n ? __ldg(contrib + s[u]) : 0.f;
  }
}

// Block b (of this launch) covers rows [block_row[b], block_row[b + 1]) when
// block_piece[b] < 0; else it is piece k = block_piece[b] of the one row
// block_row[b], the edges [row_ptr[r] + k * kBlockEdges, ...). Rows are the
// table's, out[r - row_base] is row r's sum. partials and counters hold a
// slot per block (a counter per long row, at its first piece's slot; zero
// between launches).
__global__ void __launch_bounds__(kBlock) spmv_blocks_kernel(
    const int64_t* __restrict__ row_ptr, const int32_t* __restrict__ src,
    const float* __restrict__ contrib, float* __restrict__ out,
    const int32_t* __restrict__ block_row, const int32_t* __restrict__ block_piece,
    float* __restrict__ partials, int32_t* __restrict__ counters, int64_t row_base) {
  __shared__ float vals[kBlockEdges];
  __shared__ int32_t rp[kTileRows + 1];
  __shared__ float warp_part[kWarpsPerBlock];
  const int b = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int64_t r0 = block_row[b];
  const int k = block_piece[b];
  float v[kPerThread];

  if (k < 0) {  // a block of whole rows, at most kBlockEdges edges
    const int nr = static_cast<int>(block_row[b + 1] - r0);
    const int64_t e0 = row_ptr[r0];
    const int n = static_cast<int>(row_ptr[r0 + nr] - e0);
    if (nr > kTileRows || n > kBlockEdges) __trap();  // a layout built for another source
    // the rows' offsets load beside the source ids, not before them
    constexpr int kRowSlots = (kTileRows + kBlock) / kBlock;
    int64_t offs[kRowSlots];
#pragma unroll
    for (int q = 0; q < kRowSlots; ++q) {
      const int j = threadIdx.x + q * kBlock;
      offs[q] = j <= nr ? row_ptr[r0 + j] : 0;
    }
    gather(src, e0, n, contrib, v);
#pragma unroll
    for (int q = 0; q < kRowSlots; ++q) {
      const int j = threadIdx.x + q * kBlock;
      if (j <= nr) rp[j] = static_cast<int32_t>(offs[q] - e0);
    }
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int t = threadIdx.x + u * kBlock;
      if (t < n) vals[t] = v[u];
    }
    __syncthreads();
    for (int j = threadIdx.x; j < nr; j += kBlock) {
      const int a = rp[j], e = rp[j + 1];
      if (e - a > kWarp) continue;  // a warp takes it below
      float acc = 0.f;
      for (int i = a; i < e; ++i) acc += vals[i];
      out[r0 + j - row_base] = acc;
    }
    for (int j = warp; j < nr; j += kWarpsPerBlock) {
      const int a = rp[j], e = rp[j + 1];
      if (e - a <= kWarp) continue;
      float acc = 0.f;
      for (int i = a + lane; i < e; i += kWarp) acc += vals[i];
      acc = warp_sum(acc);
      if (lane == 0) out[r0 + j - row_base] = acc;
    }
    return;
  }

  // piece k of the long row r0
  const int64_t base = row_ptr[r0], row_end = row_ptr[r0 + 1];
  const int64_t e0 = base + static_cast<int64_t>(k) * kBlockEdges;
  const int n = static_cast<int>(row_end - e0 < kBlockEdges ? row_end - e0 : kBlockEdges);
  gather(src, e0, n, contrib, v);
  float acc = 0.f;
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) acc += v[u];
  acc = warp_sum(acc);
  if (lane == 0) warp_part[warp] = acc;
  __syncthreads();
  if (threadIdx.x != 0) return;
  float piece = 0.f;
  for (int w = 0; w < kWarpsPerBlock; ++w) piece += warp_part[w];
  const int first = b - k;
  const int pieces = static_cast<int>((row_end - base + kBlockEdges - 1) / kBlockEdges);
  partials[b] = piece;
  __threadfence();  // the partial is visible before the count says so
  if (atomicAdd(counters + first, 1) != pieces - 1) return;
  __threadfence();
  float total = 0.f;
  for (int q = 0; q < pieces; ++q) total += __ldcg(partials + first + q);
  out[r0 - row_base] = total;
  counters[first] = 0;  // ready for the next launch on this stream
}

// Reads src[0, n) and gathers contrib at each as the row blocks do (a CTA
// per kBlockEdges edges, the same loads in flight), and nothing else: the
// floor that the layout's gathers set. One float per warp goes to out so
// the loads stay.
__global__ void __launch_bounds__(kBlock) gather_probe_kernel(
    const int32_t* __restrict__ src, int64_t n, const float* __restrict__ contrib,
    float* __restrict__ out) {
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * kBlockEdges;
  const int m = static_cast<int>(n - e0 < kBlockEdges ? n - e0 : kBlockEdges);
  float v[kPerThread];
  gather(src, e0, m, contrib, v);
  float acc = 0.f;
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) acc += v[u];
  acc = warp_sum(acc);
  if (threadIdx.x % kWarp == 0) out[static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp] = acc;
}

}  // namespace

// out[r - row_base] = sum of contrib[src[i]] for i in [row_ptr[r],
// row_ptr[r+1]), for the rows r of blocks [block_lo, block_hi) of the layout
// (block_row int32 [NB + 1], block_piece int32 [NB]; scratch holds NB floats
// of partials, then NB int32 counters, all zero before the first launch).
// Launches one kernel on `stream`; returns cudaGetLastError().
extern "C" int spmv_blocks(const void* row_ptr, const void* src, const void* contrib, void* out,
                           const void* block_row, const void* block_piece, void* scratch,
                           int64_t n_blocks, int64_t block_lo, int64_t block_hi, int64_t row_base,
                           void* stream) {
  if (block_hi > block_lo) {
    float* partials = static_cast<float*>(scratch);
    int32_t* counters = reinterpret_cast<int32_t*>(partials + n_blocks);
    spmv_blocks_kernel<<<static_cast<unsigned>(block_hi - block_lo), kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(row_ptr), static_cast<const int32_t*>(src),
        static_cast<const float*>(contrib), static_cast<float*>(out),
        static_cast<const int32_t*>(block_row) + block_lo,
        static_cast<const int32_t*>(block_piece) + block_lo, partials + block_lo,
        counters + block_lo, row_base);
  }
  return static_cast<int>(cudaGetLastError());
}

// The gather probe over src[0, n): out holds ceil(n / kBlockEdges) * 8
// floats.
extern "C" int spmv_gather_probe(const void* src, int64_t n, const void* contrib, void* out,
                                 void* stream) {
  const int64_t blocks = (n + kBlockEdges - 1) / kBlockEdges;
  if (blocks > 0) {
    gather_probe_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(src), n, static_cast<const float*>(contrib),
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
