// EmbeddingBag (gather rows, scale each by its weight, sum per bag) for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/embedding_bag/embedding_bag.py::
// embedding_bag_pallas (body _embag_kernel). There, scalar prefetch drives
// one table-row DMA per grid step, and the bag's sum is carried across the
// sequential grid in the revisited output block. This kernel computes the
// same out[b] = sum over i with segments[i] == b of weights[i] * table[ids[i]],
// with empty bags as zeros.
//
// What bounds it on the H100: bytes. Each id reads one D-float row at a
// random place in the table (a whole 1 KiB row at D = 256, so the reads
// are full sectors), and each bag writes one row; there is one multiply and
// one add per 4 bytes gathered.
//
// Design: nothing carries between blocks on the card, so the work is split
// by bag instead of by id. A first pass turns the sorted segments into bag
// offsets (one thread per id boundary writes the offsets of the bags that
// start there: O(ids + bags), no search). The second pass gives each bag one
// warp. Lanes stride over the row in float4s (scalars when D is not a
// multiple of 4) and loop over the bag's ids in order, each row scaled and
// added with separate roundings (__fmul_rn, __fadd_rn), as the reference's
// `rows * w` followed by its sequential sum rounds them. There are no atomics,
// so the sums are the same bits on every run. Flat offsets are 64-bit: the
// 2^23-row, 256-wide tables hold 2^31 floats, one past INT32_MAX.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr int64_t kMaxBlocks = 4096;

// offsets[b] = the first i with segments[i] >= b, for b in [0, num_bags]
// (segments sorted non-decreasing). Thread i in [0, n] writes the offsets of
// the bags b with segments[i - 1] < b <= segments[i], clipped to [0, num_bags];
// i == n stands for +infinity, i - 1 == -1 for -infinity.
__global__ void __launch_bounds__(kThreads) bag_offsets_kernel(
    const int32_t* __restrict__ segs, int64_t n, int64_t num_bags, int64_t* __restrict__ offsets) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i <= n;
       i += stride) {
    int64_t lo = i == 0 ? 0 : static_cast<int64_t>(__ldg(segs + i - 1)) + 1;
    int64_t hi = i == n ? num_bags : static_cast<int64_t>(__ldg(segs + i));
    if (lo < 0) lo = 0;
    if (hi > num_bags) hi = num_bags;
    for (int64_t b = lo; b <= hi; ++b) offsets[b] = i;
  }
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float4 load(const float4* p) { return __ldg(p); }

__device__ __forceinline__ void add_scaled(float& acc, float w, float v) {
  acc = __fadd_rn(acc, __fmul_rn(w, v));
}
__device__ __forceinline__ void add_scaled(float4& acc, float w, float4 v) {
  add_scaled(acc.x, w, v.x);
  add_scaled(acc.y, w, v.y);
  add_scaled(acc.z, w, v.z);
  add_scaled(acc.w, w, v.w);
}

// Vec is float4 (D a multiple of 4, 16 B aligned rows) or float.
template <typename Vec>
__global__ void __launch_bounds__(kThreads) embedding_bag_kernel(
    const Vec* __restrict__ table, int64_t row_vecs, const int32_t* __restrict__ ids,
    const float* __restrict__ weights, const int64_t* __restrict__ offsets, Vec* __restrict__ out,
    int64_t num_bags) {
  const int64_t bag = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (bag >= num_bags) return;
  const int lane = threadIdx.x % kWarp;
  const int64_t begin = __ldg(offsets + bag);
  const int64_t end = __ldg(offsets + bag + 1);
  Vec* dst = out + bag * row_vecs;
  for (int64_t col = lane; col < row_vecs; col += kWarp) {
    Vec acc{};
#pragma unroll 4
    for (int64_t i = begin; i < end; ++i) {
      const int64_t id = __ldg(ids + i);
      const float w = weights != nullptr ? __ldg(weights + i) : 1.f;
      add_scaled(acc, w, load(table + id * row_vecs + col));
    }
    dst[col] = acc;
  }
}

}  // namespace

// out[num_bags, D] (float32) = per-bag weighted sums of table[V, D] rows.
// ids and segments are int32 [n], segments sorted non-decreasing (ids past
// num_bags or negative fall in no bag), ids in [0, V); weights is float32 [n]
// or null for all ones; offsets is int64 [num_bags + 1] scratch. Launches two
// kernels on `stream`; returns cudaGetLastError().
extern "C" int embedding_bag(const void* table, int64_t D, const void* ids, const void* segments,
                             const void* weights, int64_t n, void* offsets, void* out,
                             int64_t num_bags, void* stream) {
  if (num_bags <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t blocks = (n + 1 + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  bag_offsets_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const int32_t*>(segments), n, num_bags, static_cast<int64_t*>(offsets));
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || D <= 0) return err;
  const unsigned bag_blocks = static_cast<unsigned>((num_bags + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const bool vec4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int32_t* id = static_cast<const int32_t*>(ids);
  const float* w = static_cast<const float*>(weights);
  const int64_t* off = static_cast<const int64_t*>(offsets);
  if (vec4) {
    embedding_bag_kernel<float4><<<bag_blocks, kThreads, 0, st>>>(
        static_cast<const float4*>(table), D / 4, id, w, off, static_cast<float4*>(out), num_bags);
  } else {
    embedding_bag_kernel<float><<<bag_blocks, kThreads, 0, st>>>(
        static_cast<const float*>(table), D, id, w, off, static_cast<float*>(out), num_bags);
  }
  return static_cast<int>(cudaGetLastError());
}
