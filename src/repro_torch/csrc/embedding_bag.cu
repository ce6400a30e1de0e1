// EmbeddingBag (gather rows, scale each by its weight, sum per bag) for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/embedding_bag/embedding_bag.py::
// embedding_bag_pallas (body _embag_kernel). There, scalar prefetch drives
// one table-row DMA per grid step, and the bag's sum is carried across the
// sequential grid in the revisited output block. This kernel computes the
// same out[b] = sum over i with segments[i] == b of weights[i] * table[ids[i]],
// with empty bags as zeros; ids whose segment lies outside [0, num_bags)
// fall in no bag. Ids follow jnp.take's rule, the reference's gather: an id
// in [-V, 0) reads row id + V, and any other id outside [0, V) reads a row
// of NaN, so its bag comes out NaN (whatever its weight), as the
// reference's NaN fill does. Each thread checks each id it loads: one
// compare and select, no host sync.
//
// What bounds it on the H100: bytes, and the latency of reaching them. Each
// id reads one D-float row at a random place in the table (a whole 1 KiB
// row at D = 256, so the reads are full sectors), and each bag writes one
// row; there is one multiply and one add per 4 bytes gathered. With short
// bags (32 ids) and few of them (a batch of 512) the card holds little work,
// so what counts is how many row loads each thread keeps in flight.
//
// Design: one launch, no scratch. A group of threads takes one bag, a
// thread per column (float4s when D is a multiple of 4 and the rows are 16 B
// aligned, else scalars): 64 threads a bag at D = 256, or, once the bags
// alone give every SM 64 warps, one warp a bag whose lanes stride over the
// columns (fewer searches, more warps resident). The group finds its bag's
// ids by a lower-bound search of the sorted segments for b and b + 1, each
// round probing as many places as the group has lanes (up to 32). The first
// round probes consecutive places around where the key would sit if every
// bag held n / num_bags ids, as the towers' fixed multi-hot bags do (one
// window for both keys when a bag averages at most half a window): there one
// coalesced load ends the search; elsewhere it bounds one side, and a search
// of 2^23 ids takes at most 5 more rounds. Then each thread walks its bag's
// ids (the same addresses across the group, so one broadcast per warp),
// unrolled kUnroll times so that kUnroll row loads are in flight before
// their adds, and adds the rows in id order, each scaled and added with
// separate roundings (__fmul_rn, __fadd_rn), as the reference's `rows * w`
// followed by its sequential sum rounds them. The sums are the bits of the
// earlier two-launch warp-per-bag kernel, and the same on every run: no
// atomics. At 2^20 bags of 8 ids the rate follows the warps resident per
// SM, so registers count: positions are 32-bit (the host refuses more ids),
// and five search rounds a bag, or 16 row loads in flight, made that shape
// up to six times slower than the two-launch kernel. Flat row offsets are
// 64-bit: the 2^23-row, 256-wide tables hold 2^31 floats, one past
// INT32_MAX.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // row loads in flight per thread (A/B: 2, 4, 8, 16, 32)

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float4 load(const float4* p) { return __ldg(p); }

__device__ __forceinline__ float nan_of(float) { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ float4 nan_of(float4) {
  const float q = __int_as_float(0x7fc00000);
  return make_float4(q, q, q, q);
}

__device__ __forceinline__ void add_scaled(float& acc, float w, float v) {
  acc = __fadd_rn(acc, __fmul_rn(w, v));
}
__device__ __forceinline__ void add_scaled(float4& acc, float w, float4 v) {
  add_scaled(acc.x, w, v.x);
  add_scaled(acc.y, w, v.y);
  add_scaled(acc.z, w, v.z);
  add_scaled(acc.w, w, v.w);
}

// The lanes [base, base + width) of a warp (width a power of two <= 32)
// find together, for two keys, the first i in [0, n) with segs[i] >= key
// (n if none). The first round probes `width` consecutive places around
// key * n / num_bags (one window for both keys when a bag averages at most
// width / 2 ids): the count below the key is the answer if it falls inside,
// else it bounds one side. Each later round a lane probes one place
// per key, evenly spread over what is left; the count of places below the
// key narrows it to one gap. Every lane of the group returns the same pair.
// Positions are 32-bit (the host refuses n > INT32_MAX): fewer registers.
__device__ __forceinline__ void lower_bounds(const int32_t* __restrict__ segs, int n, int num_bags,
                                             int key_a, int key_b, int width,
                                             unsigned group_mask, int& out_a, int& out_b) {
  const int j = threadIdx.x % kWarp % width;
  const int shift = threadIdx.x % kWarp - j;
  const int key[2] = {key_a, key_b};
  int lo[2], hi[2];
  bool below[2];
  int w0[2], w1[2];
  const int per_bag = n / num_bags;
  if (2 * per_bag <= width) {  // one window holds both bounds: one load a lane
    int start = static_cast<int>(static_cast<int64_t>(key_a) * n / num_bags) - (width - per_bag) / 2;
    if (start > n - width) start = n - width;
    if (start < 0) start = 0;
    w0[0] = w0[1] = start;
    w1[0] = w1[1] = start + width < n ? start + width : n;
    const int v = start + j < w1[0] ? __ldg(segs + start + j) : INT32_MAX;
    below[0] = start + j < w1[0] && v < key_a;
    below[1] = start + j < w1[0] && v < key_b;
  } else {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      int start = static_cast<int>(static_cast<int64_t>(key[s]) * n / num_bags) - width / 2;
      if (start > n - width) start = n - width;
      if (start < 0) start = 0;
      w0[s] = start;
      w1[s] = start + width < n ? start + width : n;
      below[s] = w0[s] + j < w1[s] && __ldg(segs + w0[s] + j) < key[s];
    }
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int c = __popc((__ballot_sync(group_mask, below[s]) >> shift) & group_mask >> shift);
    if (c == 0) {                 // the answer is at or before the window
      lo[s] = 0;
      hi[s] = w0[s];
    } else if (c == w1[s] - w0[s]) {  // past it
      lo[s] = w1[s];
      hi[s] = n;
    } else {                      // inside it
      lo[s] = hi[s] = w0[s] + c;
    }
  }
  while (lo[0] < hi[0] || lo[1] < hi[1]) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int p = lo[s] + static_cast<int>(static_cast<int64_t>(j + 1) * (hi[s] - lo[s]) / (width + 1));
      below[s] = lo[s] < hi[s] && __ldg(segs + p) < key[s];
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int c = __popc((__ballot_sync(group_mask, below[s]) >> shift) & group_mask >> shift);
      if (lo[s] < hi[s]) {
        const int64_t len = hi[s] - lo[s];
        const int below_end = c == 0 ? lo[s] : lo[s] + static_cast<int>(c * len / (width + 1)) + 1;
        if (c < width) hi[s] = lo[s] + static_cast<int>((c + 1) * len / (width + 1));
        lo[s] = below_end;
      }
    }
  }
  out_a = lo[0];
  out_b = lo[1];
}

// Vec is float4 (D a multiple of 4, 16 B aligned rows) or float. Each block
// holds kThreads / group bags; a group of `group` threads (a power of two)
// takes one bag and strides over its row_vecs columns.
template <typename Vec>
__global__ void __launch_bounds__(kThreads) embedding_bag_kernel(
    const Vec* __restrict__ table, int rows, int row_vecs, const int32_t* __restrict__ ids,
    const int32_t* __restrict__ segs, const float* __restrict__ weights, int n,
    Vec* __restrict__ out, int num_bags, int group) {
  const int bags_per_block = kThreads / group;
  const int bag = blockIdx.x * bags_per_block + threadIdx.x / group;
  if (bag >= num_bags) return;  // uniform across the group
  const int width = group < kWarp ? group : kWarp;
  const unsigned group_mask =
      width == kWarp ? 0xffffffffu : ((1u << width) - 1) << (threadIdx.x % kWarp / width * width);
  int begin, end;
  lower_bounds(segs, n, num_bags, bag, bag + 1, width, group_mask, begin, end);
  // few registers from here on: at 2^20 bags of 8 ids the rate follows the
  // warps resident per SM
  const int count = end - begin;
  const int32_t* bag_ids = ids + begin;
  const float* bag_w = weights != nullptr ? weights + begin : nullptr;
  Vec* dst = out + static_cast<int64_t>(bag) * row_vecs;
  for (int col = threadIdx.x % group; col < row_vecs; col += group) {
    const Vec* column = table + col;
    Vec acc{};
#pragma unroll (kUnroll)
    for (int i = 0; i < count; ++i) {
      const float w = bag_w != nullptr ? __ldg(bag_w + i) : 1.f;
      int id = __ldg(bag_ids + i);
      id = id < 0 ? id + rows : id;  // jnp.take wraps [-V, 0)
      const bool inside = static_cast<unsigned>(id) < static_cast<unsigned>(rows);
      const Vec v = load(column + static_cast<int64_t>(inside ? id : 0) * row_vecs);
      add_scaled(acc, w, inside ? v : nan_of(v));
    }
    dst[col] = acc;
  }
}

}  // namespace

// out[num_bags, D] (float32) = per-bag weighted sums of table[V, D] rows.
// ids and segments are int32 [n], segments sorted non-decreasing (ids whose
// segment is negative or past num_bags fall in no bag); an id in [-V, 0)
// reads row id + V, any other id outside [0, V) a row of NaN (jnp.take's
// rule); weights is float32 [n] or null for all ones; V, n and num_bags
// below INT32_MAX (else cudaErrorInvalidValue). Launches one kernel on
// `stream`; returns cudaGetLastError().
extern "C" int embedding_bag(const void* table, int64_t V, int64_t D, const void* ids,
                             const void* segments, const void* weights, int64_t n, void* out,
                             int64_t num_bags, void* stream) {
  if (V >= INT32_MAX || n > INT32_MAX || num_bags >= INT32_MAX || D > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_bags <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  if (V <= 0 && n > 0) return static_cast<int>(cudaErrorInvalidValue);  // no row to read for an id
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t row_vecs = vec4 ? D / 4 : D;
  // a group of threads per bag, up to a thread per column; once the bags
  // alone give every SM 64 warps, a warp per bag (lanes stride over the
  // columns) keeps more warps resident with fewer searches
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int most = num_bags >= static_cast<int64_t>(sms) * 64 ? kWarp : kThreads;
  int group = 1;
  while (group < row_vecs && group < most) group *= 2;
  const int64_t bags_per_block = kThreads / group;
  const unsigned blocks = static_cast<unsigned>((num_bags + bags_per_block - 1) / bags_per_block);
  const int32_t* id = static_cast<const int32_t*>(ids);
  const int32_t* seg = static_cast<const int32_t*>(segments);
  const float* w = static_cast<const float*>(weights);
  if (vec4) {
    embedding_bag_kernel<float4><<<blocks, kThreads, 0, st>>>(
        static_cast<const float4*>(table), static_cast<int>(V), static_cast<int>(row_vecs), id, seg, w,
        static_cast<int>(n), static_cast<float4*>(out), static_cast<int>(num_bags), group);
  } else {
    embedding_bag_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(table), static_cast<int>(V), static_cast<int>(row_vecs), id, seg, w,
        static_cast<int>(n), static_cast<float*>(out), static_cast<int>(num_bags), group);
  }
  return static_cast<int>(cudaGetLastError());
}
