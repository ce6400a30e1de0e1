// Degree count (vertex-id histogram, the paper's §5.1 calibration algorithm)
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/degree_count/degree_count.py::degree_count_pallas
// (body _degree_count_kernel), which counts ids already reduced mod the
// counter-array size with one-hot compare tiles, -1 never counted. This
// kernel computes the same exact int32 histogram.
//
// What bounds it on the H100: bytes, in principle (each id read once, 4 B,
// and the int32 counters written once: 0.041 ms for RMAT sf20's 33.5 M
// endpoint ids), but in practice the atomics. The backend's endpoint table
// is [src; dst] in edge order and src is sorted, so the src row is long
// runs of one id (2.01 distinct ids per 32 on RMAT sf20, runs up to 69,348,
// a whole 16 Ki-edge package of one id at the worst). One atomic per id
// turns such a run into a chain of same-address atomics that the L2
// serializes: the earlier one-thread-per-id form (commit 62dc202) spent
// 4.8 us of device time on a 32 Ki-id launch whose bytes need 0.04 us.
//
// Design: equal neighbouring ids are added up before they reach memory.
// A warp takes a step of 32 lanes x 4 * kVecs consecutive ids of one row,
// each lane its ids in order by 16-byte loads (a row slice may start at
// any id, so a step's positions are counted from the row's 16-byte-aligned
// base and positions outside the row load nothing). Each lane marks where
// a run of equal ids starts (its first id against the previous lane's
// last, by a shuffle); a suffix-min over the lanes (five shuffles) gives
// every lane the position of the next run start after it; each run then
// adds its length with one `red.global.add` from the lane where it starts.
// Runs are cut at the step's end, so a hub run costs one atomic per step
// (128 for a hub package, not 16,384) and the sorted row about one per
// run. Unsorted ids (the dst row; ids mod C) are runs of one: one atomic
// each, as before. Ids outside [0, num_counters) — the -1 padding — form
// runs that are never added. Integer sums are exact in any order, so the
// result equals the plain version's bit for bit on every run.
//
// Two kernels, chosen by the launch's size in degree_count_path():
// - degree_count_runs_kernel adds each run into the global counters. Its
//   grid is sized from the ids (a warp per step of 128 ids, two warps a
//   block, up to kMaxBlocks with a warp-stride loop beyond), so the main
//   path's 2 x 16 Ki-id launch spreads over 129 blocks that each load once
//   per lane and end about 1 us above an empty kernel.
// - degree_count_private_kernel (from kPrivateMinIds ids, where it
//   overtakes the runs kernel on the H100) sends the runs of steps of 256
//   ids to a per-block open-addressing table in shared memory (8 Ki int32
//   keys and counts, kProbes linear probes from a multiplicative hash,
//   overflow straight to the global counters), then flushes each occupied
//   slot with one atomic at the block's end: the dst row's hub ids, which
//   vertex permutation scatters over the counters, meet in shared memory
//   instead of the L2. Persistent blocks, as many as are resident.
// The counters (4 MiB at C = 2^20) do not fit a block's shared memory, so
// the table holds only the ids a block meets first; the ids are read with
// evict-first loads to keep the counters in the L2.
//
// The kernel adds into a caller-zeroed output, so several launches (the
// gang-width slices of one range) accumulate into one tensor on the device.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// runs kernel: one 16-byte load per lane per step, two warps a block;
// private kernel: two loads per lane, 32 warps a block (tools/degree_count_ab.py
// timed the neighbours of each on the H100)
constexpr int kRunsThreads = 64;
constexpr int kRunsVecs = 1;
constexpr int kPrivateThreads = 1024;
constexpr int kPrivateVecs = 2;
constexpr int64_t kMaxBlocks = 8192;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kLogSlots = 13;  // private table: 8 Ki slots, 64 KB of keys and counts
constexpr int kSlots = 1 << kLogSlots;
constexpr int kProbes = 4;
constexpr int32_t kEmpty = -1;
constexpr int64_t kPrivateMinIds = int64_t{1} << 22;

// kVecs 16-byte loads per lane per warp step: the step's ids, lane-major
template <int kVecs>
struct Step {
  static constexpr int kIdsPerLane = 4 * kVecs;
  static constexpr int kIds = 32 * kIdsPerLane;
};

enum Path : int { kRuns = 0, kPrivate = 1 };

__device__ __forceinline__ void red_add(int32_t* p, int32_t v) {
  asm volatile("red.relaxed.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The lane's kIdsPerLane ids at positions [v0, v0 + kIdsPerLane) counted
// from the row's 16-byte-aligned base `aligned`; the row's ids are
// positions [head, head + n). Positions outside it hold -1 (never counted).
template <int kVecs>
__device__ __forceinline__ void load_ids(const int32_t* __restrict__ aligned, int64_t head, int64_t n,
                                         int64_t v0, int32_t (&x)[Step<kVecs>::kIdsPerLane]) {
  constexpr int kIdsPerLane = Step<kVecs>::kIdsPerLane;
  if (v0 >= head && v0 + kIdsPerLane <= head + n) {
    const int4* q = reinterpret_cast<const int4*>(aligned + v0);
#pragma unroll
    for (int t = 0; t < kVecs; ++t) {
      const int4 v = __ldcs(q + t);  // read once: evict first, keep the counters in L2
      x[4 * t] = v.x;
      x[4 * t + 1] = v.y;
      x[4 * t + 2] = v.z;
      x[4 * t + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kIdsPerLane; ++k) {
      const int64_t v = v0 + k;
      x[k] = (v >= head && v < head + n) ? __ldcs(aligned + v) : -1;
    }
  }
}

// One warp step: the warp's 32 * kIdsPerLane ids, lane-major, cut into runs
// of equal ids; emit(id, length) once per run, from the lane where it
// starts. All 32 lanes must call it together.
template <int kVecs, class Emit>
__device__ __forceinline__ void warp_runs(const int32_t (&x)[Step<kVecs>::kIdsPerLane], int lane, Emit&& emit) {
  constexpr int kIdsPerLane = Step<kVecs>::kIdsPerLane;
  constexpr int kStepIds = Step<kVecs>::kIds;
  const int32_t prev = __shfl_up_sync(kFull, x[kIdsPerLane - 1], 1);
  bool head[kIdsPerLane];
  head[0] = lane == 0 || x[0] != prev;
#pragma unroll
  for (int k = 1; k < kIdsPerLane; ++k) head[k] = x[k] != x[k - 1];
  const int base = lane * kIdsPerLane;
  int first = kStepIds;  // this lane's first run start, or none
#pragma unroll
  for (int k = kIdsPerLane - 1; k >= 0; --k) {
    if (head[k]) first = base + k;
  }
  int next = first;  // min over lanes >= lane
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_down_sync(kFull, next, off);
    if (lane + off < 32) next = min(next, t);
  }
  int end = __shfl_down_sync(kFull, next, 1);  // the first run start after this lane
  if (lane == 31) end = kStepIds;
#pragma unroll
  for (int k = kIdsPerLane - 1; k >= 0; --k) {
    if (head[k]) {
      emit(x[k], end - (base + k));
      end = base + k;
    }
  }
}

// Calls body(x, lane) for every warp step of rows [0, rows), a step per
// warp in a grid-wide warp-stride loop. steps_per_row covers any row's
// alignment head (at most 3 ids).
template <int kVecs, class Body>
__device__ __forceinline__ void for_each_step(const int32_t* __restrict__ ids, int64_t n, int64_t rows,
                                              int64_t row_stride, int64_t steps_per_row, Body&& body) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t total = rows * steps_per_row;
  for (int64_t s = warp; s < total; s += warps) {
    const int64_t r = s / steps_per_row;
    const int64_t step = s - r * steps_per_row;
    const int32_t* row = ids + r * row_stride;
    const int64_t head = (reinterpret_cast<uintptr_t>(row) & 15) >> 2;
    int32_t x[Step<kVecs>::kIdsPerLane];
    load_ids<kVecs>(row - head, head, n, step * Step<kVecs>::kIds + lane * Step<kVecs>::kIdsPerLane, x);
    body(x, lane);
  }
}

__global__ void __launch_bounds__(kRunsThreads) degree_count_runs_kernel(
    const int32_t* __restrict__ ids, int64_t n, int64_t rows, int64_t row_stride, int64_t steps_per_row,
    int32_t* __restrict__ counts, int32_t num_counters) {
  using S = Step<kRunsVecs>;
  for_each_step<kRunsVecs>(ids, n, rows, row_stride, steps_per_row, [&](const int32_t(&x)[S::kIdsPerLane], int lane) {
    warp_runs<kRunsVecs>(x, lane, [&](int32_t id, int32_t len) {
      if (static_cast<uint32_t>(id) < static_cast<uint32_t>(num_counters)) red_add(counts + id, len);
    });
  });
}

__global__ void __launch_bounds__(kPrivateThreads) degree_count_private_kernel(
    const int32_t* __restrict__ ids, int64_t n, int64_t rows, int64_t row_stride, int64_t steps_per_row,
    int32_t* __restrict__ counts, int32_t num_counters) {
  extern __shared__ int32_t table[];
  volatile int32_t* keys = table;
  int32_t* vals = table + kSlots;
  for (int i = threadIdx.x; i < kSlots; i += kPrivateThreads) {
    keys[i] = kEmpty;
    vals[i] = 0;
  }
  __syncthreads();
  using S = Step<kPrivateVecs>;
  for_each_step<kPrivateVecs>(ids, n, rows, row_stride, steps_per_row, [&](const int32_t(&x)[S::kIdsPerLane], int lane) {
    warp_runs<kPrivateVecs>(x, lane, [&](int32_t id, int32_t len) {
      if (static_cast<uint32_t>(id) >= static_cast<uint32_t>(num_counters)) return;
      uint32_t h = (static_cast<uint32_t>(id) * 2654435761u) >> (32 - kLogSlots);
#pragma unroll
      for (int p = 0; p < kProbes; ++p) {
        int32_t k = keys[h];
        if (k == kEmpty) k = atomicCAS(const_cast<int32_t*>(keys) + h, kEmpty, id);
        if (k == kEmpty || k == id) {
          atomicAdd(vals + h, len);
          return;
        }
        h = (h + 1) & (kSlots - 1);
      }
      red_add(counts + id, len);  // the probed slots hold other ids
    });
  });
  __syncthreads();
  for (int i = threadIdx.x; i < kSlots; i += kPrivateThreads) {
    const int32_t v = vals[i];
    if (v != 0) red_add(counts + keys[i], v);
  }
}

// warp steps that cover a row of n ids after an alignment head of up to 3
template <int kVecs>
int64_t steps_per_row(int64_t n) {
  return (n + 3 + Step<kVecs>::kIds - 1) / Step<kVecs>::kIds;
}

cudaError_t launch(int path, int64_t cap, const int32_t* ids, int64_t n, int64_t rows, int64_t row_stride,
                   int32_t* counts, int32_t num_counters, cudaStream_t stream) {
  if (path == kPrivate) {
    constexpr size_t kSmem = 2 * sizeof(int32_t) * kSlots;
    static int resident = 0;  // blocks resident on the card at once, found once
    if (resident == 0) {
      const auto kernel = degree_count_private_kernel;
      cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
      int dev = 0, sms = 0, per_sm = 0;
      if (err == cudaSuccess) err = cudaGetDevice(&dev);
      if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kPrivateThreads, kSmem);
      if (err != cudaSuccess) return err;
      resident = sms * (per_sm > 0 ? per_sm : 1);
    }
    const int64_t spr = steps_per_row<kPrivateVecs>(n);
    int64_t blocks = (rows * spr + kPrivateThreads / 32 - 1) / (kPrivateThreads / 32);
    blocks = std::min<int64_t>(blocks, cap > 0 ? std::min<int64_t>(cap, resident) : resident);
    degree_count_private_kernel<<<static_cast<unsigned>(blocks), kPrivateThreads, kSmem, stream>>>(
        ids, n, rows, row_stride, spr, counts, num_counters);
    return cudaGetLastError();
  }
  if (path != kRuns) return cudaErrorInvalidValue;
  const int64_t spr = steps_per_row<kRunsVecs>(n);
  constexpr int kWarps = kRunsThreads / 32;
  int64_t blocks = (rows * spr + kWarps - 1) / kWarps;
  blocks = std::min<int64_t>(blocks, cap > 0 ? cap : kMaxBlocks);
  degree_count_runs_kernel<<<static_cast<unsigned>(blocks), kRunsThreads, 0, stream>>>(
      ids, n, rows, row_stride, spr, counts, num_counters);
  return cudaGetLastError();
}

}  // namespace

// Which kernel degree_count() launches for rows x n ids: 0 runs, 1 private
// (mirrored by kernels/degree_count/degree_count.py::_degree_count_path).
extern "C" int degree_count_path(int64_t n, int64_t rows) {
  return n * rows >= kPrivateMinIds ? kPrivate : kRuns;
}

// counts[id] += 1 for every id of rows [0, rows) of `ids` (row r starts at
// ids + r * row_stride and holds n ids) with 0 <= id < num_counters.
// One launch on `stream`; returns cudaGetLastError().
extern "C" int degree_count(const void* ids, int64_t n, int64_t rows, int64_t row_stride, void* counts,
                            int32_t num_counters, void* stream) {
  if (n <= 0 || rows <= 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(launch(degree_count_path(n, rows), 0, static_cast<const int32_t*>(ids), n, rows,
                                 row_stride, static_cast<int32_t*>(counts), num_counters,
                                 static_cast<cudaStream_t>(stream)));
}

// The same with the kernel forced (path 0 runs, 1 private) and its grid
// cut to at most `max_blocks` blocks (0: the kernel's own grid), for the
// tests and tools/degree_count_ab.py.
extern "C" int degree_count_variant(const void* ids, int64_t n, int64_t rows, int64_t row_stride, void* counts,
                                    int32_t num_counters, int path, int64_t max_blocks, void* stream) {
  if (n <= 0 || rows <= 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(launch(path, max_blocks, static_cast<const int32_t*>(ids), n, rows, row_stride,
                                 static_cast<int32_t*>(counts), num_counters, static_cast<cudaStream_t>(stream)));
}
