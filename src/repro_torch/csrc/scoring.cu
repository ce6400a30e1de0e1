// Two-tower candidate scoring (queries against a candidate corpus) for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/scoring/scoring.py::scoring_pallas (body
// _scoring_kernel). That kernel keeps the [B, D] queries resident in VMEM and
// does one MXU product per 2048-candidate tile. This file computes the same
// float32 scores[b, n] = sum_d queries[b, d] * candidates[n, d], held to the
// JAX package's rtol = atol = 1e-5, with two kernels. scoring() below picks
// one by shape:
//
//   B <= kStreamMaxBatch, or D % 4 != 0   ->  scoring_stream_kernel
//   otherwise                             ->  scoring_tc_kernel
//
// kStreamMaxBatch is where the two cross on the H100 at the retrieval
// server's shapes (tools/scoring_ab.py: the streaming kernel is faster up to
// B = 4, the tensor-core kernel from B = 8). D % 4 == 0 is TMA's rule that
// every row stride be a multiple of 16 bytes.
//
// scoring_stream_kernel: CUDA cores, exact float32 FMAs. What bounds it at
// small B: bytes. The [N, D] candidates are read once (1 GiB at N = 2^20,
// D = 256) and the B * 2 D flop per candidate row are few. So each candidate
// row is read from device memory once, by one warp, in 16-byte
// ld.global.nc loads (scalar loads when D % 4 != 0). A warp owns R rows at
// a time and issues the loads of its next depth step before it computes on
// the current one, so two steps of R rows (up to 8 KB a warp, 128 KB an SM)
// are in flight, well past the ~25 KB an SM needs to cover HBM latency at
// 3.35 TB/s. Blocks are persistent (two an SM) and walk the rows. A chunk of
// QB <= 16 queries sits in shared memory, zero past B and D; a lane's partial
// sums (R x QB) are reduced over the warp by a transposing shuffle tree
// (warp_transpose_sum): fixed, so the same inputs give the same bits. Any B
// is correct; past 16 queries the chunks run in turn, re-reading the rows.
//
// scoring_tc_kernel: tensor cores, 3xTF32. What bounds it at large B:
// operations, 2 B N D of them. The CUDA cores give 67 TFLOP/s of float32;
// the tensor cores 495 TFLOP/s of TF32, whose 10-bit mantissa alone misses
// 1e-5 (tests/test_torch_scoring_embag.py shows it). So each float32 operand x
// is split, hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and each
// score is A_hi·B_hi + A_hi·B_lo + A_lo·B_hi: three m64nBNk8 tf32 wgmma into
// one float32 accumulator, 165 TFLOP/s of float32-exact products. The
// dropped A_lo·B_lo and lo's rounding each cost ~2^-22 of |a||b| per term.
// wgmma truncates a tf32 operand's low 13 bits, so both halves are rounded
// explicitly.
//   - A = candidates [N, D] and B = queries [B, D], both K-major as stored,
//     which tf32 wgmma requires. The accumulator is [64 candidates x BN
//     queries] per warpgroup.
//   - A block owns 128 candidates (two consumer warpgroups of 64) by BN
//     queries (BN = 8 .. 128, the smallest that holds B; 128-query tiles
//     past that) and is persistent: it walks tiles with the query tile
//     fastest, so the blocks that share a candidate tile read it at about
//     the same time (from L2 after the first). One producer warp keeps TMA
//     loads of 32-float K slices (one 128 B swizzle row) of the candidate
//     tile, q_hi and q_lo in flight through a ring of full/empty mbarriers,
//     across tiles.
//   - Candidates are split where they are read: the consumers load their A
//     fragments from the swizzled slice and split them in registers. Queries
//     are split once per call by scoring_split_kernel into q_hi and q_lo in
//     device memory (the caller's scratch [2, B, D], 1 MB at B = 512) and
//     read by wgmma from shared memory.
//   - Ragged edges: TMA fills depth past D and queries past B with zeros;
//     the epilogue stores only queries below B, straight from the
//     accumulator fragments (each store instruction writes four whole
//     32-byte sectors), so the next tile's loads run under it. N must be a
//     multiple of 128 (the wrapper requires multiples of 2048).
//   - Each warpgroup waits for a slice's products before it splits the
//     next; the two warpgroups overlap each other. A wait one group behind,
//     256-query tiles (with setmaxnreg) and stores staged through shared
//     memory, by STG.128 or TMA, measured no faster on the H100 (PERF.md).
// Neither kernel calls a library.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStreamMaxBatch = 4;

// ================= helpers (as in flash_attention.cu) =================

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that never
// ends (a lost transfer) traps after ~2^26 tries instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1u << 26)) __trap();
  }
}

// One TMA box of a 2-D map at (column, row), and of a 3-D map at (column,
// row, plane), into `dst`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start, leading and stride byte
// offsets (16 B units), swizzle layout.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// x rounded to tf32 (10 mantissa bits, to nearest, ties away from zero), as
// a float32 bit pattern whose low 13 bits are zero.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// ============ scoring_stream_kernel: CUDA cores, one read of each row ============

constexpr int kStreamThreads = 256;
constexpr int kStreamWarps = kStreamThreads / 32;
constexpr int kStreamBlocksPerSm = 2;
constexpr int kMaxQuerySmem = 96 * 1024;  // two blocks an SM

__device__ __forceinline__ float4 ld_stream4(const float* p) {  // read once: no L1 line
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ float ld_stream1(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

// Sum v[0 .. V) of every lane over the warp's 32 lanes, V a power of two.
// Each step halves what a lane holds: a lane with bit M set keeps the upper
// half and sends the lower, its partner (lane ^ M) the reverse, and each
// adds what it got, so a step costs V/2 shuffles where a plain tree costs V.
// After the five steps lane l holds in v[0 .. V/32) the sums of indices
// l·V/32 + i (V >= 32), or in v[0] that of index l / (32/V) (V < 32). The
// tree is fixed, so the same inputs give the same bits.
template <int V, int M = 16>
__device__ __forceinline__ void warp_transpose_sum(float* v, int lane) {
  if constexpr (M >= 1) {
    if constexpr (V >= 2) {
      constexpr int H = V / 2;
      const bool upper = (lane & M) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = upper ? v[i] : v[i + H];
        const float keep = upper ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
      warp_transpose_sum<H, M / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], M);
      warp_transpose_sum<1, M / 2>(v, lane);
    }
  }
}

// Candidate rows per warp step: more where the queries are few, so that a
// warp keeps 2-4 KB of loads in flight while its sums stay in 128 registers.
template <int QB>
__host__ __device__ constexpr int stream_rows() {
  return QB <= 2 ? 8 : 4;
}

// grid (x: blocks walking the rows, y: query chunks of QB), kStreamThreads
// threads, QB * Dpad floats of dynamic shared memory. Dpad is D rounded up to
// the warp's step (128 floats with 16-byte loads, 32 without).
template <int QB, bool kVec>
__global__ void __launch_bounds__(kStreamThreads, kStreamBlocksPerSm) scoring_stream_kernel(
    const float* __restrict__ q, const float* __restrict__ c, float* __restrict__ out, int64_t B,
    int64_t N, int64_t D, int Dpad) {
  constexpr int R = stream_rows<QB>();
  constexpr int kW = kVec ? 4 : 1;      // floats a lane loads per row and step
  constexpr int kStep = 32 * kW;        // depth a warp covers per step
  constexpr int V = R * QB;             // a lane's partial sums, index b * R + r
  constexpr int kHeld = V >= 32 ? V / 32 : 1;  // sums a lane holds after the reduction
  extern __shared__ __align__(16) float qs[];  // [QB][Dpad]

  const int lane = threadIdx.x % 32;
  const int64_t groups = (N + R - 1) / R;  // R consecutive rows each
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kStreamWarps;
  const int steps = Dpad / kStep;

  // rows g·R .. g·R + R - 1 at depth s·kStep + lane·kW, zero past N and D
  auto load = [&](float (&dst)[R][kW], int64_t g, int s) {
    const int64_t k = static_cast<int64_t>(s) * kStep + lane * kW;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t n = g * R + r;
      if (n < N && k < D) {
        const float* p = c + n * D + k;
        if constexpr (kVec) {
          const float4 v = ld_stream4(p);
          dst[r][0] = v.x;
          dst[r][1] = v.y;
          dst[r][2] = v.z;
          dst[r][3] = v.w;
        } else {
          dst[r][0] = ld_stream1(p);
        }
      } else {
#pragma unroll
        for (int w = 0; w < kW; ++w) dst[r][w] = 0.f;
      }
    }
  };

  for (int64_t b0 = static_cast<int64_t>(blockIdx.y) * QB; b0 < B;
       b0 += static_cast<int64_t>(gridDim.y) * QB) {
    __syncthreads();  // the last chunk's readers are done with qs
    for (int i = threadIdx.x; i < QB * Dpad; i += kStreamThreads) {
      const int b = i / Dpad, k = i % Dpad;
      qs[i] = (b0 + b < B && k < D) ? q[(b0 + b) * D + k] : 0.f;
    }
    __syncthreads();

    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    float cur[R][kW], nxt[R][kW];
    int64_t g = static_cast<int64_t>(blockIdx.x) * kStreamWarps + threadIdx.x / 32;
    int s = 0;
    if (g < groups) load(cur, g, 0);
    while (g < groups) {  // uniform over the warp
      // the next step's loads go out before this step's FMAs
      int64_t ng = g;
      int ns = s + 1;
      if (ns == steps) {
        ns = 0;
        ng += stride;
      }
      if (ng < groups) load(nxt, ng, ns);

      const float* qk = qs + s * kStep + lane * kW;
#pragma unroll
      for (int b = 0; b < QB; ++b) {
        float qv[kW];
        if constexpr (kVec) {
          const float4 t = *reinterpret_cast<const float4*>(qk + b * Dpad);
          qv[0] = t.x;
          qv[1] = t.y;
          qv[2] = t.z;
          qv[3] = t.w;
        } else {
          qv[0] = qk[b * Dpad];
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int w = 0; w < kW; ++w) acc[b * R + r] = fmaf(qv[w], cur[r][w], acc[b * R + r]);
      }

      if (ns == 0) {  // the group's last step: reduce over the warp and store
        warp_transpose_sum<V>(acc, lane);
        int idx0;
        bool writer;
        if constexpr (V >= 32) {
          idx0 = lane * kHeld;
          writer = true;
        } else {
          idx0 = lane / (32 / V);
          writer = lane % (32 / V) == 0;
        }
        if (writer) {
#pragma unroll
          for (int i = 0; i < kHeld; ++i) {
            const int b = (idx0 + i) / R, r = (idx0 + i) % R;
            const int64_t n = g * R + r;
            if (b0 + b < B && n < N) out[(b0 + b) * N + n] = acc[i];
          }
        }
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int w = 0; w < kW; ++w) cur[r][w] = nxt[r][w];
      g = ng;
      s = ns;
    }
  }
}

// ============ scoring_tc_kernel: tensor cores, 3xTF32 ============

constexpr int kTcM = 128;        // candidates per tile: two consumer warpgroups of 64
constexpr int kTcThreads = 288;  // warpgroups 0 and 1 consume, warp 8 produces
constexpr uint32_t kRowBytes = 128;  // a K slice: 32 floats, one 128 B swizzle row
constexpr int kSliceFloats = 32;
constexpr uint32_t kRingBytes = 192 * 1024;
constexpr int kMaxStages = 8;

// One ring slot holds a K slice of the candidate tile, q_hi and q_lo, each
// [rows][32 floats] in 128 B swizzle atoms, each on a 1024 B boundary (where
// the swizzle pattern starts), so TMA's writes and the reads agree.
template <int BN>
struct TcLayout {
  static constexpr uint32_t kCBytes = kTcM * kRowBytes;  // 16 KB
  static constexpr uint32_t kQBytes = BN * kRowBytes;    // q_hi or q_lo
  static constexpr uint32_t kStageBytes = kCBytes + 2 * kQBytes;
  static constexpr int kStages =
      kRingBytes / kStageBytes > kMaxStages ? kMaxStages : static_cast<int>(kRingBytes / kStageBytes);
  static constexpr uint32_t kSmem = kStages * kStageBytes + 1024;  // + alignment slack
  static_assert(kQBytes % 1024 == 0 && kStages >= 2, "slots must stay on swizzle boundaries");
};

#define WG_D4 "{%0, %1, %2, %3}"
#define WG_D8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define WG_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, " \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(d, i) F4(d, i), F4(d, i + 4), F4(d, i + 8), F4(d, i + 12)
#define ACC4(d) F4(d, 0)
#define ACC8(d) F4(d, 0), F4(d, 4)
#define ACC16(d) F16(d, 0)
#define ACC32(d) F16(d, 0), F16(d, 16)
#define ACC64(d) F16(d, 0), F16(d, 16), F16(d, 32), F16(d, 48)

// d[64 x N] (+)= A·B in tf32: A (four tf32 registers, the m64k8 fragment)
// from registers, B from shared memory K-major; accumulate = 0 overwrites d.
#define WGMMA_TF32(N, DREGS, ACC, I0, I1, I2, I3, IB, IS)                                       \
  __device__ __forceinline__ void wgmma_tf32_n##N(float* d, const uint32_t* a, uint64_t b,      \
                                                  int accumulate) {                             \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"                              \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 " DREGS ", {%" #I0  \
                 ", %" #I1 ", %" #I2 ", %" #I3 "}, %" #IB ", p, 1, 1;\n}\n"                       \
                 : ACC(d)                                                                       \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));        \
  }

WGMMA_TF32(8, WG_D4, ACC4, 4, 5, 6, 7, 8, 9)
WGMMA_TF32(16, WG_D8, ACC8, 8, 9, 10, 11, 12, 13)
WGMMA_TF32(32, WG_D16, ACC16, 16, 17, 18, 19, 20, 21)
WGMMA_TF32(64, WG_D32, ACC32, 32, 33, 34, 35, 36, 37)
WGMMA_TF32(128, WG_D64, ACC64, 64, 65, 66, 67, 68, 69)

template <int BN>
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, uint64_t b, int accumulate) {
  if constexpr (BN == 8) wgmma_tf32_n8(d, a, b, accumulate);
  else if constexpr (BN == 16) wgmma_tf32_n16(d, a, b, accumulate);
  else if constexpr (BN == 32) wgmma_tf32_n32(d, a, b, accumulate);
  else if constexpr (BN == 64) wgmma_tf32_n64(d, a, b, accumulate);
  else wgmma_tf32_n128(d, a, b, accumulate);
}

// hi_lo[0 .. n) = tf32(q), hi_lo[n .. 2n) = tf32(q - tf32(q))
__global__ void scoring_split_kernel(const float* __restrict__ q, float* __restrict__ hi_lo,
                                     int64_t n) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float x = q[i];
    const float h = __uint_as_float(to_tf32(x));
    hi_lo[i] = h;
    hi_lo[n + i] = __uint_as_float(to_tf32(x - h));
  }
}

// cmap: candidates [N, D] as (D, N), boxes of 32 x 128; qmap: the split
// queries [2, B, D] as (D, B, 2), boxes of 32 x BN x 1. Tile t covers
// candidates (t / q_tiles)·128 .. +127 and queries (t % q_tiles)·BN .. +BN-1.
template <int BN>
__global__ void __launch_bounds__(kTcThreads, 1) scoring_tc_kernel(
    const __grid_constant__ CUtensorMap cmap, const __grid_constant__ CUtensorMap qmap,
    float* __restrict__ out, int64_t B, int64_t N, int k_slices, int64_t q_tiles, int64_t tiles) {
  using L = TcLayout<BN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * L::kStages];  // full, then empty, per slot

  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint8_t* ring_ptr = smem_raw + (ring - raw);
  const uint32_t full = smem_addr(bars), empty = full + 8 * L::kStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer: one thread issues every TMA load of the block ----
    if (threadIdx.x == 256) {
      int64_t it = 0;
      for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int c0 = static_cast<int>((tile / q_tiles) * kTcM);
        const int b0 = static_cast<int>((tile % q_tiles) * BN);
        for (int ks = 0; ks < k_slices; ++ks, ++it) {
          const int s = static_cast<int>(it % L::kStages);
          const int64_t round = it / L::kStages;
          if (round > 0) mbar_wait(empty + 8 * s, static_cast<uint32_t>((round - 1) & 1));
          const uint32_t st = ring + s * L::kStageBytes;
          mbar_expect_tx(full + 8 * s, L::kStageBytes);
          tma_load_2d(st, &cmap, full + 8 * s, ks * kSliceFloats, c0);
          tma_load_3d(st + L::kCBytes, &qmap, full + 8 * s, ks * kSliceFloats, b0, 0);
          tma_load_3d(st + L::kCBytes + L::kQBytes, &qmap, full + 8 * s, ks * kSliceFloats, b0, 1);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns candidates 64wg .. 64wg + 63 of a tile ----
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    // The m64k8 tf32 A fragment: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
    // a3 (g + 8, t + 4) of the warp's 16 rows and the step's 8 columns. Row
    // r's 16 B chunk j sits at r·128 + (j ^ (r % 8))·16, and r % 8 = g for
    // both of this thread's rows.
    const uint32_t a_row = (64 * wg + 16 * warp + g) * kRowBytes + 4 * t;
    // accumulator element 4j + 2i + e: candidate row0 + 8i, query 8j + col + e
    const int row0 = 64 * wg + 16 * warp + g;
    const int col = 2 * t;

    int64_t it = 0;
    for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int64_t c0 = (tile / q_tiles) * kTcM;
      const int64_t b0 = (tile % q_tiles) * BN;
      float acc[BN / 2];
      for (int ks = 0; ks < k_slices; ++ks, ++it) {
        const int s = static_cast<int>(it % L::kStages);
        mbar_wait(full + 8 * s, static_cast<uint32_t>((it / L::kStages) & 1));
        const uint32_t st = s * L::kStageBytes;  // offset into the ring
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // k8 steps: columns 8kk .. 8kk + 7 = chunks 2kk, 2kk + 1
          const uint32_t ch0 = ((2 * kk) ^ g) * 16, ch1 = ((2 * kk + 1) ^ g) * 16;
          const uint8_t* base = ring_ptr + st + a_row;
          const float x[4] = {
              *reinterpret_cast<const float*>(base + ch0),
              *reinterpret_cast<const float*>(base + 8 * kRowBytes + ch0),
              *reinterpret_cast<const float*>(base + ch1),
              *reinterpret_cast<const float*>(base + 8 * kRowBytes + ch1),
          };
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            hi[kk][i] = to_tf32(x[i]);
            lo[kk][i] = to_tf32(x[i] - __uint_as_float(hi[kk][i]));
          }
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t qh = ring + st + L::kCBytes + 32 * kk;  // 8 floats = 32 B into the row
          const uint64_t bh = make_desc(qh, 16, 8 * kRowBytes, 1);
          const uint64_t bl = make_desc(qh + L::kQBytes, 16, 8 * kRowBytes, 1);
          mma_tf32<BN>(acc, hi[kk], bh, ks > 0 || kk > 0);
          mma_tf32<BN>(acc, hi[kk], bl, 1);
          mma_tf32<BN>(acc, lo[kk], bh, 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          fence_regs(hi[kk]);
          fence_regs(lo[kk]);
        }
        mbar_arrive(empty + 8 * s);
      }

      // scores[b, n] straight from the fragment: each store instruction of a
      // warp writes 8 consecutive candidates of 4 queries, four whole 32 B
      // sectors, and the producer's loads of the next tile run under it
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int64_t b = b0 + 8 * j + col + e;
          if (b >= B) continue;
          float* o = out + b * N + c0 + row0;
          o[0] = acc[4 * j + e];
          o[8] = acc[4 * j + 2 + e];
        }
    }
  }
}

// ================= host side =================

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime, so the
// library needs no link against libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 13000
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A float32 map over `planes` planes of [rows, D] (D contiguous) as (D, rows,
// planes), boxes of 32 columns x box_rows rows x 1 plane in 128 B swizzle
// atoms; the box's part past D or rows is filled with zeros.
bool encode_map(CUtensorMap* map, const void* x, int64_t planes, int64_t rows, int64_t D,
                int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D * 4), static_cast<cuuint64_t>(rows * D * 4)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kSliceFloats), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, planes > 1 ? 3 : 2, const_cast<void*>(x), dims,
            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 0;
  }
  return sms;
}

template <int QB, bool kVec>
int launch_stream(const float* q, const float* c, float* out, int64_t B, int64_t N, int64_t D,
                  int Dpad, cudaStream_t stream) {
  const auto kernel = scoring_stream_kernel<QB, kVec>;
  static bool configured = false;  // above 48 KB needs the opt-in, once per kernel
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxQuerySmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int sms = sm_count();
  if (sms == 0) return static_cast<int>(cudaGetLastError());
  const int64_t chunks = (B + QB - 1) / QB;
  const int64_t groups = (N + stream_rows<QB>() - 1) / stream_rows<QB>();  // one warp's rows each
  const int64_t gy = chunks < 65535 ? chunks : 65535;
  int64_t gx = (static_cast<int64_t>(kStreamBlocksPerSm) * sms + gy - 1) / gy;
  const int64_t gx_max = (groups + kStreamWarps - 1) / kStreamWarps;
  if (gx > gx_max) gx = gx_max;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  kernel<<<grid, kStreamThreads, static_cast<size_t>(QB) * Dpad * 4, stream>>>(q, c, out, B, N, D, Dpad);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec>
int launch_stream_qb(const float* q, const float* c, float* out, int64_t B, int64_t N, int64_t D,
                     int qb, cudaStream_t stream) {
  const int64_t step = kVec ? 128 : 32;
  const int64_t Dpad = (D + step - 1) / step * step;
  if (static_cast<int64_t>(qb) * Dpad * 4 > kMaxQuerySmem) return static_cast<int>(cudaErrorInvalidValue);
  const int dp = static_cast<int>(Dpad);
  switch (qb) {
    case 1: return launch_stream<1, kVec>(q, c, out, B, N, D, dp, stream);
    case 2: return launch_stream<2, kVec>(q, c, out, B, N, D, dp, stream);
    case 4: return launch_stream<4, kVec>(q, c, out, B, N, D, dp, stream);
    case 8: return launch_stream<8, kVec>(q, c, out, B, N, D, dp, stream);
    case 16: return launch_stream<16, kVec>(q, c, out, B, N, D, dp, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int BN>
int launch_tc(const float* q, const float* c, float* out, float* scratch, int64_t B, int64_t N,
              int64_t D, cudaStream_t stream) {
  using L = TcLayout<BN>;
  const auto kernel = scoring_tc_kernel<BN>;
  static bool configured = false;  // above 48 KB needs the opt-in, once per kernel
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int sms = sm_count();
  if (sms == 0) return static_cast<int>(cudaGetLastError());
  const int64_t n = B * D;
  const int64_t split_blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  scoring_split_kernel<<<static_cast<unsigned>(split_blocks), 256, 0, stream>>>(q, scratch, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap cmap, qmap;
  if (!encode_map(&cmap, c, 1, N, D, kTcM) || !encode_map(&qmap, scratch, 2, B, D, BN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t q_tiles = (B + BN - 1) / BN;
  const int64_t tiles = N / kTcM * q_tiles;
  const int64_t grid = tiles < sms ? tiles : sms;
  kernel<<<static_cast<unsigned>(grid), kTcThreads, L::kSmem, stream>>>(
      cmap, qmap, out, B, N, static_cast<int>((D + kSliceFloats - 1) / kSliceFloats), q_tiles, tiles);
  return static_cast<int>(cudaGetLastError());
}

// path 0: scoring_stream_kernel with `width` queries a chunk (1, 2, 4, 8, 16);
// path 1: scoring_tc_kernel with `width` queries a tile (8, 16, ..., 128).
int launch(const void* queries, const void* candidates, void* scores, void* scratch, int64_t B,
           int64_t N, int64_t D, int path, int width, void* stream) {
  const float* q = static_cast<const float*>(queries);
  const float* c = static_cast<const float*>(candidates);
  float* out = static_cast<float*>(scores);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 0) {
    const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
    return vec ? launch_stream_qb<true>(q, c, out, B, N, D, width, st)
               : launch_stream_qb<false>(q, c, out, B, N, D, width, st);
  }
  if (D % 4 != 0 || N % kTcM != 0 || scratch == nullptr || reinterpret_cast<uintptr_t>(c) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0 || B >= (int64_t{1} << 31) || N >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* s = static_cast<float*>(scratch);
  switch (width) {
    case 8: return launch_tc<8>(q, c, out, s, B, N, D, st);
    case 16: return launch_tc<16>(q, c, out, s, B, N, D, st);
    case 32: return launch_tc<32>(q, c, out, s, B, N, D, st);
    case 64: return launch_tc<64>(q, c, out, s, B, N, D, st);
    case 128: return launch_tc<128>(q, c, out, s, B, N, D, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The batch at and below which scoring() takes the streaming kernel; the
// wrapper checks that it states the same rule.
int scoring_stream_max_batch() { return kStreamMaxBatch; }

// scores[B, N] = queries[B, D] @ candidates[N, D]^T, all float32, row-major
// and contiguous, N a multiple of 128. `scratch` is float32 [2, B, D], 16 B
// aligned, when the tensor-core kernel runs (B > kStreamMaxBatch and
// D % 4 == 0; then `candidates` must be 16 B aligned too), else unused.
// Launches on `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue
// for a shape the kernels do not take.
int scoring(const void* queries, const void* candidates, void* scores, void* scratch, int64_t B,
            int64_t N, int64_t D, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= kStreamMaxBatch || D % 4 != 0) {
    // queries a chunk: the fewest powers of two that hold B, at most 16, fewer
    // where a chunk's queries would not fit in shared memory
    int qb = 1;
    while (qb < B && qb < 16) qb *= 2;
    const int64_t step = D % 4 == 0 ? 128 : 32;
    const int64_t Dpad = (D + step - 1) / step * step;
    while (qb > 1 && qb * Dpad * 4 > kMaxQuerySmem) qb /= 2;
    return launch(queries, candidates, scores, scratch, B, N, D, 0, qb, stream);
  }
  int bn = 8;
  while (bn < B && bn < 128) bn *= 2;
  return launch(queries, candidates, scores, scratch, B, N, D, 1, bn, stream);
}

// The same with the kernel and its width named (see launch()): for tests and
// measurements that hold every variant against the plain version.
int scoring_variant(const void* queries, const void* candidates, void* scores, void* scratch,
                    int64_t B, int64_t N, int64_t D, int path, int width, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (D <= 0 || path < 0 || path > 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(queries, candidates, scores, scratch, B, N, D, path, width, stream);
}

}  // extern "C"
