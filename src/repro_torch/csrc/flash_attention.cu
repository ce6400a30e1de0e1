// Causal flash attention (forward) with grouped KV heads, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/attention/flash_attention.py::flash_attention_pallas
// (body _flash_kernel). That kernel walks a sequential grid axis over 512-key
// tiles and carries the online softmax's float32 m, l and acc in VMEM scratch
// from one grid step to the next. This file computes the same function: the
// scores q·kᵀ·Dh**-0.5 in float32, masked to -1e30 where key > query, float32
// m/l/acc, out = acc / max(l, 1e-30) in q's type. It also takes what the TPU
// kernel leaves to its caller:
//   - grouped KV heads: query head h reads KV head h / (H / K), so the
//     layer's [B, S, K, Dh] k and v are read as they are, never expanded;
//   - any S: the ragged last query and key tiles are zero-filled and masked.
//
// What bounds it on the H100: operations. A head's causal attention does
// 2 Dh S (S + 1) flop; the bytes (q, k, v, o, each once) are two orders of
// magnitude fewer, so the bound is the bf16 tensor cores' 989 TFLOP/s, which
// only `wgmma` reaches.
//
// bf16/fp16 inputs: flash_attention_wgmma_kernel.
//   - Both products run on the tensor cores. S = Q·Kᵀ is one m64nBKk16
//     wgmma per 16 columns of Dh, Q and K read from shared memory K-major (Dh
//     is contiguous in the layer's layout). Dh**-0.5 is applied to the float32
//     scores after the product, folded with log2(e) into the one FMA that
//     feeds ex2: p = 2^(c·s - c·m), c = Dh**-0.5·log2(e), which is the
//     reference's exp(scale·s - m) up to float32 rounding. O += P·V takes P
//     from registers (S's accumulator fragment is already the A operand's
//     layout) and V from shared memory MN-major through the transpose bit, so
//     V is never transposed in memory.
//   - Split-P. The tensor cores take 16-bit operands, and P in bf16 alone
//     moves ~5% of the outputs past a bf16 rounding step of the float32
//     reference. So each tile issues two P·V products into the same float32
//     accumulator, with P_hi = bf16(p) and P_lo = bf16(p - P_hi) (fp16 for
//     fp16 inputs): P_hi + P_lo holds p to ~16 bits, and every product and
//     sum is float32. l is summed from the float32 p. This costs 1.5x the
//     algorithm's tensor-core work.
//   - A block owns 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows read the same K/V tiles. One producer warp
//     (warpgroup 2, which hands its registers to the consumers with
//     setmaxnreg) loads Q once and keeps K and V tiles in flight by TMA
//     through a ring of kStages slots, with full and empty mbarriers. The
//     tensor maps are 4-D over (Dh, heads, S, B): a ragged S tile is
//     zero-filled per batch by the hardware, and GQA is the head coordinate.
//     Each tile lands in 32 B (Dh 16), 64 B (Dh 32) or 128 B (Dh 64, 128)
//     swizzle atoms, which the wgmma descriptors name. At Dh 16 Q·Kᵀ is one
//     k16 step and P·V an m64n16k16 product (8 accumulators a thread).
//     Within a warpgroup the products and the softmax alternate (wait for K,
//     S, softmax, wait for V, P·V); the two warpgroups overlap where the warp
//     schedulers interleave them.
//   - The loop over KV tiles stops at the diagonal: a tile wholly above it
//     adds exp(-1e30 - m) = 0 to every sum and leaves m as it is, so skipping
//     it is exact. Only a tile that crosses a warpgroup's diagonal is masked
//     (a ragged key past S is above every valid row's diagonal). Blocks of
//     the longest rows start first.
// float32 inputs: flash_attention_f32_kernel, on the CUDA cores. On the tensor
// cores they would need 3xTF32 to meet the JAX package's 2e-5; float32 serves
// the checks (a float32 LM, float32 comparisons), not the bf16 serving path.
// Every flat offset is 64-bit: prefill at [32, 32768, 32, 64] holds 2.1e9
// elements.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float quad_max(float x) {  // over the 4 threads of a row
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ============ bf16 / fp16: wgmma products, TMA-fed K/V ring ============

constexpr int kBQ = 128;      // query rows per block: two consumer warpgroups of 64
constexpr int kStages = 2;    // K/V ring slots
constexpr int kTcThreads = 384;  // warpgroups 0, 1 consume; warpgroup 2 produces
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Shared memory of one block. The block's base sits on a 1024 B boundary.
// An N-byte swizzle (N = 32, 64, 128: the atom row) XORs a row's 16 B chunks
// with the row's index among 8, so its pattern repeats every 8 rows, 8·N
// bytes: every buffer, and every 16-row K step of V that a P·V descriptor
// starts at, must begin on such a repeat for TMA's writes and wgmma's reads
// to agree (the descriptors' base-offset field stays 0).
template <int D, int BK>
struct TcLayout {
  static constexpr int kAtom = D < 64 ? D : 64;  // columns per swizzle atom row
  static constexpr int kAtoms = D / kAtom;
  static constexpr uint32_t kRowBytes = kAtom * 2;  // 32, 64 or 128
  static constexpr uint32_t kRepeat = 8 * kRowBytes;  // the swizzle pattern's period
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  // wgmma descriptor bits 62-63: 1 = 128 B, 2 = 64 B, 3 = 32 B swizzle
  static constexpr uint64_t kDescLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr uint32_t kQBytes = kBQ * D * 2;  // atoms of [kBQ][kAtom]
  static constexpr uint32_t kTileBytes = BK * D * 2;  // one K or V tile: atoms of [BK][kAtom]
  static constexpr uint32_t kK = kQBytes;
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kSmem = kV + kStages * kTileBytes + 1024;  // + alignment slack
  static_assert(D % 16 == 0 && kRowBytes % 32 == 0, "atoms of 16-column K slices");
  static_assert(1024 % kRepeat == 0 && kQBytes % kRepeat == 0 && kTileBytes % kRepeat == 0 &&
                    64 * kRowBytes % kRepeat == 0 && BK * kRowBytes % kRepeat == 0 &&
                    16 * kRowBytes % kRepeat == 0,
                "buffers, a warpgroup's Q rows, atoms and V's K steps must start on swizzle repeats");
};

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

// One TMA box of the 4-D map at (column, head, position, batch) into `dst`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {  // one MUFU op; 2^-126 and below flush to 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

#define WG_D8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define WG_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_D32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_D64                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "   \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(d, i) F4(d, i), F4(d, i + 4), F4(d, i + 8), F4(d, i + 12)
#define ACC8(d) F4(d, 0), F4(d, 4)
#define ACC16(d) F16(d, 0)
#define ACC32(d) F16(d, 0), F16(d, 16)
#define ACC64(d) F16(d, 0), F16(d, 16), F16(d, 32), F16(d, 48)

// d[64 x N] (+)= A·B, A and B from shared memory, both K-major.
#define WGMMA_SS(NAME, SHAPE, DREGS, ACC, IA, IB, IS)                                      \
  template <bool kHalf>                                                                    \
  __device__ __forceinline__ void NAME(float* d, uint64_t a, uint64_t b, int accumulate) { \
    if constexpr (kHalf) {                                                                 \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"                       \
                   "wgmma.mma_async.sync.aligned." SHAPE ".f32.f16.f16 " DREGS            \
                   ", %" #IA ", %" #IB ", p, 1, 1, 0, 0;\n}\n"                              \
                   : ACC(d)                                                                \
                   : "l"(a), "l"(b), "r"(accumulate));                                     \
    } else {                                                                               \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"                       \
                   "wgmma.mma_async.sync.aligned." SHAPE ".f32.bf16.bf16 " DREGS          \
                   ", %" #IA ", %" #IB ", p, 1, 1, 0, 0;\n}\n"                              \
                   : ACC(d)                                                                \
                   : "l"(a), "l"(b), "r"(accumulate));                                     \
    }                                                                                      \
  }

// d[64 x N] += A·B, A (four 32-bit registers of 16-bit pairs) from registers,
// B from shared memory MN-major (transpose bit set).
#define WGMMA_RS(NAME, SHAPE, DREGS, ACC, I0, I1, I2, I3, IB, IS)                                \
  template <bool kHalf>                                                                          \
  __device__ __forceinline__ void NAME(float* d, const uint32_t* a, uint64_t b) {                \
    if constexpr (kHalf) {                                                                       \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"                             \
                   "wgmma.mma_async.sync.aligned." SHAPE ".f32.f16.f16 " DREGS ", {%" #I0        \
                   ", %" #I1 ", %" #I2 ", %" #I3 "}, %" #IB ", p, 1, 1, 1;\n}\n"                  \
                   : ACC(d)                                                                      \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));                \
    } else {                                                                                     \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"                             \
                   "wgmma.mma_async.sync.aligned." SHAPE ".f32.bf16.bf16 " DREGS ", {%" #I0      \
                   ", %" #I1 ", %" #I2 ", %" #I3 "}, %" #IB ", p, 1, 1, 1;\n}\n"                  \
                   : ACC(d)                                                                      \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));                \
    }                                                                                            \
  }

WGMMA_SS(wgmma_ss_n64, "m64n64k16", WG_D32, ACC32, 32, 33, 34)
WGMMA_SS(wgmma_ss_n128, "m64n128k16", WG_D64, ACC64, 64, 65, 66)
WGMMA_RS(wgmma_rs_n16, "m64n16k16", WG_D8, ACC8, 8, 9, 10, 11, 12, 13)
WGMMA_RS(wgmma_rs_n32, "m64n32k16", WG_D16, ACC16, 16, 17, 18, 19, 20, 21)
WGMMA_RS(wgmma_rs_n64, "m64n64k16", WG_D32, ACC32, 32, 33, 34, 35, 36, 37)
WGMMA_RS(wgmma_rs_n128, "m64n128k16", WG_D64, ACC64, 64, 65, 66, 67, 68, 69)

template <int N, bool kHalf>
__device__ __forceinline__ void mma_ss(float* d, uint64_t a, uint64_t b, int accumulate) {
  static_assert(N == 64 || N == 128, "QK^T takes 64- or 128-key tiles");
  if constexpr (N == 64) wgmma_ss_n64<kHalf>(d, a, b, accumulate);
  else wgmma_ss_n128<kHalf>(d, a, b, accumulate);
}

template <int N, bool kHalf>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a, uint64_t b) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "PV takes Dh 16, 32, 64 or 128");
  if constexpr (N == 16) wgmma_rs_n16<kHalf>(d, a, b);
  else if constexpr (N == 32) wgmma_rs_n32<kHalf>(d, a, b);
  else if constexpr (N == 64) wgmma_rs_n64<kHalf>(d, a, b);
  else wgmma_rs_n128<kHalf>(d, a, b);
}

template <typename T>
struct Half2;
template <>
struct Half2<__nv_bfloat16> {
  using T2 = __nv_bfloat162;
  static constexpr bool kHalf = false;
  static __device__ T2 make(float x, float y) { return __floats2bfloat162_rn(x, y); }
};
template <>
struct Half2<__half> {
  using T2 = __half2;
  static constexpr bool kHalf = true;
  static __device__ T2 make(float x, float y) { return __floats2half2_rn(x, y); }
};

// (x, y) -> hi = 16-bit (x, y), lo = 16-bit (x - hi.x, y - hi.y), packed
// low half first as the A fragment takes them.
template <typename T>
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  using H = Half2<T>;
  const typename H::T2 h = H::make(x, y);
  const typename H::T2 r = H::make(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kTcThreads, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, T* __restrict__ o, int S, int H, int KH,
    float scale) {
  using L = TcLayout<D, BK>;
  constexpr bool kHalf = Half2<T>::kHalf;
  constexpr int kSlices = L::kAtom / 16;  // 16-column K slices per atom row
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];  // q full; k full, v full, empty per slot

  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = q_s + L::kK;
  const uint32_t v_s = q_s + L::kV;
  const uint32_t q_full = smem_addr(bars);
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kStages, empty = v_full + 8 * kStages;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kh = h / (H / KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest rows first
  const int n_tiles = (min(q0 + kBQ, S) - 1) / BK + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load of the block ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(q_full, L::kQBytes);
      for (int a = 0; a < L::kAtoms; ++a)
        tma_load(q_s + a * kBQ * L::kRowBytes, &qmap, q_full, a * L::kAtom, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages, round = t / kStages;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        const uint32_t off = s * L::kTileBytes;
        mbar_expect_tx(k_full + 8 * s, L::kTileBytes);
        for (int a = 0; a < L::kAtoms; ++a)
          tma_load(k_s + off + a * BK * L::kRowBytes, &kmap, k_full + 8 * s, a * L::kAtom, kh, t * BK, b);
        mbar_expect_tx(v_full + 8 * s, L::kTileBytes);
        for (int a = 0; a < L::kAtoms; ++a)
          tma_load(v_s + off + a * BK * L::kRowBytes, &vmap, v_full + 8 * s, a * L::kAtom, kh, t * BK, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows r0 .. r0 + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128;
    const int r0 = q0 + 64 * wg;
    // accumulator fragment: element 4j + 2i + e of a 64 x N product sits at
    // row `row + 8i`, column 8j + `col` + e
    const int row = r0 + 16 * (tid / 32) + (tid % 32) / 4;
    const int col = 2 * (tid % 4);
    const uint32_t q_wg = q_s + 64 * wg * L::kRowBytes;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // m in raw-score units; l over this thread's columns only
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    const float c = scale * 1.4426950408889634f;  // raw score -> exp2 exponent: Dh**-0.5 · log2(e)

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t parity = (t / kStages) & 1;
      const int c0 = t * BK;
      const bool work = r0 < S && c0 <= r0 + 63;  // else wholly above this warpgroup's diagonal
      float sc[BK / 2];
      uint32_t p_hi[BK / 4], p_lo[BK / 4];

      mbar_wait(k_full + 8 * s, parity);
      if (work) {
        const uint32_t k_t = k_s + s * L::kTileBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t in_row = (kk % kSlices) * 32;  // bytes into the atom row
          const uint64_t qd = make_desc(q_wg + (kk / kSlices) * kBQ * L::kRowBytes + in_row, 16,
                                        8 * L::kRowBytes, L::kDescLayout);
          const uint64_t kd = make_desc(k_t + (kk / kSlices) * BK * L::kRowBytes + in_row, 16,
                                        8 * L::kRowBytes, L::kDescLayout);
          mma_ss<BK, kHalf>(sc, qd, kd, kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // p = exp(scale·(s - m)) = 2^(c·s - c·m), m in raw-score units
        if (c0 + BK - 1 > r0) {  // the tile crosses this warpgroup's diagonal
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            const int key = c0 + 8 * (i / 4) + col + i % 2;
            if (key > row + 8 * ((i / 2) % 2)) sc[i] = kNegInf;
          }
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
        float alpha[2], mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = quad_max(mx[r]);
          alpha[r] = exp2_approx((m[r] - mx[r]) * c);
          m[r] = mx[r];
          mc[r] = mx[r] * c;
        }
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          sc[i] = exp2_approx(fmaf(sc[i], c, -mc[(i / 2) % 2]));
          sum[(i / 2) % 2] += sc[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
#pragma unroll
        for (int i = 0; i < BK / 4; ++i) split_pair<T>(sc[2 * i], sc[2 * i + 1], p_hi[i], p_lo[i]);
      }

      mbar_wait(v_full + 8 * s, parity);
      if (work) {
        const uint32_t v_t = v_s + s * L::kTileBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {  // keys 16kk .. 16kk + 15: A = p[4kk .. 4kk + 3]
          const uint64_t vd = make_desc(v_t + kk * 16 * L::kRowBytes, BK * L::kRowBytes,
                                        8 * L::kRowBytes, L::kDescLayout);
          mma_rs<D, kHalf>(acc, p_hi + 4 * kk, vd);
          mma_rs<D, kHalf>(acc, p_lo + 4 * kk, vd);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        fence_regs(p_hi);
        fence_regs(p_lo);
      }
      mbar_arrive(empty + 8 * s);
    }

    if (r0 < S) {
      const int64_t stride = static_cast<int64_t>(H) * D;  // between positions
      T* ob = o + (static_cast<int64_t>(b) * S * H + h) * D;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float den = fmaxf(quad_sum(l[r]), 1e-30f);
        const int64_t pos = row + 8 * r;
        if (pos >= S) continue;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<typename Half2<T>::T2*>(ob + pos * stride + 8 * j + col) =
              Half2<T>::make(acc[4 * j + 2 * r] / den, acc[4 * j + 2 * r + 1] / den);
      }
    }
  }
}

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

// 4-D map over x[B, S, heads, D] as (D, heads, S, B), boxes of `rows`
// positions by `atom` columns of one head and batch.
bool encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* x, int64_t B, int64_t S,
                int64_t heads, int64_t D, int atom, int rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D * 2), static_cast<cuuint64_t>(heads * D * 2),
                                 static_cast<cuuint64_t>(S * heads * D * 2)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(atom), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(x), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D, int BK>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t S,
                 int64_t H, int64_t KH, cudaStream_t stream) {
  using L = TcLayout<D, BK>;
  const auto kernel = flash_attention_wgmma_kernel<T, D, BK>;
  static bool configured = false;  // above 48 KB needs the opt-in, once per kernel
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    // setmaxnreg only moves the block's registers between its warpgroups: a
    // block that starts with fewer than they end with would wait forever
    if (attr.numRegs * kTcThreads < 128 * kProducerRegs + 256 * kConsumerRegs) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    configured = true;
  }
  const CUtensorMapDataType type =
      Half2<T>::kHalf ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap qmap, kmap, vmap;
  if (!encode_map(&qmap, type, q, B, S, H, D, L::kAtom, kBQ, L::kSwizzle) ||
      !encode_map(&kmap, type, k, B, S, KH, D, L::kAtom, BK, L::kSwizzle) ||
      !encode_map(&vmap, type, v, B, S, KH, D, L::kAtom, BK, L::kSwizzle)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>((S + kBQ - 1) / kBQ));
  kernel<<<grid, kTcThreads, L::kSmem, stream>>>(
      qmap, kmap, vmap, static_cast<T*>(o), static_cast<int>(S), static_cast<int>(H),
      static_cast<int>(KH), static_cast<float>(std::pow(static_cast<double>(D), -0.5)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_wgmma_dh(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t S,
                    int64_t H, int64_t KH, int64_t D, cudaStream_t stream) {
  // 128-key tiles, the widest Q·Kᵀ product instantiated (shared memory holds
  // Q and two K/V slots in 20 KB at Dh 16, 36 KB at 32, 68 KB at 64); 64 at
  // Dh 128, where S's and O's accumulators share 240 registers
  switch (D) {
    case 16: return launch_wgmma<T, 16, 128>(q, k, v, o, B, S, H, KH, stream);
    case 32: return launch_wgmma<T, 32, 128>(q, k, v, o, B, S, H, KH, stream);
    case 64: return launch_wgmma<T, 64, 128>(q, k, v, o, B, S, H, KH, stream);
    case 128: return launch_wgmma<T, 128, 64>(q, k, v, o, B, S, H, KH, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ============ float32: the CUDA-core kernel ============
//
// One block owns 64 query rows of one (batch, head) and loops over 64-key
// tiles. 128 threads as 16 x 8: thread (ty, tx) owns query rows 4ty..4ty+3
// and, of each tile, keys 4tx + {0..3} and 32 + 4tx + {0..3}; of the output,
// columns 4tx + 32g + {0..3} (Dh a multiple of 32), or 2tx + {0, 1} at Dh
// 16, where the 8 threads of a row split its 16 columns in float2 pairs. So
// every shared-memory operand read is one 16-byte (8-byte) load, either a
// broadcast or a conflict-free run. q (scaled) and k
// sit in shared memory transposed, [Dh][68]; v reuses k's space as [64][Dh]
// once the scores are taken; the probabilities go through a [64][68] tile.
// Row maxima and sums are reduced over the 8 threads of a row.

constexpr int kF32BQ = 64;         // query rows per block
constexpr int kF32BK = 64;         // keys per tile
constexpr int kF32Threads = 128;   // 16 x 8
constexpr int kLd = kF32BQ + 4;    // row stride of the transposed tiles (16 B aligned rows)

__device__ __forceinline__ float row_max(float x) {  // over the 8 threads of a row
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

template <int D>
constexpr int f32_smem_floats() {
  return 2 * D * kLd + kF32BK * kLd;  // q^T, k^T (then v), p^T
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int64_t S, int64_t H, int64_t KH, float scale) {
  static_assert(D == 16 || D % 32 == 0, "head dim 16 or a multiple of 32");
  constexpr int kVec = D == 16 ? 2 : 4;  // output columns per group: a float2 or a float4
  constexpr int kGroups = D / (8 * kVec);  // groups of output columns per thread
  constexpr int kCols = kVec * kGroups;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [D][kLd]: qs[d * kLd + row] = q[row, d] * scale
  float* kv = qs + D * kLd;    // [D][kLd] k^T, then [kF32BK][D] v
  float* ps = kv + D * kLd;    // [kF32BK][kLd]: ps[key * kLd + row] = p[row, key]

  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / H;
  const int64_t h = bh % H;
  const int64_t kh = h / (H / KH);
  const int64_t q0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kF32BQ;  // longest rows first
  const int64_t q_stride = H * D;   // between sequence positions
  const int64_t kv_stride = KH * D;
  const float* qb = q + (b * S * H + h) * D;
  const float* kb = k + (b * S * KH + kh) * D;
  const float* vb = v + (b * S * KH + kh) * D;
  float* ob = o + (b * S * H + h) * D;

  for (int i = tid; i < kF32BQ * D; i += kF32Threads) {
    const int r = i / D, d = i % D;
    const int64_t s = q0 + r;
    qs[d * kLd + r] = s < S ? qb[s * q_stride + d] * scale : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  const int64_t last_row = (q0 + kF32BQ < S ? q0 + kF32BQ : S) - 1;
  const int64_t n_tiles = last_row / kF32BK + 1;
  for (int64_t t = 0; t < n_tiles; ++t) {
    const int64_t c0 = t * kF32BK;
    for (int i = tid; i < kF32BK * D; i += kF32Threads) {
      const int r = i / D, d = i % D;
      const int64_t s = c0 + r;
      kv[d * kLd + r] = s < S ? kb[s * kv_stride + d] : 0.f;
    }
    __syncthreads();  // q (first tile) and k are in place

    // scores: sc[i][j] for row 4ty+i, key 4tx + (j & 3) + 32 (j >> 2)
    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qs[d * kLd + 4 * ty]);
      const float4 k0 = *reinterpret_cast<const float4*>(&kv[d * kLd + 4 * tx]);
      const float4 k1 = *reinterpret_cast<const float4*>(&kv[d * kLd + 32 + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(av[i], bv[j], sc[i][j]);
    }

    // mask, then the online-softmax update of this thread's four rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t col = c0 + 4 * tx + (j & 3) + 32 * (j >> 2);
        if (col > row || col >= S) sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        sum += sc[i][j];
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = 4 * tx + (j & 3) + 32 * (j >> 2);
      *reinterpret_cast<float4*>(&ps[key * kLd + 4 * ty]) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    }
    __syncthreads();  // every thread is done with k^T; p is in place

    for (int i = tid; i < kF32BK * D; i += kF32Threads) {
      const int r = i / D, d = i % D;
      const int64_t s = c0 + r;
      kv[r * D + d] = s < S ? vb[s * kv_stride + d] : 0.f;
    }
    __syncthreads();  // v is in place

#pragma unroll 4
    for (int key = 0; key < kF32BK; ++key) {
      const float4 p = *reinterpret_cast<const float4*>(&ps[key * kLd + 4 * ty]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float* vrow = &kv[key * D + 8 * kVec * g + kVec * tx];
        float vv[kVec];
        if constexpr (kVec == 4) {
          const float4 x = *reinterpret_cast<const float4*>(vrow);
          vv[0] = x.x, vv[1] = x.y, vv[2] = x.z, vv[3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(vrow);
          vv[0] = x.x, vv[1] = x.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[i][kVec * g + e] = fmaf(pv[i], vv[e], acc[i][kVec * g + e]);
      }
    }
    __syncthreads();  // v and p are read before the next tile overwrites them
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t s = q0 + 4 * ty + i;
    if (s >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        ob[s * q_stride + 8 * kVec * g + kVec * tx + e] = acc[i][kVec * g + e] / den;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t S, int64_t H,
               int64_t KH, cudaStream_t stream) {
  constexpr int bytes = f32_smem_floats<D>() * static_cast<int>(sizeof(float));
  static bool configured = false;  // above 48 KB needs the opt-in, once per kernel
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>((S + kF32BQ - 1) / kF32BQ));
  flash_attention_f32_kernel<D><<<grid, kF32Threads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, H, KH, static_cast<float>(std::pow(static_cast<double>(D), -0.5)));  // D ** -0.5, as the reference
  return static_cast<int>(cudaGetLastError());
}

int launch_f32_dh(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t S,
                  int64_t H, int64_t KH, int64_t D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_f32<16>(q, k, v, o, B, S, H, KH, stream);
    case 32: return launch_f32<32>(q, k, v, o, B, S, H, KH, stream);
    case 64: return launch_f32<64>(q, k, v, o, B, S, H, KH, stream);
    case 128: return launch_f32<128>(q, k, v, o, B, S, H, KH, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// o[B, S, H, D] = causal attention of q[B, S, H, D] over k, v[B, S, KH, D],
// query head h reading KV head h / (H / KH); all row-major and contiguous,
// of one type: dtype 0 float32, 1 bfloat16, 2 float16. D is 16, 32, 64 or 128;
// 16-bit inputs start on 16-byte boundaries (TMA). Launches on `stream`;
// returns cudaGetLastError(), or an error code for a shape, type or address
// the kernels do not take.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int64_t B,
                               int64_t S, int64_t H, int64_t KH, int64_t D, int dtype,
                               void* stream) {
  if (B < 0 || S < 0 || H <= 0 || KH <= 0 || H % KH != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const int64_t rows = dtype == 0 ? kF32BQ : kBQ;
  if ((S + rows - 1) / rows > kMaxGridY || B * H > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v)) & 15) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  switch (dtype) {
    case 0: return launch_f32_dh(q, k, v, o, B, S, H, KH, D, st);
    case 1: return launch_wgmma_dh<__nv_bfloat16>(q, k, v, o, B, S, H, KH, D, st);
    case 2: return launch_wgmma_dh<__half>(q, k, v, o, B, S, H, KH, D, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
