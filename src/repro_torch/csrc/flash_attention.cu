// Causal flash attention (forward) with grouped KV heads, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/attention/flash_attention.py::flash_attention_pallas
// (body _flash_kernel). That kernel walks a sequential grid axis over 512-key
// tiles and carries the online softmax's float32 m, l and acc in VMEM scratch
// from one grid step to the next. This kernel computes the same function: q
// cast to float32 and scaled by Dh**-0.5, float32 scores masked to -1e30
// where key > query, float32 m/l/acc, out = acc / max(l, 1e-30) in q's type.
// It also takes what the TPU kernel leaves to its caller:
//   - grouped KV heads: query head h reads KV head h / (H / K), so the
//     layer's [B, S, K, Dh] k and v are read as they are, never expanded;
//   - any S: the ragged last query and key tiles are masked here.
//
// What bounds it on the H100: operations. A head's causal attention does
// 2 Dh S (S + 1) flop; the bytes (q, k, v, o, each once) are two orders of
// magnitude fewer. This first version does its float32 math on the CUDA
// cores (67 TFLOP/s), not the tensor cores (989 TFLOP/s in bf16): right and
// simple first, the tensor-core redesign comes after it.
//
// Design: no carry across blocks (Hopper's blocks run in no order), so one
// block owns 64 query rows of one (batch, head) and loops over 64-key tiles
// itself, stopping at the diagonal: a tile wholly above it adds
// exp(-1e30 - m) = 0 to every sum and leaves m as it is, so skipping it is
// exact. Blocks of the longest rows start first. 128 threads as 16 x 8:
// thread (ty, tx) owns query rows 4ty..4ty+3 and, of each 64-key tile, keys
// 4tx + {0..3} and 32 + 4tx + {0..3} (of the output, columns 4tx + 32g +
// {0..3}), so every shared-memory operand read is one 16-byte load, either a
// broadcast or a conflict-free run. q (scaled) and k sit in shared memory
// transposed, [Dh][68]; v reuses k's space as [64][Dh] once the scores are
// taken; the probabilities go through a [64][68] tile. Row maxima and sums
// are reduced over the 8 threads of a row with warp shuffles. Every flat
// offset is 64-bit: prefill at [32, 32768, 32, 64] holds 2.1e9 elements.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 128;   // 16 x 8
constexpr int kLd = kBQ + 4;    // row stride of the transposed tiles (16 B aligned rows)
constexpr float kNegInf = -1e30f;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

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
constexpr int smem_floats() {
  return 2 * D * kLd + kBK * kLd;  // q^T, k^T (then v), p^T
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
    int64_t S, int64_t H, int64_t KH, float scale) {
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");
  constexpr int G4 = D / 32;  // float4 groups of output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [D][kLd]: qs[d * kLd + row] = q[row, d] * scale
  float* kv = qs + D * kLd;    // [D][kLd] k^T, then [kBK][D] v
  float* ps = kv + D * kLd;    // [kBK][kLd]: ps[key * kLd + row] = p[row, key]

  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / H;
  const int64_t h = bh % H;
  const int64_t kh = h / (H / KH);
  const int64_t q0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kBQ;  // longest rows first
  const int64_t q_stride = H * D;   // between sequence positions
  const int64_t kv_stride = KH * D;
  const T* qb = q + (b * S * H + h) * D;
  const T* kb = k + (b * S * KH + kh) * D;
  const T* vb = v + (b * S * KH + kh) * D;
  T* ob = o + (b * S * H + h) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int64_t s = q0 + r;
    qs[d * kLd + r] = s < S ? to_f32(qb[s * q_stride + d]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][4 * G4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * G4; ++j) acc[i][j] = 0.f;
  }

  const int64_t last_row = (q0 + kBQ < S ? q0 + kBQ : S) - 1;
  const int64_t n_tiles = last_row / kBK + 1;
  for (int64_t t = 0; t < n_tiles; ++t) {
    const int64_t c0 = t * kBK;
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const int64_t s = c0 + r;
      kv[d * kLd + r] = s < S ? to_f32(kb[s * kv_stride + d]) : 0.f;
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
      for (int j = 0; j < 4 * G4; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = 4 * tx + (j & 3) + 32 * (j >> 2);
      *reinterpret_cast<float4*>(&ps[key * kLd + 4 * ty]) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    }
    __syncthreads();  // every thread is done with k^T; p is in place

    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const int64_t s = c0 + r;
      kv[r * D + d] = s < S ? to_f32(vb[s * kv_stride + d]) : 0.f;
    }
    __syncthreads();  // v is in place

#pragma unroll 4
    for (int key = 0; key < kBK; ++key) {
      const float4 p = *reinterpret_cast<const float4*>(&ps[key * kLd + 4 * ty]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < G4; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(&kv[key * D + 32 * g + 4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * g + 0] = fmaf(pv[i], vv.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(pv[i], vv.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(pv[i], vv.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(pv[i], vv.w, acc[i][4 * g + 3]);
        }
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
    for (int g = 0; g < G4; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ob[s * q_stride + 32 * g + 4 * tx + e] = from_f32<T>(acc[i][4 * g + e] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t S, int64_t H,
           int64_t KH, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  static bool configured = false;  // above 48 KB needs the opt-in, once per kernel
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>((S + kBQ - 1) / kBQ));
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, KH, static_cast<float>(std::pow(static_cast<double>(D), -0.5)));  // D ** -0.5, as the reference
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t S,
              int64_t H, int64_t KH, int64_t D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KH, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KH, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KH, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// o[B, S, H, D] = causal attention of q[B, S, H, D] over k, v[B, S, KH, D],
// query head h reading KV head h / (H / KH); all row-major and contiguous,
// of one type: dtype 0 float32, 1 bfloat16, 2 float16. D is 32, 64 or 128.
// Launches on `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue
// for a shape or type the kernel does not take.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int64_t B,
                               int64_t S, int64_t H, int64_t KH, int64_t D, int dtype,
                               void* stream) {
  if (B < 0 || S < 0 || H <= 0 || KH <= 0 || H % KH != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  if ((S + kBQ - 1) / kBQ > kMaxGridY || B * H > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dh<float>(q, k, v, o, B, S, H, KH, D, st);
    case 1: return launch_dh<__nv_bfloat16>(q, k, v, o, B, S, H, KH, D, st);
    case 2: return launch_dh<__half>(q, k, v, o, B, S, H, KH, D, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
