// Two-tower candidate scoring (queries against a candidate corpus) for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/scoring/scoring.py::scoring_pallas (body
// _scoring_kernel). That kernel keeps the [B, D] queries resident in VMEM
// and does one MXU product per 2048-candidate tile. This kernel computes the
// same float32 scores[b, n] = sum_d queries[b, d] * candidates[n, d].
//
// What bounds it on the H100: at B = 1, bytes (the [N, D] candidates are
// read once: 1 GiB at N = 2^20, D = 256). From B of about 50 up, operations:
// 2 B N D float32 multiply-adds on the CUDA cores. There is no TF32: the
// JAX package holds scoring at 1e-5, which TF32's 10-bit mantissa misses,
// so the tensor cores are out of play.
//
// Design: a tiled SGEMM on the CUDA cores. A block of 256 threads owns a
// [64 queries x 128 candidates] output tile and walks D in steps of 16. Both
// operand tiles are staged in shared memory, transposed and double-buffered
// (the next step's global loads are issued before this step's FMAs), so each
// candidate row is read from device memory once per 64-query tile. Each
// thread keeps a 4 x 8 sub-tile of sums in registers and reads its operands
// as float4 from shared memory. Query rows past B and depth past D load as
// 0; threads whose query rows all lie past B skip the FMAs (at B = 1 only
// one thread row in sixteen computes, the rest only load). N must be a
// multiple of 128; the wrapper requires multiples of the 2048-candidate tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;         // queries per block
constexpr int kBN = 128;        // candidates per block
constexpr int kBK = 16;         // depth per step
constexpr int kThreads = 256;   // 16 x 16: tx over candidates, ty over queries
constexpr int kLdA = kBM + 4;   // padded rows: 2-way bank conflicts at most on the
constexpr int kLdB = kBN + 4;   // transposing stores, 16 B aligned for float4 reads
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads) scoring_kernel(
    const float* __restrict__ q, const float* __restrict__ c, float* __restrict__ out,
    int64_t B, int64_t N, int64_t D) {
  __shared__ __align__(16) float As[2][kBK][kLdA];
  __shared__ __align__(16) float Bs[2][kBK][kLdB];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const bool active = m0 + ty * 4 < B;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // Staging: thread (ty, tx) loads depth k0 + tx of query rows ty + 16p and
  // candidate rows ty + 16p, so a warp reads two 64 B runs of each row.
  float ra[kBM / 16];
  float rb[kBN / 16];
  auto load = [&](int64_t k0) {
    const int64_t k = k0 + tx;
    const bool kin = k < D;
#pragma unroll
    for (int p = 0; p < kBM / 16; ++p) {
      const int64_t row = m0 + ty + 16 * p;
      ra[p] = (kin && row < B) ? __ldg(q + row * D + k) : 0.f;
    }
#pragma unroll
    for (int p = 0; p < kBN / 16; ++p) {
      const int64_t row = n0 + ty + 16 * p;
      rb[p] = kin ? __ldg(c + row * D + k) : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int p = 0; p < kBM / 16; ++p) As[buf][tx][ty + 16 * p] = ra[p];
#pragma unroll
    for (int p = 0; p < kBN / 16; ++p) Bs[buf][tx][ty + 16 * p] = rb[p];
  };

  const int64_t steps = (D + kBK - 1) / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int64_t s = 0; s < steps; ++s) {
    const int cur = static_cast<int>(s & 1);
    const bool more = s + 1 < steps;
    if (more) load((s + 1) * kBK);
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    if (more) store(cur ^ 1);
    __syncthreads();
  }

  // Thread (ty, tx) holds rows ty*4 + i and columns tx*4 + j, 64 + tx*4 + j.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = m0 + ty * 4 + i;
    if (row < B) {
      float* o = out + row * N + n0;
      *reinterpret_cast<float4*>(o + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(o + 64 + tx * 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

}  // namespace

// scores[B, N] = queries[B, D] @ candidates[N, D]^T, all float32, row-major
// and contiguous; N a multiple of 128, `scores` 16 B aligned. Launches on
// `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue for a shape
// the kernel does not take.
extern "C" int scoring(const void* queries, const void* candidates, void* scores, int64_t B,
                       int64_t N, int64_t D, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (N % kBN != 0 || D <= 0 || (B + kBM - 1) / kBM > kMaxGridY) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(N / kBN), static_cast<unsigned>((B + kBM - 1) / kBM));
  scoring_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(queries), static_cast<const float*>(candidates),
      static_cast<float*>(scores), B, N, D);
  return static_cast<int>(cudaGetLastError());
}
