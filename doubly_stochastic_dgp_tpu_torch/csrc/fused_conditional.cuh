// Device helpers shared by the fused conditional's forward
// (fused_conditional.cu) and backward (fused_conditional_bwd.cu) kernels.
//
// Both kernels give each of a block's 8 warps RT rows of the batch and
// keep (rows x M) tiles in shared memory with row stride Mp = M rounded
// up to 4 (for float4 reads), zero past column M.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fc {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 4;            // columns per lane per chunk
constexpr int kChunk = 32 * kCols;  // columns per warp per chunk
constexpr int kMaxM = 512;

__host__ __device__ __forceinline__ int padded(int M) { return (M + 3) & ~3; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float comp(const float4& a, int k) {
  return k == 0 ? a.x : k == 1 ? a.y : k == 2 ? a.z : a.w;
}

// acc[i][j] = sum_k A[i][k] * Bm[k][c0 + lane + 32 j] for the warp's RT
// rows of A (shared, row stride Mp, zero past M) and the M x M matrix Bm
// (global, row-major).
template <int RT>
__device__ __forceinline__ void rows_times_matrix(
    const float* As, int Mp, const float* __restrict__ Bm, int M, int c0,
    int lane, float (&acc)[RT][kCols]) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < M; k += 4) {
    float b[4][kCols];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = c0 + lane + 32 * j;
        const int kr = k + kk;
        b[kk][j] = (kr < M && c < M) ? __ldg(Bm + (size_t)kr * M + c) : 0.f;
      }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(As + i * Mp + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float av = comp(a, kk);
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(av, b[kk][j], acc[i][j]);
      }
    }
  }
}

// The warp's RT gram rows K[i][m] = kvar exp(-0.5 ||x_r - z_m||^2) into
// Kw (zero past M and for rows past B), as the direct sum of squared
// differences.  With Kout, each computed entry is also stored to the
// (B, M) gram in global memory: exactly the value staged here.
template <int RT>
__device__ __forceinline__ void gram_rows(
    const float* __restrict__ Xs, const float* __restrict__ Zs, float kvar,
    float* Kw, int Mp, int64_t row0, int64_t B, int M, int Dx, int lane,
    float* __restrict__ Kout) {
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int64_t r = row0 + i;
    for (int m = lane; m < Mp; m += 32) {
      float k = 0.f;
      if (r < B && m < M) {
        const float* x = Xs + r * Dx;
        const float* z = Zs + (size_t)m * Dx;
        float d2 = 0.f;
        for (int d = 0; d < Dx; ++d) {
          const float t = __ldg(x + d) - __ldg(z + d);
          d2 = fmaf(t, t, d2);
        }
        k = kvar * expf(-0.5f * d2);
        if (Kout != nullptr) Kout[r * M + m] = k;
      }
      Kw[i * Mp + m] = k;
    }
  }
}

}  // namespace fc
