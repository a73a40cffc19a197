// Fused staged sparse-GP conditional (diagonal), forward, for sm_90a.
//
// Replaces the TPU kernel doubly_stochastic_dgp_tpu/ops/pallas/
// conditional.py::_fused_forward (_fwd_kernel / _fwd_body).  Per row x of
// the lengthscale-scaled batch Xs (B, Dx):
//
//   K(x)     = kvar * exp(-0.5 ||x - z_m||^2)           (M,)
//   G(x)     = K(x) LiT                                 (M,)
//   mean_d   = G(x) . alpha[:, d]                       (Do,)
//   var_d    = max(kdiag + G(x) . (G(x) W_d), 0)        (Do,)
//
// What bounds it on an H100: operations.  Per row it does about
// 2*M*Dx (gram) + 2*M^2 (staging) + 2*M*Do (mean) + Do*(2*M^2 + 2*M)
// (variance) flops against reading Dx floats and writing 2*Do floats;
// at M = 100, Do = 8 that is ~180 kflop per 72 bytes, far above the
// card's ~20 flop/byte fp32 ridge.  The operands Zs, LiT, alpha and W
// are shared by every row (under 0.4 MB at M = 100, Do = 8) and stay in
// L2/L1.
//
// Design.  One block owns TB = 8*RT rows; each of its 8 warps owns RT
// rows end to end (gram, staging, mean and every var_d), so the warps
// never wait on each other.  The K and G tiles of the warp's rows live in
// shared memory for the whole d sweep: G is computed once and reused for
// the mean and all Do variances, as the TPU kernel kept G in VMEM
// across its d grid axis.  The two (rows x M) by (M x M) products run as
// register-tiled fp32 FFMA: each lane accumulates RT rows x 4 columns,
// reading the row operand from shared memory as float4 broadcasts and the
// matrix operand from global memory in coalesced 32-lane rows.  No TF32,
// no tensor cores: the contract is fp32-accurate (the JAX kernel pins
// HIGHEST precision).  The squared distance is the direct sum of squared
// differences, as in fused_conditional_reference: it has no cancellation,
// where the expansion ||x||^2 + ||z||^2 - 2 x.z loses digits when x is
// near z and exp() amplifies the loss.  Ragged edges are masked here (no
// padding of M to 128 and no one-hot lane masks, which were Mosaic
// workarounds): the shared tiles are zero past column M, rows past B are
// computed as zeros and not stored.  Row offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 4;            // columns per lane per chunk
constexpr int kChunk = 32 * kCols;  // columns per warp per chunk
constexpr int kMaxM = 512;

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

template <int RT>
__global__ void __launch_bounds__(kThreads)
fused_conditional_fwd_kernel(const float* __restrict__ Xs,
                             const float* __restrict__ Zs,
                             const float* __restrict__ LiT,
                             const float* __restrict__ alpha,
                             const float* __restrict__ W,
                             const float* __restrict__ scal,
                             float* __restrict__ mean,
                             float* __restrict__ var,
                             int64_t B, int M, int Dx, int Do) {
  constexpr int TB = RT * kWarps;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Mp = (M + 3) & ~3;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* Kw = smem + (size_t)warp * RT * Mp;         // this warp's K rows
  float* Gw = smem + (size_t)(TB + warp * RT) * Mp;  // this warp's G rows
  const int64_t row0 = (int64_t)blockIdx.x * TB + (int64_t)warp * RT;
  const float kvar = scal[0];
  const float kdiag = scal[1];

  // 1. gram rows: K[i][m], zero past M and for rows past B
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
      }
      Kw[i * Mp + m] = k;
    }
  }
  __syncwarp();

  // 2. staging: G = K LiT, kept in shared memory (zero past M)
  float acc[RT][kCols];
  for (int c0 = 0; c0 < Mp; c0 += kChunk) {
    rows_times_matrix<RT>(Kw, Mp, LiT, M, c0, lane, acc);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = c0 + lane + 32 * j;
        if (c < Mp) Gw[i * Mp + c] = acc[i][j];
      }
  }
  __syncwarp();

  // 3. mean_d = G . alpha[:, d]
  for (int d = 0; d < Do; ++d) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float s = 0.f;
      for (int n = lane; n < M; n += 32)
        s = fmaf(Gw[i * Mp + n], __ldg(alpha + (size_t)n * Do + d), s);
      s = warp_sum(s);
      const int64_t r = row0 + i;
      if (lane == 0 && r < B) mean[r * Do + d] = s;
    }
  }

  // 4. var_d = max(kdiag + G . (G W_d), 0)
  for (int d = 0; d < Do; ++d) {
    const float* Wd = W + (size_t)d * M * M;
    float part[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) part[i] = 0.f;
    for (int c0 = 0; c0 < M; c0 += kChunk) {
      rows_times_matrix<RT>(Gw, Mp, Wd, M, c0, lane, acc);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = c0 + lane + 32 * j;
          if (c < M) part[i] = fmaf(acc[i][j], Gw[i * Mp + c], part[i]);
        }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float s = warp_sum(part[i]);
      const int64_t r = row0 + i;
      if (lane == 0 && r < B) var[r * Do + d] = fmaxf(kdiag + s, 0.f);
    }
  }
}

template <int RT>
cudaError_t launch(const float* Xs, const float* Zs, const float* LiT,
                   const float* alpha, const float* W, const float* scal,
                   float* mean, float* var, int64_t B, int M, int Dx,
                   int Do, cudaStream_t stream) {
  constexpr int TB = RT * kWarps;
  const int Mp = (M + 3) & ~3;
  const size_t smem = (size_t)2 * TB * Mp * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_conditional_fwd_kernel<RT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (B + TB - 1) / TB;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  fused_conditional_fwd_kernel<RT><<<(unsigned)blocks, kThreads, smem,
                                     stream>>>(Xs, Zs, LiT, alpha, W, scal,
                                               mean, var, B, M, Dx, Do);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Pointers are device pointers
// to contiguous float32 tensors; scal holds (kvar, kdiag) on the device.
// Returns a cudaError_t code (0 = launched).
extern "C" int fused_conditional_fwd(const float* Xs, const float* Zs,
                                     const float* LiT, const float* alpha,
                                     const float* W, const float* scal,
                                     float* mean, float* var, int64_t B,
                                     int M, int Dx, int Do, void* stream) {
  if (B <= 0 || M <= 0 || M > kMaxM || Dx <= 0 || Do <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Mp = (M + 3) & ~3;
  // 64 rows per block while the two tiles fit in 128 KB, else 32
  if (Mp <= 256)
    return (int)launch<8>(Xs, Zs, LiT, alpha, W, scal, mean, var, B, M, Dx,
                          Do, s);
  return (int)launch<4>(Xs, Zs, LiT, alpha, W, scal, mean, var, B, M, Dx, Do,
                        s);
}
