// Fused staged sparse-GP conditional (diagonal), forward, for sm_90a.
//
// Replaces the TPU kernel doubly_stochastic_dgp_tpu/ops/pallas/
// conditional.py::_fused_forward (_fwd_kernel / _fwd_body) and, as the
// kSaveGram variant, its save_gram=True form (_fwd_kernel_sg), which also
// writes the gram K (B, M) for the backward to read instead of
// recomputing.  Per row x of the lengthscale-scaled batch Xs (B, Dx):
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
// computed as zeros and not stored.  Row offsets are 64-bit.  The saved
// gram is the value staged through shared memory, so the saved variant's
// mean and var equal the plain variant's bit for bit.

#include "fused_conditional.cuh"

namespace {

using namespace fc;

template <int RT, bool kSaveGram>
__global__ void __launch_bounds__(kThreads)
fused_conditional_fwd_kernel(const float* __restrict__ Xs,
                             const float* __restrict__ Zs,
                             const float* __restrict__ LiT,
                             const float* __restrict__ alpha,
                             const float* __restrict__ W,
                             const float* __restrict__ scal,
                             float* __restrict__ mean,
                             float* __restrict__ var,
                             float* __restrict__ Kout,
                             int64_t B, int M, int Dx, int Do) {
  constexpr int TB = RT * kWarps;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Mp = padded(M);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* Kw = smem + (size_t)warp * RT * Mp;         // this warp's K rows
  float* Gw = smem + (size_t)(TB + warp * RT) * Mp;  // this warp's G rows
  const int64_t row0 = (int64_t)blockIdx.x * TB + (int64_t)warp * RT;
  const float kvar = scal[0];
  const float kdiag = scal[1];

  // 1. gram rows: K[i][m], zero past M and for rows past B (and to the
  //    saved gram in the kSaveGram variant)
  gram_rows<RT>(Xs, Zs, kvar, Kw, Mp, row0, B, M, Dx, lane,
                kSaveGram ? Kout : nullptr);
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

template <int RT, bool kSaveGram>
cudaError_t launch(const float* Xs, const float* Zs, const float* LiT,
                   const float* alpha, const float* W, const float* scal,
                   float* mean, float* var, float* Kout, int64_t B, int M,
                   int Dx, int Do, cudaStream_t stream) {
  constexpr int TB = RT * kWarps;
  const int Mp = padded(M);
  const size_t smem = (size_t)2 * TB * Mp * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_conditional_fwd_kernel<RT, kSaveGram>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (B + TB - 1) / TB;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  fused_conditional_fwd_kernel<RT, kSaveGram>
      <<<(unsigned)blocks, kThreads, smem, stream>>>(
          Xs, Zs, LiT, alpha, W, scal, mean, var, Kout, B, M, Dx, Do);
  return cudaGetLastError();
}

template <bool kSaveGram>
cudaError_t launch_rows(const float* Xs, const float* Zs, const float* LiT,
                        const float* alpha, const float* W,
                        const float* scal, float* mean, float* var,
                        float* Kout, int64_t B, int M, int Dx, int Do,
                        cudaStream_t s) {
  // 64 rows per block while the two tiles fit in 128 KB, else 32
  if (padded(M) <= 256)
    return launch<8, kSaveGram>(Xs, Zs, LiT, alpha, W, scal, mean, var,
                                Kout, B, M, Dx, Do, s);
  return launch<4, kSaveGram>(Xs, Zs, LiT, alpha, W, scal, mean, var, Kout,
                              B, M, Dx, Do, s);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Pointers are device pointers
// to contiguous float32 tensors; scal holds (kvar, kdiag) on the device.
// Kout is null, or the (B, M) gram to write (the save_gram variant).
// Returns a cudaError_t code (0 = launched).
extern "C" int fused_conditional_fwd(const float* Xs, const float* Zs,
                                     const float* LiT, const float* alpha,
                                     const float* W, const float* scal,
                                     float* mean, float* var, float* Kout,
                                     int64_t B, int M, int Dx, int Do,
                                     void* stream) {
  if (B <= 0 || M <= 0 || M > kMaxM || Dx <= 0 || Do <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Kout != nullptr)
    return (int)launch_rows<true>(Xs, Zs, LiT, alpha, W, scal, mean, var,
                                  Kout, B, M, Dx, Do, s);
  return (int)launch_rows<false>(Xs, Zs, LiT, alpha, W, scal, mean, var,
                                 nullptr, B, M, Dx, Do, s);
}
