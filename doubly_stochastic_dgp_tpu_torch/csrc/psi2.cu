// psi2 data-sum forward (the psi2_core contract), for sm_90a.
//
// Replaces the TPU kernel doubly_stochastic_dgp_tpu/ops/pallas/psi2.py::
// _psi2_core_fwd_call (_fwd_kernel), the all-Pallas forward of psi2_core.
// For U, V (N, M), w (N, D) with w >= 0, logdet (N, 1) and Z (M, D):
//
//   out[a, b] = sum_n exp(min(U[n,a] + V[n,b]
//                             - sum_d w[n,d] Z[a,d] Z[b,d], 0) + logdet[n])
//
// What bounds it on an H100: operations, not bytes.  Each (n, a, b) term
// is one exp and 4 + 2D fp32 flops, against 8 bytes of U and V per (n, a)
// pair: at N = 7372, M = 256, D = 2 that is 483 M exps and 3.9 GFLOP for
// 15 MB read.  The exps run on the SFU (16 a clock per SM, against 128
// FFMA lanes), so at small D the exp rate sets the bound; at D = 8 the
// flops do.
//
// Design.  The (N, M, M) block never exists in memory (the TPU kernel
// kept it in VMEM one n-block at a time; here it lives in registers one
// row at a time).  A block of 16 x 16 threads owns a 64 x 64 tile of the
// output, each thread a 4 x 4 register tile (a = a0 + ty + 16 i, b = b0 +
// tx + 16 j, so the shared-memory reads of one warp are broadcasts or
// consecutive words).  At M = 256 there are only 16 such tiles, so the
// rows are also split into chunks, enough to give the card's SMs about
// four blocks each; a block stages its chunk 32 rows at a time (U[:, a
// tile], V[:, b tile], w, logdet) in shared memory.  For D <= 8 the
// thread's Z rows sit in registers; above that they are read from shared
// memory.  Each thread sums 32 rows into a fresh register tile, so no
// serial chain of adds is longer than 32; the steps' sums go into the
// chunk total, and a second kernel adds the chunks' partial outputs in
// chunk order, both with Kahan's compensated sum: with plain serial sums
// there the kernel came out further from float64 than the plain version
// (whose sum is a tree), and the contract allows it at most twice the
// plain version's error.  No atomics, so repeat launches are
// bit-identical.  The ragged tail is masked (a step stages only the rows
// that exist; tile columns past M are zero and not stored), so there is
// no padding.  The clamp argument is formed as the plain version forms
// it (U + V, then the d terms), with the d terms as FMAs.  Row offsets
// are 64-bit.  exp is __expf (ex2.approx) or expf, chosen by the caller
// (the wrapper takes __expf: expf was no more accurate, see PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "psi2_common.cuh"

namespace {

using psi2::exp_;
using psi2::kahan_add;
using psi2::kMaxD;
using psi2::kMaxM;

constexpr int kSide = 16;               // threads per tile side
constexpr int kThreads = kSide * kSide;
constexpr int kPer = 4;                 // a's and b's per thread
constexpr int kTile = kSide * kPer;     // 64
constexpr int kRows = 32;               // rows staged per step

// DT > 0: D == DT, the thread's Z values held in registers.
// DT == 0: any D <= kMaxD, Z read from shared memory.
template <int DT, bool kFastExp>
__global__ void __launch_bounds__(kThreads, DT >= 1 && DT <= 4 ? 2 : 1)
psi2_fwd_kernel(const float* __restrict__ U, const float* __restrict__ V,
                const float* __restrict__ w,
                const float* __restrict__ logdet,
                const float* __restrict__ Z, float* __restrict__ part,
                int64_t N, int M, int D, int tiles_b,
                int64_t rows_per_chunk) {
  __shared__ float sU[kRows][kTile];
  __shared__ float sV[kRows][kTile];
  __shared__ float sW[kRows][kMaxD];
  __shared__ float sL[kRows];
  __shared__ float sZa[kMaxD][kTile];   // [d][a], zero past M
  __shared__ float sZb[kMaxD][kTile];

  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const int a0 = (blockIdx.x / tiles_b) * kTile;
  const int b0 = (blockIdx.x % tiles_b) * kTile;
  const int64_t n_begin = (int64_t)blockIdx.y * rows_per_chunk;
  const int64_t n_end = n_begin + rows_per_chunk < N
                            ? n_begin + rows_per_chunk : N;
  const int Dn = DT > 0 ? DT : D;

  for (int i = threadIdx.x; i < Dn * kTile; i += kThreads) {
    const int d = i / kTile, c = i % kTile;
    sZa[d][c] = a0 + c < M ? Z[(size_t)(a0 + c) * D + d] : 0.f;
    sZb[d][c] = b0 + c < M ? Z[(size_t)(b0 + c) * D + d] : 0.f;
  }
  __syncthreads();
  constexpr int kRegD = DT > 0 ? DT : 1;
  float za[kPer][kRegD], zb[kPer][kRegD];
  if constexpr (DT > 0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        za[i][d] = sZa[d][ty + kSide * i];
        zb[i][d] = sZb[d][tx + kSide * i];
      }
  }

  float acc[kPer][kPer], comp[kPer][kPer];   // Kahan sum over steps
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = comp[i][j] = 0.f;

  for (int64_t r0 = n_begin; r0 < n_end; r0 += kRows) {
    const int rows = (int)(n_end - r0 < kRows ? n_end - r0 : kRows);
    __syncthreads();                    // the last step's reads are done
    for (int i = threadIdx.x; i < kRows * kTile; i += kThreads) {
      const int r = i / kTile, c = i % kTile;
      const int64_t n = r0 + r;
      sU[r][c] = r < rows && a0 + c < M ? U[n * M + a0 + c] : 0.f;
      sV[r][c] = r < rows && b0 + c < M ? V[n * M + b0 + c] : 0.f;
    }
    for (int i = threadIdx.x; i < rows * Dn; i += kThreads) {
      const int r = i / Dn, d = i % Dn;
      sW[r][d] = w[(r0 + r) * D + d];
    }
    if (threadIdx.x < rows) sL[threadIdx.x] = logdet[r0 + threadIdx.x];
    __syncthreads();

    float s[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = 0.f;
    for (int r = 0; r < rows; ++r) {
      float pre[kPer][kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float u = sU[r][ty + kSide * i];
#pragma unroll
        for (int j = 0; j < kPer; ++j) pre[i][j] = u + sV[r][tx + kSide * j];
      }
      if constexpr (DT > 0) {
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          const float wd = sW[r][d];
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            const float wz = wd * za[i][d];
#pragma unroll
            for (int j = 0; j < kPer; ++j)
              pre[i][j] = fmaf(-wz, zb[j][d], pre[i][j]);
          }
        }
      } else {
        for (int d = 0; d < D; ++d) {
          const float wd = sW[r][d];
          float zbd[kPer];
#pragma unroll
          for (int j = 0; j < kPer; ++j) zbd[j] = sZb[d][tx + kSide * j];
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            const float wz = wd * sZa[d][ty + kSide * i];
#pragma unroll
            for (int j = 0; j < kPer; ++j)
              pre[i][j] = fmaf(-wz, zbd[j], pre[i][j]);
          }
        }
      }
      const float ld = sL[r];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          s[i][j] += exp_<kFastExp>(fminf(pre[i][j], 0.f) + ld);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        kahan_add(acc[i][j], comp[i][j], s[i][j]);
  }

  float* out = part + (size_t)blockIdx.y * M * M;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int a = a0 + ty + kSide * i;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int b = b0 + tx + kSide * j;
      if (a < M && b < M) out[(size_t)a * M + b] = acc[i][j];
    }
  }
}

// out = sum over chunks of part[c], in chunk order (Kahan)
__global__ void psi2_sum_chunks_kernel(const float* __restrict__ part,
                                       float* __restrict__ out, int chunks,
                                       int64_t MM) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MM) return;
  float s = 0.f, comp = 0.f;
  for (int c = 0; c < chunks; ++c) kahan_add(s, comp, part[c * MM + i]);
  out[i] = s;
}

template <int DT, bool kFastExp>
cudaError_t launch(const float* U, const float* V, const float* w,
                   const float* logdet, const float* Z, float* part,
                   int64_t N, int M, int D, int chunks, cudaStream_t stream) {
  const int tiles = (M + kTile - 1) / kTile;
  const int64_t steps = (N + kRows - 1) / kRows;
  const int64_t rows_per_chunk = (steps + chunks - 1) / chunks * kRows;
  const dim3 grid((unsigned)(tiles * tiles), (unsigned)chunks);
  psi2_fwd_kernel<DT, kFastExp><<<grid, kThreads, 0, stream>>>(
      U, V, w, logdet, Z, part, N, M, D, tiles, rows_per_chunk);
  return cudaGetLastError();
}

template <bool kFastExp>
cudaError_t launch_d(const float* U, const float* V, const float* w,
                     const float* logdet, const float* Z, float* part,
                     int64_t N, int M, int D, int chunks, cudaStream_t s) {
  switch (D) {
#define PSI2_CASE(d) \
  case d:            \
    return launch<d, kFastExp>(U, V, w, logdet, Z, part, N, M, D, chunks, s);
    PSI2_CASE(1) PSI2_CASE(2) PSI2_CASE(3) PSI2_CASE(4)
    PSI2_CASE(5) PSI2_CASE(6) PSI2_CASE(7) PSI2_CASE(8)
#undef PSI2_CASE
    default:   // Z from shared memory
      return launch<0, kFastExp>(U, V, w, logdet, Z, part, N, M, D, chunks,
                                 s);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Pointers are device pointers
// to contiguous float32 tensors: U, V (N, M), w (N, D), logdet (N, 1),
// Z (M, D), out (M, M).  The rows are split into `chunks` chunks; for
// chunks > 1, scratch holds chunks * M * M floats of partial outputs.
// Returns a cudaError_t code (0 = launched).
extern "C" int psi2_fwd(const float* U, const float* V, const float* w,
                        const float* logdet, const float* Z, float* out,
                        float* scratch, int64_t N, int M, int D, int chunks,
                        int fast_exp, void* stream) {
  if (N <= 0 || M <= 0 || M > kMaxM || D <= 0 || D > kMaxD || chunks <= 0
      || chunks > 65535 || (chunks > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = chunks > 1 ? scratch : out;
  cudaError_t err =
      fast_exp ? launch_d<true>(U, V, w, logdet, Z, part, N, M, D, chunks, s)
               : launch_d<false>(U, V, w, logdet, Z, part, N, M, D, chunks, s);
  if (err != cudaSuccess || chunks == 1) return (int)err;
  const int64_t MM = (int64_t)M * M;
  psi2_sum_chunks_kernel<<<(unsigned)((MM + 255) / 256), 256, 0, s>>>(
      part, out, chunks, MM);
  return (int)cudaGetLastError();
}
