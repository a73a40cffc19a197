// psi2 data-sum backward (the psi2_core contract's gradients), for sm_90a.
//
// Replaces the TPU kernels doubly_stochastic_dgp_tpu/ops/pallas/psi2.py::
// _psi2_core_bwd_call (_bwd_kernel and _bwd_kernel_mxu, two variants of one
// function that differ in the TPU unit that does the d-contractions; this
// one kernel is the counterpart of both).  For U, V (N, M), w (N, D),
// logdet (N, 1), Z (M, D) and the cotangent g (M, M) of
//
//   out[a, b] = sum_n exp(min(pre, 0) + logdet[n]),
//   pre[n, a, b] = U[n,a] + V[n,b] - sum_d w[n,d] Z[a,d] Z[b,d],
//
// with e = exp(min(pre, 0) + logdet[n]), ge = g[a,b] e and P = ge where
// pre < 0, else 0 (at an exact tie pre == 0 the clamp takes the whole
// cotangent, the TPU kernel's convention):
//
//   gU[n,a] = sum_b P          gV[n,b] = sum_a P
//   glogdet[n] = sum_ab ge     gw[n,d] = -sum_ab P Z[a,d] Z[b,d]
//   gZ[c,d] = -sum_n w[n,d] (sum_b P[n,c,b] Z[b,d] + sum_a P[n,a,c] Z[a,d])
//
// What bounds it on an H100: operations.  Each (n, a, b) term is one exp
// and about 8 + 6D fp32 flops against 8 bytes of U and V per (n, a) pair,
// so nothing of size (N, M, M) may touch memory: the exponentials are
// recomputed here, as the TPU kernel recomputed them.
//
// Design.  The five outputs reduce over three different axes.  A thread
// that owns one (row, a) pair and loops over every b sums gU[n,a] and
// S_a[n,a,d] = sum_b P Z[b,d] in its registers with no exchange between
// threads; gV and S_b would need a reduction across threads for every
// b.  So the kernel runs two passes over the same terms, the second with
// the roles of a and b exchanged (U <-> V, g read transposed), and pays
// the exps twice instead: pass 0 gives gU, glogdet, gw and gZ's S_a part,
// pass 1 gives gV and gZ's S_b part.  Both passes form pre exactly as the
// forward kernel does (U + V, then fma(-(w Z[a,d]), Z[b,d], pre) for d
// ascending), so the gate pre < 0 and the forward's clamp agree on every
// element.
//
// A block of 64 x 4 threads takes one tile of 64 "own" indices (a in pass
// 0, b in pass 1) and one chunk of rows, in steps of 4 x RN rows (RN rows
// per thread: 4 for D <= 4, else 2).  For each step it sweeps the other
// index in tiles of 32, staged in shared memory (the loop-side U or V, Z
// and the g tile; g is up to 1 MB and stays in L2), four at a time with
// 16-byte loads.  For D <= 8 the thread's w and Z values sit in registers
// (DT templates); above that pre reads them from shared memory and the
// d-sums are split into groups of 8 over blockIdx.z (the exps are then
// recomputed per group).  Sums: 32 terms into fresh registers, the tiles'
// sums and the row steps' gZ sums with Kahan's compensated sum, the sums
// across threads as shuffle trees, as the forward needed to stay within
// twice the plain version's error.  glogdet and gw are written per own
// tile and gZ per (pass, chunk); a second kernel adds these partials in a
// fixed order (Kahan).  No atomics: repeat launches are bit-identical.
// The ragged tails are masked, not padded; a row past the end counts with
// logdet = -inf, so it adds exactly 0.  Row offsets are 64-bit.  exp is
// __expf, the variant the forward's wrapper uses.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "psi2_common.cuh"

namespace {

using psi2::kahan_add;
using psi2::kMaxD;
using psi2::kMaxM;

constexpr int kOwn = 64;                  // own-side indices per block
constexpr int kSlots = 4;                 // row slots per block
constexpr int kThreads = kOwn * kSlots;   // 256
constexpr int kWarps = kThreads / 32;
constexpr int kLoop = 32;                 // loop-side indices per tile
constexpr int kGPad = kLoop + 4;          // 16-byte rows, no bank conflicts
constexpr int kGroupD = 8;                // d's per block when DT == 0

__host__ __device__ constexpr int rows_per_thread(int DT) {
  return DT >= 1 && DT <= 4 ? 4 : 2;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// DT > 0: D == DT, the thread's w and Z values held in registers.
// DT == 0: any D <= kMaxD; blockIdx.z picks the group of 8 d's whose sums
// this block forms.
// kSwap: pass 1 (own index b, loop index a).
template <int DT, bool kSwap>
__global__ void __launch_bounds__(kThreads, 1)
psi2_bwd_kernel(const float* __restrict__ U, const float* __restrict__ V,
                const float* __restrict__ w,
                const float* __restrict__ logdet,
                const float* __restrict__ Z, const float* __restrict__ g,
                float* __restrict__ g_own,      // gU (pass 0) or gV (pass 1)
                float* __restrict__ part_gl,    // (tiles, N), pass 0
                float* __restrict__ part_gw,    // (tiles, N, D), pass 0
                float* __restrict__ part_gz,    // (chunks, M, D), this pass
                int64_t N, int M, int D, int64_t rows_per_chunk) {
  constexpr int RN = rows_per_thread(DT);
  constexpr int DS = DT > 0 ? DT : kGroupD;     // d-sums per thread
  constexpr int kRowsStep = kSlots * RN;
  constexpr int kZRows = DT > 0 ? DT : kMaxD;
  constexpr int kQ = 2 + DS;                    // ge, P and the DS d-sums
  __shared__ __align__(16) float sL[kRowsStep][kLoop];   // loop-side U or V
  __shared__ __align__(16) float sZl[kZRows][kLoop];     // [d][loop index]
  __shared__ __align__(16) float sG[kOwn][kGPad];        // [own][loop]
  __shared__ float sW[DT > 0 ? 1 : kRowsStep][DT > 0 ? 1 : kMaxD];
  __shared__ float sZo[DT > 0 ? 1 : kMaxD][DT > 0 ? 1 : kOwn];
  __shared__ float sRow[kWarps][RN][1 + DS];

  const int tid = threadIdx.x;
  const int own_l = tid % kOwn;
  const int slot = tid / kOwn;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int tile = blockIdx.x;
  const int o0 = tile * kOwn;
  const int own = o0 + own_l;
  const bool own_ok = own < M;
  const int d0 = DT > 0 ? 0 : (int)blockIdx.z * kGroupD;
  const bool first_group = DT > 0 || blockIdx.z == 0;
  const float* __restrict__ Own = kSwap ? V : U;
  const float* __restrict__ Lp = kSwap ? U : V;
  const int64_t n_begin = (int64_t)blockIdx.y * rows_per_chunk;
  const int64_t n_end = n_begin + rows_per_chunk < N
                            ? n_begin + rows_per_chunk : N;

  float zo[DS];                       // Z[own][d0 + dd]
#pragma unroll
  for (int dd = 0; dd < DS; ++dd)
    zo[dd] = own_ok && d0 + dd < D ? Z[(size_t)own * D + d0 + dd] : 0.f;
  if constexpr (DT == 0) {
    for (int i = tid; i < D * kOwn; i += kThreads) {
      const int d = i / kOwn, c = i % kOwn;
      sZo[d][c] = o0 + c < M ? Z[(size_t)(o0 + c) * D + d] : 0.f;
    }
  }

  float zacc[DS], zcomp[DS];          // gZ partial of (own, d0 + dd)
#pragma unroll
  for (int dd = 0; dd < DS; ++dd) zacc[dd] = zcomp[dd] = 0.f;

  for (int64_t r0 = n_begin; r0 < n_end; r0 += kRowsStep) {
    float u[RN], ld[RN], wr[RN][DS];
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      const int64_t n = r0 + slot * RN + r;
      const bool ok = n < n_end;
      u[r] = ok && own_ok ? Own[n * M + own] : 0.f;
      ld[r] = ok ? logdet[n] : -INFINITY;
#pragma unroll
      for (int dd = 0; dd < DS; ++dd)
        wr[r][dd] = ok && d0 + dd < D ? w[n * D + d0 + dd] : 0.f;
    }
    if constexpr (DT == 0) {
      __syncthreads();                // the last step's reads of sW are done
      for (int i = tid; i < kRowsStep * D; i += kThreads) {
        const int row = i / D, d = i % D;
        sW[row][d] = r0 + row < n_end ? w[(r0 + row) * D + d] : 0.f;
      }
    }

    float T[RN][kQ], C[RN][kQ];       // Kahan sums over the loop tiles
#pragma unroll
    for (int r = 0; r < RN; ++r)
#pragma unroll
      for (int q = 0; q < kQ; ++q) T[r][q] = C[r][q] = 0.f;

    for (int l0 = 0; l0 < M; l0 += kLoop) {
      __syncthreads();                // the last tile's reads are done
      for (int i = tid; i < kRowsStep * kLoop; i += kThreads) {
        const int row = i / kLoop, j = i % kLoop;
        const int64_t n = r0 + row;
        sL[row][j] = n < n_end && l0 + j < M ? Lp[n * M + l0 + j] : 0.f;
      }
      for (int i = tid; i < kZRows * kLoop; i += kThreads) {
        const int d = i / kLoop, j = i % kLoop;
        sZl[d][j] = d < D && l0 + j < M ? Z[(size_t)(l0 + j) * D + d] : 0.f;
      }
      for (int i = tid; i < kOwn * kLoop; i += kThreads) {
        // consecutive threads on consecutive addresses of g in both passes
        const int c = kSwap ? i % kOwn : i / kLoop;
        const int j = kSwap ? i / kOwn : i % kLoop;
        float v = 0.f;
        if (o0 + c < M && l0 + j < M)
          v = kSwap ? g[(size_t)(l0 + j) * M + o0 + c]
                    : g[(size_t)(o0 + c) * M + l0 + j];
        sG[c][j] = v;
      }
      __syncthreads();

      float t[RN][kQ];                // this tile's sums
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int q = 0; q < kQ; ++q) t[r][q] = 0.f;

      for (int j4 = 0; j4 < kLoop; j4 += 4) {
        const float4 gq4 = ld4(&sG[own_l][j4]);
        const float gq[4] = {gq4.x, gq4.y, gq4.z, gq4.w};
        float zs[DS][4];              // Z[loop index][d0 + dd]
#pragma unroll
        for (int dd = 0; dd < DS; ++dd) {
          const float4 z4 = ld4(&sZl[d0 + dd][j4]);
          zs[dd][0] = z4.x; zs[dd][1] = z4.y;
          zs[dd][2] = z4.z; zs[dd][3] = z4.w;
        }
#pragma unroll
        for (int r = 0; r < RN; ++r) {
          const float4 lv4 = ld4(&sL[slot * RN + r][j4]);
          float pre[4] = {u[r] + lv4.x, u[r] + lv4.y, u[r] + lv4.z,
                          u[r] + lv4.w};
          // pre -= (w Z[a,d]) Z[b,d]: a is the own index in pass 0 and
          // the loop index in pass 1
          if constexpr (DT > 0) {
#pragma unroll
            for (int d = 0; d < DT; ++d) {
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                if constexpr (kSwap) {
                  pre[k] = fmaf(-(wr[r][d] * zs[d][k]), zo[d], pre[k]);
                } else {
                  pre[k] = fmaf(-(wr[r][d] * zo[d]), zs[d][k], pre[k]);
                }
              }
            }
          } else {
            for (int d = 0; d < D; ++d) {
              const float4 z4 = ld4(&sZl[d][j4]);
              const float zl[4] = {z4.x, z4.y, z4.z, z4.w};
              const float wd = sW[slot * RN + r][d];
              const float zod = sZo[d][own_l];
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                if constexpr (kSwap) {
                  pre[k] = fmaf(-(wd * zl[k]), zod, pre[k]);
                } else {
                  pre[k] = fmaf(-(wd * zod), zl[k], pre[k]);
                }
              }
            }
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float e = __expf(fminf(pre[k], 0.f) + ld[r]);
            const float ge = gq[k] * e;
            const float P = pre[k] < 0.f ? ge : 0.f;
            t[r][0] += ge;
            t[r][1] += P;
#pragma unroll
            for (int dd = 0; dd < DS; ++dd)
              t[r][2 + dd] = fmaf(P, zs[dd][k], t[r][2 + dd]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int q = 0; q < kQ; ++q) kahan_add(T[r][q], C[r][q], t[r][q]);
    }

    // this step's outputs: gU or gV, the gZ partial, and in pass 0 the
    // rows' sums over the own tile (glogdet, gw)
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      const int64_t n = r0 + slot * RN + r;
      if (first_group && own_ok && n < n_end) g_own[n * M + own] = T[r][1];
#pragma unroll
      for (int dd = 0; dd < DS; ++dd)
        kahan_add(zacc[dd], zcomp[dd], wr[r][dd] * T[r][2 + dd]);
    }
    if constexpr (!kSwap) {
#pragma unroll
      for (int r = 0; r < RN; ++r) {
#pragma unroll
        for (int q = 0; q < 1 + DS; ++q) {
          const int dd = q > 0 ? q - 1 : 0;
          float v = q == 0 ? T[r][0] : T[r][2 + dd] * zo[dd];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
          if (lane == 0) sRow[warp][r][q] = v;
        }
      }
      __syncthreads();
      // a slot's 64 own threads are warps 2 slot and 2 slot + 1; sRow is
      // next written after the next step's tile syncs
      for (int i = tid; i < kRowsStep * (1 + DS); i += kThreads) {
        const int row = i / (1 + DS), q = i % (1 + DS);
        const int s = row / RN, r = row % RN;
        const int64_t n = r0 + row;
        if (n >= n_end) continue;
        const float v = sRow[2 * s][r][q] + sRow[2 * s + 1][r][q];
        if (q == 0) {
          if (first_group) part_gl[(size_t)tile * N + n] = v;
        } else if (d0 + q - 1 < D) {
          part_gw[((size_t)tile * N + n) * D + d0 + q - 1] = v;
        }
      }
    }
  }

  // the block's gZ partial: the four row slots' sums, in slot order
  __syncthreads();
  float* sRed = &sG[0][0];            // [slot][own][DS]
#pragma unroll
  for (int dd = 0; dd < DS; ++dd)
    sRed[(slot * kOwn + own_l) * DS + dd] = zacc[dd];
  __syncthreads();
  for (int i = tid; i < kOwn * DS; i += kThreads) {
    const int c = i / DS, dd = i % DS;
    float v = 0.f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) v += sRed[(s * kOwn + c) * DS + dd];
    if (o0 + c < M && d0 + dd < D)
      part_gz[((size_t)blockIdx.y * M + o0 + c) * D + d0 + dd] = v;
  }
}

// glogdet = sum over own tiles of part_gl, gw = -sum of part_gw, gZ = -sum
// over (pass, chunk) of part_gz, each in index order (Kahan)
__global__ void psi2_bwd_finish_kernel(const float* __restrict__ part_gl,
                                       const float* __restrict__ part_gw,
                                       const float* __restrict__ part_gz,
                                       float* __restrict__ glogdet,
                                       float* __restrict__ gw,
                                       float* __restrict__ gZ, int64_t N,
                                       int M, int D, int tiles, int parts) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t ND = N * D, MD = (int64_t)M * D;
  float s = 0.f, comp = 0.f;
  if (i < N) {
    for (int t = 0; t < tiles; ++t) kahan_add(s, comp, part_gl[t * N + i]);
    glogdet[i] = s;
  } else if (i < N + ND) {
    const int64_t j = i - N;
    for (int t = 0; t < tiles; ++t) kahan_add(s, comp, part_gw[t * ND + j]);
    gw[j] = -s;
  } else if (i < N + ND + MD) {
    const int64_t j = i - N - ND;
    for (int p = 0; p < parts; ++p) kahan_add(s, comp, part_gz[p * MD + j]);
    gZ[j] = -s;
  }
}

template <int DT>
cudaError_t launch(const float* U, const float* V, const float* w,
                   const float* logdet, const float* Z, const float* g,
                   float* gU, float* gV, float* part_gl, float* part_gw,
                   float* part_gz, int64_t N, int M, int D, int chunks,
                   cudaStream_t stream) {
  constexpr int kRowsStep = kSlots * rows_per_thread(DT);
  const int tiles = (M + kOwn - 1) / kOwn;
  const int groups = DT > 0 ? 1 : (D + kGroupD - 1) / kGroupD;
  const int64_t steps = (N + kRowsStep - 1) / kRowsStep;
  const int64_t rows_per_chunk = (steps + chunks - 1) / chunks * kRowsStep;
  const dim3 grid((unsigned)tiles, (unsigned)chunks, (unsigned)groups);
  psi2_bwd_kernel<DT, false><<<grid, kThreads, 0, stream>>>(
      U, V, w, logdet, Z, g, gU, part_gl, part_gw, part_gz, N, M, D,
      rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  psi2_bwd_kernel<DT, true><<<grid, kThreads, 0, stream>>>(
      U, V, w, logdet, Z, g, gV, part_gl, part_gw,
      part_gz + (size_t)chunks * M * D, N, M, D, rows_per_chunk);
  return cudaGetLastError();
}

}  // namespace

// Rows a block takes per step at this D (the wrapper sizes the chunks in
// these steps).
extern "C" int psi2_bwd_rows_step(int D) {
  return kSlots * rows_per_thread(D <= 8 ? D : 0);
}

// Plain C entry point (bound with ctypes).  Pointers are device pointers
// to contiguous float32 tensors: U, V, gU, gV (N, M), w, gw (N, D), logdet,
// glogdet (N, 1), Z, gZ (M, D), g (M, M).  The rows are split into
// `chunks` chunks; scratch holds ceil(M / 64) * N * (1 + D) + 2 * chunks *
// M * D floats of partial sums.  Returns a cudaError_t code (0 =
// launched).
extern "C" int psi2_bwd(const float* U, const float* V, const float* w,
                        const float* logdet, const float* Z, const float* g,
                        float* gU, float* gV, float* gw, float* glogdet,
                        float* gZ, float* scratch, int64_t N, int M, int D,
                        int chunks, void* stream) {
  if (N <= 0 || M <= 0 || M > kMaxM || D <= 0 || D > kMaxD || chunks <= 0
      || chunks > 65535 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (M + kOwn - 1) / kOwn;
  float* part_gl = scratch;
  float* part_gw = part_gl + (size_t)tiles * N;
  float* part_gz = part_gw + (size_t)tiles * N * D;
  cudaError_t err;
  switch (D) {
#define PSI2_CASE(d)                                                      \
  case d:                                                                 \
    err = launch<d>(U, V, w, logdet, Z, g, gU, gV, part_gl, part_gw,      \
                    part_gz, N, M, D, chunks, s);                         \
    break;
    PSI2_CASE(1) PSI2_CASE(2) PSI2_CASE(3) PSI2_CASE(4)
    PSI2_CASE(5) PSI2_CASE(6) PSI2_CASE(7) PSI2_CASE(8)
#undef PSI2_CASE
    default:   // w and Z from shared memory, the d-sums in groups of 8
      err = launch<0>(U, V, w, logdet, Z, g, gU, gV, part_gl, part_gw,
                      part_gz, N, M, D, chunks, s);
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t total = N * (1 + (int64_t)D) + (int64_t)M * D;
  psi2_bwd_finish_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      part_gl, part_gw, part_gz, glogdet, gw, gZ, N, M, D, tiles,
      2 * chunks);
  return (int)cudaGetLastError();
}
