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
//   gZ[c,d] = -sum_b Z[b,d] (Q_d[c,b] + Q_d[b,c]),  Q_d[a,b] = sum_n w[n,d] P
//
// (the last is -sum_n w[n,d] (sum_b P[n,c,b] Z[b,d] + sum_a P[n,a,c] Z[a,d])
// with the sum over n taken first).
//
// What bounds it on an H100: operations.  Each (n, a, b) term is one exp
// and about 8 + 6D fp32 flops against 8 bytes of U and V per (n, a) pair,
// so nothing of size (N, M, M) may touch memory: the exponentials are
// recomputed here, as the TPU kernel recomputed them.
//
// Design: one pass, each term formed and exponentiated once.  A block
// owns a chunk of rows and all M x M (a, b) terms of them; the per-row
// outputs (gU, gV, glogdet, gw) are complete inside the block, so nothing
// of size N goes to scratch.  The block walks the (a, b) plane in
// sub-tiles of 16 TA a's x 64 b's (TA = 4 for D <= 4, else 2), and each
// sub-tile over the chunk's rows, four rows a step.  A thread owns a TA x
// 4 register tile (a = a0 + ty + 16 i, b = b0 + tx + 16 j); its g, Z[a]
// and Z[b] values stay in registers for the whole sub-tile.  Per term it
// forms pre exactly as the forward kernel does (U + V, then fma(-(w
// Z[a,d]), Z[b,d], pre) for d ascending, so the gate pre < 0 and the
// forward's clamp agree on every term), computes e once, and from P feeds
// all five gradients: its row sums gU (over its b's), gV (over its a's),
// glogdet and gw (over both) go to shared memory as per-thread partials,
// which a fixed-order pass after each step adds across threads into the
// chunk's (rows, M) sums; Q_d of its (a, b) terms sums over the chunk's
// rows in registers.  At the end of a sub-tile the Q tile is contracted
// with Z into gZ's share (across the tx lanes by shuffles, across ty
// through shared memory) and added, Kahan-compensated, into the block's
// (M, D) gZ sums.  The step's U, V, w and logdet rows are staged by
// cp.async one step ahead.  Up to D = 2 the kernel fits 128 registers, so
// two blocks share an SM (16 warps; shared memory sizes the chunks to
// fit), else one.  A block takes one or more chunks (a grid of at most
// the SMs' block slots); its gZ sums go to scratch (blocks x M x D
// floats, whatever N), and a second kernel adds them in block order
// (Kahan).  For D > 8, w and Z of the clamp come from shared memory and
// the d-sums of gw and Q are split into groups of 8 over blockIdx.y (there
// each group recomputes the exps).  No atomics: repeat launches are
// bit-identical.  Ragged N and M are masked, not padded: a row past the
// end has logdet = -inf and adds exactly 0, and g is 0 past M.  Row
// offsets are 64-bit.  exp is __expf (ex2.approx, as in the forward).
// The launch plan (rows a chunk, chunks, blocks, shared memory)
// comes from ops/cuda/psi2.py::backward_plan, which mirrors smem_floats.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "psi2_common.cuh"

namespace {

using psi2::kahan_add;
using psi2::kMaxD;
using psi2::kMaxM;

constexpr int kSide = 16;                 // threads a block side
constexpr int kThreads = kSide * kSide;   // 256
constexpr int kTB = 4;                    // b's a thread
constexpr int kSB = kSide * kTB;          // b's a sub-tile
constexpr int kRS = 4;                    // rows a step
constexpr int kGroupD = 8;                // d's of gw and Q a block, D > 8
constexpr int kPad = kSide + 1;           // row stride of the partials
constexpr int kSmemMax = 232448;          // bytes a block may use

// a's a thread, blocks an SM, and d's of gw and Q a block, for the D
// template: above D = 4 a thread takes 2 a's (its Q sums are 8 D
// registers); up to D = 2 the kernel fits 128 registers a thread, so two
// blocks share an SM
__host__ __device__ constexpr int a_per_thread(int DT) {
  return DT >= 1 && DT <= 4 ? 4 : 2;
}
__host__ __device__ constexpr int blocks_per_sm(int DT) {
  return DT >= 1 && DT <= 2 ? 2 : 1;
}
__host__ __device__ constexpr int group_d(int DT) {
  return DT > 0 ? DT : kGroupD;
}

// Shared memory of a block, in floats (psi2.py::_bwd_smem_floats): the
// chunk's gU and gV (rc x M) and glogdet/gw (rc x (1 + DS)) sums, the
// block's gZ sums and their Kahan compensation (M x DS each), the step's
// per-thread partials of gU, gV and glogdet/gw, two stages of U, V, w and
// logdet rows, and for D > 8 the sub-tile's Z columns.
__host__ __device__ inline int64_t smem_floats(int DT, int M, int D,
                                               int rc) {
  const int sa = kSide * a_per_thread(DT), ds = group_d(DT);
  return 2LL * rc * M + (int64_t)rc * (1 + ds) + 2LL * M * ds +
         kRS * sa * kPad + kRS * kSB * kPad + kRS * (1 + ds) * kThreads +
         2 * kRS * (sa + kSB + D + 1) + (DT == 0 ? D * (sa + kSB) : 0);
}

// cp.async of 4 bytes with zero fill (src_bytes = 0 reads nothing)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The sum of the 16 values p[0], p[stride], ..., in four interleaved
// chains, added in a fixed order
__device__ __forceinline__ float sum16(const float* p, int stride) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 16; ++k) c[k % 4] += p[k * stride];
  return (c[0] + c[1]) + (c[2] + c[3]);
}

// DT > 0: D == DT, w and Z of the clamp from registers.  DT == 0: any
// D <= kMaxD; blockIdx.y picks the group of 8 d's whose gw and Q this
// block forms.
template <int DT>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(DT))
psi2_bwd_kernel(const float* __restrict__ U, const float* __restrict__ V,
                const float* __restrict__ w,
                const float* __restrict__ logdet,
                const float* __restrict__ Z, const float* __restrict__ g,
                float* __restrict__ gU, float* __restrict__ gV,
                float* __restrict__ gw, float* __restrict__ glogdet,
                float* __restrict__ part_gz,   // (gridDim.x, M, D)
                int64_t N, int M, int D, int rc, int chunks) {
  constexpr int TA = a_per_thread(DT);
  constexpr int TB = kTB;
  constexpr int DS = group_d(DT);
  constexpr int SA = kSide * TA;              // a's a sub-tile
  constexpr int SB = kSB;
  constexpr int NQ = 1 + DS;                  // glogdet and gw's d-sums
  const int Dn = DT > 0 ? DT : D;             // a constant for DT > 0
  extern __shared__ __align__(16) float smem[];
  float* sGU = smem;                          // [rc][M]
  float* sGV = sGU + (size_t)rc * M;          // [rc][M]
  float* sGL = sGV + (size_t)rc * M;          // [rc][NQ]
  float* sZ = sGL + (size_t)rc * NQ;          // [M][DS]
  float* sZc = sZ + (size_t)M * DS;           // [M][DS]
  float* sPU = sZc + (size_t)M * DS;          // [kRS][SA][kPad]
  float* sPV = sPU + kRS * SA * kPad;         // [kRS][SB][kPad]
  float* sPL = sPV + kRS * SB * kPad;         // [kRS][NQ][kThreads]
  float* sStage = sPL + kRS * NQ * kThreads;  // 2 x (U, V, w, logdet)
  const int stage_floats = kRS * (SA + SB + Dn + 1);
  float* sZa = sStage + 2 * stage_floats;     // DT == 0: [D][SA]
  float* sZb = sZa + (DT == 0 ? D * SA : 0);  // DT == 0: [D][SB]

  const int tid = threadIdx.x;
  const int tx = tid % kSide;
  const int ty = tid / kSide;
  const int d0 = DT > 0 ? 0 : (int)blockIdx.y * kGroupD;
  const int dn = DT > 0 ? DT : min(kGroupD, D - d0);   // this group's d's
  const int tiles_b = (M + SB - 1) / SB;
  const int subtiles = ((M + SA - 1) / SA) * tiles_b;

  for (int e = tid; e < M * DS; e += kThreads) sZ[e] = sZc[e] = 0.f;

  for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    const int64_t n0 = (int64_t)chunk * rc;
    const int rows = (int)(N - n0 < rc ? N - n0 : rc);
    const int steps = (rows + kRS - 1) / kRS;
    const int total = subtiles * steps;
    for (int e = tid; e < rows * M; e += kThreads) sGU[e] = sGV[e] = 0.f;
    for (int e = tid; e < rows * NQ; e += kThreads) sGL[e] = 0.f;

    // stage step `it` (sub-tile it / steps, rows (it % steps) * kRS on)
    auto stage = [&](int it) {
      const int st = it / steps, s = it % steps;
      const int a0 = (st / tiles_b) * SA, b0 = (st % tiles_b) * SB;
      float* bU = sStage + (it & 1) * stage_floats;
      float* bV = bU + kRS * SA;
      float* bW = bV + kRS * SB;
      float* bL = bW + kRS * Dn;
      for (int e = tid; e < kRS * SA; e += kThreads) {
        const int r = e / SA, c = e % SA, lr = s * kRS + r;
        const bool ok = lr < rows && a0 + c < M;
        cp_async4(bU + e, ok ? U + (n0 + lr) * M + a0 + c : U, ok);
      }
      for (int e = tid; e < kRS * SB; e += kThreads) {
        const int r = e / SB, c = e % SB, lr = s * kRS + r;
        const bool ok = lr < rows && b0 + c < M;
        cp_async4(bV + e, ok ? V + (n0 + lr) * M + b0 + c : V, ok);
      }
      for (int e = tid; e < kRS * Dn; e += kThreads) {
        const int r = e / Dn, lr = s * kRS + r;
        const bool ok = lr < rows;
        cp_async4(bW + e, ok ? w + (n0 + lr) * Dn + e % Dn : w, ok);
      }
      if (tid < kRS) {
        const int lr = s * kRS + tid;
        if (lr < rows) {
          cp_async4(bL + tid, logdet + n0 + lr, true);
        } else {
          bL[tid] = -INFINITY;        // a row past the end adds exactly 0
        }
      }
      cp_async_commit();
    };

    float Q[TA][TB][DS];              // sum over the chunk's rows of w P
    float za[TA][DS], zb[TB][DS];     // Z[a][d0 + dd], Z[b][d0 + dd]
    float gr[TA][TB];                 // g[a][b]
    int a0 = 0, b0 = 0;
    stage(0);
    for (int it = 0; it < total; ++it) {
      const int s = it % steps;
      if (s == 0) {                   // a new sub-tile
        const int st = it / steps;
        a0 = (st / tiles_b) * SA;
        b0 = (st % tiles_b) * SB;
#pragma unroll
        for (int i = 0; i < TA; ++i) {
          const int a = a0 + ty + kSide * i;
#pragma unroll
          for (int dd = 0; dd < DS; ++dd)
            za[i][dd] = a < M && d0 + dd < Dn ? Z[(size_t)a * Dn + d0 + dd]
                                             : 0.f;
#pragma unroll
          for (int j = 0; j < TB; ++j) {
            const int b = b0 + tx + kSide * j;
            gr[i][j] = a < M && b < M ? g[(size_t)a * M + b] : 0.f;
#pragma unroll
            for (int dd = 0; dd < DS; ++dd) Q[i][j][dd] = 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < TB; ++j) {
          const int b = b0 + tx + kSide * j;
#pragma unroll
          for (int dd = 0; dd < DS; ++dd)
            zb[j][dd] = b < M && d0 + dd < Dn ? Z[(size_t)b * Dn + d0 + dd]
                                             : 0.f;
        }
        if constexpr (DT == 0) {
          // the last reads of sZa / sZb were before the last step's
          // second barrier
          for (int e = tid; e < D * SA; e += kThreads) {
            const int d = e / SA, c = e % SA;
            sZa[e] = a0 + c < M ? Z[(size_t)(a0 + c) * D + d] : 0.f;
          }
          for (int e = tid; e < D * SB; e += kThreads) {
            const int d = e / SB, c = e % SB;
            sZb[e] = b0 + c < M ? Z[(size_t)(b0 + c) * D + d] : 0.f;
          }
        }
      }
      if (it + 1 < total) {
        stage(it + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();                // this step's rows have landed

      const float* bU = sStage + (it & 1) * stage_floats;
      const float* bV = bU + kRS * SA;
      const float* bW = bV + kRS * SB;
      const float* bL = bW + kRS * Dn;
#pragma unroll 1
      for (int r = 0; r < kRS; ++r) {
        float pre[TA][TB];
#pragma unroll
        for (int i = 0; i < TA; ++i) {
          const float u = bU[r * SA + ty + kSide * i];
#pragma unroll
          for (int j = 0; j < TB; ++j)
            pre[i][j] = u + bV[r * SB + tx + kSide * j];
        }
        float wg[DS];                 // w[n][d0 + dd]
#pragma unroll
        for (int dd = 0; dd < DS; ++dd)
          wg[dd] = d0 + dd < Dn ? bW[r * Dn + d0 + dd] : 0.f;
        // pre -= (w Z[a,d]) Z[b,d], d ascending: the forward's order
        if constexpr (DT > 0) {
#pragma unroll
          for (int d = 0; d < DT; ++d) {
#pragma unroll
            for (int i = 0; i < TA; ++i) {
              const float wz = wg[d] * za[i][d];
#pragma unroll
              for (int j = 0; j < TB; ++j)
                pre[i][j] = fmaf(-wz, zb[j][d], pre[i][j]);
            }
          }
        } else {
          for (int d = 0; d < D; ++d) {
            const float wd = bW[r * D + d];
            float zbd[TB];
#pragma unroll
            for (int j = 0; j < TB; ++j) zbd[j] = sZb[d * SB + tx + kSide * j];
#pragma unroll
            for (int i = 0; i < TA; ++i) {
              const float wz = wd * sZa[d * SA + ty + kSide * i];
#pragma unroll
              for (int j = 0; j < TB; ++j)
                pre[i][j] = fmaf(-wz, zbd[j], pre[i][j]);
            }
          }
        }
        const float ld = bL[r];
        float pl = 0.f, pu[TA], pv[TB], sw[TA][DS];
#pragma unroll
        for (int j = 0; j < TB; ++j) pv[j] = 0.f;
#pragma unroll
        for (int i = 0; i < TA; ++i) {
          pu[i] = 0.f;
#pragma unroll
          for (int dd = 0; dd < DS; ++dd) sw[i][dd] = 0.f;
#pragma unroll
          for (int j = 0; j < TB; ++j) {
            const float e = __expf(fminf(pre[i][j], 0.f) + ld);
            const float ge = gr[i][j] * e;
            const float P = pre[i][j] < 0.f ? ge : 0.f;
            pl += ge;
            pu[i] += P;
            pv[j] += P;
#pragma unroll
            for (int dd = 0; dd < DS; ++dd) {
              sw[i][dd] = fmaf(P, zb[j][dd], sw[i][dd]);
              Q[i][j][dd] = fmaf(wg[dd], P, Q[i][j][dd]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < TA; ++i)
          sPU[(r * SA + ty + kSide * i) * kPad + tx] = pu[i];
#pragma unroll
        for (int j = 0; j < TB; ++j)
          sPV[(r * SB + tx + kSide * j) * kPad + ty] = pv[j];
        sPL[(r * NQ) * kThreads + tid] = pl;
#pragma unroll
        for (int dd = 0; dd < DS; ++dd) {
          float pw = 0.f;             // sum_ab P Z[a,d] Z[b,d], this tile
#pragma unroll
          for (int i = 0; i < TA; ++i) pw = fmaf(za[i][dd], sw[i][dd], pw);
          sPL[(r * NQ + 1 + dd) * kThreads + tid] = pw;
        }
      }
      __syncthreads();                // the step's partials are written

      // add the partials across threads, in a fixed order, into the
      // chunk's sums (each sum has one writer a step)
      for (int t = tid; t < kRS * SA; t += kThreads) {
        const int r = t / SA, al = t % SA;
        const int lr = s * kRS + r, a = a0 + al;
        const float sum = sum16(sPU + (r * SA + al) * kPad, 1);
        if (lr < rows && a < M) sGU[lr * M + a] += sum;
      }
      for (int t = tid; t < kRS * SB; t += kThreads) {
        const int r = t / SB, bl = t % SB;
        const int lr = s * kRS + r, b = b0 + bl;
        const float sum = sum16(sPV + (r * SB + bl) * kPad, 1);
        if (lr < rows && b < M) sGV[lr * M + b] += sum;
      }
      for (int t0 = 0; t0 < kRS * NQ * kSide; t0 += kThreads) {
        const int t = t0 + tid, o = t / kSide, k = t % kSide;
        float sum = o < kRS * NQ ? sum16(sPL + o * kThreads + k, kSide) : 0.f;
#pragma unroll
        for (int off = kSide / 2; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        const int lr = s * kRS + o / NQ;
        if (k == 0 && o < kRS * NQ && lr < rows) sGL[lr * NQ + o % NQ] += sum;
      }

      if (s == steps - 1) {
        // the sub-tile's share of gZ: first the rows c = a (sum over the
        // thread's b's, then over the tx lanes)
#pragma unroll
        for (int i = 0; i < TA; ++i) {
          const int a = a0 + ty + kSide * i;
#pragma unroll
          for (int dd = 0; dd < DS; ++dd) {
            float c = 0.f;
#pragma unroll
            for (int j = 0; j < TB; ++j) c = fmaf(zb[j][dd], Q[i][j][dd], c);
#pragma unroll
            for (int off = kSide / 2; off > 0; off >>= 1)
              c += __shfl_xor_sync(0xffffffffu, c, off);
            if (tx == 0 && a < M && d0 + dd < Dn)
              kahan_add(sZ[a * DS + dd], sZc[a * DS + dd], c);
          }
        }
        // then the columns c = b (sum over the thread's a's, then over the
        // ty rows through shared memory, in sPL's place)
        __syncthreads();              // the reads of sPL are done
        float* sQ = sPL;              // [kSide][DS][SB]
#pragma unroll
        for (int j = 0; j < TB; ++j) {
#pragma unroll
          for (int dd = 0; dd < DS; ++dd) {
            float c = 0.f;
#pragma unroll
            for (int i = 0; i < TA; ++i) c = fmaf(za[i][dd], Q[i][j][dd], c);
            sQ[(ty * DS + dd) * SB + tx + kSide * j] = c;
          }
        }
        __syncthreads();
        for (int t = tid; t < DS * SB; t += kThreads) {
          const int dd = t / SB, bl = t % SB, b = b0 + bl;
          float c = 0.f;
#pragma unroll
          for (int k = 0; k < kSide; ++k) c += sQ[(k * DS + dd) * SB + bl];
          if (b < M && d0 + dd < Dn)
            kahan_add(sZ[b * DS + dd], sZc[b * DS + dd], c);
        }
      }
    }

    // the chunk's rows are complete
    __syncthreads();
    if (blockIdx.y == 0) {
      for (int e = tid; e < rows * M; e += kThreads) {
        gU[n0 * M + e] = sGU[e];
        gV[n0 * M + e] = sGV[e];
      }
      for (int e = tid; e < rows; e += kThreads) glogdet[n0 + e] = sGL[e * NQ];
    }
    for (int e = tid; e < rows * dn; e += kThreads) {
      const int r = e / dn, dd = e % dn;
      gw[(n0 + r) * Dn + d0 + dd] = -sGL[r * NQ + 1 + dd];
    }
    __syncthreads();                  // before the next chunk's zeroing
  }

  for (int e = tid; e < M * dn; e += kThreads) {
    const int c = e / dn, dd = e % dn;
    part_gz[((size_t)blockIdx.x * M + c) * Dn + d0 + dd] = sZ[c * DS + dd];
  }
}

// gZ = -sum over blocks of part_gz, in block order (Kahan)
__global__ void psi2_bwd_finish_kernel(const float* __restrict__ part_gz,
                                       float* __restrict__ gZ, int64_t MD,
                                       int parts) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MD) return;
  float s = 0.f, comp = 0.f;
  for (int p = 0; p < parts; ++p) kahan_add(s, comp, part_gz[p * MD + i]);
  gZ[i] = -s;
}

// Lets the kernel use up to 227 KB of dynamic shared memory, with the
// SM's carveout at its largest share, once per device.
template <int DT>
cudaError_t allow_smem() {
  static unsigned long long done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(psi2_bwd_kernel<DT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(psi2_bwd_kernel<DT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done |= bit;
  return err;
}

template <int DT>
cudaError_t launch(const float* U, const float* V, const float* w,
                   const float* logdet, const float* Z, const float* g,
                   float* gU, float* gV, float* gw, float* glogdet,
                   float* part_gz, int64_t N, int M, int D, int rc,
                   int chunks, int grid, size_t smem, cudaStream_t stream) {
  cudaError_t err = allow_smem<DT>();
  if (err != cudaSuccess) return err;
  const int groups = DT > 0 ? 1 : (D + kGroupD - 1) / kGroupD;
  psi2_bwd_kernel<DT><<<dim3((unsigned)grid, (unsigned)groups), kThreads,
                        smem, stream>>>(U, V, w, logdet, Z, g, gU, gV, gw,
                                        glogdet, part_gz, N, M, D, rc,
                                        chunks);
  return cudaGetLastError();
}

template <int DT>
int occupancy(int M, int D, int rc) {
  int n = 0;
  cudaError_t err = allow_smem<DT>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, psi2_bwd_kernel<DT>, kThreads,
        smem_floats(DT, M, D, rc) * sizeof(float));
  return err == cudaSuccess ? n : -1;
}

}  // namespace

// Plain C entry point (bound with ctypes).  Pointers are device pointers
// to contiguous float32 tensors: U, V, gU, gV (N, M), w, gw (N, D), logdet,
// glogdet (N, 1), Z, gZ (M, D), g (M, M), and scratch of grid * M * D
// floats.  The plan (psi2.py::backward_plan): rows_per_chunk rows a chunk
// (a multiple of 4), `chunks` chunks covering N, `grid` blocks (each
// takes chunks blockIdx.x, + grid, ...), smem_bytes of shared memory a
// block, which must equal this file's smem_floats.  Returns a cudaError_t
// code (0 = launched).
extern "C" int psi2_bwd(const float* U, const float* V, const float* w,
                        const float* logdet, const float* Z, const float* g,
                        float* gU, float* gV, float* gw, float* glogdet,
                        float* gZ, float* scratch, int64_t N, int M, int D,
                        int rows_per_chunk, int chunks, int grid,
                        int64_t smem_bytes, void* stream) {
  const int dt = D <= 8 ? D : 0;
  const int rc = rows_per_chunk;
  if (N <= 0 || M <= 0 || M > kMaxM || D <= 0 || D > kMaxD || rc <= 0 ||
      rc % kRS || (int64_t)chunks * rc < N ||
      (int64_t)(chunks - 1) * rc >= N || grid <= 0 || grid > chunks ||
      scratch == nullptr ||
      smem_bytes != smem_floats(dt, M, D, rc) * (int64_t)sizeof(float) ||
      smem_bytes > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)smem_bytes;
  cudaError_t err;
  switch (dt) {
#define PSI2_CASE(d)                                                      \
  case d:                                                                 \
    err = launch<d>(U, V, w, logdet, Z, g, gU, gV, gw, glogdet, scratch,  \
                    N, M, D, rc, chunks, grid, smem, s);                  \
    break;
    PSI2_CASE(1) PSI2_CASE(2) PSI2_CASE(3) PSI2_CASE(4)
    PSI2_CASE(5) PSI2_CASE(6) PSI2_CASE(7) PSI2_CASE(8)
#undef PSI2_CASE
    default:   // w and Z of the clamp from shared memory, d's in groups
      err = launch<0>(U, V, w, logdet, Z, g, gU, gV, gw, glogdet, scratch,
                      N, M, D, rc, chunks, grid, smem, s);
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t MD = (int64_t)M * D;
  psi2_bwd_finish_kernel<<<(unsigned)((MD + 255) / 256), 256, 0, s>>>(
      scratch, gZ, MD, grid);
  return (int)cudaGetLastError();
}

// Resident blocks an SM of the kernel at this (M, D) and rows a chunk, or
// -1 on an error.
extern "C" int psi2_bwd_occupancy(int M, int D, int rows_per_chunk) {
  if (M <= 0 || M > kMaxM || D <= 0 || D > kMaxD || rows_per_chunk <= 0)
    return -1;
  switch (D <= 8 ? D : 0) {
    case 1: return occupancy<1>(M, D, rows_per_chunk);
    case 2: return occupancy<2>(M, D, rows_per_chunk);
    case 3: return occupancy<3>(M, D, rows_per_chunk);
    case 4: return occupancy<4>(M, D, rows_per_chunk);
    case 5: return occupancy<5>(M, D, rows_per_chunk);
    case 6: return occupancy<6>(M, D, rows_per_chunk);
    case 7: return occupancy<7>(M, D, rows_per_chunk);
    case 8: return occupancy<8>(M, D, rows_per_chunk);
    default: return occupancy<0>(M, D, rows_per_chunk);
  }
}
