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
// pair.  The exps run on the SFU (16 a clock per SM, against 128 FFMA
// lanes), so at small D the exp rate sets the bound; at D = 8 the flops
// do.  When U and V come from one RBF kernel's staging (U = V - t/2 row by
// row), out is symmetric: the `symmetric` variant computes each a <= b
// once and writes it to (a, b) and (b, a) from the same register, which
// halves the exps and makes the output bitwise symmetric.
//
// Design of psi2_fwd_kernel (one launch):
//
// - Tiles.  A thread owns a 4 x 4 register tile of (a, b), the micro-tile
//   (i, j) = (a / 4, b / 4).  The micro-tiles are enumerated row-major:
//   all P x P of them (P = ceil(M / 4)) in the general variant, those with
//   i <= j in the symmetric one, so nothing below the diagonal is computed
//   but the 6 lower cells of each of the P diagonal micro-tiles (150 of
//   the 5,200 cells computed at M = 100), which are not stored.  A block's
//   `wt` warps of threads take 32 wt consecutive micro-tiles, a "group";
//   the block stages only the a's and b's its group spans (a box of U's
//   and V's columns), so staging costs little next to the exps.
// - Rows.  The rows are cut into `chunks` chunks, one a block along y, and
//   a block's R row groups of wt warps take its chunk's rows in turn, 8
//   rows each a step.  A step's S = 8 R rows of U, V (the box), w and
//   logdet stream through a cp.async ring of 3 stages (2 where shared
//   memory is short), so the loads of the next steps overlap this step's
//   exps; each thread's share of a row's copies is fixed for the block,
//   so staging costs no index arithmetic a copy.  ops/cuda/psi2.py::
//   forward_plan sizes wt, R and the chunks so that the blocks fill the
//   card's SMs once, and the ring for the widest box.
// - Arithmetic.  pre is formed as the plain version forms it (U + V, then
//   fma(-(w Z[a,d]), Z[b,d], pre) for d ascending), and exp(min(pre, 0) +
//   ld) = 2^(min(pre, 0) L + ld L) with L = log2(e): one FMA into
//   ex2.approx, so a term costs one add, D FMAs, a min, an FMA, the exp and
//   the accumulating add.  (Folding L and ld into U and Z instead saves the
//   FMA but rounds U L, which is large where U and V cancel: on
//   collapsed_L2's operands that put the kernel further from float64 than
//   the plain version.)
// - Sums.  A thread adds its rows into a fresh register tile four steps
//   (at most 32 rows) at a time and those into its total with Kahan's
//   compensated sum, total and compensation kept in shared memory so that
//   16 warps fit an SM's registers (plain serial sums there came out
//   further from float64 than the plain version, whose sum is a tree).
//   The R row groups' totals are added in row-group order through shared
//   memory, also by Kahan's sum.  With one chunk the block writes the
//   output; with several, each block writes its group's sums to scratch
//   (chunks x groups x 512 wt floats, whatever N), and the block that
//   finishes last among its group's chunks (a ticket counter per group)
//   adds the chunks in chunk order (Kahan) and writes the output (the
//   CTA-wide release and acquire of a semaphore: a block barrier, then one
//   thread's fence and atomic).  The tickets are the launch's own: they
//   sit at the end of its scratch, which the wrapper takes from the
//   stream-ordered caching allocator, and psi2_fwd zeroes them with a
//   cudaMemsetAsync on the launch's stream (a memset node in a CUDA
//   graph), so launches on other streams, or other graphs' replays, never
//   share them.  The orders are fixed and no float is added atomically,
//   so repeat launches are bit-identical.
// - Ragged edges are masked, not padded: a step stages only the rows that
//   exist, a tile's cells past M are not stored.  Row offsets are 64-bit.
//   For D <= 4 a thread's Z values sit in registers; above that they are
//   read from shared memory (at D = 8 the 64 registers of Z cost more
//   speed than the loads do).

#include <cuda_runtime.h>
#include <stdint.h>

#include "psi2_common.cuh"

namespace {

using psi2::kahan_add;
using psi2::kMaxD;
using psi2::kMaxM;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxThreads = 512;   // 16 warps: wt tile warps x R row groups
constexpr int kMaxStages = 3;      // the cp.async ring: 2 or 3 stages
constexpr int kKr = 8;             // rows a row group a step
constexpr int kFlush = 4;          // steps a thread adds before a Kahan step
constexpr int kMaxChunksReduce = 16;   // chunks of a launch
constexpr int kRegMaxD = 4;        // Z in registers up to this D
constexpr int kSmemDyn = 200 * 1024;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// micro-tile number k -> (i, j): row-major over P x P, or over i <= j
__device__ __forceinline__ void decode(int k, int P, bool sym, int& i,
                                       int& j) {
  if (!sym) {
    i = k / P;
    j = k % P;
    return;
  }
  i = 0;
  while (k >= P - i) {
    k -= P - i;
    ++i;
  }
  j = i + k;
}

// Floats of one ring stage: S rows of `box` U's and V's (the widest
// group's, a multiple of 4), D w's and a logdet, rounded up to 4 floats
// (16 bytes)
__host__ __device__ inline int64_t stage_floats(int S, int box, int D) {
  return ((int64_t)S * (box + D + 1) + 3) / 4 * 4;
}

// Shared memory of a block in floats (psi2.py::_fwd_smem_floats): the
// ring, the per-thread totals and their Kahan compensations (16 each a
// thread) and, for D > 4, Z transposed ([d][4P])
__host__ __device__ inline int64_t smem_floats(int M, int D, int R, int box,
                                               int threads, int stages) {
  const int P4 = 4 * ((M + 3) / 4);
  return stages * stage_floats(kKr * R, box, D) + 32LL * threads +
         (D > kRegMaxD ? (int64_t)D * P4 : 0);
}

__device__ __forceinline__ void store(float* out, int M, bool sym, int ti,
                                      int tj, int k, float v) {
  const int a = 4 * ti + k / 4, b = 4 * tj + k % 4;
  if (a >= M || b >= M) return;
  if (!sym) {
    out[(int64_t)a * M + b] = v;
  } else if (a <= b) {
    out[(int64_t)a * M + b] = v;
    out[(int64_t)b * M + a] = v;
  }
}

// DT > 0: D == DT <= kRegMaxD, the thread's Z values in registers.
// DT == 0: any D <= kMaxD, Z read from shared memory.  grid (groups,
// chunks), 32 wt R threads a block.
template <int DT>
__global__ void __launch_bounds__(kMaxThreads, 1)
psi2_fwd_kernel(const float* __restrict__ U, const float* __restrict__ V,
                const float* __restrict__ w,
                const float* __restrict__ logdet,
                const float* __restrict__ Z, float* __restrict__ out,
                float* __restrict__ scratch, unsigned* __restrict__ tickets,
                int64_t N, int M, int D, int sym, int wt, int R,
                int64_t rows_per_chunk, int box, int stages, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int last;

  const int P = (M + 3) / 4, P4 = 4 * P;
  const int T = sym ? P * (P + 1) / 2 : P * P;
  const int TL = 32 * wt;                 // micro-tiles of the group
  const int nthreads = TL * R;
  const int tid = threadIdx.x, tl = tid % TL, rg = tid / TL;
  const int g = blockIdx.x, c = blockIdx.y;
  const int G = gridDim.x, chunks = gridDim.y;
  const int k0 = g * TL;
  const bool has = k0 + tl < T;
  int ti, tj, i0, j0, i1, j1;
  decode(has ? k0 + tl : k0, P, sym, ti, tj);
  decode(k0, P, sym, i0, j0);
  decode(min(T, k0 + TL) - 1, P, sym, i1, j1);
  // the group's box: micro-rows i0..i1; micro-columns j0..j1 on one row,
  // else from the first row's j0 (or the next row's diagonal) to the end
  const int a_lo = i0, ua = 4 * (i1 - i0 + 1);
  const int b_lo = i0 == i1 ? j0 : (sym ? min(j0, i0 + 1) : 0);
  const int vb = 4 * ((i0 == i1 ? j1 + 1 : P) - b_lo);
  const int S = R * kKr;
  const int64_t sf = stage_floats(S, box, D);
  // the thread's totals and compensations, [cell k][thread]
  float* part = smem + stages * sf;
  float* pcomp = part + 16 * nthreads;
  float* sZ = pcomp + 16 * nthreads;

  const int64_t n_begin = (int64_t)c * rows_per_chunk;
  const int64_t n_end =
      n_begin + rows_per_chunk < N ? n_begin + rows_per_chunk : N;
  const int steps = (int)((n_end - n_begin + S - 1) / S);

  // A row's copies: Q units (16 bytes when M % 4 == 0 and the rows are
  // 16-byte aligned, so that 4P == M; else 4 bytes, and the columns past
  // M are not read, their cells not stored), the first qa of U's box.  A
  // thread copies unit q0 of rows r0, r0 + rstep, ...
  const int unit = vec ? 4 : 1;
  const int Q = (ua + vb) / unit, qa = ua / unit;
  const int rstep = Q <= nthreads ? nthreads / Q : 1;
  const bool copier = Q > nthreads || tid < rstep * Q;
  const int r0 = Q <= nthreads ? tid / Q : 0;
  const int q0 = Q <= nthreads ? tid % Q : tid;
  auto copy = [&](float* st, int64_t n0, int r, int q) {
    const bool in_u = q < qa;
    const int off = unit * (in_u ? q : q - qa);
    const int col = 4 * (in_u ? a_lo : b_lo) + off;
    const float* src = (in_u ? U : V) + (n0 + r) * M + col;
    float* dst = in_u ? st + r * ua + off : st + S * ua + r * vb + off;
    if (vec)
      cp_async16(dst, src);
    else if (col < M)
      cp_async4(dst, src);
  };
  auto stage = [&](int s) {
    float* st = smem + (s % stages) * sf;
    const int64_t n0 = n_begin + (int64_t)s * S;
    const int rows = (int)(n_end - n0 < S ? n_end - n0 : S);
    if (copier) {
      for (int r = r0; r < rows; r += rstep)
        for (int q = q0; q < Q; q += nthreads) copy(st, n0, r, q);
    }
    float* sW = st + S * (ua + vb);
    float* sL = sW + S * D;
    for (int e = tid; e < rows * D; e += nthreads)
      cp_async4(sW + e, w + n0 * D + e);
    for (int e = tid; e < rows; e += nthreads)
      cp_async4(sL + e, logdet + n0 + e);
  };

  for (int s = 0; s < stages - 1; ++s) {
    if (s < steps) stage(s);
    cp_async_commit();
  }

  constexpr int kRegD = DT > 0 ? DT : 1;
  float za[4][kRegD], zb[4][kRegD];
  if constexpr (DT > 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const int a = 4 * ti + i, b = 4 * tj + i;
        za[i][d] = a < M ? Z[(int64_t)a * DT + d] : 0.f;
        zb[i][d] = b < M ? Z[(int64_t)b * DT + d] : 0.f;
      }
  } else {
    for (int e = tid; e < D * P4; e += nthreads) {
      const int d = e / P4, m = e % P4;
      sZ[e] = m < M ? Z[(int64_t)m * D + d] : 0.f;
    }
  }

  float sum[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sum[i][j] = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k)
    part[k * nthreads + tid] = pcomp[k * nthreads + tid] = 0.f;
  // sum += the register tile (Kahan), which restarts from 0
  auto flush = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = (4 * i + j) * nthreads + tid;
        float a = part[e], cp = pcomp[e];
        kahan_add(a, cp, sum[i][j]);
        part[e] = a;
        pcomp[e] = cp;
        sum[i][j] = 0.f;
      }
  };

  for (int s = 0; s < steps; ++s) {
    if (stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();   // step s has landed; step s - 1's buffer is free
    if (s + stages - 1 < steps) stage(s + stages - 1);
    cp_async_commit();
    const float* st = smem + (s % stages) * sf;
    const int64_t left = n_end - n_begin - (int64_t)s * S;
    const int rows = (int)(left < S ? left : S);
    const float* sU = st + 4 * (ti - a_lo);
    const float* sV = st + S * ua + 4 * (tj - b_lo);
    const float* sW = st + S * (ua + vb);
    const float* sL = sW + S * D;
#pragma unroll
    for (int q = 0; q < kKr; ++q) {
      const int r = rg + R * q;          // the same for a whole warp
      if (r >= rows) continue;
      const float4 u4 = *reinterpret_cast<const float4*>(sU + r * ua);
      const float4 v4 = *reinterpret_cast<const float4*>(sV + r * vb);
      const float ldL = sL[r] * kLog2e;
      const float up[4] = {u4.x, u4.y, u4.z, u4.w};
      const float vp[4] = {v4.x, v4.y, v4.z, v4.w};
      float pre[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) pre[i][j] = up[i] + vp[j];
      const float* wr = sW + r * D;
      if constexpr (DT > 0) {
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          const float wd = wr[d];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float wz = wd * za[i][d];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              pre[i][j] = fmaf(-wz, zb[j][d], pre[i][j]);
          }
        }
      } else {
        for (int d = 0; d < D; ++d) {
          const float wd = wr[d];
          const float4 a4 =
              *reinterpret_cast<const float4*>(sZ + d * P4 + 4 * ti);
          const float4 b4 =
              *reinterpret_cast<const float4*>(sZ + d * P4 + 4 * tj);
          const float zav[4] = {a4.x, a4.y, a4.z, a4.w};
          const float zbv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float wz = wd * zav[i];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              pre[i][j] = fmaf(-wz, zbv[j], pre[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sum[i][j] += ex2(fmaf(fminf(pre[i][j], 0.f), kLog2e, ldL));
    }
    if (s % kFlush == kFlush - 1) flush();
  }
  cp_async_wait<0>();

  // the row groups' totals, added in row-group order
  flush();
  __syncthreads();
  const bool multi = chunks > 1;
  for (int k = rg; k < 16; k += R) {
    float v = 0.f, cv = 0.f;
    for (int r = 0; r < R; ++r)
      kahan_add(v, cv, part[k * nthreads + r * TL + tl]);
    if (multi)
      scratch[(((int64_t)c * G + g) * 16 + k) * TL + tl] = v;
    else if (has)
      store(out, M, sym, ti, tj, k, v);
  }
  if (!multi) return;

  // the last of the group's chunks adds all of them, in chunk order
  __syncthreads();
  if (tid == 0) {
    __threadfence();   // release the block's scratch writes
    last = atomicAdd(tickets + g, 1u) == (unsigned)(chunks - 1);
    __threadfence();   // acquire the other chunks'
  }
  __syncthreads();
  if (!last) return;
  const int64_t stride = (int64_t)G * 16 * TL;
  for (int k = rg; k < 16; k += R) {
    const float* p = scratch + ((int64_t)g * 16 + k) * TL + tl;
    float x[kMaxChunksReduce];     // every chunk's value in flight at once
#pragma unroll
    for (int q = 0; q < kMaxChunksReduce; ++q)
      x[q] = q < chunks ? __ldcg(p + q * stride) : 0.f;
    float v = 0.f, cv = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxChunksReduce; ++q)
      if (q < chunks) kahan_add(v, cv, x[q]);
    if (has) store(out, M, sym, ti, tj, k, v);
  }
}

template <int DT>
cudaError_t allow_smem() {
  static unsigned long long done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(psi2_fwd_kernel<DT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemDyn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(psi2_fwd_kernel<DT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done |= bit;
  return err;
}

template <int DT>
cudaError_t launch(const float* U, const float* V, const float* w,
                   const float* logdet, const float* Z, float* out,
                   float* scratch, unsigned* tickets, int64_t N, int M,
                   int D, int sym, int wt, int R, int64_t rpc, int box,
                   int stages, int groups, int chunks, size_t smem, int vec,
                   cudaStream_t stream) {
  cudaError_t err = allow_smem<DT>();
  if (err != cudaSuccess) return err;
  psi2_fwd_kernel<DT><<<dim3((unsigned)groups, (unsigned)chunks),
                        32 * wt * R, smem, stream>>>(
      U, V, w, logdet, Z, out, scratch, tickets, N, M, D, sym, wt, R, rpc,
      box, stages, vec);
  return cudaGetLastError();
}

template <int DT>
int occupancy(int threads, size_t smem) {
  int n = 0;
  cudaError_t err = allow_smem<DT>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, psi2_fwd_kernel<DT>, threads, smem);
  return err == cudaSuccess ? n : -1;
}

}  // namespace

// Plain C entry point (bound with ctypes).  Pointers are device pointers
// to contiguous float32 tensors: U, V (N, M), w (N, D), logdet (N, 1),
// Z (M, D), out (M, M).  The plan (psi2.py::forward_plan): wt tile warps
// and R row groups a block (32 wt R threads), `groups` x `chunks` blocks,
// rows_per_chunk rows a chunk, `box` the widest group's U and V columns
// (a multiple of 4), `stages` (2 or 3) ring stages, smem_bytes of shared
// memory a block, which must equal this file's smem_floats.  With
// chunks > 1, scratch holds chunks x groups x 512 wt floats of the chunks'
// sums and then the launch's `groups` ticket counters, which this function
// zeroes on `stream` before the launch (forward_plan's scratch_floats
// counts both).  symmetric: U and V make out symmetric; each a <= b is
// computed once and written to (a, b) and (b, a).  Returns a cudaError_t
// code (0 = launched).
extern "C" int psi2_fwd(const float* U, const float* V, const float* w,
                        const float* logdet, const float* Z, float* out,
                        float* scratch, int64_t N, int M,
                        int D, int symmetric, int wt, int R,
                        int64_t rows_per_chunk, int box, int stages,
                        int groups, int chunks, int64_t smem_bytes,
                        void* stream) {
  const int P = (M + 3) / 4;
  const int64_t T = symmetric ? (int64_t)P * (P + 1) / 2 : (int64_t)P * P;
  if (N <= 0 || M <= 0 || M > kMaxM || D <= 0 || D > kMaxD || wt <= 0 ||
      R <= 0 || 32 * wt * R > kMaxThreads || groups <= 0 || box <= 0 ||
      box % 4 || box > 8 * P || stages < 2 || stages > kMaxStages ||
      (int64_t)groups * 32 * wt < T || (int64_t)(groups - 1) * 32 * wt >= T ||
      chunks <= 0 || chunks > kMaxChunksReduce || rows_per_chunk <= 0 ||
      (int64_t)chunks * rows_per_chunk < N ||
      (int64_t)(chunks - 1) * rows_per_chunk >= N ||
      (chunks > 1 && scratch == nullptr) ||
      smem_bytes != smem_floats(M, D, R, box, 32 * wt * R, stages) *
                        (int64_t)sizeof(float) ||
      smem_bytes > kSmemDyn)
    return (int)cudaErrorInvalidValue;
  const int vec = M % 4 == 0 && reinterpret_cast<uintptr_t>(U) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(V) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)smem_bytes;
  unsigned* tickets = nullptr;
  if (chunks > 1) {
    tickets = reinterpret_cast<unsigned*>(
        scratch + (int64_t)chunks * groups * 32 * wt * 16);
    const cudaError_t err =
        cudaMemsetAsync(tickets, 0, sizeof(unsigned) * groups, s);
    if (err != cudaSuccess) return (int)err;
  }
  switch (D <= kRegMaxD ? D : 0) {
#define PSI2_CASE(d)                                                      \
  case d:                                                                 \
    return (int)launch<d>(U, V, w, logdet, Z, out, scratch, tickets, N, M, \
                          D, symmetric, wt, R, rows_per_chunk, box, stages, \
                          groups, chunks, smem, vec, s);
    PSI2_CASE(1) PSI2_CASE(2) PSI2_CASE(3) PSI2_CASE(4)
#undef PSI2_CASE
    default:
      return (int)launch<0>(U, V, w, logdet, Z, out, scratch, tickets, N, M,
                            D, symmetric, wt, R, rows_per_chunk, box, stages,
                            groups, chunks, smem, vec, s);
  }
}

// Resident blocks an SM of psi2_fwd_kernel at this D, block size and
// shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1.
extern "C" int psi2_fwd_occupancy(int D, int threads, int64_t smem_bytes) {
  if (D <= 0 || D > kMaxD || threads <= 0 || threads > kMaxThreads ||
      smem_bytes < 0 || smem_bytes > kSmemDyn)
    return -1;
  const size_t smem = (size_t)smem_bytes;
  switch (D <= kRegMaxD ? D : 0) {
    case 1: return occupancy<1>(threads, smem);
    case 2: return occupancy<2>(threads, smem);
    case 3: return occupancy<3>(threads, smem);
    case 4: return occupancy<4>(threads, smem);
    default: return occupancy<0>(threads, smem);
  }
}
