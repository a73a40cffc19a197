// Fused staged sparse-GP conditional (diagonal), backward, for sm_90a.
//
// Replaces the TPU kernel doubly_stochastic_dgp_tpu/ops/pallas/
// conditional.py::_fused_backward (_bwd_kernel / _bwd_body) and, as the
// kSaved variant, its form that reads the forward's saved gram
// (_bwd_kernel_sg).  Given the forward's inputs and the output cotangents
// gm, gv (B, Do) (gv already zero where the forward clamped var), per
// row x with K = kvar exp(-0.5 ||x - z||^2), G = K LiT:
//
//   dG    = gm alpha^T + sum_d 2 gv_d (G W_d)        (M,) per row
//   dK    = dG LiT^T,   Gd = -0.5 dK * K
//   dX    = 2 sum_m Gd_m (x - z_m)                   per row
//   dalpha = sum_rows G^T gm        dLiT = sum_rows K^T dG
//   dW_d  = sum_rows gv_d G^T G     dZ_m = 2 sum_rows Gd_m (z_m - x)
//
// (dkvar and dkdiag come from the saved forward outputs in the wrapper.)
// dX and dZ are taken as sums of Gd times the differences, which cancel
// nothing, where x sum Gd - Gd Z (the JAX kernel's form) cancels.
//
// What bounds it on an H100: operations.  Per row about 6 M Dx + 6 M^2 +
// 4 M Do + Do (4 M^2 + 2 M) flops against Dx + 2 Do floats read and Dx
// written (the saved variant reads M more); ~390 kflop a row at M = 100,
// Do = 8.  Nearly all of it is five GEMM-shaped products: per row G = K
// LiT, T_d = G W_d, dK = dG LiT^T; over the rows G^T diag(gv_d) G and
// K^T dG.
//
// Design: two passes and a fixed-order sum, no atomics.  All products are
// register-tiled fp32 FFMA (fused_conditional.cuh; the 3xTF32 tensor-core
// design was up to 4.5x further from float64 than the plain float32
// version in dX here, PERF.md §6).
//
// Row pass (fused_conditional_bwd_rows_kernel).  A block owns TB rows in 4 x 4
// thread tiles, as the forward: K (built by the forward's gram stage, whose
// ring lies over the tiles X and Y, or read back), then LiT, W_0 ..
// W_{Do-1} and LiT^T stream through the forward's cp.async ring of 16-row
// k-slices (LiT^T as column slices of LiT transposed on the way in: no
// transposed copy), each product's k sum a fresh FFMA chain a slice added to
// the running sum (ffma_slice_blocked).  Each thread keeps its tile of dG in
// registers and adds 2 gv_d T_d to it at the end of each W_d; dG then takes
// gm alpha^T, and dK's epilogue forms Gd = -0.5 dK K.  Two shared tiles serve:
// K then dG, and G then Gd (the epilogue reads K back from global
// memory).  The pass writes dX and the row panels the sums need, G, dG, Gd and
// (unless saved) K, each (B, P) with P = M rounded up to 4 and zeros past M.
//
// Reduction pass (fused_conditional_bwd_reduce_kernel).  dW_d and dLiT
// are products over the batch, G^T diag(gv_d) G and K^T dG, on square
// output tiles sized to M (M rounded up to 8, at most 128: one 104 x 104
// tile at M = 100), each block one tile over one of R fixed row slices,
// streaming 8-row slices of the two panels through a cp.async ring (the
// gv_d scale applied to the A slice in shared memory), an 8 x 8 tile a
// thread.  dalpha and dZ are FFMA sums, one thread an output.  With R > 1
// each slice writes its own partial outputs and a third kernel adds them
// in slice order; R is chosen by the wrapper's launch plan
// (conditional.py::backward_plan): two output-tile blocks an SM, as far as
// the partials stay within 8 MB, whatever B is.  Repeat launches give the
// same bits.

#include "fused_conditional.cuh"

namespace {

using namespace fc;

// the tiles X and Y, over which the gram stage's ring lies (whichever is
// larger), so that the product ring's first slices arrive while the gram
// is built
__host__ __device__ inline size_t tiles_union_floats(int M) {
  const int TB = block_rows(M);
  const size_t tiles = (size_t)2 * k_rows(M) * TB;
  const size_t gram = (size_t)gram_stage_floats(TB, M);
  return tiles > gram ? tiles : gram;
}

// X and Y (tiles_union_floats), the product ring, then the cotangent rows
__host__ __device__ inline size_t rows_smem_floats(int M, int Do) {
  const int TB = block_rows(M);
  return tiles_union_floats(M) + (size_t)kStages * kKS * 4 * col_groups(M) +
         (size_t)2 * TB * Do;
}

__host__ __device__ inline size_t reduce_smem_floats(int T) {
  return (size_t)kStages * (2 * kKS * T + kKS);
}

template <bool kSaved>
__global__ void __launch_bounds__(kThreads, 2)
fused_conditional_bwd_rows_kernel(
    const float* __restrict__ Xs, const float* __restrict__ Zs,
    const float* __restrict__ LiT, const float* __restrict__ alpha,
    const float* __restrict__ W, const float* __restrict__ kvar_p,
    const float* __restrict__ gm, const float* __restrict__ gv,
    const float* __restrict__ Kin, float* __restrict__ dX,
    float* __restrict__ Kp, float* __restrict__ Gp, float* __restrict__ dGp,
    float* __restrict__ Gdp, int64_t B, int M, int Dx, int Do) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int CG = col_groups(M), RG = row_groups(M), TB = 4 * RG;
  const int P4 = 4 * CG, P = k_rows(M), SF = kKS * P4;
  float* X = smem;                            // P x TB: K, then dG
  float* Y = X + (size_t)P * TB;              // P x TB: G, then Gd
  float* ring = smem + tiles_union_floats(M); // kStages x kKS x P4
  float* gms = ring + (size_t)kStages * SF;   // TB x Do
  float* gvs = gms + (size_t)TB * Do;         // TB x Do
  const int tid = threadIdx.x;
  const bool active = tid < RG * CG;
  const int lr = (tid / CG) * 4, lc = (tid % CG) * 4;  // tile's row, column
  const int64_t row0 = (int64_t)blockIdx.x * TB;
  const int nks = P / kKS, total = (Do + 2) * nks;
  const SliceLoader loader(P4, (M & 3) == 0, tid, kThreads);
  // the gram as the Gd epilogue reads it back
  const float* Kg = kSaved ? Kin : Kp;
  const int ldk = kSaved ? M : P4;

  auto issue = [&](int s) {
    const int mat = s / nks, ks = s - mat * nks;
    float* dst = ring + (size_t)(s % kStages) * SF;
    if (mat == Do + 1)
      load_slice_t(dst, LiT, M, ks * kKS, P4, tid, kThreads);
    else
      loader.copy(dst, P4, mat == 0 ? LiT : W + (size_t)(mat - 1) * M * M,
                  M, ks * kKS, M, M);
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) issue(s);
    cp_async_commit();
  }

  // the cotangent rows, zero past B
  for (int e = tid; e < TB * Do; e += kThreads) {
    const bool ok = row0 * Do + e < B * Do;
    gms[e] = ok ? __ldg(gm + row0 * Do + e) : 0.f;
    gvs[e] = ok ? __ldg(gv + row0 * Do + e) : 0.f;
  }
  // the gram rows: read back, or recomputed as in the forward (and then
  // written to the K panel for the reduction pass) through a ring laid
  // over X and Y, while the product ring's first slices arrive
  if (kSaved) {
    for (int e = tid; e < TB * P; e += kThreads) {
      const int i = e / P, m = e - i * P;
      const int64_t r = row0 + i;
      X[m * TB + i] = (r < B && m < M) ? __ldg(Kin + r * M + m) : 0.f;
    }
  } else {
    gram_tiles(Xs, Zs, *kvar_p, X, X, TB, P, row0, B, M, Dx, Kp, P4, P4,
               tid, kThreads);
  }
  // G's and Gd's k rows past the column groups (P4 <= k < P) stay 0 (the
  // epilogues write the first P4)
  for (int e = P4 * TB + tid; e < P * TB; e += kThreads) Y[e] = 0.f;

  float acc[4][4], dg[4][4];
  zero(acc);
  zero(dg);

  // a thread's tile v to a k-major shared tile and to a row panel
  auto store = [&](float (&v)[4][4], float* tile, float* panel) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(tile + (size_t)(lc + j) * TB + lr) =
          make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t r = row0 + lr + i;
      if (r < B)
        *reinterpret_cast<float4*>(panel + r * P4 + lc) =
            make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
    }
  };

  for (int s = 0; s < total; ++s) {
    cp_async_wait_ring();
    __syncthreads();  // slice s is in; slice s - 1's buffer is free
    if (s + kStages - 1 < total) issue(s + kStages - 1);
    cp_async_commit();
    if (!active) continue;
    const int mat = s / nks, ks = s - mat * nks;
    // A: K (mat 0), G (the W_d), dG (LiT^T)
    const float* As = (mat == 0 || mat > Do) ? X : Y;
    ffma_slice_blocked(acc, As + (size_t)ks * kKS * TB + lr, TB,
                       ring + (size_t)(s % kStages) * SF + lc, P4,
                       min(kKS, M - ks * kKS));
    if (ks != nks - 1) continue;
    if (mat == 0) {
      store(acc, Y, Gp);  // G = K LiT
    } else if (mat <= Do) {
      // dG += 2 gv_d T_d
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float sc = 2.f * gvs[(lr + i) * Do + mat - 1];
#pragma unroll
        for (int j = 0; j < 4; ++j) dg[i][j] = fmaf(sc, acc[i][j], dg[i][j]);
      }
      if (mat == Do) {
        // dG += gm alpha^T (zero past column M); dG replaces K, which was
        // last read by the products of mat 0
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (lc + j >= M) continue;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dg[i][j] += dot4(gms + (lr + i) * Do, 1,
                             alpha + (size_t)(lc + j) * Do, 1, Do);
        }
        store(dg, X, dGp);
      }
    } else {
      // Gd = -0.5 dK K (K read back from global memory, with plain loads:
      // the K panel was written by this kernel) replaces G, which was last
      // read by the products of mat Do
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t r = row0 + lr + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float k = (r < B && lc + j < M) ? Kg[r * ldk + lc + j] : 0.f;
          acc[i][j] = -0.5f * acc[i][j] * k;
        }
      }
      store(acc, Y, Gdp);
    }
    zero(acc);
  }
  cp_async_wait_all();
  __syncthreads();  // every thread's Gd is in

  // dX = 2 sum_m Gd_m (x - z_m), one thread an output, as four interleaved
  // FFMA chains added pairwise
  for (int e = tid; e < TB * Dx; e += kThreads) {
    const int i = e / Dx, j = e - i * Dx;
    const int64_t r = row0 + i;
    if (r >= B) continue;
    const float x = __ldg(Xs + r * Dx + j);
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    int m = 0;
    for (; m + 4 <= M; m += 4)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        t[u] = fmaf(Y[(size_t)(m + u) * TB + i],
                    x - __ldg(Zs + (size_t)(m + u) * Dx + j), t[u]);
#pragma unroll
    for (int u = 0; u < 3; ++u)
      if (m + u < M)
        t[u] = fmaf(Y[(size_t)(m + u) * TB + i],
                    x - __ldg(Zs + (size_t)(m + u) * Dx + j), t[u]);
    dX[r * Dx + j] = 2.f * ((t[0] + t[1]) + (t[2] + t[3]));
  }
}

// One block: one T x T output tile of dW_q (q < Do) or dLiT (q == Do)
// over one row slice, or one 32-wide column chunk of dalpha and dZ over
// it.  Writes to out + slice * E (E = 0: one slice, the outputs
// themselves).  Thread t owns the 8 x 8 tile at rows (t % (T / 8)) * 8,
// columns (t / (T / 8)) * 8 of the output tile.
__global__ void __launch_bounds__(256)
fused_conditional_bwd_reduce_kernel(
    const float* __restrict__ Kg, int ldk, const float* __restrict__ Gp,
    const float* __restrict__ dGp, const float* __restrict__ Gdp,
    const float* __restrict__ gm, const float* __restrict__ gv,
    const float* __restrict__ Xs, const float* __restrict__ Zs,
    float* __restrict__ out, int64_t E, int64_t B, int M, int Dx, int Do,
    int64_t rows_per_slice, int T) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int P = 4 * col_groups(M);  // the panels' row stride
  const int nt = (M + T - 1) / T;
  const int big = (Do + 1) * nt * nt;
  const int jobs = big + (M + 31) / 32;
  const int slice = blockIdx.x / jobs, job = blockIdx.x - slice * jobs;
  const int64_t rs = (int64_t)slice * rows_per_slice;
  const int64_t re = rs + rows_per_slice < B ? rs + rows_per_slice : B;
  float* dst = out + (int64_t)slice * E;
  const int64_t oL = (int64_t)Do * M * M, oA = oL + (int64_t)M * M;
  const int64_t oZ = oA + (int64_t)M * Do;
  const int tid = threadIdx.x, nthreads = blockDim.x;

  if (job >= big) {
    // dalpha[m][d] = sum_r G[r][m] gm[r][d];
    // dZ[m][j] = 2 sum_r Gd[r][m] (z[m][j] - x[r][j])
    const int m = (job - big) * 32 + (tid & 31);
    if (m >= M) return;
    for (int c = tid >> 5; c < Do + Dx; c += nthreads >> 5) {
      if (c < Do) {
        float a = 0.f;
        for (int64_t r = rs; r < re; ++r)
          a = fmaf(__ldg(Gp + r * P + m), __ldg(gm + r * Do + c), a);
        dst[oA + (int64_t)m * Do + c] = a;
      } else {
        const int j = c - Do;
        const float z = __ldg(Zs + (size_t)m * Dx + j);
        float a = 0.f;
        for (int64_t r = rs; r < re; ++r)
          a = fmaf(__ldg(Gdp + r * P + m), z - __ldg(Xs + r * Dx + j), a);
        dst[oZ + (int64_t)m * Dx + j] = 2.f * a;
      }
    }
    return;
  }

  const int q = job / (nt * nt), tile = job - q * (nt * nt);
  const int m0 = (tile / nt) * T, n0 = (tile % nt) * T;
  const bool scaled = q < Do;
  // dW_q: A = G scaled by gv_q, B = G; dLiT: A = K, B = dG
  const float* A = (scaled ? Gp : Kg) + m0;
  const int lda = scaled ? P : ldk;
  const float* Bp = (scaled ? Gp : dGp) + n0;
  const int SF = 2 * kKS * T + kKS;
  const int nsteps = (int)((re - rs + kKS - 1) / kKS);
  const int TG = T / 8;
  const int lr = (tid % TG) * 8, lc = (tid / TG) * 8;
  const bool active = tid < TG * TG;
  const SliceLoader la(T, (lda & 3) == 0, tid, nthreads);
  const SliceLoader lb(T, true, tid, nthreads);

  auto issue = [&](int s) {
    float* st = smem + (size_t)(s % kStages) * SF;
    const int64_t r0 = rs + (int64_t)s * kKS;
    la.copy(st, T, A, lda, r0, re, lda - m0);
    lb.copy(st + kKS * T, T, Bp, P, r0, re, P - n0);
    if (scaled && tid < kKS) {
      const int64_t r = r0 + tid;
      cp_async4(st + 2 * kKS * T + tid, r < re ? gv + r * Do + q : gv,
                r < re);
    }
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) issue(s);
    cp_async_commit();
  }

  float acc[8][8];
  zero(acc);
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait_ring();
    __syncthreads();  // slice s is in; slice s - 1's buffer is free
    float* As = smem + (size_t)(s % kStages) * SF;
    const float* Bs = As + kKS * T;
    if (scaled) {
      const float* sc = Bs + kKS * T;
      for (int e = tid; e < kKS * T; e += nthreads) As[e] *= sc[e / T];
      __syncthreads();
    }
    if (s + kStages - 1 < nsteps) issue(s + kStages - 1);
    cp_async_commit();
    const int64_t left = re - rs - (int64_t)s * kKS;  // rows in the slice
    if (active)
      ffma_slice(acc, As + lr, T, Bs + lc, T, left < kKS ? (int)left : kKS);
  }
  cp_async_wait_all();
  if (!active) return;
  float* o = dst + (scaled ? (int64_t)q * M * M : oL);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + lr + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + lc + j;
      if (m < M && n < M) o[(int64_t)m * M + n] = acc[i][j];
    }
  }
}

// out[e] = sum over slices s = 0, 1, ... of part[s * E + e], in that order
__global__ void sum_slices_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int64_t E,
                                  int nslices) {
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < E;
       e += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < nslices; ++b) s += part[(int64_t)b * E + e];
    out[e] = s;
  }
}

unsigned long long g_smem_set[3] = {0, 0, 0};

template <bool kSaved>
cudaError_t launch_rows(const float* Xs, const float* Zs, const float* LiT,
                        const float* alpha, const float* W,
                        const float* kvar, const float* gm, const float* gv,
                        const float* Kin, float* dX, float* Kp, float* Gp,
                        float* dGp, float* Gdp, int64_t B, int M, int Dx,
                        int Do, cudaStream_t stream) {
  auto* kernel = fused_conditional_bwd_rows_kernel<kSaved>;
  cudaError_t err = allow_smem(kernel, g_smem_set[kSaved ? 1 : 0]);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (B + block_rows(M) - 1) / block_rows(M);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads,
           rows_smem_floats(M, Do) * sizeof(float), stream>>>(
      Xs, Zs, LiT, alpha, W, kvar, gm, gv, Kin, dX, Kp, Gp, dGp, Gdp, B, M,
      Dx, Do);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Pointers are device pointers
// to contiguous float32 tensors: the forward's inputs (kvar a 0-dim tensor
// on the device), the cotangents gm, gv (B, Do), Kin the saved (B, M) gram
// or null (then K is recomputed), dX (B, Dx), out the E = Do*M*M + M*M +
// M*Do + M*Dx floats of (dW, dLiT, dalpha, dZ), panels the (3 or, without
// Kin, 4) x B x P floats of the row panels (P = M rounded up to 4), and
// part the nslices x E floats of slice partials (null when nslices == 1).
// The reduction's plan (nslices slices of rows_per_slice rows; square
// output tiles of `tile` columns; `threads` a block) comes from
// conditional.py::backward_plan.  Launches the row pass, the reduction and
// (nslices > 1) the fixed-order sum on `stream`.  Returns a cudaError_t
// code (0 = launched).
extern "C" int fused_conditional_bwd(
    const float* Xs, const float* Zs, const float* LiT, const float* alpha,
    const float* W, const float* kvar, const float* gm, const float* gv,
    const float* Kin, float* dX, float* out, float* panels, float* part,
    int64_t B, int M, int Dx, int Do, int nslices, int64_t rows_per_slice,
    int tile, int threads, void* stream) {
  if (B <= 0 || M <= 0 || M > kMaxM || Dx <= 0 || Do <= 0 ||
      rows_smem_floats(M, Do) * sizeof(float) > 232448)
    return (int)cudaErrorInvalidValue;
  const int P = 4 * col_groups(M);  // the panels' row stride
  if (nslices < 1 || rows_per_slice < 1 ||
      (int64_t)nslices * rows_per_slice < B || (nslices > 1 && !part) ||
      tile % 8 || tile < 8 || tile > 128 || tile > round_up(M, 8) ||
      threads % 32 || threads > 256 || threads < (tile / 8) * (tile / 8))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t BP = B * P;
  float* Gp = panels;
  float* dGp = Gp + BP;
  float* Gdp = dGp + BP;
  float* Kp = Kin != nullptr ? nullptr : Gdp + BP;
  cudaError_t err =
      Kin != nullptr
          ? launch_rows<true>(Xs, Zs, LiT, alpha, W, kvar, gm, gv, Kin, dX,
                              nullptr, Gp, dGp, Gdp, B, M, Dx, Do, s)
          : launch_rows<false>(Xs, Zs, LiT, alpha, W, kvar, gm, gv, nullptr,
                               dX, Kp, Gp, dGp, Gdp, B, M, Dx, Do, s);
  if (err != cudaSuccess) return (int)err;

  err = allow_smem(fused_conditional_bwd_reduce_kernel, g_smem_set[2]);
  if (err != cudaSuccess) return (int)err;
  const int64_t E = (int64_t)Do * M * M + (int64_t)M * M +
                    (int64_t)M * Do + (int64_t)M * Dx;
  const int nt = (M + tile - 1) / tile;
  const int64_t blocks =
      ((int64_t)(Do + 1) * nt * nt + (M + 31) / 32) * nslices;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  fused_conditional_bwd_reduce_kernel<<<(unsigned)blocks, threads,
                                        reduce_smem_floats(tile) *
                                            sizeof(float),
                                        s>>>(
      Kin != nullptr ? Kin : Kp, Kin != nullptr ? M : P, Gp, dGp, Gdp, gm,
      gv, Xs, Zs, nslices > 1 ? part : out, nslices > 1 ? E : 0, B, M, Dx,
      Do, rows_per_slice, tile);
  err = cudaGetLastError();
  if (err != cudaSuccess || nslices == 1) return (int)err;
  int64_t sblocks = (E + 255) / 256;
  if (sblocks > 4096) sblocks = 4096;
  sum_slices_kernel<<<(unsigned)sblocks, 256, 0, s>>>(part, out, E, nslices);
  return (int)cudaGetLastError();
}

// Resident blocks an SM of the row pass (which 0, saved 1) or the
// reduction (which 2: `threads` threads, square tiles of `tile`) at this
// shape, or -1 on an error.
extern "C" int fused_conditional_bwd_occupancy(int which, int M, int Do,
                                               int tile, int threads) {
  if (M <= 0 || M > kMaxM || Do <= 0 || which < 0 || which > 2) return -1;
  int n = 0;
  cudaError_t err;
  const size_t smem = rows_smem_floats(M, Do) * sizeof(float);
  if (which == 2) {
    err = allow_smem(fused_conditional_bwd_reduce_kernel, g_smem_set[2]);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, fused_conditional_bwd_reduce_kernel, threads,
          reduce_smem_floats(tile) * sizeof(float));
  } else if (which == 1) {
    err = allow_smem(fused_conditional_bwd_rows_kernel<true>, g_smem_set[1]);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, fused_conditional_bwd_rows_kernel<true>, kThreads, smem);
  } else {
    err = allow_smem(fused_conditional_bwd_rows_kernel<false>,
                     g_smem_set[0]);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, fused_conditional_bwd_rows_kernel<false>, kThreads, smem);
  }
  return err == cudaSuccess ? n : -1;
}
