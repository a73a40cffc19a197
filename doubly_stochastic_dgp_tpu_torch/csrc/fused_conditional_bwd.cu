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
// memory).  The pass writes the row panels the sums need, G, dG, Gd and
// (unless saved) K, each (B, P) with P = M rounded up to 4 and zeros past M,
// and, at narrow Dx only (conditional.py::DX_IN_ROWS_MAX), dX, one thread
// an output.
//
// At small B (kCluster) a cluster of cs blocks shares a row block
// (fused_conditional.cuh): block q builds K (or reads it back whole), G, dG
// and dK at its column groups and stores K, G and dG into every block of the
// cluster.  The W_d products go in rounds: in round j block q forms T_d for d
// = j cs + q (past Do a product whose T is not used) and leaves it in one of
// two shared buffers; after a cluster barrier each block folds the round's
// T_d, d ascending, read from their blocks' buffers, into dG's columns it
// owns, held in X: the instructions of one block's dG, in its order.  So at
// B = 1000 (Do = 30) the pass runs on 25 x 8 blocks, where one block a row
// block streamed Do + 2 matrices one after another on 25 SMs.
//
// Reduction pass (fused_conditional_bwd_reduce_kernel), one launch of
// independent jobs over the panels.  dW_d and dLiT are products over the
// batch, G^T diag(gv_d) G and K^T dG, on square output tiles sized to M (M
// rounded up to 8, at most 128: one 104 x 104 tile at M = 100), each block
// one tile over one of R fixed row slices, streaming 8-row slices of the two
// panels through a cp.async ring (the gv_d scale applied to the A slice in
// shared memory), an 8 x 8 tile a thread.  dZ and dalpha are column sums
// over the same slices (colsum_tile): a block a tile of inducing points by
// columns, a 4 x 4 register tile a thread, the slice's panel rows (Gd or G)
// and its Xs or gm rows streamed through a ring of 16-row slices, one FFMA
// chain an output in row order.  dX, where the row pass does not form it,
// is a grid of row tiles by column chunks (dx_tile): Gd's rows and Zs's
// columns staged in 16-wide chunks of m, a 4 x 4 register tile a thread with
// x in registers, four FFMA chains an output.  Both keep the order of the
// one-thread-an-output passes they replace, so every gradient has the same
// bits as they gave.  At the MNIST layer 0 (B = 1000, Dx = 784) those passes
// ran on 25 and 20 blocks, one dependent chain with global loads a step;
// the tiles give the launch 578 blocks of two instructions a term.  With R >
// 1 each slice writes its own partial outputs and a third kernel adds them
// in slice order; R is chosen by the wrapper's launch plan
// (conditional.py::backward_plan): two output-tile blocks an SM, as far as
// the partials stay within 8 MB, whatever B is.  Repeat launches give the
// same bits.

#include "fused_conditional.cuh"

namespace {

using namespace fc;

// the tiles X and Y, over which the gram stage's ring lies (whichever is
// larger), so that the product ring's first slices arrive while the gram
// is built.  In a cluster also the two T buffers after Y, and the ring lies
// over Y and them, as the cluster's blocks store K into X meanwhile.
__host__ __device__ inline size_t tiles_union_floats(int M, bool cluster) {
  const int TB = block_rows(M);
  const size_t PT = (size_t)k_rows(M) * TB;
  const size_t gram = (size_t)gram_stage_floats(TB, M) + (cluster ? PT : 0);
  const size_t tiles =
      2 * PT + (cluster ? (size_t)2 * TB * 4 * col_groups(M) : 0);
  return tiles > gram ? tiles : gram;
}

// X and Y (tiles_union_floats), the product ring, then the cotangent rows
__host__ __device__ inline size_t rows_smem_floats(int M, int Do,
                                                   bool cluster) {
  return tiles_union_floats(M, cluster) +
         (size_t)kStages * kKS * 4 * col_groups(M) +
         (size_t)2 * block_rows(M) * Do;
}

template <bool kSaved, bool kCluster>
__global__ void __launch_bounds__(kThreads, 2)
fused_conditional_bwd_rows_kernel(
    const float* __restrict__ Xs, const float* __restrict__ Zs,
    const float* __restrict__ LiT, const float* __restrict__ alpha,
    const float* __restrict__ W, const float* __restrict__ kvar_p,
    const float* __restrict__ gm, const float* __restrict__ gv,
    const float* __restrict__ Kin, float* __restrict__ dX,
    float* __restrict__ Kp, float* __restrict__ Gp, float* __restrict__ dGp,
    float* __restrict__ Gdp, int64_t B, int M, int Dx, int Do, int dx_rows) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int CG = col_groups(M), RG = row_groups(M), TB = 4 * RG;
  const int P4 = 4 * CG, P = k_rows(M), SF = kKS * P4;
  float* X = smem;                            // P x TB: K, then dG
  float* Y = X + (size_t)P * TB;              // P x TB: G, then Gd
  float* Tb = Y + (size_t)P * TB;             // a cluster's 2 x TB x P4: T_d
  float* ring = smem + tiles_union_floats(M, kCluster);
  float* gms = ring + (size_t)kStages * SF;   // TB x Do
  float* gvs = gms + (size_t)TB * Do;         // TB x Do
  const int tid = threadIdx.x;
  const Split sp = split_of<kCluster>(CG);
  const int64_t row0 = (int64_t)(blockIdx.x / sp.cs) * TB;
  // the tiles of the W_d products (all columns), and of G and dK (in a
  // cluster the block's column groups, packed into the first threads)
  const bool active = tid < RG * CG;
  const int lr = (tid / CG) * 4, lc = (tid % CG) * 4;
  const int ng = sp.g1 - sp.g0;
  const bool gactive = tid < RG * ng;
  const int glr = (tid / ng) * 4, glc = (sp.g0 + tid % ng) * 4;
  // rounds of the W_d products: block q's T_d at d = j cs + q in round j
  const int R = (Do + sp.cs - 1) / sp.cs;
  const int nks = P / kKS, total = (R + 2) * nks;
  const SliceLoader loader(P4, (M & 3) == 0, tid, kThreads);
  // the gram as the Gd epilogue reads it back
  const float* Kg = kSaved ? Kin : Kp;
  const int ldk = kSaved ? M : P4;

  auto issue = [&](int s) {
    const int mat = s / nks, ks = s - mat * nks;
    float* dst = ring + (size_t)(s % kStages) * SF;
    if (mat == R + 1) {
      load_slice_t(dst, LiT, M, ks * kKS, P4, tid, kThreads);
    } else {
      // in a cluster past Do: W_{Do-1} again, a product whose T is not used
      const int d = kCluster ? min(sp.cs * (mat - 1) + sp.q, Do - 1)
                             : mat - 1;
      loader.copy(dst, P4, mat == 0 ? LiT : W + (size_t)d * M * M, M,
                  ks * kKS, M, M);
    }
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
  // over X and Y (in a cluster over Y and the T buffers), while the
  // product ring's first slices arrive
  if constexpr (kCluster) cluster_sync();  // every block of it has started
  if (kSaved) {
    for (int e = tid; e < TB * P; e += kThreads) {
      const int i = e / P, m = e - i * P;
      const int64_t r = row0 + i;
      X[m * TB + i] = (r < B && m < M) ? __ldg(Kin + r * M + m) : 0.f;
    }
  } else {
    gram_stage<kCluster>(sp.cs, Xs, Zs, *kvar_p, X, kCluster ? Y : X, TB, P,
                         row0, B, M, Dx, Kp, P4, P4, sp.g0, sp.g1, tid,
                         kThreads);
  }
  // G's and Gd's k rows past the column groups (P4 <= k < P) stay 0 (the
  // epilogues write the first P4)
  for (int e = P4 * TB + tid; e < P * TB; e += kThreads) Y[e] = 0.f;
  if constexpr (kCluster) cluster_sync();  // K whole in every block

  float acc[4][4];
  zero(acc);

  if constexpr (!kCluster) {
    float dg[4][4];
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
          for (int j = 0; j < 4; ++j)
            dg[i][j] = fmaf(sc, acc[i][j], dg[i][j]);
        }
        if (mat == Do) {
          // dG += gm alpha^T (zero past column M); dG replaces K, which
          // was last read by the products of mat 0
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
        // Gd = -0.5 dK K (K read back from global memory, with plain
        // loads: the K panel was written by this kernel) replaces G, which
        // was last read by the products of mat Do
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int64_t r = row0 + lr + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float k =
                (r < B && lc + j < M) ? Kg[r * ldk + lc + j] : 0.f;
            acc[i][j] = -0.5f * acc[i][j] * k;
          }
        }
        store(acc, Y, Gdp);
      }
      zero(acc);
    }
  } else {
    // a thread's tile v (rows tr, columns tc) to the k-major shared tile
    // of this block (or, with `all`, of every block of the cluster) and to
    // a row panel
    auto store = [&](float (&v)[4][4], int tr, int tc, float* tile,
                     float* panel, bool all) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float4* p =
            reinterpret_cast<float4*>(tile + (size_t)(tc + j) * TB + tr);
        const float4 val = make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
        if (all)
          put<true>(p, val);
        else
          *p = val;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t r = row0 + tr + i;
        if (r < B)
          *reinterpret_cast<float4*>(panel + r * P4 + tc) =
              make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
      }
    };

    // after round j's barrier: the round's T_d, d = j cs .. (j + 1) cs - 1
    // below Do, folded in d order into the columns of dG this block owns
    // (4 rows of a column a step), in X; after the last round dG takes gm
    // alpha^T and goes to the panel and to every block's X
    auto fold = [&](int j) {
      const int w = 4 * ng, c0 = 4 * sp.g0;
      const float* tb = Tb + (size_t)(j & 1) * TB * P4;
      cg::cluster_group cl = cg::this_cluster();
      for (int e = tid; e < RG * w; e += kThreads) {
        const int i0 = 4 * (e / w), c = c0 + e % w;
        float4* xp = reinterpret_cast<float4*>(X + (size_t)c * TB + i0);
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (j > 0) {
          const float4 x = *xp;
          v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
        }
        for (int r = 0; r < sp.cs; ++r) {
          const int d = j * sp.cs + r;
          if (d >= Do) break;
          const float4 t = *cl.map_shared_rank(
              reinterpret_cast<const float4*>(tb + (size_t)c * TB + i0), r);
          const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = fmaf(2.f * gvs[(i0 + i) * Do + d], tv[i], v[i]);
        }
        if (j < R - 1) {
          *xp = make_float4(v[0], v[1], v[2], v[3]);
          continue;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (c < M)
            v[i] +=
                dot4(gms + (i0 + i) * Do, 1, alpha + (size_t)c * Do, 1, Do);
          const int64_t r = row0 + i0 + i;
          if (r < B) dGp[r * P4 + c] = v[i];
        }
        put<true>(xp, make_float4(v[0], v[1], v[2], v[3]));
      }
    };

    for (int s = 0; s < total; ++s) {
      cp_async_wait_ring();
      __syncthreads();  // slice s is in; slice s - 1's buffer is free
      if (s + kStages - 1 < total) issue(s + kStages - 1);
      cp_async_commit();
      const int mat = s / nks, ks = s - mat * nks;
      // A: K (mat 0), G (the W_d), dG (LiT^T); G and dK at the block's
      // column groups
      const bool part = mat == 0 || mat == R + 1;
      const bool on = part ? gactive : active;
      const int tr = part ? glr : lr, tc = part ? glc : lc;
      const float* As = part ? X : Y;
      if (on)
        ffma_slice_blocked(acc, As + (size_t)ks * kKS * TB + tr, TB,
                           ring + (size_t)(s % kStages) * SF + tc, P4,
                           min(kKS, M - ks * kKS));
      if (ks != nks - 1) continue;
      if (mat == 0) {
        if (on) store(acc, tr, tc, Y, Gp, true);  // G = K LiT
        cluster_sync();  // G whole in every block
      } else if (mat <= R) {
        // round mat - 1: this block's T_d to its buffer, then the fold
        const int d = sp.cs * (mat - 1) + sp.q;
        float* tb = Tb + (size_t)((mat - 1) & 1) * TB * P4;
        if (active && d < Do)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            *reinterpret_cast<float4*>(tb + (size_t)(lc + j) * TB + lr) =
                make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
        cluster_sync();  // the round's T_d in their buffers
        fold(mat - 1);
        if (mat == R) cluster_sync();  // dG whole in every block
      } else if (on) {
        // Gd = -0.5 dK K, as outside a cluster, to every block's Y only
        // where the row pass forms dX
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int64_t r = row0 + tr + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float k =
                (r < B && tc + j < M) ? Kg[r * ldk + tc + j] : 0.f;
            acc[i][j] = -0.5f * acc[i][j] * k;
          }
        }
        store(acc, tr, tc, Y, Gdp, dx_rows != 0);
      }
      zero(acc);
    }
  }
  cp_async_wait_all();
  if (!dx_rows) return;
  // every thread's Gd is in (in every block of a cluster)
  if constexpr (kCluster)
    cluster_sync();
  else
    __syncthreads();

  // dX = 2 sum_m Gd_m (x - z_m), one thread an output (a cluster's blocks
  // take turns), as four interleaved FFMA chains (m mod 4, m ascending)
  // added pairwise: dx_tile's order
  for (int e = sp.q * kThreads + tid; e < TB * Dx; e += sp.cs * kThreads) {
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

// The reduction launch's jobs (conditional.py::backward_plan): square
// output tiles of `tile` columns for dW and dLiT; column-sum tiles of 4 cg
// inducing points by 4 zjg (dZ) or 4 ajg (dalpha) columns; dX tiles of 4 xrg
// rows by 4 xjg columns (xrg = 0: the row pass forms dX).
struct ReducePlan {
  int tile, cg, zjg, ajg, xrg, xjg;
};

__host__ __device__ inline int64_t cdiv(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

// Jobs of the launch, in block order: the dW / dLiT tiles of every slice
// (`big` a slice), then dZ's column-sum tiles of every slice (`nz` a slice),
// dalpha's (`na`), then dX's tiles (`nx`).
struct ReduceJobs {
  int nt, big, nmt, nz, na;
  int64_t nx, blocks;

  __host__ __device__ ReduceJobs(const ReducePlan& p, int64_t B, int M,
                                 int Dx, int Do, int nslices) {
    nt = (int)cdiv(M, p.tile);
    big = (Do + 1) * nt * nt;
    nmt = (int)cdiv(M, 4 * p.cg);
    nz = nmt * (int)cdiv(Dx, 4 * p.zjg);
    na = nmt * (int)cdiv(Do, 4 * p.ajg);
    nx = p.xrg > 0 ? cdiv(B, 4 * p.xrg) * cdiv(Dx, 4 * p.xjg) : 0;
    blocks = (int64_t)nslices * (big + nz + na) + nx;
  }
};

// shared memory of the reduction launch: the largest of its jobs' rings
__host__ inline size_t reduce_smem_floats(const ReducePlan& p) {
  const size_t tiles = (size_t)kStages * (2 * kKS * p.tile + kKS);
  const int jg = p.zjg > p.ajg ? p.zjg : p.ajg;
  const size_t sums = (size_t)kStages * kKS * 4 * (p.cg + jg);
  const size_t dx =
      (size_t)kStages * (4 * p.xrg * gt::kRow<float> + kKS * 4 * p.xjg);
  size_t n = tiles > sums ? tiles : sums;
  return n > dx ? n : dx;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One T x T output tile of dW_q (q < Do) or dLiT (q == Do) over the rows rs
// .. re - 1 of one slice, into o (the slice's outputs).  Thread t owns the
// 8 x 8 tile at rows (t % (T / 8)) * 8, columns (t / (T / 8)) * 8 of it.
__device__ __forceinline__ void product_tile(
    float* smem, const float* __restrict__ Kg, int ldk,
    const float* __restrict__ Gp, const float* __restrict__ dGp,
    const float* __restrict__ gv, float* __restrict__ o, int64_t rs,
    int64_t re, int M, int Do, int P, int T, int job, int tid,
    int nthreads) {
  const int nt = (M + T - 1) / T;
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
  o += scaled ? (int64_t)q * M * M : (int64_t)Do * M * M;
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

// One column-sum tile over the rows rs .. re - 1 of one slice: o[m][c] (an
// M x W output) for the 4 cg inducing points from m0 and the 4 jg columns
// from c0, one FFMA chain an output in row order,
//   kDiff (dZ):  2 sum_r Gd[r][m] (z[m][c] - x[r][c])    (Pn = Gd, V = Xs)
//   dalpha:        sum_r  G[r][m] gm[r][c]                (Pn = G,  V = gm)
// The panel's rows (columns m0 ..) and V's (columns c0 ..) stream through a
// ring of kKS-row slices; thread t owns the 4 x 4 register tile at m-group
// t % cg and column group t / cg, with kDiff z[m][c] in registers.
template <bool kDiff>
__device__ __forceinline__ void colsum_tile(
    float* smem, const float* __restrict__ Pn, int P,
    const float* __restrict__ V, int W, const float* __restrict__ Zs,
    float* __restrict__ o, int64_t rs, int64_t re, int M, int m0, int c0,
    int cg, int jg, int tid, int nthreads) {
  const int MT = 4 * cg, CT = 4 * jg, SF = kKS * (MT + CT);
  const bool active = tid < cg * jg;
  const int lm = (tid % cg) * 4, lc = (tid / cg) * 4;
  const SliceLoader lp(MT, true, tid, nthreads);
  const SliceLoader lv(CT, (W & 3) == 0 && aligned16(V), tid, nthreads);
  const int nsteps = re > rs ? (int)((re - rs + kKS - 1) / kKS) : 0;
  auto issue = [&](int s) {
    float* st = smem + (size_t)(s % kStages) * SF;
    const int64_t r0 = rs + (int64_t)s * kKS;
    lp.copy(st, MT, Pn + m0, P, r0, re, P - m0);
    lv.copy(st + kKS * MT, CT, V + c0, W, r0, re, W - c0);
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) issue(s);
    cp_async_commit();
  }

  float z[4][4], a[4][4];
  zero(a);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + lm + i, c = c0 + lc + j;
      z[i][j] = (kDiff && active && m < M && c < W)
                    ? __ldg(Zs + (int64_t)m * W + c) : 0.f;
    }
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait_ring();
    __syncthreads();  // slice s is in; slice s - 1's buffer is free
    if (s + kStages - 1 < nsteps) issue(s + kStages - 1);
    cp_async_commit();
    if (!active) continue;
    const float* ps = smem + (size_t)(s % kStages) * SF + lm;
    const float* vs = smem + (size_t)(s % kStages) * SF + kKS * MT + lc;
    const int64_t left = re - rs - (int64_t)s * kKS;  // rows in the slice
    const int n = left < kKS ? (int)left : kKS;
    for (int k = 0; k < n; ++k) {
      float p[4], v[4];
      gt::load16(ps + k * MT, p);
      gt::load16(vs + k * CT, v);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          a[i][j] = fmaf(p[i], kDiff ? z[i][j] - v[j] : v[j], a[i][j]);
    }
  }
  cp_async_wait_all();
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + lm + i, c = c0 + lc + j;
      if (m < M && c < W)
        o[(int64_t)m * W + c] = kDiff ? 2.f * a[i][j] : a[i][j];
    }
}

// One dX tile: the 4 rg rows from r0 and the 4 jg columns from j0 of dX =
// 2 sum_m Gd[r][m] (x[r][j] - z[m][j]), each output as four interleaved FFMA
// chains (m mod 4, m ascending) added pairwise, the row pass's order.  Gd's
// rows (16-wide chunks of m, rows of gt::kRow floats) and Zs's rows (the
// chunk's m, columns j0 ..) stream through a ring; thread t owns the 4 x 4
// register tile at row group t / jg and column group t % jg, x in
// registers.
__device__ __forceinline__ void dx_tile(
    float* smem, const float* __restrict__ Gdp, int P,
    const float* __restrict__ Xs, const float* __restrict__ Zs,
    float* __restrict__ dX, int64_t B, int M, int Dx, int64_t r0, int j0,
    int rg, int jg, int tid, int nthreads) {
  constexpr int kRow = gt::kRow<float>;
  const int RT = 4 * rg, JT = 4 * jg, SF = RT * kRow + kKS * JT;
  const bool active = tid < rg * jg;
  const int lr = (tid / jg) * 4, lc = (tid % jg) * 4;
  const SliceLoader lz(JT, (Dx & 3) == 0 && aligned16(Zs), tid, nthreads);
  const int nch = (M + kKS - 1) / kKS;
  auto issue = [&](int c) {
    float* st = smem + (size_t)(c % kStages) * SF;
    const int m0 = c * kKS;
    for (int e = tid; e < RT * (kKS / 4); e += nthreads) {
      const int i = e / (kKS / 4), q = (e % (kKS / 4)) * 4;
      const int64_t r = r0 + i;
      const bool ok = r < B && m0 + q < P;  // P is a multiple of 4
      cp_async16(st + i * kRow + q, ok ? Gdp + r * P + m0 + q : Gdp, ok);
    }
    lz.copy(st + RT * kRow, JT, Zs + j0, Dx, m0, M, Dx - j0);
  };
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nch) issue(c);
    cp_async_commit();
  }

  float x[4][4], t[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t r = r0 + lr + i;
      const int col = j0 + lc + j;
      x[i][j] = (active && r < B && col < Dx) ? __ldg(Xs + r * Dx + col)
                                              : 0.f;
    }
#pragma unroll
  for (int u = 0; u < 4; ++u) zero(t[u]);
  for (int c = 0; c < nch; ++c) {
    cp_async_wait_ring();
    __syncthreads();  // chunk c is in; chunk c - 1's buffer is free
    if (c + kStages - 1 < nch) issue(c + kStages - 1);
    cp_async_commit();
    if (!active) continue;
    const float* g = smem + (size_t)(c % kStages) * SF + lr * kRow;
    const float* zs = smem + (size_t)(c % kStages) * SF + RT * kRow + lc;
    const int n = M - c * kKS < kKS ? M - c * kKS : kKS;  // m in the chunk
#pragma unroll
    for (int q = 0; q < kKS; q += 4) {
      if (q >= n) break;
      float gd[4][4];  // gd[i][u] = Gd[row i][m q + u]
#pragma unroll
      for (int i = 0; i < 4; ++i) gt::load16(g + i * kRow + q, gd[i]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (q + u >= n) break;  // the ragged tail: chains u < M mod 4
        float z[4];
        gt::load16(zs + (q + u) * JT, z);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            t[u][i][j] = fmaf(gd[i][u], x[i][j] - z[j], t[u][i][j]);
      }
    }
  }
  cp_async_wait_all();
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t r = r0 + lr + i;
      const int col = j0 + lc + j;
      if (r < B && col < Dx)
        dX[r * Dx + col] = 2.f * ((t[0][i][j] + t[1][i][j]) +
                                  (t[2][i][j] + t[3][i][j]));
    }
}

// One block a job (ReduceJobs).  A slice's jobs write to out + slice * E
// (E = 0: one slice, the outputs themselves); dX's to dX.  At most 168
// registers a thread, so that two blocks of 192 threads (the launch at M =
// 100) fit an SM's 65,536: left to itself ptxas takes 173 and fits one,
// which made the headline backward 14% slower; capped it takes 159 and
// spills nothing.
__global__ void __maxnreg__(168)
fused_conditional_bwd_reduce_kernel(
    const float* __restrict__ Kg, int ldk, const float* __restrict__ Gp,
    const float* __restrict__ dGp, const float* __restrict__ Gdp,
    const float* __restrict__ gm, const float* __restrict__ gv,
    const float* __restrict__ Xs, const float* __restrict__ Zs,
    float* __restrict__ out, float* __restrict__ dX, int64_t E, int64_t B,
    int M, int Dx, int Do, int nslices, int64_t rows_per_slice,
    ReducePlan pl) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int P = 4 * col_groups(M);  // the panels' row stride
  const ReduceJobs jobs(pl, B, M, Dx, Do, nslices);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  int64_t b = blockIdx.x;
  const int64_t nbig = (int64_t)nslices * jobs.big;
  const int64_t nz = (int64_t)nslices * jobs.nz;
  const int64_t na = (int64_t)nslices * jobs.na;
  if (b >= nbig + nz + na) {
    b -= nbig + nz + na;
    const int JT = 4 * pl.xjg, ncol = (int)cdiv(Dx, JT);
    dx_tile(smem, Gdp, P, Xs, Zs, dX, B, M, Dx,
            (b / ncol) * 4 * pl.xrg, (int)(b % ncol) * JT, pl.xrg, pl.xjg,
            tid, nthreads);
    return;
  }
  // a slice's job: kind 0 a product tile, 1 dZ, 2 dalpha
  int kind = 0, per = jobs.big;
  if (b >= nbig + nz) {
    kind = 2;
    b -= nbig + nz;
    per = jobs.na;
  } else if (b >= nbig) {
    kind = 1;
    b -= nbig;
    per = jobs.nz;
  }
  const int slice = (int)(b / per), job = (int)(b % per);
  const int64_t rs = (int64_t)slice * rows_per_slice;
  const int64_t re = rs + rows_per_slice < B ? rs + rows_per_slice : B;
  float* dst = out + (int64_t)slice * E;
  const int64_t oA = (int64_t)(Do + 1) * M * M, oZ = oA + (int64_t)M * Do;
  if (kind == 0) {
    product_tile(smem, Kg, ldk, Gp, dGp, gv, dst, rs, re, M, Do, P,
                 pl.tile, job, tid, nthreads);
  } else {
    const int mt = job % jobs.nmt, ct = job / jobs.nmt;
    if (kind == 1)
      colsum_tile<true>(smem, Gdp, P, Xs, Dx, Zs, dst + oZ, rs, re, M,
                        mt * 4 * pl.cg, ct * 4 * pl.zjg, pl.cg, pl.zjg, tid,
                        nthreads);
    else
      colsum_tile<false>(smem, Gp, P, gm, Do, nullptr, dst + oA, rs, re, M,
                         mt * 4 * pl.cg, ct * 4 * pl.ajg, pl.cg, pl.ajg,
                         tid, nthreads);
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

unsigned long long g_smem_set[5] = {0, 0, 0, 0, 0};

template <bool kSaved, bool kCluster>
cudaError_t rows_smem_ready() {
  return allow_smem(fused_conditional_bwd_rows_kernel<kSaved, kCluster>,
                    g_smem_set[2 * (int)kSaved + (int)kCluster]);
}

template <bool kSaved>
cudaError_t launch_rows(const float* Xs, const float* Zs, const float* LiT,
                        const float* alpha, const float* W,
                        const float* kvar, const float* gm, const float* gv,
                        const float* Kin, float* dX, float* Kp, float* Gp,
                        float* dGp, float* Gdp, int64_t B, int M, int Dx,
                        int Do, int dx_rows, int cs, cudaStream_t stream) {
  const int64_t blocks = (B + block_rows(M) - 1) / block_rows(M) * cs;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = rows_smem_floats(M, Do, cs > 1) * sizeof(float);
  if (cs == 1) {
    cudaError_t err = rows_smem_ready<kSaved, false>();
    if (err != cudaSuccess) return err;
    fused_conditional_bwd_rows_kernel<kSaved, false>
        <<<(unsigned)blocks, kThreads, smem, stream>>>(
            Xs, Zs, LiT, alpha, W, kvar, gm, gv, Kin, dX, Kp, Gp, dGp, Gdp,
            B, M, Dx, Do, dx_rows);
    return cudaGetLastError();
  }
  cudaError_t err = rows_smem_ready<kSaved, true>();
  if (err != cudaSuccess) return err;
  return gt::launch_clusters(fused_conditional_bwd_rows_kernel<kSaved, true>,
                             blocks, kThreads, cs, smem, stream, Xs, Zs, LiT,
                             alpha, W, kvar, gm, gv, Kin, dX, Kp, Gp, dGp,
                             Gdp, B, M, Dx, Do, dx_rows);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Pointers are device pointers
// to contiguous float32 tensors: the forward's inputs (kvar a 0-dim tensor
// on the device), the cotangents gm, gv (B, Do), Kin the saved (B, M) gram
// or null (then K is recomputed), dX (B, Dx), out the E = Do*M*M + M*M +
// M*Do + M*Dx floats of (dW, dLiT, dalpha, dZ), panels the (3 or, without
// Kin, 4) x B x P floats of the row panels (P = M rounded up to 4; 16-byte
// aligned), and part the nslices x E floats of slice partials (null when
// nslices == 1).  The reduction's plan (nslices slices of rows_per_slice
// rows; square output tiles of `tile` columns; column-sum tiles of 4 cg
// inducing points by 4 zjg or 4 ajg columns; dX tiles of 4 xrg rows by 4
// xjg columns, or xrg = 0 for dX in the row pass; `threads` a block and
// `smem_bytes` of shared memory, at least what the jobs need) and the row
// pass's (clusters of cs blocks, cs = 1 for none: any cs that plan_ok
// refuses, or whose row pass needs more shared memory than a block may
// use, is refused) come from conditional.py::backward_plan.  Launches the row pass,
// the reduction and (nslices > 1) the fixed-order sum on `stream`.  Returns
// a cudaError_t code (0 = launched).
extern "C" int fused_conditional_bwd(
    const float* Xs, const float* Zs, const float* LiT, const float* alpha,
    const float* W, const float* kvar, const float* gm, const float* gv,
    const float* Kin, float* dX, float* out, float* panels, float* part,
    int64_t B, int M, int Dx, int Do, int nslices, int64_t rows_per_slice,
    int tile, int threads, int cg, int zjg, int ajg, int xrg, int xjg,
    int smem_bytes, int cs, void* stream) {
  if (B <= 0 || M <= 0 || M > kMaxM || Dx <= 0 || Do <= 0 ||
      !plan_ok(M, Do, cs) ||
      rows_smem_floats(M, Do, cs > 1) * sizeof(float) > 232448 ||
      !aligned16(panels))
    return (int)cudaErrorInvalidValue;
  const ReducePlan pl{tile, cg, zjg, ajg, xrg, xjg};
  if (nslices < 1 || rows_per_slice < 1 ||
      (int64_t)nslices * rows_per_slice < B || (nslices > 1 && !part) ||
      tile % 8 || tile < 8 || tile > 128 || tile > round_up(M, 8) ||
      threads % 32 || threads > 256 || threads < (tile / 8) * (tile / 8) ||
      cg < 1 || zjg < 1 || ajg < 1 || cg * zjg > threads ||
      cg * ajg > threads || xrg < 0 || xjg < 0 ||
      (xrg > 0 && (xjg < 1 || xrg * xjg > threads)) ||
      (size_t)smem_bytes < reduce_smem_floats(pl) * sizeof(float) ||
      smem_bytes > 232448)
    return (int)cudaErrorInvalidValue;
  const ReduceJobs jobs(pl, B, M, Dx, Do, nslices);
  if (jobs.blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int P = 4 * col_groups(M);  // the panels' row stride
  const int64_t BP = B * P;
  float* Gp = panels;
  float* dGp = Gp + BP;
  float* Gdp = dGp + BP;
  float* Kp = Kin != nullptr ? nullptr : Gdp + BP;
  const int dx_rows = xrg == 0;
  cudaError_t err =
      Kin != nullptr
          ? launch_rows<true>(Xs, Zs, LiT, alpha, W, kvar, gm, gv, Kin, dX,
                              nullptr, Gp, dGp, Gdp, B, M, Dx, Do, dx_rows,
                              cs, s)
          : launch_rows<false>(Xs, Zs, LiT, alpha, W, kvar, gm, gv, nullptr,
                               dX, Kp, Gp, dGp, Gdp, B, M, Dx, Do, dx_rows,
                               cs, s);
  if (err != cudaSuccess) return (int)err;

  err = allow_smem(fused_conditional_bwd_reduce_kernel, g_smem_set[4]);
  if (err != cudaSuccess) return (int)err;
  const int64_t E = (int64_t)Do * M * M + (int64_t)M * M +
                    (int64_t)M * Do + (int64_t)M * Dx;
  fused_conditional_bwd_reduce_kernel<<<(unsigned)jobs.blocks, threads,
                                        smem_bytes, s>>>(
      Kin != nullptr ? Kin : Kp, Kin != nullptr ? M : P, Gp, dGp, Gdp, gm,
      gv, Xs, Zs, nslices > 1 ? part : out, dX, nslices > 1 ? E : 0, B, M,
      Dx, Do, nslices, rows_per_slice, pl);
  err = cudaGetLastError();
  if (err != cudaSuccess || nslices == 1) return (int)err;
  int64_t sblocks = (E + 255) / 256;
  if (sblocks > 4096) sblocks = 4096;
  sum_slices_kernel<<<(unsigned)sblocks, 256, 0, s>>>(part, out, E, nslices);
  return (int)cudaGetLastError();
}

template <bool kSaved, bool kCluster>
int rows_occupancy(size_t smem) {
  int n = 0;
  cudaError_t err = rows_smem_ready<kSaved, kCluster>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, fused_conditional_bwd_rows_kernel<kSaved, kCluster>, kThreads,
        smem);
  return err == cudaSuccess ? n : -1;
}

// Resident blocks an SM of the row pass (which 0, saved 1) at M and Do, in
// clusters (cs > 1) or not, or of the reduction (which 2) at `threads`
// threads and `smem_bytes` of shared memory a block; -1 on an error.
extern "C" int fused_conditional_bwd_occupancy(int which, int M, int Do,
                                               int threads, int smem_bytes,
                                               int cs) {
  if (M <= 0 || M > kMaxM || Do <= 0 || which < 0 || which > 2) return -1;
  if (which == 2) {
    int n = 0;
    cudaError_t err =
        allow_smem(fused_conditional_bwd_reduce_kernel, g_smem_set[4]);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, fused_conditional_bwd_reduce_kernel, threads, smem_bytes);
    return err == cudaSuccess ? n : -1;
  }
  const size_t smem = rows_smem_floats(M, Do, cs > 1) * sizeof(float);
  if (which == 1)
    return cs > 1 ? rows_occupancy<true, true>(smem)
                  : rows_occupancy<true, false>(smem);
  return cs > 1 ? rows_occupancy<false, true>(smem)
                : rows_occupancy<false, false>(smem);
}
