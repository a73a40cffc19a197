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
// What bounds it on an H100: operations.  Per row about 2 M Dx (gram) +
// 2 M^2 (staging) + 2 M Do (mean) + Do (2 M^2 + 2 M) (variance) flops
// against Dx floats read and 2 Do written; at M = 100, Do = 8 ~180 kflop
// per 72 bytes.  Nearly all of it is two GEMM-shaped products: (B x M)
// (M x M) for G and (B x M)(M x Do M) for the variance, whose epilogue
// takes each row's dot with G, so T = G W_d never leaves the registers.
//
// Design.  A block owns TB rows (40 at M = 100), each thread a 4 x 4 register
// tile of the (TB x M) products (fused_conditional.cuh).  K is built in shared
// memory by the gram stage (gram_tiles: the same tiles, Xs and Zs staged in
// 16-wide chunks of Dx through a ring laid over the product ring's space, so
// shared memory does not grow at M = 100), then LiT, W_0, ..., W_{Do-1}
// stream through a 4-stage cp.async ring of 16-row k-slices (zero past M) as
// one continuous stream, so the copies of the next matrix overlap the
// products of this one and every operand is read once a block.  G replaces K
// in shared memory and is the A operand of every W_d product.  Each thread
// folds its tile of T into per-row partials, which meet in shared memory and
// are added in column order, so the result is deterministic.  The mean is G .
// alpha as four interleaved FFMA chains a thread and output (one chain of M
// terms was 2x further from float64 than the plain version at M = 37).  The
// products are fp32 FFMA chains in k order, a fresh chain each 16-row k-slice
// added to the running sum (ffma_slice_blocked): the 3xTF32 tensor-core
// designs (kept below as fused_conditional_fwd_3xtf32 for the precision
// comparison that chip_smoke.py prints) were up to 4x further from float64
// than the plain float32 version on the H100, past the contract's 2x (PERF.md
// §6); plain TF32 is never used (the JAX kernel pins HIGHEST precision).  The
// squared distance is the direct sum of squared differences.  Ragged edges: M
// is padded with zeros in shared memory only; rows past B are zeros and not
// stored.  The saved gram is the value staged in shared memory, so the
// save-gram variant's mean and var equal the plain variant's bit for bit.
//
// At small B (kCluster) a cluster of cs blocks shares a row block: block q
// builds the gram and G at its column groups (the gram's tiles then R x 4,
// R = gram_tile_rows, so that its few columns still spread over the
// threads), stores them into every block of the cluster, and streams only
// W_q, W_{q+cs}, ... to form those var_d and mean_d.  At B = 1000, M = 100
// and Do = 30 that is 25 x 8 blocks where one block a row block left 107 of
// 132 SMs idle and streamed Do + 1 matrices one after another.

#include "fused_conditional.cuh"

namespace {

using namespace fc;

// A (P x TB), then the product ring and the variance partials, over which
// the gram stage's ring lies (whichever is larger)
__host__ __device__ inline size_t smem_floats(int M) {
  const int TB = block_rows(M), CG = col_groups(M);
  const size_t products = (size_t)kStages * kKS * 4 * CG + (size_t)2 * TB * CG;
  const size_t gram = (size_t)gram_stage_floats(TB, M);
  return (size_t)k_rows(M) * TB + (products > gram ? products : gram);
}

// Two blocks an SM: 127 registers, no spill.  At three (80 registers, 12
// bytes spilled) it ran 4-12% slower at B = 1000 and 10,000, the training
// shapes, and 3-11% faster at B = 100,000 (tools/gram_stage_variants.py,
// PERF.md §6).
template <bool kSaveGram, bool kCluster>
__global__ void __launch_bounds__(kThreads, 2)
fused_conditional_fwd_kernel(const float* __restrict__ Xs,
                             const float* __restrict__ Zs,
                             const float* __restrict__ LiT,
                             const float* __restrict__ alpha,
                             const float* __restrict__ W,
                             const float* __restrict__ kvar_p,
                             const float* __restrict__ kdiag_p,
                             float* __restrict__ mean,
                             float* __restrict__ var,
                             float* __restrict__ Kout,
                             int64_t B, int M, int Dx, int Do) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int CG = col_groups(M), RG = row_groups(M), TB = 4 * RG;
  const int P4 = 4 * CG, P = k_rows(M), SF = kKS * P4;
  float* A = smem;                              // P x TB: K, then G
  float* ring = A + (size_t)P * TB;             // kStages x kKS x P4
  float* vpart = ring + (size_t)kStages * SF;   // [2][TB][CG]
  const int tid = threadIdx.x;
  const Split sp = split_of<kCluster>(CG);
  const int64_t row0 = (int64_t)(blockIdx.x / sp.cs) * TB;
  // this block's d: q, q + cs, ...: its W_d, alpha, var and mean columns
  // from W_q, alpha[:, q], var[:, q], mean[:, q] with a step of cs (read
  // again at each use)
  const int nd = (Do - sp.q + sp.cs - 1) / sp.cs;
  const int nks = P / kKS, total = (nd + 1) * nks;
  const float kvar = *kvar_p, kdiag = *kdiag_p;
  const SliceLoader loader(P4, (M & 3) == 0, tid, kThreads);
  W += (size_t)sp.q * M * M;
  alpha += sp.q;
  var += sp.q;
  mean += sp.q;
  auto step = [&]() { return kCluster ? cluster_blocks() : 1; };

  auto issue = [&](int s) {
    const int mat = s / nks, ks = s - mat * nks;
    const float* Bm =
        mat == 0 ? LiT : W + (size_t)(step() * (mat - 1)) * M * M;
    loader.copy(ring + (size_t)(s % kStages) * SF, P4, Bm, M, ks * kKS, M,
                M);
  };
  // the gram (and the saved gram), staged through the ring's space; then
  // the ring's first slices
  if constexpr (kCluster) cluster_sync();  // every block of it has started
  gram_stage<kCluster>(sp.cs, Xs, Zs, kvar, A, ring, TB, P, row0, B, M, Dx,
                       kSaveGram ? Kout : nullptr, M, M, sp.g0, sp.g1, tid,
                       kThreads);
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) issue(s);
    cp_async_commit();
  }
  if constexpr (kCluster) cluster_sync();  // K whole in every block

  // var_d = max(kdiag + the sum of row i's CG partials, 0): four
  // interleaved chains added pairwise, in column order (d: the block's
  // dl-th, counted from q)
  auto finish_var = [&](int dl) {
    const float* vp = vpart + (size_t)(dl & 1) * TB * CG;
    const int d = step() * dl;
    for (int i = tid; i < TB; i += kThreads) {
      const int64_t r = row0 + i;
      float q[4] = {0.f, 0.f, 0.f, 0.f};
      int c = 0;
      for (; c + 4 <= CG; c += 4)
#pragma unroll
        for (int u = 0; u < 4; ++u) q[u] += vp[i * CG + c + u];
#pragma unroll
      for (int u = 0; u < 3; ++u)
        if (c + u < CG) q[u] += vp[i * CG + c + u];
      if (r < B)
        var[r * Do + d] = fmaxf(kdiag + ((q[0] + q[1]) + (q[2] + q[3])), 0.f);
    }
  };

  float acc[4][4];
  zero(acc);
  if constexpr (kCluster) {
    // G = K LiT at the block's column groups, their tiles packed into the
    // first threads (a loop of its own, so that the W_d products below
    // keep the registers they have outside a cluster), then into every
    // block of the cluster
    const int ng = sp.g1 - sp.g0;
    const bool gactive = tid < RG * ng;
    const int glr = (tid / ng) * 4, glc = (sp.g0 + tid % ng) * 4;
    for (int s = 0; s < nks; ++s) {
      cp_async_wait_ring();
      __syncthreads();  // slice s is in; slice s - 1's buffer is free
      if (s + kStages - 1 < total) issue(s + kStages - 1);
      cp_async_commit();
      if (gactive)
        ffma_slice_blocked(acc, A + (size_t)s * kKS * TB + glr, TB,
                           ring + (size_t)(s % kStages) * SF + glc, P4,
                           min(kKS, M - s * kKS));
    }
    cluster_sync();  // every thread of every block is done reading K
    if (gactive)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        put<true>(reinterpret_cast<float4*>(A + (size_t)(glc + j) * TB + glr),
                  make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]));
    cluster_sync();  // G whole in every block
    zero(acc);
  }
  // the thread's tile of the W_d products (and outside a cluster of G)
  const bool active = tid < RG * CG;
  const int lr = (tid / CG) * 4, lc = (tid % CG) * 4;
  for (int s = kCluster ? nks : 0; s < total; ++s) {
    cp_async_wait_ring();
    __syncthreads();  // slice s is in; slice s - 1's buffer is free
    if (s + kStages - 1 < total) issue(s + kStages - 1);
    cp_async_commit();
    const int mat = s / nks, ks = s - mat * nks;
    if (ks == 0 && mat >= 2) finish_var(mat - 2);
    if (active)
      ffma_slice_blocked(acc, A + (size_t)ks * kKS * TB + lr, TB,
                         ring + (size_t)(s % kStages) * SF + lc, P4,
                         min(kKS, M - ks * kKS));
    if (ks != nks - 1) continue;
    if (mat == 0) {
      // G = K LiT replaces K (every thread is done reading K)
      __syncthreads();
      if (active)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(A + (size_t)(lc + j) * TB + lr) =
              make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    } else if (active) {
      // var_d's partials: each row's dot of its T_d columns with G
      float pr[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 g =
            *reinterpret_cast<const float4*>(A + (size_t)(lc + j) * TB + lr);
        pr[0] = fmaf(acc[0][j], g.x, pr[0]);
        pr[1] = fmaf(acc[1][j], g.y, pr[1]);
        pr[2] = fmaf(acc[2][j], g.z, pr[2]);
        pr[3] = fmaf(acc[3][j], g.w, pr[3]);
      }
      float* vp = vpart + (size_t)((mat - 1) & 1) * TB * CG;
#pragma unroll
      for (int i = 0; i < 4; ++i) vp[(lr + i) * CG + lc / 4] = pr[i];
    }
    zero(acc);
  }
  cp_async_wait_all();
  __syncthreads();
  finish_var(nd - 1);

  // mean_d = G . alpha[:, d], one thread an output
  for (int e = tid; e < TB * nd; e += kThreads) {
    const int i = e / nd, d = step() * (e - i * nd);
    const int64_t r = row0 + i;
    if (r < B) mean[r * Do + d] = dot4(A + i, TB, alpha + d, Do, M);
  }
}

// ----------------------------------------------------------------------------
// The 3xTF32 tensor-core designs, for the precision comparison only.
//
// mma.sync.m16n8k8 in TF32 keeps 10 mantissa bits, so each operand x is
// split as hi = tf32(x), lo = tf32(x - hi) and a product taken as lo_a
// hi_b + hi_a lo_b + hi_a hi_b (lo_a lo_b dropped).  kChain chains every
// k-step's three products in the tensor core's accumulator; kPromote
// starts each k-step's from zero and adds it to an fp32 register sum.  A
// block of 8 warps owns 32 rows, two m16 tiles, each over 4 warps that
// split its columns.  Fragments (PTX ISA, m16n8k8 .tf32), g = lane / 4,
// t = lane % 4: a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 =
// A[g+8][t+4]; b0 = B[t][g], b1 = B[t+4][g]; c0 = C[g][2t], c1 =
// C[g][2t+1], c2 = C[g+8][2t], c3 = C[g+8][2t+1].  The mean is the FFMA
// dot of the kernel above, so the comparison isolates the products.
// ----------------------------------------------------------------------------

constexpr int kChain = 0, kPromote = 1;
constexpr int kCmpThreads = 256, kCmpNT = 16;
constexpr int kRows = 32;  // rows a block

// columns (and k rows) of the tiles: M rounded up to 16
__host__ __device__ inline int p16(int M) { return round_up(M, 16); }

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int kPrec>
__device__ __forceinline__ void mma3(float (&acc)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh[2], bl[2];
  split(b0, bh[0], bl[0]);
  split(b1, bh[1], bl[1]);
  if (kPrec == kChain) {
    mma_tf32(acc, al, bh);
    mma_tf32(acc, ah, bl);
    mma_tf32(acc, ah, bh);
  } else {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(d, al, bh);
    mma_tf32(d, ah, bl);
    mma_tf32(d, ah, bh);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += d[i];
  }
}

__host__ __device__ inline size_t cmp_smem_floats(int M) {
  const size_t products = (size_t)kStages * kKS * p16(M) + 2 * 8 * kRows;
  const size_t gram = (size_t)gram_stage_floats(kRows, M);
  return (size_t)p16(M) * kRows + (products > gram ? products : gram);
}

template <int kPrec>
__global__ void __launch_bounds__(kCmpThreads)
fused_conditional_fwd_3xtf32(const float* __restrict__ Xs,
                             const float* __restrict__ Zs,
                             const float* __restrict__ LiT,
                             const float* __restrict__ alpha,
                             const float* __restrict__ W,
                             const float* __restrict__ kvar_p,
                             const float* __restrict__ kdiag_p,
                             float* __restrict__ mean,
                             float* __restrict__ var, int64_t B, int M,
                             int Dx, int Do) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int P = p16(M), stages = kStages, SF = kKS * P;
  float* Gs = smem;                             // P x 32, k-major: K, G
  float* ring = Gs + (size_t)P * kRows;
  float* vpart = ring + (size_t)stages * SF;    // [2][8][32]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mr = (warp >> 2) * 16, nq = warp & 3;  // m16 tile, column part
  const int ntiles = P / 8, ntw = (ntiles + 3) / 4, nt0 = nq * ntw;
  const int nt_end = min(ntiles, nt0 + ntw);
  const int64_t row0 = (int64_t)blockIdx.x * kRows;
  const int nks = P / kKS, total = (Do + 1) * nks;
  const float kvar = *kvar_p, kdiag = *kdiag_p;
  const SliceLoader loader(P, (M & 3) == 0, tid, kCmpThreads);

  auto issue = [&](int s) {
    const int mat = s / nks, ks = s - mat * nks;
    const float* Bm = mat == 0 ? LiT : W + (size_t)(mat - 1) * M * M;
    loader.copy(ring + (size_t)(s % stages) * SF, P, Bm, M, ks * kKS, M, M);
  };
  gram_tiles<4, false>(Xs, Zs, kvar, Gs, ring, kRows, P, row0, B, M, Dx,
                       nullptr, 0, 0, 0, col_groups(M), tid, kCmpThreads);
  for (int s = 0; s < stages - 1; ++s) {
    if (s < total) issue(s);
    cp_async_commit();
  }

  auto finish_var = [&](int d) {
    for (int i = tid; i < kRows; i += kCmpThreads) {
      const int64_t r = row0 + i;
      const int h0 = (i / 16) * 4;  // the four warps of row i's m16 tile
      float s = 0.f;
      for (int h = 0; h < 4; ++h)
        s += vpart[((d & 1) * 8 + h0 + h) * kRows + i];
      if (r < B) var[r * Do + d] = fmaxf(kdiag + s, 0.f);
    }
  };

  float acc[kCmpNT][4];
#pragma unroll
  for (int j = 0; j < kCmpNT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  for (int s = 0; s < total; ++s) {
    cp_async_wait_ring();
    __syncthreads();
    if (s + stages - 1 < total) issue(s + stages - 1);
    cp_async_commit();
    const int mat = s / nks, ks = s - mat * nks;
    if (ks == 0 && mat >= 2) finish_var(mat - 2);
    const float* As = Gs + (size_t)ks * kKS * kRows + mr;
    const float* Bs = ring + (size_t)(s % stages) * SF;
#pragma unroll
    for (int k0 = 0; k0 < kKS; k0 += 8) {
      uint32_t ah[4], al[4];
      split(As[(k0 + t) * kRows + g], ah[0], al[0]);
      split(As[(k0 + t) * kRows + g + 8], ah[1], al[1]);
      split(As[(k0 + t + 4) * kRows + g], ah[2], al[2]);
      split(As[(k0 + t + 4) * kRows + g + 8], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < kCmpNT; ++j) {
        if (nt0 + j >= nt_end) break;
        const int n = (nt0 + j) * 8 + g;
        mma3<kPrec>(acc[j], ah, al, Bs[(k0 + t) * P + n],
                    Bs[(k0 + t + 4) * P + n]);
      }
    }
    if (ks != nks - 1) continue;
    if (mat == 0) __syncthreads();  // G replaces K: every warp is done
    float p0 = 0.f, p8 = 0.f;
#pragma unroll
    for (int j = 0; j < kCmpNT; ++j) {
      if (nt0 + j < nt_end) {
        const int c = (nt0 + j) * 8 + 2 * t;
        float* g0 = Gs + mr + g;
        if (mat == 0) {
          g0[c * kRows] = acc[j][0];
          g0[(c + 1) * kRows] = acc[j][1];
          g0[c * kRows + 8] = acc[j][2];
          g0[(c + 1) * kRows + 8] = acc[j][3];
        } else {
          p0 = fmaf(acc[j][0], g0[c * kRows], p0);
          p0 = fmaf(acc[j][1], g0[(c + 1) * kRows], p0);
          p8 = fmaf(acc[j][2], g0[c * kRows + 8], p8);
          p8 = fmaf(acc[j][3], g0[(c + 1) * kRows + 8], p8);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
    }
    if (mat > 0) {
      p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
      p8 += __shfl_xor_sync(0xffffffffu, p8, 1);
      p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
      p8 += __shfl_xor_sync(0xffffffffu, p8, 2);
      if (t == 0) {
        float* vp = vpart + (((mat - 1) & 1) * 8 + warp) * kRows + mr + g;
        vp[0] = p0;
        vp[8] = p8;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  finish_var(Do - 1);
  for (int e = tid; e < kRows * Do; e += kCmpThreads) {
    const int i = e / Do, d = e - i * Do;
    const int64_t r = row0 + i;
    if (r < B) mean[r * Do + d] = dot4(Gs + i, kRows, alpha + d, Do, M);
  }
}

unsigned long long g_smem_set[6] = {0, 0, 0, 0, 0, 0};

template <bool kSaveGram, bool kCluster>
cudaError_t smem_ready() {
  return allow_smem(fused_conditional_fwd_kernel<kSaveGram, kCluster>,
                    g_smem_set[2 * (int)kSaveGram + (int)kCluster]);
}

template <bool kSaveGram>
cudaError_t launch_fwd(const float* Xs, const float* Zs, const float* LiT,
                       const float* alpha, const float* W, const float* kvar,
                       const float* kdiag, float* mean, float* var,
                       float* Kout, int64_t B, int M, int Dx, int Do, int cs,
                       cudaStream_t stream) {
  const int64_t blocks = (B + block_rows(M) - 1) / block_rows(M) * cs;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = smem_floats(M) * sizeof(float);
  if (cs == 1) {
    cudaError_t err = smem_ready<kSaveGram, false>();
    if (err != cudaSuccess) return err;
    fused_conditional_fwd_kernel<kSaveGram, false>
        <<<(unsigned)blocks, kThreads, smem, stream>>>(
            Xs, Zs, LiT, alpha, W, kvar, kdiag, mean, var, Kout, B, M, Dx,
            Do);
    return cudaGetLastError();
  }
  cudaError_t err = smem_ready<kSaveGram, true>();
  if (err != cudaSuccess) return err;
  return gt::launch_clusters(fused_conditional_fwd_kernel<kSaveGram, true>,
                             blocks, kThreads, cs, smem, stream, Xs, Zs, LiT,
                             alpha, W, kvar, kdiag, mean, var, Kout, B, M, Dx,
                             Do);
}

template <int kPrec>
cudaError_t launch_cmp(const float* Xs, const float* Zs, const float* LiT,
                       const float* alpha, const float* W, const float* kvar,
                       const float* kdiag, float* mean, float* var, int64_t B,
                       int M, int Dx, int Do, cudaStream_t stream) {
  auto* kernel = fused_conditional_fwd_3xtf32<kPrec>;
  cudaError_t err = allow_smem(kernel, g_smem_set[4 + kPrec]);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (B + kRows - 1) / kRows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kCmpThreads, cmp_smem_floats(M) * sizeof(float),
           stream>>>(Xs, Zs, LiT, alpha, W, kvar, kdiag, mean, var, B, M, Dx,
                     Do);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Pointers are device pointers
// to contiguous float32 tensors; kvar and kdiag are 0-dim tensors on the
// device.  Kout is null, or the (B, M) gram to write (the save-gram
// variant).  design 0 is the kernel (fp32 FFMA), launched with the plan of
// ops/cuda/conditional.py::forward_plan: clusters of cs blocks (cs = 1:
// none; any cs that plan_ok refuses is refused before any launch); 1 and 2 are the 3xTF32
// comparison designs (per-k-step fp32 sums, chained sums; no saved gram,
// their own geometry).  Returns a cudaError_t code (0 = launched).
extern "C" int fused_conditional_fwd(const float* Xs, const float* Zs,
                                     const float* LiT, const float* alpha,
                                     const float* W, const float* kvar,
                                     const float* kdiag, float* mean,
                                     float* var, float* Kout, int64_t B,
                                     int M, int Dx, int Do, int design,
                                     int cs, void* stream) {
  if (B <= 0 || M <= 0 || M > kMaxM || Dx <= 0 || Do <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 0) {
    if (!plan_ok(M, Do, cs)) return (int)cudaErrorInvalidValue;
    return Kout != nullptr
               ? (int)launch_fwd<true>(Xs, Zs, LiT, alpha, W, kvar, kdiag,
                                       mean, var, Kout, B, M, Dx, Do, cs, s)
               : (int)launch_fwd<false>(Xs, Zs, LiT, alpha, W, kvar, kdiag,
                                        mean, var, nullptr, B, M, Dx, Do, cs,
                                        s);
  }
  if (Kout != nullptr || cmp_smem_floats(M) * sizeof(float) > 232448)
    return (int)cudaErrorInvalidValue;
  if (design == 1)
    return (int)launch_cmp<kPromote>(Xs, Zs, LiT, alpha, W, kvar, kdiag,
                                     mean, var, B, M, Dx, Do, s);
  if (design == 2)
    return (int)launch_cmp<kChain>(Xs, Zs, LiT, alpha, W, kvar, kdiag, mean,
                                   var, B, M, Dx, Do, s);
  return (int)cudaErrorInvalidValue;
}

template <bool kSaveGram, bool kCluster>
int occupancy(size_t smem) {
  int n = 0;
  cudaError_t err = smem_ready<kSaveGram, kCluster>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, fused_conditional_fwd_kernel<kSaveGram, kCluster>, kThreads,
        smem);
  return err == cudaSuccess ? n : -1;
}

// Resident blocks an SM of the forward kernel at M, in clusters (cs > 1) or
// not (the occupancy its launches get), or -1 on an error.
extern "C" int fused_conditional_fwd_occupancy(int M, int save_gram, int cs) {
  if (M <= 0 || M > kMaxM) return -1;
  const size_t smem = smem_floats(M) * sizeof(float);
  if (save_gram)
    return cs > 1 ? occupancy<true, true>(smem) : occupancy<true, false>(smem);
  return cs > 1 ? occupancy<false, true>(smem) : occupancy<false, false>(smem);
}
