// Device helpers shared by the fused conditional's forward
// (fused_conditional.cu) and backward (fused_conditional_bwd.cu) kernels:
// the block geometry, the cp.async ring that streams the M x M operands
// through shared memory in k-slices, the gram stage (a tiled
// direct-difference product), the register-tiled fp32 FFMA step, and the
// thread-block cluster that shares a row block at small batches.
//
// Geometry of the row kernels.  A (rows x M) by (M x M) product is cut
// into 4 x 4 register tiles: CG = ceil(M / 4) column groups and RG row
// groups, one tile a thread (thread t: row group t / CG, column group
// t % CG), so a block of kThreads threads owns TB = 4 RG rows with RG =
// kThreads / CG (at most 32): 40 rows at M = 100 (250 of 256 threads
// busy), 8 at M = 512.  Many small tiles keep many warps on every SM at
// the training shape (B = 10,000: 250 blocks of 8 warps), which hides the
// latency of the loads and barriers; 8 x 8 tiles halve the shared-memory
// reads per FFMA but leave a third as many warps, and measured slower
// (PERF.md §6).  The A operand (K, G or dG rows) lives in shared
// memory k-major, A[k][row] (row stride TB), so a thread reads its 4 rows
// at one k as one float4; the B slices are row-major, B[k][n] (row stride
// P4 = 4 CG), one float4 per thread and k.  k rows are padded to whole
// 16-row slices, columns to P4, with zeros.
//
// At small batches (the MNIST minibatch, B = 1000: 25 row blocks on 132
// SMs) a thread-block cluster of cs blocks shares each row block
// (ops/cuda/conditional.py's plans choose cs, which the C entry points
// check).  Block q of a cluster builds K, G (and in the backward dG's
// running sum and dK) at its run of whole column groups g0 .. g1 - 1 and
// stores them into every block of the cluster through distributed shared
// memory, so that each block holds them whole; the Do products, independent
// of each other given G, are split over the blocks by d (block q takes d =
// q, q + cs, ...).  Every output is still one thread's sum in the order it
// had in one block, so the bits do not depend on the plan.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gram_tile.cuh"

namespace fc {

namespace cg = cooperative_groups;

constexpr int kMaxM = 512;
constexpr int kThreads = 256;   // threads of a row-kernel block
constexpr int kKS = 16;         // k rows of a streamed slice
constexpr int kStages = 4;      // slices in flight in the ring
constexpr int kMaxRG = 32;      // row groups a block at most
constexpr int kMaxCluster = 8;  // blocks of a cluster at most (portable)

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
__host__ __device__ __forceinline__ int col_groups(int M) {
  return (M + 3) / 4;
}
__host__ __device__ __forceinline__ int row_groups(int M) {
  const int rg = kThreads / col_groups(M);
  return rg < kMaxRG ? rg : kMaxRG;
}
// rows a row-kernel block
__host__ __device__ __forceinline__ int block_rows(int M) {
  return 4 * row_groups(M);
}
// k rows of the A tiles: M rounded up to whole slices
__host__ __device__ __forceinline__ int k_rows(int M) {
  return round_up(M, kKS);
}
// rows of a cluster's gram-stage tiles: the fewest (1, 2 or 4) at which
// the TB rows by ncg column groups of a block's gram take one pass of its
// threads, so that a block's few columns still spread over them
__host__ __device__ __forceinline__ int gram_tile_rows(int TB, int ncg) {
  for (int r = 1; r < 4; r *= 2)
    if ((TB / r) * ncg <= kThreads) return r;
  return 4;
}
// Whether the C entry points take a plan of clusters of cs blocks
// (ops/cuda/conditional.py's plans): cs <= 8, at most one block a d and a
// column group
__host__ __forceinline__ bool plan_ok(int M, int Do, int cs) {
  return cs >= 1 && cs <= kMaxCluster && cs <= Do && cs <= col_groups(M);
}

// ----------------------------------------------------------------------------
// the cluster a row block's blocks form (one block, outside a cluster)
// ----------------------------------------------------------------------------

// cs blocks; this one is q and owns the column groups g0 .. g1 - 1
struct Split {
  int cs, q, g0, g1;
};

template <bool kCluster>
__device__ __forceinline__ Split split_of(int CG) {
  if constexpr (kCluster) {
    cg::cluster_group cl = cg::this_cluster();
    const int cs = (int)cl.num_blocks(), q = (int)cl.block_rank();
    return {cs, q, q * CG / cs, (q + 1) * CG / cs};
  } else {
    return {1, 0, 0, CG};
  }
}

// blocks of this cluster, read from the special register at each use (so
// that a loop does not hold it in a register of its own)
__device__ __forceinline__ int cluster_blocks() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return (int)n;
}

// barrier of every thread of the cluster; it orders their shared-memory
// writes (distributed ones too) before the reads after it
__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }

// v to *p in this block, or (kCluster) to the same address in every block of
// the cluster
template <bool kCluster, typename V>
__device__ __forceinline__ void put(V* p, V v) {
  if constexpr (kCluster) {
    cg::cluster_group cl = cg::this_cluster();
    const unsigned n = cl.num_blocks();
    for (unsigned r = 0; r < n; ++r) *cl.map_shared_rank(p, r) = v;
  } else {
    *p = v;
  }
}

// R (1, 2 or 4) consecutive floats at p (aligned to R floats), by put
template <int R, bool kCluster>
__device__ __forceinline__ void put_rows(float* p, const float (&k)[R]) {
  if constexpr (R == 4)
    put<kCluster>(reinterpret_cast<float4*>(p),
                  make_float4(k[0], k[1], k[2], k[3]));
  else if constexpr (R == 2)
    put<kCluster>(reinterpret_cast<float2*>(p), make_float2(k[0], k[1]));
  else
    put<kCluster>(p, k[0]);
}

// ----------------------------------------------------------------------------
// cp.async with zero fill (src_bytes = 0 writes zeros and reads nothing;
// the caller then passes a valid address all the same)
// ----------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until slice s of the ring is in (at most kStages - 2 newer groups
// pending)
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A thread's share of copying kKS-row slices of a row-major matrix into
// shared memory: the chunks e = tid, tid + nthreads, ... of the slice's
// kKS x (width / q) chunks of q floats (q = 4 with 16-byte copies, else
// 1), walked without a division per chunk.  copy() fills dst[kk][n] (row
// stride width) from rows k0 + kk of src (row stride ld), zero where the
// row is not below rows_valid or the column not below cols_valid.
struct SliceLoader {
  int q, per_row, kk0, c0, dkk, dc, nchunks, tid, nthreads;

  __device__ __forceinline__ SliceLoader(int width, bool vec, int tid_,
                                         int nthreads_)
      : tid(tid_), nthreads(nthreads_) {
    q = vec ? 4 : 1;
    per_row = width / q;
    nchunks = kKS * per_row;
    kk0 = tid / per_row;
    c0 = (tid - kk0 * per_row) * q;
    dkk = nthreads / per_row;
    dc = (nthreads - dkk * per_row) * q;
  }

  __device__ __forceinline__ void copy(float* dst, int width,
                                       const float* src, int64_t ld,
                                       int64_t k0, int64_t rows_valid,
                                       int cols_valid) const {
    int kk = kk0, c = c0;
    for (int e = tid; e < nchunks; e += nthreads) {
      const int64_t k = k0 + kk;
      const bool ok = k < rows_valid && c < cols_valid;
      const float* s = ok ? src + k * ld + c : src;
      if (q == 4)
        cp_async16(dst + kk * width + c, s, ok);
      else
        cp_async4(dst + kk * width + c, s, ok);
      kk += dkk;
      c += dc;
      if (c >= per_row * q) {
        c -= per_row * q;
        ++kk;
      }
    }
  }
};

// Columns k0 .. k0+kKS-1 of the M x M row-major matrix Bm, transposed on
// the way: dst[kk][n] = Bm[n][k0 + kk] (row stride width), zero past M.  A
// slice of Bm^T read in place (no transposed copy of Bm); the global reads
// are 64-byte runs of one row, the shared writes strided.
__device__ __forceinline__ void load_slice_t(float* dst, const float* Bm,
                                             int M, int k0, int width,
                                             int tid, int nthreads) {
  for (int e = tid; e < kKS * width; e += nthreads) {
    const int n = e / kKS, kk = e - n * kKS, k = k0 + kk;
    const bool ok = n < M && k < M;
    cp_async4(dst + kk * width + n, ok ? Bm + (size_t)n * M + k : Bm, ok);
  }
}

// ----------------------------------------------------------------------------
// the register-tiled FFMA step
// ----------------------------------------------------------------------------

template <int R, int C>
__device__ __forceinline__ void zero(float (&acc)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum over the slice's nk (<= kKS) k of A[k][i] B[k][j],
// i < R, j < C (R, C = 4 or 8): a k-major strip of A at a (row stride sa)
// and a row-major strip of B at b (row stride sb), 16-byte aligned; FFMA
// chains in k order.  A whole slice is unrolled with the next k's
// operands loaded before this k's FFMAs, so their shared-memory latency
// hides behind the FFMAs; a partial last slice (the rows past M) takes a
// plain loop.
template <int R, int C>
__device__ __forceinline__ void ffma_k(float (&acc)[R][C], const float* a,
                                       const float* b) {
  float ar[R], br[C];
#pragma unroll
  for (int i = 0; i < R; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(a + i);
    ar[i] = v.x; ar[i + 1] = v.y; ar[i + 2] = v.z; ar[i + 3] = v.w;
  }
#pragma unroll
  for (int j = 0; j < C; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(b + j);
    br[j] = v.x; br[j + 1] = v.y; br[j + 2] = v.z; br[j + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
}

template <int R, int C>
__device__ __forceinline__ void ffma_slice(float (&acc)[R][C], const float* a,
                                           int sa, const float* b, int sb,
                                           int nk) {
  if (nk < kKS) {
    for (int k = 0; k < nk; ++k) ffma_k(acc, a + k * sa, b + k * sb);
    return;
  }
  float4 av[R / 4], bv[C / 4];
#pragma unroll
  for (int i = 0; i < R / 4; ++i)
    av[i] = *reinterpret_cast<const float4*>(a + 4 * i);
#pragma unroll
  for (int j = 0; j < C / 4; ++j)
    bv[j] = *reinterpret_cast<const float4*>(b + 4 * j);
#pragma unroll
  for (int k = 0; k < kKS; ++k) {
    float ar[R], br[C];
#pragma unroll
    for (int i = 0; i < R / 4; ++i) {
      ar[4 * i] = av[i].x; ar[4 * i + 1] = av[i].y;
      ar[4 * i + 2] = av[i].z; ar[4 * i + 3] = av[i].w;
    }
#pragma unroll
    for (int j = 0; j < C / 4; ++j) {
      br[4 * j] = bv[j].x; br[4 * j + 1] = bv[j].y;
      br[4 * j + 2] = bv[j].z; br[4 * j + 3] = bv[j].w;
    }
    if (k + 1 < kKS) {
#pragma unroll
      for (int i = 0; i < R / 4; ++i)
        av[i] = *reinterpret_cast<const float4*>(a + (k + 1) * sa + 4 * i);
#pragma unroll
      for (int j = 0; j < C / 4; ++j)
        bv[j] = *reinterpret_cast<const float4*>(b + (k + 1) * sb + 4 * j);
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// acc += the slice's products as a fresh FFMA chain: ffma_slice into a
// zeroed partial, then one add an entry.  The row kernels' k sums run in
// blocks of kKS, so an output's longest chain is kKS terms and
// ceil(M / kKS) adds.  Where a wide input makes the gram O(1), one chain
// over all M terms was up to 3.5x (forward) and 2.0x (backward) further
// from float64 than the plain version at one row (cuBLAS sums a one-row
// product as a tree), against 1.9x and 1.2x blocked, under phase 1's 2x
// (tools/gram_stage_variants.py, PERF.md §6).
template <int R, int C>
__device__ __forceinline__ void ffma_slice_blocked(float (&acc)[R][C],
                                                   const float* a, int sa,
                                                   const float* b, int sb,
                                                   int nk) {
  float part[R][C];
  zero(part);
  ffma_slice(part, a, sa, b, sb, nk);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] += part[i][j];
}

// sum_{n < len} x[n * sx] y[n * sy] as four interleaved FFMA chains added
// pairwise (shorter chains: less rounding and less latency)
__device__ __forceinline__ float dot4(const float* x, int sx, const float* y,
                                      int sy, int len) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  int n = 0;
  for (; n + 4 <= len; n += 4)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      s[u] = fmaf(x[(n + u) * sx], __ldg(y + (size_t)(n + u) * sy), s[u]);
#pragma unroll
  for (int u = 0; u < 3; ++u)
    if (n + u < len)
      s[u] = fmaf(x[(n + u) * sx], __ldg(y + (size_t)(n + u) * sy), s[u]);
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// ----------------------------------------------------------------------------
// the gram stage
// ----------------------------------------------------------------------------

// floats of the gram stage's two ring stages for TB rows and M columns
__host__ __device__ __forceinline__ int gram_stage_floats(int TB, int M) {
  return 2 * (TB + 4 * col_groups(M)) * gt::kRow<float>;
}

// The block's TB gram rows at the columns of its column groups g0 .. g1 - 1
// (m = 4 g0 .. 4 g1 - 1; all of them, g0 = 0 and g1 = CG, outside a
// cluster) into Ks, k-major: Ks[m * TB + i] = kvar exp(-0.5 ||x_{row0+i} -
// z_m||^2), zero for m >= M and for rows past B, and zero for the k rows
// P4 <= m < P; with kCluster each entry also goes to the same place in every
// block of the cluster.  With Kout (row stride ldk), each entry is also
// stored to global memory for m < ncols_out (zeros past M): exactly the
// value staged.
//
// A tiled direct-difference product (gram_tile.cuh, the wide rbf_gram's
// order too).  With n = g1 - g0 column groups, thread t owns the R x 4
// register tile (R: gram_tile_rows) of rows R (t / n) .. + R - 1 and columns
// 4 g0 + t % n + n j, j < 4; with more tiles than threads (the 3xTF32
// comparison designs at large M) the threads take them in passes.  d is
// walked in chunks of 16: each chunk's Xs rows and the Zs rows of the block's
// columns come in by cp.async through a two-stage ring at `stage`
// (gram_stage_floats(TB, M) floats: the forward lays it over its product
// ring, whose first slices it issues after this returns; the backward over
// Ks and its other tile, as `stage` may lie over Ks where the tiles take one
// pass, or in a cluster, whose blocks write into Ks meanwhile, over its
// other tile), and each term goes into its output's total with Kahan's
// compensation in d order; the distance is total - compensation.  A warp's
// Xs rows are one or two broadcasts.  A running fp32 sum over Dx = 784 terms
// is off by ~1e-6 of d2 (about ten times the plain version's pairwise sum),
// this order by 6.5e-8.  Every output's terms are summed in one order
// whatever the geometry, so the forward, its save-gram variant, the
// backward's recompute, every plan and the comparison designs stage the same
// bits.  Every staged chunk is read before Ks is written, and `stage` is
// free on return.
template <int R, bool kCluster>
__device__ __forceinline__ void gram_tiles(
    const float* __restrict__ Xs, const float* __restrict__ Zs, float kvar,
    float* Ks, float* stage, int TB, int P, int64_t row0, int64_t B, int M,
    int Dx, float* __restrict__ Kout, int ldk, int ncols_out, int g0, int g1,
    int tid, int nthreads) {
  constexpr int kRow = gt::kRow<float>;
  const int P4 = 4 * col_groups(M), n = g1 - g0, m0 = 4 * g0;
  const int tiles = (TB / R) * n;
  const int nch = (Dx + gt::kChunk - 1) / gt::kChunk;
  const int buf = (TB + 4 * n) * kRow;
  const bool vec = gt::stage_vec(Xs, Zs, Dx);
  auto stage_chunk = [&](int c) {
    gt::stage_chunk(stage + (c & 1) * buf, Xs, TB, row0, B, Zs, 4 * n,
                    (int64_t)m0, (int64_t)M, Dx, c * gt::kChunk, vec, tid,
                    nthreads);
  };
  for (int t = tid; t - tid < tiles; t += nthreads) {
    const bool active = t < tiles;
    const int lr = active ? R * (t / n) : 0, cn = active ? t % n : 0;
    float S[R][4], C[R][4];
    zero(S);
    zero(C);
    stage_chunk(0);
    for (int c = 0; c < nch; ++c) {
      cp_async_wait_all();
      __syncthreads();  // chunk c is in; chunk c - 1's stage is free
      if (c + 1 < nch) stage_chunk(c + 1);
      if (!active) continue;
      const float* at = stage + (c & 1) * buf;
      gt::tile_chunk(S, C, at + lr * kRow, at + (TB + cn) * kRow, n * kRow,
                     Dx - c * gt::kChunk);
    }
    __syncthreads();  // every thread is done with the ring
    if (!active) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + cn + n * j;
      float k[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int64_t r = row0 + lr + i;
        k[i] = (r < B && m < M) ? kvar * expf(-0.5f * (S[i][j] - C[i][j]))
                                : 0.f;
        if (Kout != nullptr && r < B && m < ncols_out)
          Kout[r * ldk + m] = k[i];
      }
      put_rows<R, kCluster>(Ks + (size_t)m * TB + lr, k);
    }
  }
  // k rows past the column groups (P4 <= m < P): zero
  for (int e = P4 * TB + tid; e < P * TB; e += nthreads) Ks[e] = 0.f;
}

// gram_tiles: outside a cluster in 4 x 4 tiles (TB rows by CG column
// groups fill the threads); in a cluster of cs blocks with R =
// gram_tile_rows(TB, ceil(CG / cs))
template <bool kCluster>
__device__ __forceinline__ void gram_stage(
    int cs, const float* __restrict__ Xs, const float* __restrict__ Zs,
    float kvar, float* Ks, float* stage, int TB, int P, int64_t row0,
    int64_t B, int M, int Dx, float* __restrict__ Kout, int ldk,
    int ncols_out, int g0, int g1, int tid, int nthreads) {
  const int CG = col_groups(M);
  if constexpr (!kCluster) {
    gram_tiles<4, false>(Xs, Zs, kvar, Ks, stage, TB, P, row0, B, M, Dx,
                         Kout, ldk, ncols_out, g0, g1, tid, nthreads);
    return;
  }
  switch (gram_tile_rows(TB, (CG + cs - 1) / cs)) {
    case 1:
      gram_tiles<1, kCluster>(Xs, Zs, kvar, Ks, stage, TB, P, row0, B, M, Dx,
                              Kout, ldk, ncols_out, g0, g1, tid, nthreads);
      break;
    case 2:
      gram_tiles<2, kCluster>(Xs, Zs, kvar, Ks, stage, TB, P, row0, B, M, Dx,
                              Kout, ldk, ncols_out, g0, g1, tid, nthreads);
      break;
    default:
      gram_tiles<4, kCluster>(Xs, Zs, kvar, Ks, stage, TB, P, row0, B, M, Dx,
                              Kout, ldk, ncols_out, g0, g1, tid, nthreads);
  }
}

// Lets a kernel use up to 227 KB of dynamic shared memory, with the SM's
// carveout at its largest share (so that several blocks fit), once per
// device.
template <typename F>
__host__ inline cudaError_t allow_smem(F* kernel,
                                       unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             232448);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done |= bit;
  return err;
}

}  // namespace fc
