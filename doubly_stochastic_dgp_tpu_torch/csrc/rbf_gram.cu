// RBF gram, forward, for sm_90a, in float32 and float64.
//
// Replaces the TPU kernel doubly_stochastic_dgp_tpu/ops/pallas/gram.py::
// _gram_pallas_call (_gram_kernel), with the lengthscale scaling that the
// JAX rbf_gram does outside it folded in.  For X (N, D), Z (M, D), the
// lengthscales ls (D values read with stride ls_stride: 1 for a vector, 0
// for a scalar) and the variance var (one value on the device):
//
//   K[n, m] = var * exp(-0.5 * sum_d ((X[n,d] - Z[m,d]) / ls_d)^2)    (N, M)
//
// What bounds it on an H100.  Each output costs 3D + 2 flops and one exp
// against sizeof(T) bytes written (the divisions are per row and per
// column, not per output).  At D = 8 in float32 that is 6.5 flops and
// 0.25 exps a byte, under the card's ridges of about 20 fp32 flops and
// 1.25 SFU exps a byte of HBM traffic, and the inputs (N + M) D are small
// beside the N M output: bytes.  At the MNIST DGP's D = 784 it is 590
// flops a byte: operations, the 2D FFMA-pipe instructions an output.
//
// Two kernels, one per regime, chosen by D (ops/cuda/gram.py::launch_plan
// hands the C entry point its plan, which checks it).
//
// D <= 8 (rbf_gram_kernel, the D template).  A block of 32 x 4 threads
// owns a tile of 16 rows x 128 columns; tiles are numbered on a 1-D grid,
// columns fastest.  It first stages its 16 X rows and 128 Z rows, read in
// order (coalesced) and divided by ls, in shared memory (Z transposed);
// then lane tx takes the four consecutive columns m0 + 4 tx .. + 3 into
// registers (one 16-byte read a d) and warp ty takes rows ty + 4 k, k < 4,
// reading each X row as a broadcast.  For each row the thread forms its
// four distances and writes them as one float4 (two double2 in float64)
// when M is a multiple of 4, else as masked scalar stores.  The sum is a
// running FMA chain over the D <= 8 terms, no TF32 and no tensor cores
// (D <= 8 leaves nothing for them).
//
// D > 8 (rbf_gram_kernel_wide).  A block of 256 threads owns a 64 x 64 output
// tile, a 4 x 4 register tile a thread (rows 4 ty .. + 3, columns tx + 16 j),
// and walks d in chunks of 16: the chunk's 64 X rows and 64 Z rows come in by
// cp.async (16-byte copies when D is a multiple of the copy and the rows
// aligned, else one element a copy; zeros past N, M and D) into a two-stage
// ring, are divided by ls in place, once each, and each thread then adds the
// chunk's terms to its 16 outputs' sums, each term with Kahan's compensation
// in d order (gram_tile.cuh, the fused conditional's gram stage's order too):
// at D = 784 a running fp32 sum is off by ~1e-6 of d2, which exp turns into
// the gram's relative error; this order by 6.5e-8 (9.8e-8 over 8 splits),
// the least of the orders measured (tools/mnist_precision.py; PERF.md §6 has
// the blocked order also tried).  A small gram cannot fill the card by tiles
// alone (Kuu at 100 x 100 is 4 tiles), so the plan splits the chunks over a thread-block cluster of
// `splits` (1, 2, 4 or 8) blocks that share a tile: each block sums its own
// contiguous run of chunks, writes total - compensation to its shared memory,
// and after a cluster barrier block r reads the 64 / splits rows r owns from
// every block of the cluster (distributed shared memory) in rank order, adds
// them compensated, and writes var exp(-0.5 d2).  No atomics and no workspace:
// the result depends on the plan alone, and repeats are bit for bit.
//
// Both: each operand is scaled by an IEEE division (as one reciprocal
// and a corrected product, the bits of the division), as the JAX rbf_gram
// scales X and Z before its kernel; both operands of K(X, X) are scaled
// alike and every output's terms are summed in one order, so it comes out
// bitwise symmetric with its diagonal exactly var.  The distance is the
// direct sum of squares as fp32 (or fp64) FMAs: no TF32, no tensor cores,
// and no cancellation of the expansion ||x||^2 + ||z||^2 - 2 x.z.
// Offsets are 64-bit.  exp is expf or __expf in float32 (the caller
// picks; see ops/cuda/gram.py) and exp in float64.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gram_tile.cuh"

namespace {

constexpr int kLanes = 32;                 // threads along the columns
constexpr int kWarps = 4;                  // threads along the rows
constexpr int kThreads = kLanes * kWarps;
constexpr int kCols = 4;                   // columns a thread
constexpr int kTileM = kLanes * kCols;     // columns a block
constexpr int kRows = 4;                   // rows a thread
constexpr int kTileN = kWarps * kRows;     // rows a block

using gt::fma_;

template <typename T, bool kFastExp>
__device__ __forceinline__ T exp_(T x);

template <>
__device__ __forceinline__ float exp_<float, false>(float x) {
  return expf(x);
}
template <>
__device__ __forceinline__ float exp_<float, true>(float x) {
  return __expf(x);
}
template <>
__device__ __forceinline__ double exp_<double, false>(double x) {
  return exp(x);
}

// a / b rounded to nearest, from r = 1 / b rounded to nearest: q = a r,
// then one correction with the exact residual a - b q (Markstein's
// theorem: the result is the correctly rounded quotient, the bits of an
// IEEE division, wherever nothing over- or underflows)
template <typename T>
__device__ __forceinline__ T div_rn(T a, T b, T r) {
  const T q = a * r;
  return fma_(fma_(-q, b, a), r, q);
}

// the four outputs of a thread in one row: 16-byte stores when aligned
__device__ __forceinline__ void store4(float* p, const float (&o)[kCols]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store4(double* p, const double (&o)[kCols]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(o[0], o[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(o[2], o[3]);
}

// D == DT <= 8: the block's scaled X rows and Z columns staged, the
// thread's columns then held in registers.
template <typename T, int DT, bool kFastExp>
__global__ void __launch_bounds__(kThreads)
rbf_gram_kernel(const T* __restrict__ X, const T* __restrict__ Z,
                const T* __restrict__ ls, int ls_stride,
                const T* __restrict__ var, T* __restrict__ K, int64_t N,
                int64_t M, int D, int64_t tiles_m) {
  static_assert(DT > 0 && DT <= 8, "the wide kernel takes D > 8");
  constexpr int kRegD = DT > 0 ? DT : 1;
  // the block's Z columns divided by ls, transposed ([d][column], rows
  // padded to 132 so that the staging stores and the 16-byte reads are
  // free of bank conflicts), and its X rows divided by ls
  __shared__ __align__(16) T sZt[kRegD][kTileM + 4];
  __shared__ __align__(16) T sX[kTileN][kRegD];
  __shared__ T sLs[kRegD], sRl[kRegD];    // ls_d and 1 / ls_d
  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  const int64_t n0 = (int64_t)(blockIdx.x / tiles_m) * kTileN;
  const int64_t mb = (int64_t)(blockIdx.x % tiles_m) * kTileM;
  if constexpr (DT > 0) {
    if (threadIdx.x < DT) {
      const T l = ls[threadIdx.x * ls_stride];
      sLs[threadIdx.x] = l;
      sRl[threadIdx.x] = T(1) / l;
    }
    __syncthreads();
    const int64_t cols = M - mb < kTileM ? M - mb : kTileM;
    for (int e = threadIdx.x; e < kTileM * DT; e += kThreads) {
      const int col = e / DT, d = e % DT;   // Z read in order: coalesced
      sZt[d][col] =
          col < cols ? div_rn(Z[mb * DT + e], sLs[d], sRl[d]) : T(0);
    }
    const int64_t rows = N - n0 < kTileN ? N - n0 : kTileN;
    for (int e = threadIdx.x; e < kTileN * DT; e += kThreads) {
      const int r = e / DT, d = e % DT;
      sX[r][d] = r < rows ? div_rn(X[n0 * DT + e], sLs[d], sRl[d]) : T(0);
    }
    __syncthreads();
  }
  const int64_t m0 = mb + kCols * tx;
  if (m0 >= M) return;
  const int nc = M - m0 < kCols ? (int)(M - m0) : kCols;
  const bool vec = M % kCols == 0;   // then nc == kCols and p is aligned
  const T v = *var;

  T z[kCols][kRegD];
  if constexpr (DT > 0) {
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int c = 0; c < kCols; ++c) z[c][d] = sZt[d][kCols * tx + c];
  }

#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = ty + kWarps * k;
    const int64_t n = n0 + r;
    if (n >= N) break;
    T o[kCols];
    if constexpr (DT > 0) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        T d2 = T(0);
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          const T t = sX[r][d] - z[c][d];
          d2 = fma_(t, t, d2);
        }
        o[c] = v * exp_<T, kFastExp>(T(-0.5) * d2);
      }
    }
    T* p = K + n * M + m0;
    if (vec) {
      store4(p, o);
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (c < nc) p[c] = o[c];
    }
  }
}

// ----------------------------------------------------------------------------
// D > 8: the wide kernel
// ----------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kWTile = 64;                 // rows and columns of a tile
constexpr int kWGroups = kWTile / 4;       // 4-row (4-column) groups a tile
constexpr int kWThreads = kWGroups * kWGroups;
constexpr int kMaxSplits = 8;              // blocks of a cluster at most

// elements of one ring stage (64 X rows, then 64 Z rows, of gt::kRow), and
// the dynamic shared memory of a block: two stages, which the exchange
// tile (64 x 64 partial sums) reuses
template <typename T>
constexpr int kWStage = 2 * kWTile * gt::kRow<T>;
template <typename T>
constexpr size_t wide_smem_bytes() {
  return sizeof(T) * (2 * kWStage<T> > kWTile * kWTile ? 2 * kWStage<T>
                                                       : kWTile * kWTile);
}

// s += x with Kahan's compensation c
template <typename T>
__device__ __forceinline__ void kahan_add(T& s, T& c, T x) {
  const T y = x - c;
  const T t = s + y;
  c = (t - s) - y;
  s = t;
}

template <typename T, bool kFastExp>
__global__ void __launch_bounds__(kWThreads)
rbf_gram_kernel_wide(const T* __restrict__ X, const T* __restrict__ Z,
                     const T* __restrict__ ls, int ls_stride,
                     const T* __restrict__ var, T* __restrict__ K,
                     int64_t N, int64_t M, int D, int64_t tiles_m,
                     bool vec) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  T* ring = reinterpret_cast<T*>(wide_smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int64_t tile = blockIdx.x / splits;
  const int64_t n0 = (tile / tiles_m) * kWTile;
  const int64_t m0 = (tile % tiles_m) * kWTile;
  const int tid = threadIdx.x;
  const int ty = tid / kWGroups, tx = tid % kWGroups;
  // this block's chunks: an even share of the ceil(D / 16), in order
  const int chunks = (D + gt::kChunk - 1) / gt::kChunk;
  const int c0 = (int)((int64_t)rank * chunks / splits);
  const int c1 = (int)((int64_t)(rank + 1) * chunks / splits);

  T S[4][4], Cp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) S[i][j] = Cp[i][j] = T(0);

  auto stage = [&](int c) {
    gt::stage_chunk(ring + ((c - c0) & 1) * kWStage<T>, X, kWTile, n0, N, Z,
                    kWTile, m0, M, D, c * gt::kChunk, vec, tid, kWThreads);
  };
  if (c0 < c1) stage(c0);
  for (int c = c0; c < c1; ++c) {
    T* buf = ring + ((c - c0) & 1) * kWStage<T>;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // chunk c is in; chunk c - 1's stage is free
    if (c + 1 < c1) stage(c + 1);
    // divide the chunk by ls in place, each element once: thread t takes
    // column t % 16 of rows t / 16, + 16, ...
    {
      const int dd = tid % gt::kChunk, d = c * gt::kChunk + dd;
      if (d < D) {
        const T l = __ldg(ls + (int64_t)d * ls_stride);
        const T r = T(1) / l;
        for (int row = tid / gt::kChunk; row < 2 * kWTile;
             row += kWThreads / gt::kChunk) {
          T* p = buf + row * gt::kRow<T> + dd;
          *p = div_rn(*p, l, r);
        }
      }
    }
    __syncthreads();
    // every term added to its output's total with compensation, in d
    // order; past D the chunk holds zeros
    gt::tile_chunk(S, Cp, buf + (4 * ty) * gt::kRow<T>,
                   buf + (kWTile + tx) * gt::kRow<T>, kWGroups * gt::kRow<T>,
                   D - c * gt::kChunk);
  }

  // the block's partial tile (total - compensation) into its shared
  // memory, over the ring (every thread is done reading it)
  __syncthreads();
  T* part = ring;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      part[(4 * ty + i) * kWTile + tx + kWGroups * j] = S[i][j] - Cp[i][j];
  cluster.sync();
  // block `rank` finishes rows rank * 64 / splits ..: the cluster's
  // partials added in rank order, with compensation, then var exp(-d2/2)
  const T v = *var;
  const int rows = kWTile / splits;
  for (int e = tid; e < rows * kWTile; e += kWThreads) {
    const int i = rank * rows + e / kWTile, j = e % kWTile;
    T s = T(0), c = T(0);
    for (int q = 0; q < splits; ++q)
      kahan_add(s, c, cluster.map_shared_rank(part, q)[i * kWTile + j]);
    const int64_t n = n0 + i, m = m0 + j;
    if (n < N && m < M)
      K[n * M + m] = v * exp_<T, kFastExp>(T(-0.5) * (s - c));
  }
  cluster.sync();  // no block leaves while another reads its partials
}

template <typename T, bool kFastExp>
int launch(const T* X, const T* Z, const T* ls, int ls_stride, const T* var,
           T* K, int64_t N, int64_t M, int D, int splits, void* stream) {
  if (N <= 0 || M <= 0 || D <= 0 || ls_stride < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 8) {
    // the plan of the narrow kernel: one block a tile, static shared memory
    if (splits != 1) return (int)cudaErrorInvalidValue;
    const int64_t tiles_m = (M + kTileM - 1) / kTileM;
    const int64_t tiles = tiles_m * ((N + kTileN - 1) / kTileN);
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    switch (D) {
#define GRAM_CASE(d)                                                       \
  case d:                                                                  \
    rbf_gram_kernel<T, d, kFastExp><<<(unsigned)tiles, kThreads, 0, s>>>(  \
        X, Z, ls, ls_stride, var, K, N, M, D, tiles_m);                    \
    break;
      GRAM_CASE(1) GRAM_CASE(2) GRAM_CASE(3) GRAM_CASE(4)
      GRAM_CASE(5) GRAM_CASE(6) GRAM_CASE(7) GRAM_CASE(8)
#undef GRAM_CASE
    }
    return (int)cudaGetLastError();
  }
  // the plan of the wide kernel: a cluster of `splits` blocks a tile, a
  // power of two of at most kMaxSplits, each with a chunk at least
  const int chunks = (D + gt::kChunk - 1) / gt::kChunk;
  if (splits < 1 || splits > kMaxSplits || (splits & (splits - 1)) != 0 ||
      splits > chunks)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles_m = (M + kWTile - 1) / kWTile;
  const int64_t blocks = tiles_m * ((N + kWTile - 1) / kWTile) * splits;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = gt::stage_vec(X, Z, D);
  return (int)gt::launch_clusters(rbf_gram_kernel_wide<T, kFastExp>, blocks,
                                  kWThreads, splits, wide_smem_bytes<T>(), s,
                                  X, Z, ls, ls_stride, var, K, N, M, D,
                                  tiles_m, vec);
}

}  // namespace

// Plain C entry points (bound with ctypes).  Pointers are device pointers
// to tensors of the entry point's type: X (N, D) and Z (M, D) contiguous,
// ls the lengthscales (element d at ls[d * ls_stride]), var one value, K
// (N, M).  `splits` is the launch plan (ops/cuda/gram.py::launch_plan): 1
// for D <= 8; for D > 8 the blocks of a cluster (1, 2, 4 or 8, at most one
// a 16-wide chunk of d).  Any other is refused before any launch.  Return
// a cudaError_t code (0 = launched).
extern "C" int rbf_gram_f32(const float* X, const float* Z, const float* ls,
                            int ls_stride, const float* var, float* K,
                            int64_t N, int64_t M, int D, int splits,
                            int fast_exp, void* stream) {
  return fast_exp ? launch<float, true>(X, Z, ls, ls_stride, var, K, N, M, D,
                                        splits, stream)
                  : launch<float, false>(X, Z, ls, ls_stride, var, K, N, M,
                                         D, splits, stream);
}

extern "C" int rbf_gram_f64(const double* X, const double* Z,
                            const double* ls, int ls_stride,
                            const double* var, double* K, int64_t N,
                            int64_t M, int D, int splits, void* stream) {
  return launch<double, false>(X, Z, ls, ls_stride, var, K, N, M, D, splits,
                               stream);
}

// Resident blocks an SM of the kernel that D takes (float64 if f64, else
// float32 with expf): the narrow kernel at D = 8 for D <= 8, the wide one
// with its shared memory above, or -1 on an error.
extern "C" int rbf_gram_occupancy(int f64, int D) {
  int n = 0;
  cudaError_t err;
  if (f64) {
    err = D <= 8 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &n, rbf_gram_kernel<double, 8, false>, kThreads, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &n, rbf_gram_kernel_wide<double, false>, kWThreads,
                       wide_smem_bytes<double>());
  } else {
    err = D <= 8 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &n, rbf_gram_kernel<float, 8, false>, kThreads, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &n, rbf_gram_kernel_wide<float, false>, kWThreads,
                       wide_smem_bytes<float>());
  }
  return err == cudaSuccess ? n : -1;
}
