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
// What bounds it on an H100: bytes.  Each output costs 3D + 2 flops and
// one exp against sizeof(T) bytes written (the divisions are per row and
// per column, not per output); at D = 8 in float32 that is 6.5 flops and
// 0.25 exps a byte, under the card's ridges of about 20
// fp32 flops and 1.25 SFU exps a byte of HBM traffic, and the inputs
// (N + M) D are small beside the N M output.  So the kernel writes each
// output once, in 16-byte stores, and keeps no (N, M) intermediate in
// global memory (the TPU kernel's point as well: one HBM write of the
// final tile).
//
// Design.  A block of 32 x 4 threads owns a tile of 16 rows x 128
// columns; tiles are numbered on a 1-D grid, columns fastest.  For D <= 8
// (the D template) it first stages its 16 X rows and 128 Z rows, read in
// order (coalesced) and divided by ls, in shared memory (Z transposed);
// then lane tx takes the four consecutive columns m0 + 4 tx .. + 3 into
// registers (one 16-byte read a d) and warp ty takes rows ty + 4 k, k < 4,
// reading each X row as a broadcast.  For each row the thread forms its
// four distances and writes them as one float4 (two double2 in float64)
// when M is a multiple of 4, else as masked scalar stores.  Each operand
// is scaled by an IEEE division, as the JAX rbf_gram scales X and Z before
// its kernel (as one reciprocal and a corrected product, the bits of the
// division), so the distance loop sees the values the earlier design was
// handed (X / ls and Z / ls as torch divides them) and its outputs are the
// same bits; both operands of K(X, X) are scaled alike, so with the dims
// summed in one order it comes out bitwise symmetric with its diagonal
// exactly var.  The distance is the direct sum of squares as fp32 (or
// fp64) FMAs: no TF32, no tensor cores (D <= 8 leaves nothing for them),
// and no cancellation of the expansion ||x||^2 + ||z||^2 - 2 x.z.  Above
// D = 8 the operands are read from L1 and divided in the distance loop,
// and the sum is Kahan-compensated (at D = 784 a running sum is off by
// ~1e-6 of d2, which exp turns into the gram's relative error).
// Offsets are 64-bit.  exp is expf or __expf in float32 (the caller
// picks; see ops/cuda/gram.py) and exp in float64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;                 // threads along the columns
constexpr int kWarps = 4;                  // threads along the rows
constexpr int kThreads = kLanes * kWarps;
constexpr int kCols = 4;                   // columns a thread
constexpr int kTileM = kLanes * kCols;     // columns a block
constexpr int kRows = 4;                   // rows a thread
constexpr int kTileN = kWarps * kRows;     // rows a block

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}

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

// DT > 0: D == DT, the block's scaled X rows and Z columns staged, the
// thread's columns then held in registers.  DT == 0: any D, the operands
// read from L1 and divided in the distance loop.
template <typename T, int DT, bool kFastExp>
__global__ void __launch_bounds__(kThreads)
rbf_gram_kernel(const T* __restrict__ X, const T* __restrict__ Z,
                const T* __restrict__ ls, int ls_stride,
                const T* __restrict__ var, T* __restrict__ K, int64_t N,
                int64_t M, int D, int64_t tiles_m) {
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
    } else {
      T d2[kCols] = {}, comp[kCols] = {};
      for (int d = 0; d < D; ++d) {
        const T lsd = __ldg(ls + d * ls_stride);
        const T x = __ldg(X + n * D + d) / lsd;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const T t = x - (c < nc ? __ldg(Z + (m0 + c) * D + d) / lsd : T(0));
          const T y = fma_(t, t, -comp[c]);
          const T s = d2[c] + y;
          comp[c] = (s - d2[c]) - y;
          d2[c] = s;
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        o[c] = v * exp_<T, kFastExp>(T(-0.5) * d2[c]);
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

template <typename T, bool kFastExp>
int launch(const T* X, const T* Z, const T* ls, int ls_stride, const T* var,
           T* K, int64_t N, int64_t M, int D, void* stream) {
  if (N <= 0 || M <= 0 || D <= 0 || ls_stride < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles_m = (M + kTileM - 1) / kTileM;
  const int64_t tiles = tiles_m * ((N + kTileN - 1) / kTileN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
#define GRAM_CASE(d)                                                       \
  case d:                                                                  \
    rbf_gram_kernel<T, d, kFastExp><<<(unsigned)tiles, kThreads, 0, s>>>(  \
        X, Z, ls, ls_stride, var, K, N, M, D, tiles_m);                    \
    break;
    GRAM_CASE(1) GRAM_CASE(2) GRAM_CASE(3) GRAM_CASE(4)
    GRAM_CASE(5) GRAM_CASE(6) GRAM_CASE(7) GRAM_CASE(8)
#undef GRAM_CASE
    default:
      rbf_gram_kernel<T, 0, kFastExp><<<(unsigned)tiles, kThreads, 0, s>>>(
          X, Z, ls, ls_stride, var, K, N, M, D, tiles_m);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  Pointers are device pointers
// to tensors of the entry point's type: X (N, D) and Z (M, D) contiguous,
// ls the lengthscales (element d at ls[d * ls_stride]), var one value, K
// (N, M).  Return a cudaError_t code (0 = launched).
extern "C" int rbf_gram_f32(const float* X, const float* Z, const float* ls,
                            int ls_stride, const float* var, float* K,
                            int64_t N, int64_t M, int D, int fast_exp,
                            void* stream) {
  return fast_exp ? launch<float, true>(X, Z, ls, ls_stride, var, K, N, M, D,
                                        stream)
                  : launch<float, false>(X, Z, ls, ls_stride, var, K, N, M,
                                         D, stream);
}

extern "C" int rbf_gram_f64(const double* X, const double* Z,
                            const double* ls, int ls_stride,
                            const double* var, double* K, int64_t N,
                            int64_t M, int D, void* stream) {
  return launch<double, false>(X, Z, ls, ls_stride, var, K, N, M, D, stream);
}

// Resident blocks an SM of the kernel (float64 if f64, else float32 with
// expf) at this D, or -1 on an error.
extern "C" int rbf_gram_occupancy(int f64, int D) {
  int n = 0;
  cudaError_t err;
  if (f64) {
    err = D == 8 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &n, rbf_gram_kernel<double, 8, false>, kThreads, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &n, rbf_gram_kernel<double, 0, false>, kThreads, 0);
  } else {
    err = D == 8 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &n, rbf_gram_kernel<float, 8, false>, kThreads, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &n, rbf_gram_kernel<float, 0, false>, kThreads, 0);
  }
  return err == cudaSuccess ? n : -1;
}
