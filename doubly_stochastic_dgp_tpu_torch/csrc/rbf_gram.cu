// RBF gram, forward, for sm_90a, in float32 and float64.
//
// Replaces the TPU kernel doubly_stochastic_dgp_tpu/ops/pallas/gram.py::
// _gram_pallas_call (_gram_kernel).  For the lengthscale-scaled inputs
// Xs (N, D) and Zs (M, D) and the variance var (one value on the device):
//
//   K[n, m] = var * exp(-0.5 * sum_d (Xs[n,d] - Zs[m,d])^2)        (N, M)
//
// What bounds it on an H100: bytes.  Each output costs 3D + 2 flops and
// one exp against sizeof(T) bytes written; at D = 8 in float32 that is
// 6.5 flops and 0.25 exps a byte, under the card's ridges of about 20
// fp32 flops and 1.25 SFU exps a byte of HBM traffic, and the inputs
// (N + M) D are small beside the N M output.  So the kernel writes each
// output once, coalesced, and keeps no (N, M) intermediate in global
// memory (the TPU kernel's point as well: one HBM write of the final
// tile).
//
// Design.  A block of 32 x 8 threads owns a 32 x 32 output tile: lane
// tx owns column m0 + tx and rows n0 + ty + 8 i, i < 4, so each warp
// stores 32 consecutive outputs of a row.  The tile's 32 rows of Xs and
// 32 rows of Zs are staged in shared memory 16 dims at a time (row
// stride 17, so the lanes' reads of their Zs rows fall in distinct banks;
// the Xs reads are broadcasts).  The distance is the direct sum of
// squared differences as fp32 (or fp64) FMAs, dims in order: no TF32, no
// tensor cores (D <= 8 leaves nothing for them), and no cancellation of
// the expansion ||x||^2 + ||z||^2 - 2 x.z.  Because (a - b)^2 and
// (b - a)^2 are the same bits and the dims are summed in one order,
// K(X, X) comes out bitwise symmetric with its diagonal exactly var.
// Ragged edges are masked (no padding); offsets are 64-bit; tiles are
// numbered on a 1-D grid, so neither N nor M is limited by a grid
// dimension.  exp is expf or __expf in float32 (the caller picks; see
// ops/cuda/gram.py) and exp in float64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;               // rows and columns of a tile
constexpr int kRowsStep = 8;            // threadIdx.y extent
constexpr int kPer = kTile / kRowsStep; // rows per thread
constexpr int kThreads = kTile * kRowsStep;
constexpr int kDChunk = 16;             // dims staged at a time

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

template <typename T, bool kFastExp>
__global__ void __launch_bounds__(kThreads)
rbf_gram_kernel(const T* __restrict__ Xs, const T* __restrict__ Zs,
                const T* __restrict__ var, T* __restrict__ K, int64_t N,
                int64_t M, int D, int64_t tiles_m) {
  __shared__ T sX[kTile][kDChunk + 1];
  __shared__ T sZ[kTile][kDChunk + 1];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int64_t n0 = (int64_t)(blockIdx.x / tiles_m) * kTile;
  const int64_t m0 = (int64_t)(blockIdx.x % tiles_m) * kTile;

  T d2[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) d2[i] = T(0);

  for (int d0 = 0; d0 < D; d0 += kDChunk) {
    const int dc = min(kDChunk, D - d0);
    for (int e = tid; e < kTile * dc; e += kThreads) {
      const int r = e / dc;
      const int d = e % dc;
      const int64_t n = n0 + r;
      const int64_t m = m0 + r;
      sX[r][d] = n < N ? Xs[n * D + d0 + d] : T(0);
      sZ[r][d] = m < M ? Zs[m * D + d0 + d] : T(0);
    }
    __syncthreads();
    for (int d = 0; d < dc; ++d) {
      const T z = sZ[tx][d];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const T t = sX[ty + kRowsStep * i][d] - z;
        d2[i] = fma_(t, t, d2[i]);
      }
    }
    __syncthreads();
  }

  const int64_t m = m0 + tx;
  if (m >= M) return;
  const T v = *var;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int64_t n = n0 + ty + kRowsStep * i;
    if (n < N) K[n * M + m] = v * exp_<T, kFastExp>(T(-0.5) * d2[i]);
  }
}

template <typename T, bool kFastExp>
int launch(const T* Xs, const T* Zs, const T* var, T* K, int64_t N,
           int64_t M, int D, void* stream) {
  if (N <= 0 || M <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const int64_t tiles_n = (N + kTile - 1) / kTile;
  const int64_t tiles_m = (M + kTile - 1) / kTile;
  if (tiles_n * tiles_m > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 block(kTile, kRowsStep);
  rbf_gram_kernel<T, kFastExp>
      <<<(unsigned)(tiles_n * tiles_m), block, 0,
         static_cast<cudaStream_t>(stream)>>>(Xs, Zs, var, K, N, M, D,
                                              tiles_m);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  Pointers are device pointers
// to contiguous tensors of the entry point's type: Xs (N, D), Zs (M, D),
// var (1,), K (N, M).  Return a cudaError_t code (0 = launched).
extern "C" int rbf_gram_f32(const float* Xs, const float* Zs,
                            const float* var, float* K, int64_t N, int64_t M,
                            int D, int fast_exp, void* stream) {
  return fast_exp ? launch<float, true>(Xs, Zs, var, K, N, M, D, stream)
                  : launch<float, false>(Xs, Zs, var, K, N, M, D, stream);
}

extern "C" int rbf_gram_f64(const double* Xs, const double* Zs,
                            const double* var, double* K, int64_t N,
                            int64_t M, int D, void* stream) {
  return launch<double, false>(Xs, Zs, var, K, N, M, D, stream);
}
