// The staged, tiled squared distance shared by the wide RBF gram
// (rbf_gram.cu, float32 and float64) and the fused conditional's gram stage
// (fused_conditional.cuh, float32), so that both sum every distance in one
// order.
//
// A block stages d in chunks of kChunk: its X rows, then its Z rows, copied
// by cp.async into rows of kRow<T> elements (the chunk and one 16-byte
// copy's padding: an odd number of 16-byte units, 5 in float32 and 9 in
// float64, so the 16-byte shared reads of neighbouring threads' rows are
// free of bank conflicts), zeros past the rows and past D.  Each thread owns
// a 4 x 4 register tile of distances (4 consecutive X rows, 4 Z rows a
// fixed step apart) and adds each chunk's terms to it: every squared
// difference goes into its output's total with Kahan's compensation, in d
// order, and the distance is total - compensation.  The direct sum cancels
// nothing, where the expansion ||x||^2 + ||z||^2 - 2 x.z loses digits that
// exp amplifies; a running fp32 sum over 784 terms is off by ~1e-6 of d2,
// this order by 6.5e-8, the least of the orders measured
// (tools/mnist_precision.py --cpu; PERF.md §6).  No TF32, no tensor cores.
// Both kernels that use it split their work over thread-block clusters,
// launched by launch_clusters.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gt {

constexpr int kChunk = 16;  // d of a staged chunk

// elements of a 16-byte copy, and of a staged row
template <typename T>
constexpr int kQ = 16 / (int)sizeof(T);
template <typename T>
constexpr int kRow = kChunk + kQ<T>;

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}

// cp.async of kBytes (4, 8 or 16) with zero fill: src_bytes 0 writes
// zeros and reads nothing (src must still be a valid address)
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to),
                 "l"(src), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(to),
                 "l"(src), "n"(kBytes), "r"(valid ? kBytes : 0));
}

// whether a chunk may be staged by 16-byte copies: D a multiple of kQ and
// both bases 16-byte aligned
template <typename T>
__host__ __device__ __forceinline__ bool stage_vec(const T* X, const T* Z,
                                                   int D) {
  return D % kQ<T> == 0 &&
         ((reinterpret_cast<uintptr_t>(X) | reinterpret_cast<uintptr_t>(Z)) &
          15) == 0;
}

// Chunk d0 .. d0 + kChunk - 1 of nx rows of X (x0 ..; NX rows in all) and
// nz rows of Z (z0 ..; NZ in all), both with D columns, into one ring
// stage at dst (X rows, then Z rows, row stride kRow<T>): 16-byte copies
// when `vec`, else one element a copy; zeros past NX, NZ and D.  Commits
// the copies as one group.
template <typename T>
__device__ __forceinline__ void stage_chunk(T* dst, const T* X, int nx,
                                            int64_t x0, int64_t NX,
                                            const T* Z, int nz, int64_t z0,
                                            int64_t NZ, int D, int d0,
                                            bool vec, int tid, int nthreads) {
  const int q = vec ? kQ<T> : 1, per = kChunk / q;
  for (int e = tid; e < (nx + nz) * per; e += nthreads) {
    const int row = e / per, d = d0 + (e - row * per) * q;
    const bool isx = row < nx;
    const int64_t g = isx ? x0 + row : z0 + (row - nx);
    const T* base = isx ? X : Z;
    const bool ok = g < (isx ? NX : NZ) && d < D;
    const T* src = ok ? base + g * D + d : base;
    T* to = dst + row * kRow<T> + (d - d0);
    if (vec)
      cp_async<16>(to, src, ok);
    else
      cp_async<(int)sizeof(T)>(to, src, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 16 bytes of shared memory as kQ<T> elements
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load16(const double* p, double (&v)[2]) {
  const double2 t = *reinterpret_cast<const double2*>(p);
  v[0] = t.x; v[1] = t.y;
}

// s += u^2 with Kahan's compensation c: the square's rounding folded into
// one FMA with the compensation, then three adds
template <typename T>
__device__ __forceinline__ void kahan_sq(T& s, T& c, T u) {
  const T y = fma_(u, u, -c);
  const T t = s + y;
  c = (t - s) - y;
  s = t;
}

// One staged chunk into a thread's tile: S[i][j] += sum_d (x_i[d] -
// z_j[d])^2 with compensation C[i][j], d ascending, for the X rows at xs +
// i kRow (i < R: 4, or fewer where a block has few rows a thread) and the
// Z rows at zs + j zstep (j < 4).  nd is the chunk's d below D; whole
// groups of kQ past it hold zeros and are skipped.  Each output's terms
// take the same instructions in the same order whatever R is.
template <typename T, int R>
__device__ __forceinline__ void tile_chunk(T (&S)[R][4], T (&C)[R][4],
                                           const T* xs, const T* zs,
                                           int zstep, int nd) {
#pragma unroll
  for (int d = 0; d < kChunk; d += kQ<T>) {
    if (d >= nd) break;
    T z[4][kQ<T>];
#pragma unroll
    for (int j = 0; j < 4; ++j) load16(zs + j * zstep + d, z[j]);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      T x[kQ<T>];
      load16(xs + i * kRow<T> + d, x);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int u = 0; u < kQ<T>; ++u)
          kahan_sq(S[i][j], C[i][j], x[u] - z[j][u]);
    }
  }
}

// Launches `kernel` on `blocks` blocks of `threads` threads, in clusters of
// cs blocks, with `smem` bytes of dynamic shared memory
template <typename... KArgs, typename... Args>
__host__ inline cudaError_t launch_clusters(void (*kernel)(KArgs...),
                                            int64_t blocks, int threads,
                                            int cs, size_t smem,
                                            cudaStream_t stream,
                                            Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace gt
