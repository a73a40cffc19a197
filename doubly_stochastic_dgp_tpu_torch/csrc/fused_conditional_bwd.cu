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
//   dX    = 2 (x sum_m Gd_m - sum_m Gd_m z_m)        per row
//   dalpha = sum_rows G^T gm        dLiT = sum_rows K^T dG
//   dW_d  = sum_rows gv_d G^T G     dZ_m = 2 (z_m sum_rows Gd_m - sum_rows Gd_m x)
//
// (dkvar and dkdiag come from the saved forward outputs in the wrapper.)
//
// What bounds it on an H100: operations.  Per row it does about
// 6 M Dx + 6 M^2 + 4 M Do + Do (4 M^2 + 2 M) flops against reading
// Dx + 2 Do floats and writing Dx (the saved variant reads M more); at
// M = 100, Do = 8 that is ~390 kflop per row.
//
// Design.  The TPU grid was (Do, batch tiles) and recomputed K and G for
// every d, carrying its row sums in output blocks it revisited.  Here a
// block owns TB = 8 RT rows across every d, as the forward does: each warp
// builds its rows' K, G and dG (gm alpha^T once, then 2 gv_d G W_d for
// each d, summed before dK and dLiT), so K and G are computed once and dX
// needs no per-d partials.  The sums over rows (dW, dLiT, dalpha, dZ) are
// made deterministic, with no atomics: each block adds its rows'
// contributions, in a fixed order, into its own slice of a scratch buffer
// (block-wide register-tiled outer products out of the shared K, G and dG
// tiles); a block walks the row tiles blockIdx, blockIdx + gridDim, ... so
// the scratch is bounded by the grid, not by B.  A second kernel then sums
// the slices in block order.  All products are fp32 FFMA (no TF32), as in
// the forward.  Shared memory per block: K, G (later Gd) and dG tiles of
// TB x Mp floats plus the TB x Do cotangent rows: 81 KB at M = 100,
// Do = 8 (TB = 64), 197 KB at M = 512 (TB = 32).

#include "fused_conditional.cuh"

namespace {

using namespace fc;

constexpr int kOT = 8;              // outputs per thread along each axis
constexpr int kOTile = 16 * kOT;    // output tile edge of a block (16 x 16 threads)
constexpr size_t kSmemMax = 232448; // bytes of shared memory a block may use
constexpr int64_t kScratchMaxFloats = (int64_t)1 << 28;  // 1 GiB of partials

__device__ __forceinline__ void load4(const float* row, int c, int Mp,
                                      float* out) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < Mp) v = *reinterpret_cast<const float4*>(row + c);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// P[m * M + n] (=, or += unless first) sum_{r < TB} s_r A[r][m] Bm[r][n]
// over the block's rows; A and Bm are shared tiles (row stride Mp, zero
// past M), s the optional row scale (s[r * s_stride]).  Each thread owns
// an 8 x 8 sub-tile of every 128 x 128 output tile (columns ty*4 + {0..3}
// and 64 + ty*4 + {0..3}, rows likewise with tx), so it rereads only its
// own entries of P and needs no synchronization with other threads.
template <int TB>
__device__ __forceinline__ void block_outer(const float* A, const float* s,
                                            int s_stride, const float* Bm,
                                            int Mp, int M,
                                            float* __restrict__ P,
                                            bool first) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  for (int m0 = 0; m0 < M; m0 += kOTile)
    for (int n0 = 0; n0 < M; n0 += kOTile) {
      float acc[kOT][kOT];
#pragma unroll
      for (int i = 0; i < kOT; ++i)
#pragma unroll
        for (int j = 0; j < kOT; ++j) acc[i][j] = 0.f;
      for (int r = 0; r < TB; ++r) {
        float a[kOT], b[kOT];
        load4(A + r * Mp, m0 + ty * 4, Mp, a);
        load4(A + r * Mp, m0 + 64 + ty * 4, Mp, a + 4);
        load4(Bm + r * Mp, n0 + tx * 4, Mp, b);
        load4(Bm + r * Mp, n0 + 64 + tx * 4, Mp, b + 4);
        if (s != nullptr) {
          const float sr = s[r * s_stride];
#pragma unroll
          for (int i = 0; i < kOT; ++i) a[i] *= sr;
        }
#pragma unroll
        for (int i = 0; i < kOT; ++i)
#pragma unroll
          for (int j = 0; j < kOT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kOT; ++i) {
        const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < kOT; ++j) {
          const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
          if (n < M) {
            float* p = P + (size_t)m * M + n;
            *p = first ? acc[i][j] : *p + acc[i][j];
          }
        }
      }
    }
}

template <int RT, bool kSaved>
__global__ void __launch_bounds__(kThreads)
fused_conditional_bwd_kernel(const float* __restrict__ Xs,
                             const float* __restrict__ Zs,
                             const float* __restrict__ LiT,
                             const float* __restrict__ LiTT,
                             const float* __restrict__ alpha,
                             const float* __restrict__ W,
                             const float* __restrict__ scal,
                             const float* __restrict__ gm,
                             const float* __restrict__ gv,
                             const float* __restrict__ Kin,
                             float* __restrict__ dX,
                             float* __restrict__ part, int64_t E,
                             int64_t B, int M, int Dx, int Do,
                             int64_t ntiles) {
  constexpr int TB = RT * kWarps;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Mp = padded(M);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* Ks = smem;                          // TB x Mp: K
  float* Gs = Ks + (size_t)TB * Mp;          // TB x Mp: G, later Gd
  float* dGs = Gs + (size_t)TB * Mp;         // TB x Mp: dG
  float* gms = dGs + (size_t)TB * Mp;        // TB x Do: gm rows
  float* gvs = gms + (size_t)TB * Do;        // TB x Do: gv rows
  float* Kw = Ks + (size_t)warp * RT * Mp;   // this warp's rows
  float* Gw = Gs + (size_t)warp * RT * Mp;
  float* dGw = dGs + (size_t)warp * RT * Mp;
  const float* gmw = gms + (size_t)warp * RT * Do;
  const float* gvw = gvs + (size_t)warp * RT * Do;
  const float kvar = scal[0];
  float* P = part + (int64_t)blockIdx.x * E;  // this block's partial sums
  const int64_t oLiT = (int64_t)Do * M * M;
  const int64_t oAlpha = oLiT + (int64_t)M * M;
  const int64_t oZ = oAlpha + (int64_t)M * Do;
  float acc[RT][kCols];

  bool first = true;
  for (int64_t tile = blockIdx.x; tile < ntiles;
       tile += gridDim.x, first = false) {
    const int64_t row0 = tile * TB + (int64_t)warp * RT;

    // a. the cotangent rows, zero past B
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int64_t r = row0 + i;
      for (int d = lane; d < Do; d += 32) {
        const size_t o = (size_t)(warp * RT + i) * Do + d;
        gms[o] = r < B ? __ldg(gm + r * Do + d) : 0.f;
        gvs[o] = r < B ? __ldg(gv + r * Do + d) : 0.f;
      }
    }

    // b. gram rows: recomputed as in the forward, or read back
    if (kSaved) {
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int64_t r = row0 + i;
        for (int m = lane; m < Mp; m += 32)
          Kw[i * Mp + m] = (r < B && m < M) ? __ldg(Kin + r * M + m) : 0.f;
      }
    } else {
      gram_rows<RT>(Xs, Zs, kvar, Kw, Mp, row0, B, M, Dx, lane, nullptr);
    }
    __syncwarp();

    // c. G = K LiT
    for (int c0 = 0; c0 < Mp; c0 += kChunk) {
      rows_times_matrix<RT>(Kw, Mp, LiT, M, c0, lane, acc);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = c0 + lane + 32 * j;
          if (c < Mp) Gw[i * Mp + c] = acc[i][j];
        }
    }
    __syncwarp();

    // d. dG = gm alpha^T (the mean term, once), then + 2 gv_d (G W_d)
#pragma unroll
    for (int i = 0; i < RT; ++i)
      for (int c = lane; c < Mp; c += 32) {
        float s = 0.f;
        if (c < M)
          for (int d = 0; d < Do; ++d)
            s = fmaf(gmw[i * Do + d], __ldg(alpha + (size_t)c * Do + d), s);
        dGw[i * Mp + c] = s;
      }
    __syncwarp();
    for (int d = 0; d < Do; ++d) {
      const float* Wd = W + (size_t)d * M * M;
      for (int c0 = 0; c0 < M; c0 += kChunk) {
        rows_times_matrix<RT>(Gw, Mp, Wd, M, c0, lane, acc);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float g2 = 2.f * gvw[i * Do + d];
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            const int c = c0 + lane + 32 * j;
            if (c < M) dGw[i * Mp + c] = fmaf(g2, acc[i][j], dGw[i * Mp + c]);
          }
        }
      }
    }
    __syncthreads();  // every warp's K, G, dG and cotangent rows are in

    // e. this block's sums over its rows: dW_d, dLiT, dalpha
    for (int d = 0; d < Do; ++d)
      block_outer<TB>(Gs, gvs + d, Do, Gs, Mp, M, P + (size_t)d * M * M,
                      first);
    block_outer<TB>(Ks, nullptr, 0, dGs, Mp, M, P + oLiT, first);
    for (int e = threadIdx.x; e < M * Do; e += kThreads) {
      const int m = e / Do, d = e - (e / Do) * Do;
      float s = 0.f;
      for (int r = 0; r < TB; ++r)
        s = fmaf(Gs[(size_t)r * Mp + m], gms[r * Do + d], s);
      P[oAlpha + e] = first ? s : P[oAlpha + e] + s;
    }
    __syncthreads();  // G is read for the last time above

    // f. dK = dG LiT^T (LiTT = LiT^T, row-major) and Gd = -0.5 dK K,
    //    written over the warp's G rows
    for (int c0 = 0; c0 < Mp; c0 += kChunk) {
      rows_times_matrix<RT>(dGw, Mp, LiTT, M, c0, lane, acc);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = c0 + lane + 32 * j;
          if (c < Mp)
            Gw[i * Mp + c] = c < M ? -0.5f * acc[i][j] * Kw[i * Mp + c] : 0.f;
        }
    }
    __syncwarp();

    // g. dX = 2 (x rowsum(Gd) - Gd Z), one row at a time
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int64_t r = row0 + i;
      float rs = 0.f;
      for (int m = lane; m < M; m += 32) rs += Gw[i * Mp + m];
      rs = warp_sum(rs);
      for (int d = 0; d < Dx; ++d) {
        float t = 0.f;
        for (int m = lane; m < M; m += 32)
          t = fmaf(Gw[i * Mp + m], __ldg(Zs + (size_t)m * Dx + d), t);
        t = warp_sum(t);
        if (lane == 0 && r < B)
          dX[r * Dx + d] = 2.f * (__ldg(Xs + r * Dx + d) * rs - t);
      }
    }
    __syncthreads();  // every warp's Gd rows are in

    // h. this block's share of dZ = 2 (z colsum(Gd) - Gd^T X)
    const int64_t rowb = tile * TB;
    for (int m = threadIdx.x; m < M; m += kThreads) {
      float cs = 0.f;
      for (int r = 0; r < TB; ++r) cs += Gs[(size_t)r * Mp + m];
      for (int d = 0; d < Dx; ++d) {
        float t = 0.f;
        for (int r = 0; r < TB && rowb + r < B; ++r)
          t = fmaf(Gs[(size_t)r * Mp + m], __ldg(Xs + (rowb + r) * Dx + d), t);
        const float v = 2.f * (__ldg(Zs + (size_t)m * Dx + d) * cs - t);
        float* p = P + oZ + (size_t)m * Dx + d;
        *p = first ? v : *p + v;
      }
    }
    __syncthreads();  // before the next tile overwrites the tiles
  }
}

// out[e] = sum over blocks b = 0, 1, ... of part[b * E + e], in that order
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int64_t E,
                                    int nblk) {
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < E;
       e += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < nblk; ++b) s += part[(int64_t)b * E + e];
    out[e] = s;
  }
}

size_t smem_bytes(int RT, int M, int Do) {
  const size_t TB = (size_t)RT * kWarps;
  return (3 * TB * padded(M) + 2 * TB * Do) * sizeof(float);
}

// 8 rows per warp while the tiles fit in shared memory, else 4; 0 if
// neither fits.
int rows_per_warp(int M, int Do) {
  if (smem_bytes(8, M, Do) <= kSmemMax && padded(M) <= 256) return 8;
  if (smem_bytes(4, M, Do) <= kSmemMax) return 4;
  return 0;
}

int64_t partial_floats(int M, int Dx, int Do) {
  return (int64_t)Do * M * M + (int64_t)M * M + (int64_t)M * Do +
         (int64_t)M * Dx;
}

// Blocks of the row pass: one per row tile, at most two per SM (so all
// are resident at once) and at most what kScratchMaxFloats of partial
// sums allow.
int grid_blocks(int64_t B, int M, int Dx, int Do) {
  const int RT = rows_per_warp(M, Do);
  if (RT == 0) return 0;
  const int64_t ntiles = (B + RT * kWarps - 1) / (RT * kWarps);
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  int64_t n = ntiles < 2 * (int64_t)sms ? ntiles : 2 * (int64_t)sms;
  const int64_t cap = kScratchMaxFloats / partial_floats(M, Dx, Do);
  if (n > cap) n = cap;
  return n < 1 ? 1 : (int)n;
}

template <int RT, bool kSaved>
cudaError_t launch(const float* Xs, const float* Zs, const float* LiT,
                   const float* LiTT, const float* alpha, const float* W,
                   const float* scal, const float* gm, const float* gv,
                   const float* Kin, float* dX, float* out, float* part,
                   int nblk, int64_t B, int M, int Dx, int Do,
                   cudaStream_t stream) {
  constexpr int TB = RT * kWarps;
  const size_t smem = smem_bytes(RT, M, Do);
  cudaError_t err = cudaFuncSetAttribute(
      fused_conditional_bwd_kernel<RT, kSaved>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t ntiles = (B + TB - 1) / TB;
  const int64_t E = partial_floats(M, Dx, Do);
  fused_conditional_bwd_kernel<RT, kSaved>
      <<<nblk, kThreads, smem, stream>>>(Xs, Zs, LiT, LiTT, alpha, W, scal,
                                         gm, gv, Kin, dX, part, E, B, M, Dx,
                                         Do, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int64_t rblocks = (E + 255) / 256;
  if (rblocks > 4096) rblocks = 4096;
  sum_partials_kernel<<<(unsigned)rblocks, 256, 0, stream>>>(part, out, E,
                                                            nblk);
  return cudaGetLastError();
}

template <bool kSaved>
cudaError_t launch_rows(const float* Xs, const float* Zs, const float* LiT,
                        const float* LiTT, const float* alpha,
                        const float* W, const float* scal, const float* gm,
                        const float* gv, const float* Kin, float* dX,
                        float* out, float* part, int nblk, int64_t B, int M,
                        int Dx, int Do, cudaStream_t s) {
  if (rows_per_warp(M, Do) == 8)
    return launch<8, kSaved>(Xs, Zs, LiT, LiTT, alpha, W, scal, gm, gv, Kin,
                             dX, out, part, nblk, B, M, Dx, Do, s);
  return launch<4, kSaved>(Xs, Zs, LiT, LiTT, alpha, W, scal, gm, gv, Kin,
                           dX, out, part, nblk, B, M, Dx, Do, s);
}

}  // namespace

// Floats of scratch the backward needs for this shape on the current
// device (0 if the shape is not supported).
extern "C" int64_t fused_conditional_bwd_scratch(int64_t B, int M, int Dx,
                                                 int Do) {
  if (B <= 0 || M <= 0 || M > kMaxM || Dx <= 0 || Do <= 0) return 0;
  return (int64_t)grid_blocks(B, M, Dx, Do) * partial_floats(M, Dx, Do);
}

// Plain C entry point (bound with ctypes).  Pointers are device pointers
// to contiguous float32 tensors: the forward's inputs, LiTT = LiT^T, scal =
// (kvar, kdiag), the cotangents gm, gv (B, Do), Kin the saved (B, M) gram
// or null (then K is recomputed), dX (B, Dx), out the Do*M*M + M*M + M*Do
// + M*Dx floats of (dW, dLiT, dalpha, dZ), and part the scratch of
// scratch_floats floats (fused_conditional_bwd_scratch).  Launches the row
// pass and the fixed-order sum of its partials on `stream`.  Returns a
// cudaError_t code (0 = launched).
extern "C" int fused_conditional_bwd(const float* Xs, const float* Zs,
                                     const float* LiT, const float* LiTT,
                                     const float* alpha, const float* W,
                                     const float* scal, const float* gm,
                                     const float* gv, const float* Kin,
                                     float* dX, float* out, float* part,
                                     int64_t scratch_floats, int64_t B,
                                     int M, int Dx, int Do, void* stream) {
  if (B <= 0 || M <= 0 || M > kMaxM || Dx <= 0 || Do <= 0 ||
      rows_per_warp(M, Do) == 0)
    return (int)cudaErrorInvalidValue;
  const int nblk = grid_blocks(B, M, Dx, Do);
  if (nblk <= 0 || (int64_t)nblk * partial_floats(M, Dx, Do) > scratch_floats)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Kin != nullptr)
    return (int)launch_rows<true>(Xs, Zs, LiT, LiTT, alpha, W, scal, gm, gv,
                                  Kin, dX, out, part, nblk, B, M, Dx, Do, s);
  return (int)launch_rows<false>(Xs, Zs, LiT, LiTT, alpha, W, scal, gm, gv,
                                 nullptr, dX, out, part, nblk, B, M, Dx, Do,
                                 s);
}
