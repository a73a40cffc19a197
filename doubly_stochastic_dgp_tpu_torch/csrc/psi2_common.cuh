// Helpers shared by the psi2 data-sum kernels (psi2.cu: forward,
// psi2_bwd.cu: backward), for sm_90a.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace psi2 {

// the kernels' limits (the JAX kernel's _MAX_M, _MAX_D)
constexpr int kMaxD = 32;
constexpr int kMaxM = 512;

// One step of Kahan's compensated sum: sum += x, the rounding error kept
// in comp.
__device__ __forceinline__ void kahan_add(float& sum, float& comp, float x) {
  const float y = x - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

}  // namespace psi2
