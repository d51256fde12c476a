// Geometry and the dense layer shared by the grouped sub-network kernels
// (neuralut_mlp.cu: inference; neuralut_grad.cu: training forward and
// backward).
//
// The packed weights' geometry (SubnetGeom, repro_subnet_geom) is in
// subnet_geom.h.  Widths, depth and skip period are runtime values, so
// one build serves every geometry; register arrays are sized by a
// compile-time maximum width NMAX and indexed only inside fully
// unrolled loops, with the runtime widths as guards.
#pragma once
#include <cuda_runtime.h>

#include "subnet_geom.h"

static_assert(REPRO_EINVAL == (int)cudaErrorInvalidValue,
              "the host geometry's error code is cudaErrorInvalidValue");

// y = h @ w + b for one row: the products summed first, the bias added
// last, as the reference einsum does.
template <int NMAX>
__device__ __forceinline__ void dense(const float (&h)[NMAX],
                                      float (&y)[NMAX],
                                      const float* __restrict__ w,
                                      const float* __restrict__ b,
                                      int nin, int nout) {
  float acc[NMAX];
#pragma unroll
  for (int j = 0; j < NMAX; ++j) acc[j] = 0.f;
#pragma unroll
  for (int i = 0; i < NMAX; ++i) {
    if (i < nin) {
      const float hi = h[i];
      const float* wr = w + i * nout;
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        if (j < nout) acc[j] = fmaf(hi, wr[j], acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NMAX; ++j) y[j] = (j < nout) ? acc[j] + b[j] : 0.f;
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
static inline int repro_allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}
