// Geometry and the dense layer shared by the grouped sub-network kernels
// (neuralut_mlp.cu: inference; neuralut_grad.cu: training forward and
// backward).
//
// A neuron's parameters are packed by the wrapper into one row of
// pstride floats: every layer's w (n_l x n_{l+1}, row-major) then b
// (n_{l+1}), then every skip chunk's w then b.  The offsets below walk
// that row.  Widths, depth and skip period are runtime values, so one
// build serves every geometry; register arrays are sized by a
// compile-time maximum width NMAX and indexed only inside fully
// unrolled loops, with the runtime widths as guards.
#pragma once
#include <cuda_runtime.h>

#define REPRO_MAX_DEPTH 16

struct SubnetGeom {
  int nlayers;
  int skip;
  int pstride;                      // floats of packed weights per neuron
  int width[REPRO_MAX_DEPTH + 1];   // n_0 = F, ..., n_L = 1
  int w_off[REPRO_MAX_DEPTH];       // layer l: w (n_l, n_{l+1}) row-major
  int b_off[REPRO_MAX_DEPTH];       //          b (n_{l+1})
  int sw_off[REPRO_MAX_DEPTH];      // skip chunk c: w, then b
  int sb_off[REPRO_MAX_DEPTH];
};

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

// Fill g from (nlayers, widths, skip) and check that pstride equals the
// packed row's length.  Returns 0 or a cudaError_t; *nmax gets the
// largest width.
static inline int repro_subnet_geom(int nlayers, const int* widths,
                                    int skip, int pstride, SubnetGeom* g,
                                    int* nmax) {
  if (nlayers < 1 || nlayers > REPRO_MAX_DEPTH || skip < 0 ||
      (skip > 0 && nlayers % skip)) {
    return (int)cudaErrorInvalidValue;
  }
  g->nlayers = nlayers;
  g->skip = skip;
  g->pstride = pstride;
  *nmax = 0;
  for (int l = 0; l <= nlayers; ++l) {
    if (widths[l] < 1) return (int)cudaErrorInvalidValue;
    g->width[l] = widths[l];
    *nmax = widths[l] > *nmax ? widths[l] : *nmax;
  }
  int off = 0;
  for (int l = 0; l < nlayers; ++l) {
    g->w_off[l] = off;
    off += g->width[l] * g->width[l + 1];
    g->b_off[l] = off;
    off += g->width[l + 1];
  }
  for (int c = 0; skip > 0 && c < nlayers / skip; ++c) {
    const int l0 = c * skip;
    g->sw_off[c] = off;
    off += g->width[l0] * g->width[l0 + skip];
    g->sb_off[c] = off;
    off += g->width[l0 + skip];
  }
  return off == pstride ? 0 : (int)cudaErrorInvalidValue;
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
static inline int repro_allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}
