// Device code shared by the grouped sub-network kernels (neuralut_mlp.cu:
// inference, K2; neuralut_grad.cu: training forward K4 and backward K5):
// the copies into shared memory, the spread of a neuron's packed weights
// into padded rows, and the forward walk through its MLP.
//
// The packed weights' geometry and its compact record (GH_*, SU_*) are
// in subnet_geom.h.  Widths, depth and skip period are runtime values,
// so one build serves every geometry; register arrays are sized by a
// compile-time maximum width NMAX and indexed only inside fully
// unrolled loops, with the runtime widths as guards.
#pragma once
#include <cuda_runtime.h>

#include "subnet_geom.h"

static_assert(REPRO_EINVAL == (int)cudaErrorInvalidValue,
              "the host geometry's error code is cudaErrorInvalidValue");

__device__ __forceinline__ const int* sub_rec(const int* g, int u) {
  return g + GH_WORDS + u * SU_WORDS;
}

// The used part of the geometry record into shared memory.
__device__ __forceinline__ void copy_geom(const GeomRecord& geom, int* sg) {
  const int used = geom.w[GH_USED];
  for (int k = threadIdx.x; k < used; k += blockDim.x) sg[k] = geom.w[k];
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Wait for this thread's cp.async copies.
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// x / d from d's divisor m = ceil(2^32 / d) (0 for d = 1), made on the
// host (udiv_magic): one multiply instead of a division, exact for x *
// (d - 1) < 2^32 (the callers' x < 2^16 with d <= 2^11; K1's items of a
// tile with d = O, which its wrapper bounds).
__device__ __forceinline__ int udiv(int x, int m) {
  return m ? (int)__umulhi((unsigned)x, (unsigned)m) : x;
}

// Rows of n <= 32 contiguous floats, moved by one warp: lane (dr, j)
// takes row r0 + dr of 32 / n rows per step, column j.  m: n's divisor.
struct RowLanes {
  int rpi, dr, j;
  __device__ __forceinline__ RowLanes(int n, int m) {
    const int lane = threadIdx.x & 31;
    rpi = udiv(32, m);
    dr = udiv(lane, m);
    j = lane - dr * n;
  }
  __device__ __forceinline__ bool on(int r0, int rows) const {
    return dr < rpi && r0 + dr < rows;
  }
};

// The warp's neuron's packed row (pstride floats at src) as it is into
// the warp's scratch (pstride + 3 floats, 16-byte aligned), 16 bytes at
// a time: raw[e] = src[e] with raw 16-byte aligned where src is.
// Asynchronous: the warp waits (cp_async_wait, __syncwarp) and then
// spreads the row out (spread_weights).
__device__ __forceinline__ float* weights_raw(float* scratch,
                                              const float* src) {
  return scratch + (int)((reinterpret_cast<size_t>(src) >> 2) & 3);
}
__device__ __forceinline__ void issue_weights(float* __restrict__ scratch,
                                              const float* __restrict__ src,
                                              const int* sg) {
  const int lane = threadIdx.x & 31, pstride = sg[GH_PSTRIDE];
  float* raw = weights_raw(scratch, src);
  const int head = min((4 - (int)(raw - scratch)) & 3, pstride);
  const int nvec = (pstride - head) / 4, tail = head + 4 * nvec;
  if (lane < head) cp_async4(raw + lane, src + lane);
  for (int v = lane; v < nvec; v += 32)
    cp_async16(raw + head + 4 * v, src + head + 4 * v);
  if (tail + lane < pstride && lane < 4)
    cp_async4(raw + tail + lane, src + tail + lane);
}

// The copied row into the padded layout w, 8 rows of a sub-layer per
// lane loaded before any is stored.  Ends with the warp in step.
__device__ __forceinline__ void spread_weights(float* __restrict__ w,
                                               const float* __restrict__ raw,
                                               const int* sg) {
  const int nsub = sg[GH_NL] + sg[GH_NCH];
  for (int u = 0; u < nsub; ++u) {
    const int* su = sub_rec(sg, u);
    const int nin = su[SU_NIN], nout = su[SU_NOUT], ldo = su[SU_LDO];
    const RowLanes rl(ldo, su[SU_MLDO]);
    float* d = w + su[SU_PAD] + rl.j;
    const float* r = raw + su[SU_PK] + rl.j;
    for (int p0 = 0; p0 <= nin; p0 += 8 * rl.rpi) {
      float v[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int p = p0 + m * rl.rpi;
        v[m] = rl.on(p, nin + 1) && rl.j < nout ? r[(p + rl.dr) * nout]
                                                 : 0.f;
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int p = p0 + m * rl.rpi;
        if (rl.on(p, nin + 1)) d[(p + rl.dr) * ldo] = v[m];
      }
    }
  }
  __syncwarp();
}

// acc += h @ w over rows 0 .. NI-1 of w (nin, ldo), padded row-major
// with its bias row after it, every NMAX columns of each row: a row past
// nin reads the (finite) bias row and h is 0 there, so it adds exact
// zeros; columns past nout read on into the next rows (the callers'
// shared memory holds at least NMAX floats past the last row), and the
// caller drops them.  Straight-line code with no branch, so the loads
// can run ahead of the multiply-adds that use them; each 16-byte load
// feeds 4R of them.
template <int NMAX, int R, int NI>
__device__ __forceinline__ void dense_rows(const float (&h)[R][NMAX],
                                           float (&acc)[R][NMAX],
                                           const float* __restrict__ w,
                                           int nin, int ldo) {
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const float4* wr = reinterpret_cast<const float4*>(w + min(i, nin) * ldo);
#pragma unroll
    for (int j = 0; j < NMAX; j += 4) {
      const float4 v = wr[j / 4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float hi = h[r][i];
        acc[r][j] = fmaf(hi, v.x, acc[r][j]);
        acc[r][j + 1] = fmaf(hi, v.y, acc[r][j + 1]);
        acc[r][j + 2] = fmaf(hi, v.z, acc[r][j + 2]);
        acc[r][j + 3] = fmaf(hi, v.w, acc[r][j + 3]);
      }
    }
  }
}

// The same for a single output: its column, one load per row.
template <int NMAX, int R, int NI>
__device__ __forceinline__ void dense_col(const float (&h)[R][NMAX],
                                          float (&acc)[R][NMAX],
                                          const float* __restrict__ w,
                                          int nin, int ldo) {
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const float v = w[min(i, nin) * ldo];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = fmaf(h[r][i], v, acc[r][0]);
  }
}

// y = h @ w + b for R rows: the products summed first, in input order,
// the bias added last, as the reference einsum does; y is 0 past nout.
// Rows walked: 4 for an input of at most 4 (a first layer, a first
// skip), else NMAX; a single output (the last layer, a last skip) walks
// its column.
template <int NMAX, int R>
__device__ __forceinline__ void dense4(const float (&h)[R][NMAX],
                                       float (&y)[R][NMAX],
                                       const float* __restrict__ w, int nin,
                                       int nout, int ldo) {
  float acc[R][NMAX];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < NMAX; ++j) acc[r][j] = 0.f;
  if (nout == 1) {
    if (nin <= 4) {
      dense_col<NMAX, R, 4>(h, acc, w, nin, ldo);
    } else {
      dense_col<NMAX, R, NMAX>(h, acc, w, nin, ldo);
    }
    const float b = w[nin * ldo];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      y[r][0] = acc[r][0] + b;
#pragma unroll
      for (int j = 1; j < NMAX; ++j) y[r][j] = 0.f;
    }
    return;
  }
  if (nin <= 4) {
    dense_rows<NMAX, R, 4>(h, acc, w, nin, ldo);
  } else {
    dense_rows<NMAX, R, NMAX>(h, acc, w, nin, ldo);
  }
  const float4* b = reinterpret_cast<const float4*>(w + nin * ldo);
  if (nout == NMAX) {   // no column to drop: no select
#pragma unroll
    for (int j = 0; j < NMAX; j += 4) {
      const float4 v = b[j / 4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        y[r][j] = acc[r][j] + v.x;
        y[r][j + 1] = acc[r][j + 1] + v.y;
        y[r][j + 2] = acc[r][j + 2] + v.z;
        y[r][j + 3] = acc[r][j + 3] + v.w;
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < NMAX; j += 4) {
    const float4 v = b[j / 4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      y[r][j] = j < nout ? acc[r][j] + v.x : 0.f;
      y[r][j + 1] = j + 1 < nout ? acc[r][j + 1] + v.y : 0.f;
      y[r][j + 2] = j + 2 < nout ? acc[r][j + 2] + v.z : 0.f;
      y[r][j + 3] = j + 3 < nout ? acc[r][j + 3] + v.w : 0.f;
    }
  }
}

// R rows through the neuron's MLP with skip chunks, weights spread at w
// (spread_weights): h[r] holds the row's F inputs (0 past F) and comes
// back with the output in h[r][0].  Chunks of `skip` layers after their
// skip sub-layer (q = -1), or of one layer and no skip when skip = 0;
// ReLU between layers and between chunks.  Every sub-layer reads h: the
// skip sub-layer runs first on the chunk's input, then the chunk's
// layers each replace h.  save(l, h) sees the input of every layer l >=
// 1 (K4 stores it), before the layer runs.
template <int NMAX, int R, class Save>
__device__ __forceinline__ void subnet_forward(const int* sg,
                                               const float* __restrict__ w,
                                               float (&h)[R][NMAX],
                                               Save save) {
  const int nl = sg[GH_NL], skip = sg[GH_SKIP];
  float res[R][NMAX], y[R][NMAX];
  const int cs = skip ? skip : 1, nc = skip ? sg[GH_NCH] : nl;
  for (int c = 0; c < nc; ++c) {
    for (int q = skip ? -1 : 0; q < cs; ++q) {
      const int l = c * cs + q;
      if (q >= 0 && l > 0) save(l, h);
      const int* su = sub_rec(sg, q < 0 ? nl + c : l);
      dense4<NMAX, R>(h, y, w + su[SU_PAD], su[SU_NIN], su[SU_NOUT],
                      su[SU_LDO]);
      if (q < 0) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < NMAX; ++j) res[r][j] = y[r][j];
      } else if (q < cs - 1) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < NMAX; ++j) h[r][j] = fmaxf(y[r][j], 0.f);
      } else {   // the chunk's end: its skip added, ReLU unless last
        if (skip) {
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int j = 0; j < NMAX; ++j) y[r][j] = y[r][j] + res[r][j];
        }
        const bool act = c < nc - 1;
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < NMAX; ++j)
            h[r][j] = act ? fmaxf(y[r][j], 0.f) : y[r][j];
      }
    }
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
static inline int repro_allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}
