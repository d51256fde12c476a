// Grouped sub-network evaluation for Hopper (sm_90a): every (code row,
// neuron) pair through its neuron's L-layer ReLU MLP with skip chunks.
//
// Replaces the Pallas kernel src/repro/kernels/neuralut_mlp.py
// (grouped_subnet, body _kernel), which the converter runs through
// ops.subnet_kernel_apply (route kernel_infer).
//
// What bounds it on the card: fp32 operations.  A jsc-5l neuron does
// 608-640 multiply-adds per code on 2-16 inputs; at conversion the five
// layers do about 4.3 GFLOP on ~30 MB of inputs, so the 67 TFLOP/s fp32
// rate of the CUDA cores, not HBM, is the bound.  The widths (F <= 6,
// N <= 32) are far too small to fill a tensor-core tile, and TF32 would
// break the fp32 contract of the conversion anyway.
//
// Design:
//  * One thread per (code row, neuron); a block is 256 rows of one
//    neuron (grid.x = neuron, grid.y = row tile), so consecutive blocks
//    share the rows' cache lines in L2.
//  * The neuron's weights (~640 floats at N=16, packed per neuron with
//    offsets by the wrapper) are staged once per block in shared memory;
//    every thread reads the same word at a time, a broadcast.
//  * The hidden state stays in registers: arrays of a compile-time
//    maximum width NMAX (8, 16 or 32), indexed only inside fully
//    unrolled loops, with the runtime widths as guards.  Widths, depth
//    and skip period are runtime arguments, so one build serves every
//    geometry.
//  * fp32 FMAs on the CUDA cores; each dense layer sums its products
//    first and adds the bias last, as the reference einsum does.
//  * Ragged edges are masked: rows past T return after the weight load.
#include "subnet_geom.cuh"

#define REPRO_SUBNET_THREADS 256

template <int NMAX>
__global__ void __launch_bounds__(REPRO_SUBNET_THREADS)
grouped_subnet_kernel(const float* __restrict__ xg,
                      const float* __restrict__ wpack,
                      float* __restrict__ out, int T, int O,
                      SubnetGeom g) {
  extern __shared__ float sw[];
  const int o = blockIdx.x;
  const float* src = wpack + (size_t)o * g.pstride;
  for (int k = threadIdx.x; k < g.pstride; k += blockDim.x) sw[k] = src[k];
  __syncthreads();
  const int t = blockIdx.y * blockDim.x + threadIdx.x;
  if (t >= T) return;

  const int F = g.width[0];
  const float* x = xg + ((size_t)t * O + o) * F;
  float h[NMAX], a[NMAX], r[NMAX], z[NMAX];
#pragma unroll
  for (int i = 0; i < NMAX; ++i) h[i] = (i < F) ? x[i] : 0.f;

  if (g.skip == 0) {
    for (int l = 0; l < g.nlayers; ++l) {
      dense<NMAX>(h, a, sw + g.w_off[l], sw + g.b_off[l], g.width[l],
                  g.width[l + 1]);
      const bool act = l < g.nlayers - 1;
#pragma unroll
      for (int j = 0; j < NMAX; ++j) h[j] = act ? fmaxf(a[j], 0.f) : a[j];
    }
  } else {
    const int nch = g.nlayers / g.skip;
    for (int c = 0; c < nch; ++c) {
      const int l0 = c * g.skip;
      dense<NMAX>(h, r, sw + g.sw_off[c], sw + g.sb_off[c], g.width[l0],
                  g.width[l0 + g.skip]);
#pragma unroll
      for (int j = 0; j < NMAX; ++j) a[j] = h[j];
      for (int s = 0; s < g.skip; ++s) {
        const int l = l0 + s;
        dense<NMAX>(a, z, sw + g.w_off[l], sw + g.b_off[l], g.width[l],
                    g.width[l + 1]);
        const bool act = s < g.skip - 1;
#pragma unroll
        for (int j = 0; j < NMAX; ++j) a[j] = act ? fmaxf(z[j], 0.f) : z[j];
      }
      const bool act = c < nch - 1;
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        const float v = a[j] + r[j];
        h[j] = act ? fmaxf(v, 0.f) : v;
      }
    }
  }
  out[(size_t)t * O + o] = h[0];
}

template <int NMAX>
static int launch(const float* xg, const float* wpack, float* out, int T,
                  int O, const SubnetGeom& g, cudaStream_t stream) {
  const size_t smem = (size_t)g.pstride * sizeof(float);
  const int e = repro_allow_smem(grouped_subnet_kernel<NMAX>, smem);
  if (e) return e;
  const dim3 grid(O, (T + REPRO_SUBNET_THREADS - 1) / REPRO_SUBNET_THREADS);
  grouped_subnet_kernel<NMAX><<<grid, REPRO_SUBNET_THREADS, smem, stream>>>(
      xg, wpack, out, T, O, g);
  return (int)cudaGetLastError();
}

// widths: nlayers + 1 ints (F, N, ..., N, 1).  The packed weights of a
// neuron are, in order, every layer's w then b, then every skip chunk's
// w then b; pstride must equal their total.
extern "C" int repro_grouped_subnet(int device, const float* xg,
                                    const float* wpack,
                                    float* out, int T, int O, int pstride,
                                    int nlayers, const int* widths,
                                    int skip, void* stream) {
  if (T < 1 || O < 1) return (int)cudaErrorInvalidValue;
  SubnetGeom g;
  int nmax = 0;
  int rc = repro_subnet_geom(nlayers, widths, skip, pstride, &g, &nmax);
  if (rc) return rc;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if (nmax <= 8) return launch<8>(xg, wpack, out, T, O, g, s);
  if (nmax <= 16) return launch<16>(xg, wpack, out, T, O, g, s);
  if (nmax <= 32) return launch<32>(xg, wpack, out, T, O, g, s);
  return (int)cudaErrorInvalidValue;
}
