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
// break the fp32 contract of the conversion anyway.  What keeps a plain
// walk from that rate is the shared-memory loads that feed the FMAs: on
// the H100 a warp's 16-byte broadcast load takes the SM's load pipe
// longer than a 4-byte one but far less than four of them, so the FMAs a
// loaded weight feeds, and the latency around each load, set the rate.
//
// Design (the launch plan is in mlp_plan.h):
//  * A block is G <= 8 consecutive neurons x a tile of rows; warp k owns
//    neuron k, so every weight load is a broadcast within the warp.
//  * Each warp copies its neuron's packed weights 16 bytes at a time
//    (cp.async) and spreads them into rows padded to 4 floats with the
//    bias as the row after (spread_weights, shared with the training
//    forward K4), so the walk (subnet_forward / dense4, also K4's) reads
//    each weight as one 16-byte broadcast.
//  * A thread carries R rows (a template argument, R = 1, 2, 4) through
//    the walk together, so each 16-byte broadcast feeds 4R FMAs.  More
//    rows cost registers (R = 4 takes most of them: 8 warps per SM), so
//    the plan takes R = 4 where the rows fill the card and fewer where
//    they do not; R = 4 exists for NMAX <= 16 only, its state would not
//    fit at 32.
//  * Within a sub-layer the walk has no branch: it reads 4 rows (an
//    input of at most 4) or all NMAX rows, every column, and drops what
//    lies past the sub-layer's widths, so the loads run ahead of the
//    FMAs that use them (the block's shared memory holds at least NMAX
//    floats after each warp's weights: the next warp's, or the input
//    tile).
//  * The block's inputs (each row's G x F floats are contiguous in the
//    (T, O, F) input) come into shared memory through coalesced 4-byte
//    cp.async copies, and its outputs leave through a shared tile whose
//    rows of G floats the warps store together, so global traffic moves
//    in whole sectors instead of 4-12 useful bytes of each.
//  * The hidden state stays in registers: arrays of a compile-time
//    maximum width NMAX (8, 16 or 32), indexed only inside fully
//    unrolled loops.  Widths, depth and skip period are runtime values
//    in a record that every block copies into shared memory, so one
//    build serves every geometry.
//  * fp32 FMAs on the CUDA cores; each dense layer sums its products
//    first, in input order, and adds the bias last, as the reference
//    einsum does.  Rows past a sub-layer's inputs add exact zeros, so the
//    result is the old one-thread-per-pair kernel's, bit for bit, and
//    does not depend on R or the tile.
//  * Ragged edges are masked: rows past T and neurons past O are never
//    loaded or stored.
#include "mlp_plan.h"
#include "subnet_geom.cuh"

template <int NMAX, int R>
__global__ void __launch_bounds__(REPRO_MLP_THREADS, 1)
grouped_subnet_kernel(const float* __restrict__ xg,
                      const float* __restrict__ wpack,
                      float* __restrict__ out, int T, int O, MlpTile tl,
                      GeomRecord geom) {
  extern __shared__ __align__(16) float smem[];
  int* sg = reinterpret_cast<int*>(smem);
  copy_geom(geom, sg);
  __syncthreads();
  const int G = tl.G, k = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o0 = blockIdx.x * G, t0 = blockIdx.y * tl.rows;
  const int gv = min(G, O - o0), rv = min(tl.rows, T - t0);
  const int F = sub_rec(sg, 0)[SU_NIN], pstride = sg[GH_PSTRIDE];
  float* w = smem + REPRO_GEOM_INTS + k * tl.wfl;
  float* xs = smem + tl.xoff;
  float* zs = smem + tl.zoff;
  const bool active = k < gv;
  const bool staged = tl.flags & TF_STAGED;
  const float* wsrc = wpack + (size_t)(o0 + k) * pstride;
  float* raw = zs + k * tl.raw;
  if (active && staged) issue_weights(raw, wsrc, sg);
  {
    // row r of the tile: the G neurons' F inputs, contiguous
    const int n = gv * F;
    const float* src = xg + ((size_t)t0 * O + o0) * F;
    for (int r = k; r < rv; r += G)
      for (int j = lane; j < n; j += 32)
        cp_async4(xs + r * tl.xld + j, src + (size_t)r * O * F + j);
  }
  cp_async_wait();
  __syncwarp();
  // two call sites, so that each load's state space stays known
  if (active && staged) spread_weights(w, weights_raw(raw, wsrc), sg);
  if (active && !staged) spread_weights(w, wsrc, sg);
  __syncthreads();   // the input tile is in; the raw rows are spread

  if (active) {
    const float* x = xs + k * F;
    for (int r0 = lane; r0 < rv; r0 += 32 * R) {
      float h[R][NMAX];
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int r = r0 + 32 * m;
#pragma unroll
        for (int j = 0; j < NMAX; ++j)
          h[m][j] = (r < rv && j < F) ? x[r * tl.xld + j] : 0.f;
      }
      subnet_forward<NMAX, R>(sg, w, h,
                              [](int, const float (&)[R][NMAX]) {});
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int r = r0 + 32 * m;
        if (r < rv) zs[r * tl.yld + k] = h[m][0];
      }
    }
  }
  __syncthreads();
  // rows of gv floats: lane (dr, c) takes column c of row dr of the
  // 32 / 2^glog rows a warp stores at a time
  const int c = lane & ((1 << tl.glog) - 1), dr = lane >> tl.glog;
  const int step = G << (5 - tl.glog);
  if (c < gv)
    for (int r = (k << (5 - tl.glog)) + dr; r < rv; r += step)
      out[(size_t)(t0 + r) * O + o0 + c] = zs[r * tl.yld + c];
}

// The largest R instantiated at NMAX: the state of R rows (about 3 x
// NMAX x R floats) stays within the registers, with no spills.
template <int NMAX>
constexpr int max_rows_per_thread() {
  return NMAX <= 16 ? 4 : 1;
}

template <int NMAX, int R>
static int func_regs(int* regs) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a,
                                              grouped_subnet_kernel<NMAX, R>);
  *regs = a.numRegs;
  return (int)e;
}

// The registers of each R's instantiation for NMAX (0: none) and the
// card's SM count, as mlp_plan takes them.
template <int NMAX>
static int card_facts(int device, int regs[3], int* sms) {
  int e = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                      device);
  if (e) return e;
  regs[1] = regs[2] = 0;
  if ((e = func_regs<NMAX, 1>(regs))) return e;
  if constexpr (max_rows_per_thread<NMAX>() >= 2)
    if ((e = func_regs<NMAX, 2>(regs + 1))) return e;
  if constexpr (max_rows_per_thread<NMAX>() >= 4)
    e = func_regs<NMAX, 4>(regs + 2);
  return e;
}

template <int NMAX, int R>
static int launch(const float* xg, const float* wpack, float* out, int T,
                  int O, const MlpPlan& p, cudaStream_t stream) {
  const int e = repro_allow_smem(grouped_subnet_kernel<NMAX, R>, p.smem);
  if (e) return e;
  const dim3 grid(p.grid_x, p.grid_y);
  grouped_subnet_kernel<NMAX, R><<<grid, 32 * p.tile.G, p.smem, stream>>>(
      xg, wpack, out, T, O, p.tile, p.geom);
  return (int)cudaGetLastError();
}

template <int NMAX>
static int plan_and_launch(int device, const float* xg, const float* wpack,
                           float* out, int T, int O, const SubnetGeom& g,
                           int nmax, const int* force, cudaStream_t stream,
                           long long* words) {
  int regs[3], sms = 0;
  int e = card_facts<NMAX>(device, regs, &sms);
  if (e) return e;
  MlpPlan p;
  if ((e = mlp_plan(g, nmax, T, O, sms, regs, force, &p))) return e;
  if (words) {   // the plan alone
    mlp_plan_words(p, words);
    words[MP_WORDS] = regs[p.tile.R == 1 ? 0 : p.tile.R == 2 ? 1 : 2];
    return 0;
  }
  if constexpr (max_rows_per_thread<NMAX>() >= 4)
    if (p.tile.R == 4) return launch<NMAX, 4>(xg, wpack, out, T, O, p, stream);
  if constexpr (max_rows_per_thread<NMAX>() >= 2)
    if (p.tile.R == 2) return launch<NMAX, 2>(xg, wpack, out, T, O, p, stream);
  return launch<NMAX, 1>(xg, wpack, out, T, O, p, stream);
}

static int dispatch(int device, const float* xg, const float* wpack,
                    float* out, int T, int O, const SubnetGeom& g, int nmax,
                    const int* force, void* stream, long long* words) {
  if (T < 1 || O < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if (nmax <= 8)
    return plan_and_launch<8>(device, xg, wpack, out, T, O, g, nmax,
                              force, s, words);
  if (nmax <= 16)
    return plan_and_launch<16>(device, xg, wpack, out, T, O, g, nmax,
                               force, s, words);
  if (nmax <= 32)
    return plan_and_launch<32>(device, xg, wpack, out, T, O, g, nmax,
                               force, s, words);
  return (int)cudaErrorInvalidValue;
}

// widths: nlayers + 1 ints (F, N, ..., N, 1).  The packed weights of a
// neuron are, in order, every layer's w then b, then every skip chunk's
// w then b; pstride must equal their total.  force: NULL, or {R,
// neurons per block, rows per block} instead of the plan's choice (0:
// the plan's).
extern "C" int repro_grouped_subnet(int device, const float* xg,
                                    const float* wpack, float* out, int T,
                                    int O, int pstride, int nlayers,
                                    const int* widths, int skip,
                                    const int* force, void* stream) {
  SubnetGeom g;
  int nmax = 0;
  const int rc = repro_subnet_geom(nlayers, widths, skip, pstride, &g, &nmax);
  if (rc) return rc;
  return dispatch(device, xg, wpack, out, T, O, g, nmax, force, stream,
                  nullptr);
}

// The plan repro_grouped_subnet would launch on this card, into
// out[MP_WORDS + 1] (the last word: the chosen kernel's registers).
extern "C" int repro_grouped_subnet_launch_plan(int device, int T, int O,
                                                int nlayers,
                                                const int* widths, int skip,
                                                const int* force,
                                                long long* out) {
  SubnetGeom g;
  int nmax = 0;
  const int rc = repro_subnet_layout(nlayers, widths, skip, &g, &nmax);
  if (rc) return rc;
  return dispatch(device, nullptr, nullptr, nullptr, T, O, g, nmax, force,
                  nullptr, out);
}
