// Training forward (K4) and backward (K5) of the grouped sub-network for
// Hopper (sm_90a): every (batch row, neuron) pair through its neuron's
// L-layer ReLU MLP with skip chunks, and back.
//
// Replaces the Pallas kernels of src/repro/kernels/neuralut_grad.py:
// _forward (body _fwd_kernel) and _backward (body _bwd_kernel), which
// the reference's training step runs through subnet_train_op on the
// kernel_train route.
//
// What bounds them on the card: bytes.  At jsc-5l, B = 256, the forward
// does ~73 M multiply-adds over the five layers and writes the input of
// every sub-layer i >= 1 (256 rows x 453 neurons x 3 x 16 floats,
// ~22 MB); the backward reads those activations back and does about
// twice the forward's arithmetic.  22 MB over 3.35 TB/s is ~6.6 us,
// against ~2.2 us (forward) and ~4.4 us (backward) of fp32 work at
// 67 TFLOP/s.  The widths (F <= 6, N <= 32) are far below a tensor-core
// tile, and TF32 would break the fp32 contract of training parity.
//
// Design (simple and deterministic first; no wgmma, no TMA):
//  * K4 is the inference kernel (neuralut_mlp.cu) plus stores: one
//    thread per (row, neuron), the neuron's ~700 weights in shared
//    memory read as a broadcast, the hidden state in registers.  It
//    stores the post-ReLU input of sub-layers 1 .. L-1 to `acts`, one
//    (T, O, n_i) block per sub-layer: the reference's layout, so the
//    wrapper hands out views of one buffer.  Stores are per thread
//    contiguous (n_i floats, whole 32-byte sectors at n_i = 16).
//  * K5 gives each block one neuron and a tile of ROWS rows.  Each
//    thread walks its row's cotangent back through the layers in
//    registers, reloading that row's saved activations, and writes dx.
//    For every dense layer the block stages its rows' inputs and
//    cotangents in shared memory and reduces them over the rows in a
//    fixed order (row 0, 1, ..., ROWS-1) into one partial gradient per
//    row tile.  A second small kernel sums the partials over the tiles
//    in a fixed order.  No atomics anywhere, so a rerun on the same
//    inputs is bit-identical.
//  * ReLU masks are recovered from the saved post-ReLU values (a > 0),
//    so the gradient at 0 is 0, as in the reference.
//  * Ragged edges are masked: rows past T load zeros and store nothing,
//    so B and O need not divide any tile (the Pallas kernel requires
//    it).
//  * Gradients come out leaf-major: leaf k (layer w, layer b, ..., skip
//    w, skip b, in the packing order) of neuron o, element e, lives at
//    O * off_k + o * size_k + e, where off_k is the leaf's offset in a
//    packed weight row; the wrapper views each leaf as its own tensor.
//  * A leading seed axis S (the seed ensemble, one network per seed)
//    is gridDim.z: every tensor carries S as its outermost dimension,
//    and block (o, tile, s) works on seed s's rows, weights and
//    gradients.  The kernels treat (s, o) as one of S * O neurons: row
//    (s, t, o) is element (s * T + t) * O + o of the (S, T, O) arrays,
//    the packed weights of (s, o) are row s * O + o, a gradient leaf is
//    an (S, O, ...) block, and the tile partials and their fixed-order
//    sum see S * O neurons.  So the sum stays per seed and in order, and
//    S = 1 is the single-network launch.
#include "subnet_geom.cuh"

#define REPRO_TRAIN_FWD_THREADS 128
#define REPRO_SUM_THREADS 256

struct ActGeom {
  long long off[REPRO_MAX_DEPTH];   // act i (i >= 1) at off[i], (S, T, O, n_i)
};

template <int NMAX>
__device__ __forceinline__ void save_act(float* __restrict__ acts,
                                         const ActGeom& ag,
                                         const SubnetGeom& g, int i,
                                         size_t row, const float (&v)[NMAX]) {
  const int n = g.width[i];
  float* dst = acts + ag.off[i] + row * n;
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    if (j < n) dst[j] = v[j];
  }
}

template <int NMAX>
__global__ void __launch_bounds__(REPRO_TRAIN_FWD_THREADS)
subnet_train_fwd_kernel(const float* __restrict__ xg,
                        const float* __restrict__ wpack,
                        float* __restrict__ out, float* __restrict__ acts,
                        int T, int O, SubnetGeom g, ActGeom ag) {
  extern __shared__ float sw[];
  const int o = blockIdx.x;
  const int s = blockIdx.z;
  const float* src = wpack + ((size_t)s * O + o) * g.pstride;
  for (int k = threadIdx.x; k < g.pstride; k += blockDim.x) sw[k] = src[k];
  __syncthreads();
  const int t = blockIdx.y * blockDim.x + threadIdx.x;
  if (t >= T) return;

  const size_t row = ((size_t)s * T + t) * O + o;
  const int F = g.width[0];
  const float* x = xg + row * F;
  float h[NMAX], a[NMAX], r[NMAX], z[NMAX];
#pragma unroll
  for (int i = 0; i < NMAX; ++i) h[i] = (i < F) ? x[i] : 0.f;

  if (g.skip == 0) {
    for (int l = 0; l < g.nlayers; ++l) {
      if (l > 0) save_act<NMAX>(acts, ag, g, l, row, h);
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
      if (c > 0) save_act<NMAX>(acts, ag, g, l0, row, h);
      dense<NMAX>(h, r, sw + g.sw_off[c], sw + g.sb_off[c], g.width[l0],
                  g.width[l0 + g.skip]);
#pragma unroll
      for (int j = 0; j < NMAX; ++j) a[j] = h[j];
      for (int s = 0; s < g.skip; ++s) {
        const int l = l0 + s;
        if (s > 0) save_act<NMAX>(acts, ag, g, l, row, a);
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
  out[row] = h[0];
}

// ---------------------------------------------------------------------------
// K5

struct BwdCtx {
  const float* xg;
  const float* acts;
  float* grads;        // this tile's leaf-major gradient (S * O * pstride)
  const float* sw;     // the neuron's packed weights (shared)
  float* sa;           // ROWS x (NMAX + 1): the rows' layer inputs
  float* sg;           // ROWS x (NMAX + 1): the rows' output cotangents
  size_t row;          // (s * T + t) * O + o
  int o, O, rows;      // neuron s * O + o of S * O
  bool valid;          // t < T
};

// The input of sub-layer i for this thread's row (zeros past T).
template <int NMAX>
__device__ __forceinline__ void load_in(const BwdCtx& c, const SubnetGeom& g,
                                        const ActGeom& ag, int i,
                                        float (&a)[NMAX]) {
  const int n = g.width[i];
  const float* src = i == 0 ? c.xg + c.row * n : c.acts + ag.off[i] + c.row * n;
#pragma unroll
  for (int j = 0; j < NMAX; ++j) a[j] = (c.valid && j < n) ? src[j] : 0.f;
}

// dW += a^T gm and db += gm over the block's rows, in row order, into
// this tile's gradient at the leaf offsets (w_off, b_off) of a packed
// row.  Every thread of the block must call it.
template <int NMAX>
__device__ __forceinline__ void accumulate(const BwdCtx& c, int nin, int nout,
                                           const float (&a)[NMAX],
                                           const float (&gm)[NMAX],
                                           int w_off, int b_off) {
  constexpr int LD = NMAX + 1;   // padded row: conflict-free staging
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    if (j < nin) c.sa[tid * LD + j] = a[j];
    if (j < nout) c.sg[tid * LD + j] = gm[j];
  }
  __syncthreads();
  const int nw = nin * nout;
  for (int e = tid; e < nw + nout; e += blockDim.x) {
    float acc = 0.f;
    if (e < nw) {
      const int p = e / nout, q = e % nout;
      for (int r = 0; r < c.rows; ++r)
        acc = fmaf(c.sa[r * LD + p], c.sg[r * LD + q], acc);
      c.grads[(size_t)c.O * w_off + (size_t)c.o * nw + e] = acc;
    } else {
      const int q = e - nw;
      for (int r = 0; r < c.rows; ++r) acc += c.sg[r * LD + q];
      c.grads[(size_t)c.O * b_off + (size_t)c.o * nout + q] = acc;
    }
  }
  __syncthreads();
}

// gn = w @ gm (the cotangent of the layer's input), w (nin, nout)
// row-major in shared memory.
template <int NMAX>
__device__ __forceinline__ void back(const float (&gm)[NMAX],
                                     float (&gn)[NMAX],
                                     const float* __restrict__ w, int nin,
                                     int nout) {
#pragma unroll
  for (int i = 0; i < NMAX; ++i) {
    float acc = 0.f;
    if (i < nin) {
      const float* wr = w + i * nout;
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        if (j < nout) acc = fmaf(wr[j], gm[j], acc);
      }
    }
    gn[i] = acc;
  }
}

template <int NMAX>
__global__ void __launch_bounds__(256)
subnet_train_bwd_kernel(const float* __restrict__ gout_in,
                                        const float* __restrict__ xg,
                                        const float* __restrict__ acts,
                                        const float* __restrict__ wpack,
                                        float* __restrict__ dx,
                                        float* __restrict__ part, int T,
                                        int O, SubnetGeom g, ActGeom ag) {
  extern __shared__ float smem[];
  const int o = blockIdx.x;
  const int s = blockIdx.z;
  const int rows = blockDim.x;
  const int so = s * O + o;       // the neuron among S * O
  float* sw = smem;
  const float* src = wpack + (size_t)so * g.pstride;
  for (int k = threadIdx.x; k < g.pstride; k += rows) sw[k] = src[k];
  const int t = blockIdx.y * rows + threadIdx.x;
  BwdCtx c;
  c.xg = xg;
  c.acts = acts;
  c.grads = part + (size_t)blockIdx.y * gridDim.z * O * g.pstride;
  c.sw = sw;
  c.sa = smem + ((g.pstride + 3) & ~3);
  c.sg = c.sa + rows * (NMAX + 1);
  c.row = ((size_t)s * T + t) * O + o;
  c.o = so;
  c.O = gridDim.z * O;
  c.rows = rows;
  c.valid = t < T;
  __syncthreads();

  float gout[NMAX], gm[NMAX], gn[NMAX], a[NMAX];
#pragma unroll
  for (int j = 0; j < NMAX; ++j) gout[j] = 0.f;
  gout[0] = c.valid ? gout_in[c.row] : 0.f;

  if (g.skip == 0) {
#pragma unroll
    for (int j = 0; j < NMAX; ++j) gm[j] = gout[j];
    for (int l = g.nlayers - 1; l >= 0; --l) {
      load_in<NMAX>(c, g, ag, l, a);
      accumulate<NMAX>(c, g.width[l], g.width[l + 1], a, gm, g.w_off[l],
                       g.b_off[l]);
      back<NMAX>(gm, gn, sw + g.w_off[l], g.width[l], g.width[l + 1]);
      const bool mask = l > 0;
#pragma unroll
      for (int j = 0; j < NMAX; ++j)
        gm[j] = (mask && !(a[j] > 0.f)) ? 0.f : gn[j];
    }
  } else {
    float hc[NMAX], ghc[NMAX];
    const int nch = g.nlayers / g.skip;
    for (int ch = nch - 1; ch >= 0; --ch) {
      const int l0 = ch * g.skip;
      load_in<NMAX>(c, g, ag, l0, hc);
      accumulate<NMAX>(c, g.width[l0], g.width[l0 + g.skip], hc, gout,
                       g.sw_off[ch], g.sb_off[ch]);
      back<NMAX>(gout, ghc, sw + g.sw_off[ch], g.width[l0],
                 g.width[l0 + g.skip]);
#pragma unroll
      for (int j = 0; j < NMAX; ++j) gm[j] = gout[j];
      for (int l = l0 + g.skip - 1; l >= l0; --l) {
        load_in<NMAX>(c, g, ag, l, a);
        accumulate<NMAX>(c, g.width[l], g.width[l + 1], a, gm, g.w_off[l],
                         g.b_off[l]);
        back<NMAX>(gm, gn, sw + g.w_off[l], g.width[l], g.width[l + 1]);
        const bool mask = l > l0;
#pragma unroll
        for (int j = 0; j < NMAX; ++j)
          gm[j] = (mask && !(a[j] > 0.f)) ? 0.f : gn[j];
      }
      // inter-chunk ReLU boundary: the chunk's input hc is post-ReLU
      const bool mask = ch > 0;
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        const float v = ghc[j] + gm[j];
        gout[j] = (mask && !(hc[j] > 0.f)) ? 0.f : v;
      }
    }
#pragma unroll
    for (int j = 0; j < NMAX; ++j) gm[j] = gout[j];
  }
  if (c.valid) {
    const int F = g.width[0];
    float* d = dx + c.row * F;
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
      if (j < F) d[j] = gm[j];
    }
  }
}

// out[e] = part[0][e] + part[1][e] + ... in tile order.
__global__ void __launch_bounds__(REPRO_SUM_THREADS)
sum_tiles_kernel(const float* __restrict__ part, float* __restrict__ out,
                 long long n, int ntiles) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < n; e += (long long)gridDim.x * blockDim.x) {
    float s = part[e];
    for (int k = 1; k < ntiles; ++k) s += part[(long long)k * n + e];
    out[e] = s;
  }
}

static void act_geom(const SubnetGeom& g, int S, int T, int O,
                     ActGeom* ag) {
  long long off = 0;
  ag->off[0] = 0;
  for (int i = 1; i < g.nlayers; ++i) {
    ag->off[i] = off;
    off += (long long)S * T * O * g.width[i];
  }
}

template <int NMAX>
static int launch_fwd(const float* xg, const float* wpack, float* out,
                      float* acts, int S, int T, int O, const SubnetGeom& g,
                      const ActGeom& ag, cudaStream_t stream) {
  const size_t smem = (size_t)g.pstride * sizeof(float);
  const int e = repro_allow_smem(subnet_train_fwd_kernel<NMAX>, smem);
  if (e) return e;
  const dim3 grid(O, (T + REPRO_TRAIN_FWD_THREADS - 1) /
                         REPRO_TRAIN_FWD_THREADS, S);
  subnet_train_fwd_kernel<NMAX><<<grid, REPRO_TRAIN_FWD_THREADS, smem,
                                  stream>>>(xg, wpack, out, acts, T, O, g,
                                            ag);
  return (int)cudaGetLastError();
}

template <int NMAX>
static int launch_bwd(const float* gout, const float* xg, const float* acts,
                      const float* wpack, float* dx, float* part,
                      float* grads, int S, int T, int O, int rows,
                      const SubnetGeom& g, const ActGeom& ag,
                      cudaStream_t stream) {
  const size_t smem = (size_t)(((g.pstride + 3) & ~3) +
                               2 * rows * (NMAX + 1)) * sizeof(float);
  int e = repro_allow_smem(subnet_train_bwd_kernel<NMAX>, smem);
  if (e) return e;
  const int ntiles = (T + rows - 1) / rows;
  const dim3 grid(O, ntiles, S);
  subnet_train_bwd_kernel<NMAX><<<grid, rows, smem, stream>>>(
      gout, xg, acts, wpack, dx, ntiles == 1 ? grads : part, T, O, g, ag);
  e = (int)cudaGetLastError();
  if (e || ntiles == 1) return e;
  const long long n = (long long)S * O * g.pstride;
  long long blocks = (n + REPRO_SUM_THREADS - 1) / REPRO_SUM_THREADS;
  if (blocks > 4096) blocks = 4096;
  sum_tiles_kernel<<<(int)blocks, REPRO_SUM_THREADS, 0, stream>>>(
      part, grads, n, ntiles);
  return (int)cudaGetLastError();
}

// S seeds (S = 1: one network).  xg (S, T, O, F), out (S, T, O), the
// packed weights (S, O, pstride) as in neuralut_mlp.cu.  widths:
// nlayers + 1 ints (F, N, ..., N, 1).  acts: the sub-layer inputs
// i = 1 .. nlayers-1, one (S, T, O, n_i) block after another.
extern "C" int repro_subnet_train_fwd(int device, const float* xg,
                                      const float* wpack, float* out,
                                      float* acts, int S, int T, int O,
                                      int pstride, int nlayers,
                                      const int* widths, int skip,
                                      void* stream) {
  if (S < 1 || S > 65535 || T < 1 || O < 1)
    return (int)cudaErrorInvalidValue;
  SubnetGeom g;
  int nmax = 0;
  int rc = repro_subnet_geom(nlayers, widths, skip, pstride, &g, &nmax);
  if (rc) return rc;
  ActGeom ag;
  act_geom(g, S, T, O, &ag);
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  if (nmax <= 8)
    return launch_fwd<8>(xg, wpack, out, acts, S, T, O, g, ag, st);
  if (nmax <= 16)
    return launch_fwd<16>(xg, wpack, out, acts, S, T, O, g, ag, st);
  if (nmax <= 32)
    return launch_fwd<32>(xg, wpack, out, acts, S, T, O, g, ag, st);
  return (int)cudaErrorInvalidValue;
}

// S seeds as in repro_subnet_train_fwd.  gout: (S, T, O) cotangent of
// the output.  dx: (S, T, O, F).  grads: the leaf-major gradient
// (S * O * pstride floats).  rows: rows per block, a multiple of 32 in
// [32, 256]; part: ceil(T / rows) * S * O * pstride floats of scratch
// (unused, may be null, when one tile holds every row).
extern "C" int repro_subnet_train_bwd(int device, const float* gout,
                                      const float* xg, const float* acts,
                                      const float* wpack, float* dx,
                                      float* part, float* grads, int S,
                                      int T, int O, int pstride,
                                      int nlayers, const int* widths,
                                      int skip, int rows, void* stream) {
  if (S < 1 || S > 65535 || T < 1 || O < 1 || rows < 32 || rows > 256 ||
      rows % 32)
    return (int)cudaErrorInvalidValue;
  SubnetGeom g;
  int nmax = 0;
  int rc = repro_subnet_geom(nlayers, widths, skip, pstride, &g, &nmax);
  if (rc) return rc;
  if (T > rows && part == nullptr) return (int)cudaErrorInvalidValue;
  ActGeom ag;
  act_geom(g, S, T, O, &ag);
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  if (nmax <= 8)
    return launch_bwd<8>(gout, xg, acts, wpack, dx, part, grads, S, T, O,
                         rows, g, ag, st);
  if (nmax <= 16)
    return launch_bwd<16>(gout, xg, acts, wpack, dx, part, grads, S, T, O,
                          rows, g, ag, st);
  if (nmax <= 32)
    return launch_bwd<32>(gout, xg, acts, wpack, dx, part, grads, S, T, O,
                          rows, g, ag, st);
  return (int)cudaErrorInvalidValue;
}
