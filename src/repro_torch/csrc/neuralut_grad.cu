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
// tile, and TF32 would break the fp32 contract of training parity.  At
// these sizes a launch holds ~8 warps per SM, so what a kernel pays is
// the latency of one warp's walk and the instructions around it.
//
// Design.  A block holds G consecutive neurons and a tile of R = 32 rows;
// warp k of the block owns neuron k and lane r row r, and a warp waits
// for no other warp after the block's start (in K5, until the cluster's
// reduction):
//  * each warp copies its neuron's packed weights 16 bytes at a time
//    (cp.async) and spreads them into its own shared-memory row, every
//    output row padded to a multiple of 4 floats (zeros) and the bias as
//    the row after the weights, so a thread's walk through the MLP reads
//    each weight as a 16-byte broadcast that feeds 4 multiply-adds;
//  * K4 stages each saved sub-layer input in the warp's shared tile and
//    stores it row by row (n_i contiguous floats of the (S, T, O, n_i)
//    layout per row, several rows per instruction);
//  * K5 copies the tile's input and saved activations of its neuron once
//    (cp.async) into shared memory, beside a column of ones, and keeps
//    them there for the tile's whole backward walk.  A sub-layer's weight
//    gradient is then a^T . gm over the warp's 32 rows, register-tiled:
//    lane (p, q) owns input rows p, p + P, ... (the row of ones gives the
//    bias) x 4 outputs q..q+3, and per row reads one 16-byte gm vector
//    and one a value per input row, summing rows in order;
//  * the row tiles of a neuron group are one thread-block cluster of C
//    <= 8 blocks (rank = blockIdx.y).  Rank c walks row tiles c, c + C,
//    c + 2C, ... in order, adding each tile's gradient into its own
//    shared-memory sum; then every rank sums its share of the gradient
//    elements over the ranks 0, 1, ..., C-1 through distributed shared
//    memory and writes it.  One launch per call, no atomics, and the
//    order of every sum depends only on (T, R, C) and the widths, never
//    on S, G or scheduling: a rerun is bit-identical, and member s of a
//    seed-axis launch is bit-identical to a single-seed launch on its
//    operands;
//  * one walk serves every geometry: skip chunks of `skip` layers, or
//    chunks of one layer without a skip sub-layer when skip = 0, so the
//    unrolled multiply-add code is emitted once per kernel;
//  * the launch plan (train_plan.h) is made on the host per launch: the
//    geometry (widths, offsets), which each block copies into shared
//    memory, and G, the cluster and shared memory.  Activation offsets
//    are computed from (S, T, O, width prefix sums), so nothing is
//    indexed at run time outside shared memory (no stack frame).  Where
//    a block would not fit in shared memory (deep width-32 geometries),
//    the plan takes one neuron per block, spreads the packed row straight
//    from global memory, and at last keeps K5's block sum in a slice of
//    global scratch that the cluster sums the same way;
//  * ReLU masks are recovered from the saved post-ReLU values (a > 0),
//    so the gradient at 0 is 0, as in the reference.
//  * Ragged edges are masked: rows past T and neurons past O are never
//    loaded or stored, so B and O need not divide any tile.
//  * Gradients come out leaf-major: leaf k (layer w, layer b, ..., skip
//    w, skip b, in the packing order) of neuron o, element e, lives at
//    O * off_k + o * size_k + e, where off_k is the leaf's offset in a
//    packed weight row; the wrapper views each leaf as its own tensor.
//  * A leading seed axis S (the seed ensemble) is gridDim.z: the kernels
//    treat (s, o) as one of S * O neurons (row (s, t, o) is element
//    (s * T + t) * O + o of the (S, T, O) arrays, the packed weights of
//    (s, o) are row s * O + o, a gradient leaf is an (S, O, ...) block),
//    and a block group never spans two seeds.
#include <cooperative_groups.h>

#include "subnet_geom.cuh"
#include "train_plan.h"

namespace cg = cooperative_groups;

__device__ __forceinline__ const int* act_rec(const int* g, int i) {
  return g + g[GH_ACT] + i * AC_WORDS;
}

// gn = w @ gm (the cotangent of the layer's input); gm is 0 past nout.
// Output columns outer, rows inner: every row's sum advances together.
// gn past nin is not 0 (the bias row's products): callers mask it.
template <int NMAX>
__device__ __forceinline__ void back4(const float (&gm)[NMAX],
                                      float (&gn)[NMAX],
                                      const float* __restrict__ w, int nin,
                                      int nout, int ldo) {
#pragma unroll
  for (int i = 0; i < NMAX; ++i) gn[i] = 0.f;
#pragma unroll
  for (int j = 0; j < NMAX; j += 4) {
    if (j < nout) {
#pragma unroll
      for (int i0 = 0; i0 < NMAX; i0 += 4) {
        if (i0 < nin) {
#pragma unroll
          for (int i = i0; i < i0 + 4; ++i) {
            const float4 v = reinterpret_cast<const float4*>(
                w + min(i, nin) * ldo)[j / 4];
            gn[i] = fmaf(v.x, gm[j], gn[i]);
            gn[i] = fmaf(v.y, gm[j + 1], gn[i]);
            gn[i] = fmaf(v.z, gm[j + 2], gn[i]);
            gn[i] = fmaf(v.w, gm[j + 3], gn[i]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K4

// One warp's tile: its neuron, its rows and its shared floats (the
// padded weights, then a staging tile of 32 x ld floats, ld odd).
struct FwdWarp {
  const int* sg;
  float* w;
  float* st;
  int ld, k, r, rv;
  size_t row0;   // element (s, t0, o) of the (S, T, O) arrays
};

// Stage this thread's n values of act i, then store the warp's rows (n
// contiguous floats each) to act i's block of the buffer.
template <int NMAX>
__device__ __forceinline__ void save_act(const FwdWarp& f,
                                         float* __restrict__ acts,
                                         size_t block, int O, int i,
                                         const float (&v)[NMAX]) {
  const int* ac = act_rec(f.sg, i);
  const int n = ac[AC_N];
  __syncwarp();
#pragma unroll
  for (int j = 0; j < NMAX; ++j)
    if (j < n) f.st[f.r * f.ld + j] = v[j];
  __syncwarp();
  const RowLanes rl(n, ac[AC_MN]);
  float* dst = acts + block * ac[AC_PW] + f.row0 * n + rl.j;
  for (int r0 = 0; r0 < f.rv; r0 += rl.rpi)
    if (rl.on(r0, f.rv)) {
      const int r = r0 + rl.dr;
      dst[(size_t)r * O * n] = f.st[r * f.ld + rl.j];
    }
}

// Block (group, row tile, seed).  Shared memory: the geometry, then per
// warp the padded weights and the staging tile.
template <int NMAX>
__global__ void __launch_bounds__(REPRO_TRAIN_THREADS, 1)
subnet_train_fwd_kernel(const float* __restrict__ xg,
                        const float* __restrict__ wpack,
                        float* __restrict__ out, float* __restrict__ acts,
                        int T, int O, GeomRecord geom) {
  extern __shared__ __align__(16) float smem[];
  int* sg = reinterpret_cast<int*>(smem);
  copy_geom(geom, sg);
  __syncthreads();
  const int G = sg[GH_G], nl = sg[GH_NL];
  const int k = threadIdx.x >> 5, r = threadIdx.x & 31;
  const int o = blockIdx.x * G + k, t0 = blockIdx.y * REPRO_TRAIN_ROWS;
  const int s = blockIdx.z;
  if (o >= O) return;   // no block-wide barrier follows
  FwdWarp f;
  f.sg = sg;
  f.w = smem + REPRO_GEOM_INTS + k * sg[GH_WARP_FWD];
  f.st = f.w + sg[GH_PPAD];
  f.k = k;
  f.r = r;
  f.rv = min(REPRO_TRAIN_ROWS, T - t0);
  f.row0 = ((size_t)s * T + t0) * O + o;
  const int F = act_rec(sg, 0)[AC_N];
  int nst = F;
  for (int i = 1; i < nl; ++i) nst = max(nst, act_rec(sg, i)[AC_N]);
  f.ld = nst | 1;
  const size_t block = (size_t)gridDim.z * T * O;   // one act's floats / n
  {
    const float* src = wpack + ((size_t)s * O + o) * sg[GH_PSTRIDE];
    // two call sites, so that each load's state space stays known
    if (sg[GH_FLAGS] & TF_STAGED) {
      issue_weights(f.st, src, sg);   // the staging tile is the scratch
      cp_async_wait();
      __syncwarp();
      spread_weights(f.w, weights_raw(f.st, src), sg);
    } else {
      spread_weights(f.w, src, sg);
    }
  }
  {
    const RowLanes rl(F, act_rec(sg, 0)[AC_MN]);
    const float* src = xg + f.row0 * F + rl.j;
    for (int r0 = 0; r0 < f.rv; r0 += rl.rpi)
      if (rl.on(r0, f.rv)) {
        const int rr = r0 + rl.dr;
        cp_async4(f.st + rr * f.ld + rl.j, src + (size_t)rr * O * F);
      }
  }
  cp_async_wait();
  __syncwarp();

  const bool valid = r < f.rv;
  float h[1][NMAX];
#pragma unroll
  for (int j = 0; j < NMAX; ++j)
    h[0][j] = (valid && j < F) ? f.st[r * f.ld + j] : 0.f;
  subnet_forward<NMAX, 1>(
      sg, f.w, h, [&](int l, const float (&a)[1][NMAX]) {
        save_act<NMAX>(f, acts, block, O, l, a[0]);
      });
  if (valid) out[f.row0 + (size_t)r * O] = h[0][0];
}

// ---------------------------------------------------------------------------
// K5

// One warp's tile: its neuron and rows, its shared floats (the padded
// weights, the activation tiles, the gm staging tile) and the block's
// gradient sum (G x pstride, leaf-major).
struct BwdWarp {
  const int* sg;
  float* w;
  float* tiles;
  float* st;
  float* acc;
  float* spare;   // a word of the warp's past the sum: discarded stores
  int G, k, r, rv;
  bool first;   // the rank's first row tile: its sum starts here
};

// Sub-layer u's weight gradient over the warp's rows, added into the
// block's sum, and its input cotangent gn.  gm is 0 past NOUT.
template <int NMAX>
__device__ __forceinline__ void grad_sub(const BwdWarp& b, int u,
                                         const float (&gm)[NMAX],
                                         float (&gn)[NMAX]) {
  constexpr int JMAX = ((NMAX + 1) * NMAX + 127) / 128;  // input rows/lane
  const int* su = sub_rec(b.sg, u);
  const int nin = su[SU_NIN], nout = su[SU_NOUT], ldo = su[SU_LDO];
  const int ldg = su[SU_LDG];
  __syncwarp();   // the previous sub-layer's readers are done
  {
    float4* d = reinterpret_cast<float4*>(b.st + b.r * ldg);
#pragma unroll
    for (int j = 0; j < NMAX; j += 4)
      if (j < ldo) d[j / 4] = make_float4(gm[j], gm[j + 1], gm[j + 2],
                                          gm[j + 3]);
  }
  __syncwarp();
  // lane (pg, tq): input rows pg, pg + npg, ... (<= nin; row nin is the
  // column of ones, the bias), outputs 4 tq .. 4 tq + 3
  const int ntq = ldo / 4, npg = udiv(32, su[SU_MNTQ]);
  const int lane = threadIdx.x & 31, pg = udiv(lane, su[SU_MNTQ]);
  const int tq = lane - pg * ntq;
  if (pg < npg) {
    const int lda = su[SU_LDA];
    const float* A = b.tiles + su[SU_TILE] + pg;
    const float* Gm = b.st + 4 * tq;
    float c[JMAX][4];
#pragma unroll
    for (int x = 0; x < JMAX; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) c[x][y] = 0.f;
#pragma unroll 8
    for (int r = 0; r < b.rv; ++r, A += lda, Gm += ldg) {
      const float4 gv = *reinterpret_cast<const float4*>(Gm);
#pragma unroll
      for (int x = 0; x < JMAX; ++x) {
        if (pg + x * npg <= nin) {
          const float av = A[x * npg];
          c[x][0] = fmaf(av, gv.x, c[x][0]);
          c[x][1] = fmaf(av, gv.y, c[x][1]);
          c[x][2] = fmaf(av, gv.z, c[x][2]);
          c[x][3] = fmaf(av, gv.w, c[x][3]);
        }
      }
    }
    // into the rank's sum: the tile's sum, or after the rank's first
    // tile the earlier tiles' sum plus it (all loaded before any store);
    // an element past the gradient goes to the warp's spare word
    const int G = b.G, pk = su[SU_PK], nw = nin * nout;
    float* dst[JMAX][4];
#pragma unroll
    for (int x = 0; x < JMAX; ++x) {
      const int p = pg + x * npg;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int q = 4 * tq + y;
        dst[x][y] = q >= nout || p > nin
                        ? b.spare
                        : b.acc + (p < nin ? G * pk + b.k * nw + p * nout + q
                                           : G * (pk + nw) + b.k * nout + q);
      }
    }
    if (!b.first) {
      float old[JMAX][4];
#pragma unroll
      for (int x = 0; x < JMAX; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) old[x][y] = *dst[x][y];
#pragma unroll
      for (int x = 0; x < JMAX; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) c[x][y] = old[x][y] + c[x][y];
    }
#pragma unroll
    for (int x = 0; x < JMAX; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) *dst[x][y] = c[x][y];
  }
  back4<NMAX>(gm, gn, b.w + su[SU_PAD], nin, nout, ldo);
}

// Block (group, rank, seed) of a cluster of C blocks along y.  Shared
// memory: the geometry, per warp the padded weights, activation tiles
// and gm staging tile, then the block's gradient sum, which with
// ACC_GLOBAL (the plan's TF_ACC_GLOBAL) is instead slice (s, group,
// rank) of the scratch (G x pstride floats and a spare word per warp
// each).  A template argument, so that the sum's state space is known
// where it is read and written.
template <int NMAX, bool ACC_GLOBAL>
__global__ void __launch_bounds__(REPRO_TRAIN_THREADS, 1)
subnet_train_bwd_kernel(const float* __restrict__ gout_in,
                        const float* __restrict__ xg,
                        const float* __restrict__ acts,
                        const float* __restrict__ wpack,
                        float* __restrict__ dx, float* __restrict__ grads,
                        float* scratch, int T, int O, GeomRecord geom) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  int* sg = reinterpret_cast<int*>(smem);
  copy_geom(geom, sg);
  __syncthreads();
  const int G = sg[GH_G], nl = sg[GH_NL], skip = sg[GH_SKIP];
  const int nch = sg[GH_NCH], pstride = sg[GH_PSTRIDE];
  const int C = gridDim.y, rank = blockIdx.y, s = blockIdx.z;
  const int o0 = blockIdx.x * G, gv = min(G, O - o0);
  const size_t block = (size_t)gridDim.z * T * O;
  BwdWarp b;
  b.sg = sg;
  b.G = G;
  b.k = threadIdx.x >> 5;
  b.r = threadIdx.x & 31;
  b.w = smem + REPRO_GEOM_INTS + b.k * sg[GH_WARP_BWD];
  b.tiles = b.w + sg[GH_PPAD];
  const size_t slice = (size_t)G * pstride + ((G + 3) & ~3);
  float* const slices =
      ACC_GLOBAL ? scratch + ((size_t)s * gridDim.x + blockIdx.x) * C * slice
                 : nullptr;
  b.acc = ACC_GLOBAL ? slices + rank * slice
                     : smem + REPRO_GEOM_INTS + G * sg[GH_WARP_BWD];
  b.spare = b.acc + G * pstride + b.k;
  b.st = b.tiles + sg[GH_STAGE];
  const int F = act_rec(sg, 0)[AC_N];
  const int ntiles = (T + REPRO_TRAIN_ROWS - 1) / REPRO_TRAIN_ROWS;

  if (b.k < gv) {
    // a staged packed row goes through the gm staging tile while the
    // first row tile's activations arrive
    const float* wsrc = wpack + ((size_t)s * O + o0 + b.k) * pstride;
    const bool staged = sg[GH_FLAGS] & TF_STAGED;
    if (staged) issue_weights(b.st, wsrc, sg);
    // ones in the tiles' column N (the bias's input)
    for (int i = 0; i < nl; ++i) {
      const int* ac = act_rec(sg, i);
      b.tiles[ac[AC_TILE] + b.r * ac[AC_LDA] + ac[AC_N]] = 1.f;
    }

    for (int tile = rank; tile < ntiles; tile += C) {
      const int t0 = tile * REPRO_TRAIN_ROWS;
      b.rv = min(REPRO_TRAIN_ROWS, T - t0);
      const size_t row0 = ((size_t)s * T + t0) * O + o0 + b.k;
      __syncwarp();   // the previous tile's readers are done
      // the neuron's input and saved activations for the tile, once; 16
      // bytes at a time where the rows are 16-byte aligned
      for (int i = 0; i < nl; ++i) {
        const int* ac = act_rec(sg, i);
        const int n = ac[AC_N], lda = ac[AC_LDA];
        const float* base = i == 0 ? xg : acts + block * ac[AC_PW];
        float* dst = b.tiles + ac[AC_TILE];
        if (n % 4 == 0 && (reinterpret_cast<size_t>(base) & 15) == 0) {
          const RowLanes rl(n / 4, ac[AC_MN4]);
          const float* src = base + row0 * n + 4 * rl.j;
          for (int r0 = 0; r0 < b.rv; r0 += rl.rpi)
            if (rl.on(r0, b.rv)) {
              const int r = r0 + rl.dr;
              cp_async16(dst + r * lda + 4 * rl.j, src + (size_t)r * O * n);
            }
        } else {
          const RowLanes rl(n, ac[AC_MN]);
          const float* src = base + row0 * n + rl.j;
          for (int r0 = 0; r0 < b.rv; r0 += rl.rpi)
            if (rl.on(r0, b.rv)) {
              const int r = r0 + rl.dr;
              cp_async4(dst + r * lda + rl.j, src + (size_t)r * O * n);
            }
        }
      }
      cp_async_wait();
      __syncwarp();
      b.first = tile == rank;
      if (b.first && staged) spread_weights(b.w, weights_raw(b.st, wsrc), sg);
      if (b.first && !staged) spread_weights(b.w, wsrc, sg);

      const bool valid = b.r < b.rv;
      float gout[NMAX], ghc[NMAX], cur[NMAX], gn[NMAX];
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        gout[j] = 0.f;
        ghc[j] = 0.f;
      }
      gout[0] = valid ? gout_in[row0 + (size_t)b.r * O] : 0.f;
      // the forward's chunks backwards: the skip sub-layer (j = 0), then
      // the chunk's layers from its last; skip = 0: one layer a chunk
      const int cs = skip ? skip : 1, nc = skip ? nch : nl;
      for (int c = nc - 1; c >= 0; --c) {
        const int l0 = c * cs;
        for (int j = skip ? 0 : 1; j <= cs; ++j) {
          const int l = l0 + cs - j;
          if (j <= 1) {
#pragma unroll
            for (int e = 0; e < NMAX; ++e) cur[e] = gout[e];
          }
          grad_sub<NMAX>(b, j == 0 ? nl + c : l, cur, gn);
          if (j == 0) {
#pragma unroll
            for (int e = 0; e < NMAX; ++e) ghc[e] = gn[e];
            continue;
          }
          // through the ReLU at the layer's input: inside the chunk, or
          // at the chunk's input (where the skip's cotangent joins) for
          // every chunk but the first
          const bool first = l == l0;
          const bool mask = first ? c > 0 : true;
          const int* sl = sub_rec(sg, l);   // act l is layer l's input
          const float* a = b.tiles + sl[SU_TILE] + b.r * sl[SU_LDA];
          const int n = sl[SU_NIN];
#pragma unroll
          for (int e = 0; e < NMAX; ++e) {
            const float v = first ? ghc[e] + gn[e] : gn[e];
            cur[e] = e >= n ? 0.f : (mask && !(a[e] > 0.f)) ? 0.f : v;
          }
          if (first) {
#pragma unroll
            for (int e = 0; e < NMAX; ++e) gout[e] = cur[e];
          }
        }
      }
      // dx: the warp's rows of F contiguous floats through its stage
      __syncwarp();
      const int ldx = F | 1;
#pragma unroll
      for (int j = 0; j < NMAX; ++j)
        if (j < F) b.st[b.r * ldx + j] = gout[j];
      __syncwarp();
      const RowLanes rl(F, act_rec(sg, 0)[AC_MN]);
      for (int r0 = 0; r0 < b.rv; r0 += rl.rpi)
        if (rl.on(r0, b.rv)) {
          const int r = r0 + rl.dr;
          dx[(row0 + (size_t)r * O) * F + rl.j] = b.st[r * ldx + rl.j];
        }
    }
  }

  // Sum the ranks' gradients, rank 0 first, each rank its share of the
  // elements, and write them leaf-major.
  cluster.sync();   // every rank's sum is written (release / acquire)
  const int n = G * pstride;
  const int lo = (int)((long long)n * rank / C);
  const int hi = (int)((long long)n * (rank + 1) / C);
  const float* rem[REPRO_MAX_CLUSTER];
#pragma unroll
  for (int q = 0; q < REPRO_MAX_CLUSTER; ++q)
    rem[q] = q >= C       ? b.acc
             : ACC_GLOBAL ? slices + q * slice
                          : cluster.map_shared_rank(b.acc, q);
  const size_t so0 = (size_t)s * O + o0;
  const size_t SO = (size_t)gridDim.z * O;
  // the leaves in packing order tile [0, n): leaf (u, 0) is sub-layer
  // u's w, (u, 1) its b; a cursor follows this thread's rising f
  int u = 0, leaf = 0, off = sub_rec(sg, 0)[SU_PK];
  int sz = sub_rec(sg, 0)[SU_NIN] * sub_rec(sg, 0)[SU_NOUT];
  constexpr int BATCH = 4;   // loads in flight per rank before a store
  for (int f0 = lo; f0 < hi; f0 += BATCH * blockDim.x) {
    float v[BATCH];
#pragma unroll
    for (int m = 0; m < BATCH; ++m) {
      const int f = f0 + m * blockDim.x + threadIdx.x;
      v[m] = 0.f;
      if (f < hi) {
        v[m] = rem[0][f];
#pragma unroll
        for (int q = 1; q < REPRO_MAX_CLUSTER; ++q)
          if (q < C) v[m] += rem[q][f];
      }
    }
#pragma unroll
    for (int m = 0; m < BATCH; ++m) {
      const int f = f0 + m * blockDim.x + threadIdx.x;
      if (f >= hi) break;
      while (f >= G * (off + sz)) {   // next leaf
        if (leaf == 0) {
          leaf = 1;
          off += sz;
          sz = sub_rec(sg, u)[SU_NOUT];
        } else {
          ++u;
          leaf = 0;
          off = sub_rec(sg, u)[SU_PK];
          sz = sub_rec(sg, u)[SU_NIN] * sub_rec(sg, u)[SU_NOUT];
        }
      }
      if (f - G * off < gv * sz)
        grads[SO * off + so0 * sz + (f - G * off)] = v[m];
    }
  }
  cluster.sync();   // no rank leaves while another reads its sum
}

// ---------------------------------------------------------------------------
// Host side

template <int NMAX>
static int launch_fwd(const float* xg, const float* wpack, float* out,
                      float* acts, int S, int T, int O, const TrainPlan& p,
                      cudaStream_t stream) {
  const int G = p.fwd.w[GH_G];
  int e = repro_allow_smem(subnet_train_fwd_kernel<NMAX>, p.smem_fwd);
  if (e) return e;
  const dim3 grid((O + G - 1) / G, p.tiles, S);
  subnet_train_fwd_kernel<NMAX><<<grid, G * REPRO_TRAIN_ROWS, p.smem_fwd,
                                  stream>>>(xg, wpack, out, acts, T, O,
                                            p.fwd);
  return (int)cudaGetLastError();
}

template <int NMAX, bool ACC_GLOBAL>
static int launch_bwd(const float* gout, const float* xg, const float* acts,
                      const float* wpack, float* dx, float* grads,
                      float* scratch, int S, int T, int O, const TrainPlan& p,
                      cudaStream_t stream) {
  const int G = p.bwd.w[GH_G];
  int e = repro_allow_smem(subnet_train_bwd_kernel<NMAX, ACC_GLOBAL>,
                           p.smem_bwd);
  if (e) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((O + G - 1) / G, p.cluster, S);
  cfg.blockDim = dim3(G * REPRO_TRAIN_ROWS, 1, 1);
  cfg.dynamicSmemBytes = p.smem_bwd;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = (int)cudaLaunchKernelEx(&cfg, subnet_train_bwd_kernel<NMAX, ACC_GLOBAL>,
                              gout, xg, acts, wpack, dx, grads, scratch, T, O,
                              p.bwd);
  if (e) return e;
  return (int)cudaGetLastError();
}

// Shared by both entries: check the sizes and make the plan.  Returns 0
// or a cudaError_t.
static int train_setup(int S, int T, int O, int pstride, int nlayers,
                       const int* widths, int skip, TrainPlan* p,
                       int* nmax) {
  SubnetGeom g;
  int rc = repro_subnet_geom(nlayers, widths, skip, pstride, &g, nmax);
  if (rc) return rc;
  return train_plan(g, *nmax, S, T, O, p);
}

// S seeds (S = 1: one network).  xg (S, T, O, F), out (S, T, O), the
// packed weights (S, O, pstride) as in neuralut_mlp.cu.  widths:
// nlayers + 1 ints (F, N, ..., N, 1), each <= 32.  acts: the sub-layer
// inputs i = 1 .. nlayers-1, one (S, T, O, n_i) block after another.
extern "C" int repro_subnet_train_fwd(int device, const float* xg,
                                      const float* wpack, float* out,
                                      float* acts, int S, int T, int O,
                                      int pstride, int nlayers,
                                      const int* widths, int skip,
                                      void* stream) {
  TrainPlan p;
  int nmax = 0;
  int rc = train_setup(S, T, O, pstride, nlayers, widths, skip, &p, &nmax);
  if (rc) return rc;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  if (nmax <= 8) return launch_fwd<8>(xg, wpack, out, acts, S, T, O, p, st);
  if (nmax <= 16) return launch_fwd<16>(xg, wpack, out, acts, S, T, O, p, st);
  return launch_fwd<32>(xg, wpack, out, acts, S, T, O, p, st);
}

// S seeds as in repro_subnet_train_fwd.  gout: (S, T, O) cotangent of
// the output.  dx: (S, T, O, F).  grads: the leaf-major gradient
// (S * O * pstride floats).  scratch: scratch_floats floats of global
// memory, at least the plan's TP_SCRATCH (NULL and 0 when that is 0).
extern "C" int repro_subnet_train_bwd(int device, const float* gout,
                                      const float* xg, const float* acts,
                                      const float* wpack, float* dx,
                                      float* grads, float* scratch,
                                      long long scratch_floats, int S, int T,
                                      int O, int pstride, int nlayers,
                                      const int* widths, int skip,
                                      void* stream) {
  TrainPlan p;
  int nmax = 0;
  int rc = train_setup(S, T, O, pstride, nlayers, widths, skip, &p, &nmax);
  if (rc) return rc;
  if (p.scratch && (scratch == nullptr || scratch_floats < p.scratch))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  // a sum in global scratch only where a block of one neuron does not
  // fit: deep geometries, which NMAX = 32 serves whatever their widths
  if (p.bwd.w[GH_FLAGS] & TF_ACC_GLOBAL)
    return launch_bwd<32, true>(gout, xg, acts, wpack, dx, grads, scratch, S,
                                T, O, p, st);
  if (nmax <= 8)
    return launch_bwd<8, false>(gout, xg, acts, wpack, dx, grads, scratch, S,
                                T, O, p, st);
  if (nmax <= 16)
    return launch_bwd<16, false>(gout, xg, acts, wpack, dx, grads, scratch, S,
                                 T, O, p, st);
  return launch_bwd<32, false>(gout, xg, acts, wpack, dx, grads, scratch, S,
                               T, O, p, st);
}
