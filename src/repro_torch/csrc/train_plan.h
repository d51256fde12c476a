// The launch plan of the training kernels K4 and K5 (neuralut_grad.cu):
// the geometry record every block copies into shared memory, the neurons
// per block, the row tiles and K5's cluster, each block's shared memory
// and the global scratch K5 may need.  Host code in plain C++ with no
// CUDA header: the kernels' entries launch what train_plan returns, and
// the same plan is read through repro_subnet_train_plan, by the wrapper
// (K5's scratch) and by the CPU tests, which build this header alone
// with a host compiler.
//
// Choices, most preferred first, the first whose block fits in 227 KB of
// shared memory: K4 4, 2, 1 neurons per block, K5 2, 1 (the fastest at
// the jsc-5l training shapes on the H100), each with its neurons' packed
// rows staged through shared memory (16-byte copies); then one neuron
// whose packed row is spread into shared memory straight from global
// memory; then, for K5 alone, one neuron whose block keeps its gradient
// sum in global scratch instead of shared memory (the cluster sums the
// ranks' slices in rank order all the same).  The last choices fit every
// geometry the entries take (widths <= 32, depth <= 16).  None of the
// choices depends on S or O, and the row tiles and cluster depend on T
// alone, so neither does the order of any sum over rows.
#pragma once
#include <stddef.h>

#include "subnet_geom.h"

#define REPRO_TRAIN_ROWS 32        // rows per block: the lanes of a warp
#define REPRO_TRAIN_THREADS 256    // G * 32 at most
#define REPRO_MAX_SUBS (2 * REPRO_MAX_DEPTH)
#define REPRO_MAX_CLUSTER 8        // portable cluster size
#define REPRO_MAX_SMEM 232448      // dynamic shared memory of a block

// The geometry, compact: the header, then one record per sub-layer u
// (layers 0 .. L-1, then skip chunks 0 .. nch-1), then one per
// activation i (the input of layer i; 0 = x).
// Header: depth, skip period, chunks, packed and padded row lengths,
// neurons per block, K4's and K5's shared floats per warp, where the
// activation records start, words used, where K5's gm staging tile
// starts after the activation tiles, and the TF_* flags.
enum { GH_NL, GH_SKIP, GH_NCH, GH_PSTRIDE, GH_PPAD, GH_G, GH_WARP_FWD,
       GH_WARP_BWD, GH_ACT, GH_USED, GH_STAGE, GH_FLAGS, GH_WORDS = 12 };
// TF_STAGED: the packed rows come into shared memory as they are (16
// bytes at a time) before they are spread out; else they are spread out
// straight from global memory.  TF_ACC_GLOBAL (K5): the block's gradient
// sum lives in a slice of global scratch, not in shared memory.
enum { TF_STAGED = 1, TF_ACC_GLOBAL = 2 };
// Sub-layer: input and output width, padded output stride (multiple of
// 4), offset of w in a packed row (b follows at PK + NIN * NOUT), offset
// of w in the padded row (b at PAD + NIN * LDO), its input activation,
// K5's gm staging stride (LDO, or LDO + 4 to make it 4 mod 8), and the
// stride and offset of the input activation's tile in K5 (copied from
// its record, so that a sub-layer's fields are one load away), and the
// divisors (udiv) of LDO and LDO / 4.
enum { SU_NIN, SU_NOUT, SU_LDO, SU_PK, SU_PAD, SU_IN, SU_LDG, SU_LDA,
       SU_TILE, SU_MLDO, SU_MNTQ, SU_WORDS = 12 };
// Activation: width, prefix sum of widths 1 .. i-1 (act i's block in
// the activation buffer starts at S * T * O * PW), K5's tile stride (a
// multiple of 4, > N: the column N holds ones), the tile's offset in
// the warp's shared floats, and the divisors of N and N / 4 (0 when 4
// does not divide N).
enum { AC_N, AC_PW, AC_LDA, AC_TILE, AC_MN, AC_MN4, AC_WORDS = 8 };
#define REPRO_GEOM_INTS \
  (GH_WORDS + REPRO_MAX_SUBS * SU_WORDS + REPRO_MAX_DEPTH * AC_WORDS)

struct TrainGeom {
  int w[REPRO_GEOM_INTS];
};

static inline int round4(int n) { return (n + 3) & ~3; }

// udiv's divisor for d: ceil(2^32 / d), or 0 for d = 1.
static inline int udiv_magic(int d) {
  return d == 1 ? 0 : (int)(unsigned)((0x100000000ull + d - 1) / d);
}

// The geometry for G neurons per block and the TF_* flags; *smem_fwd /
// *smem_bwd: the two kernels' dynamic shared memory with it.
static void train_geom(const SubnetGeom& g, int G, int flags, TrainGeom* tg,
                       size_t* smem_fwd, size_t* smem_bwd) {
  for (int k = 0; k < REPRO_GEOM_INTS; ++k) tg->w[k] = 0;
  int* h = tg->w;
  const int nl = g.nlayers, skip = g.skip, nch = skip ? nl / skip : 0;
  const int R = REPRO_TRAIN_ROWS;
  h[GH_NL] = nl;
  h[GH_SKIP] = skip;
  h[GH_NCH] = nch;
  h[GH_PSTRIDE] = g.pstride;
  h[GH_G] = G;
  h[GH_FLAGS] = flags;
  int ppad = 0, ldg_max = 4;
  for (int u = 0; u < nl + nch; ++u) {
    int* su = h + GH_WORDS + u * SU_WORDS;
    const bool layer = u < nl;
    const int in = layer ? u : (u - nl) * skip;
    const int nin = g.width[in];
    const int nout = layer ? g.width[u + 1] : g.width[in + skip];
    const int ldo = round4(nout);
    su[SU_NIN] = nin;
    su[SU_NOUT] = nout;
    su[SU_LDO] = ldo;
    su[SU_PK] = layer ? g.w_off[u] : g.sw_off[u - nl];
    su[SU_PAD] = ppad;
    su[SU_IN] = in;
    su[SU_LDG] = ldo % 8 ? ldo : ldo + 4;
    su[SU_MLDO] = udiv_magic(ldo);
    su[SU_MNTQ] = udiv_magic(ldo / 4);
    ppad += (nin + 1) * ldo;
    ldg_max = su[SU_LDG] > ldg_max ? su[SU_LDG] : ldg_max;
  }
  const int act = GH_WORDS + (nl + nch) * SU_WORDS;
  h[GH_ACT] = act;
  h[GH_USED] = act + nl * AC_WORDS;
  h[GH_PPAD] = ppad;
  int tiles = 0, pw = 0, nst = 1;
  for (int i = 0; i < nl; ++i) {
    int* ac = h + act + i * AC_WORDS;
    const int n = g.width[i];
    ac[AC_N] = n;
    ac[AC_PW] = pw;
    ac[AC_LDA] = round4(n + 1);
    ac[AC_TILE] = tiles;
    ac[AC_MN] = udiv_magic(n);
    ac[AC_MN4] = n % 4 ? 0 : udiv_magic(n / 4);
    if (i > 0) pw += n;
    tiles += R * ac[AC_LDA];
    nst = n > nst ? n : nst;
  }
  for (int u = 0; u < nl + nch; ++u) {
    int* su = h + GH_WORDS + u * SU_WORDS;
    const int* ac = h + act + su[SU_IN] * AC_WORDS;
    su[SU_LDA] = ac[AC_LDA];
    su[SU_TILE] = ac[AC_TILE];
  }
  // per warp, in floats, each part 16-byte aligned: K4 the weights and
  // a staging tile (R x (nst | 1)); K5 the weights, the activation tiles
  // and a gm (or dx) staging tile.  A staged packed row first passes
  // through the staging tile as it comes (pstride + 3 floats).
  const int f1 = g.width[0] | 1;
  const int scratch = flags & TF_STAGED ? round4(g.pstride + 3) : 0;
  const int st_fwd = round4(R * (nst | 1));
  const int st_bwd = round4(R * (ldg_max > f1 ? ldg_max : f1));
  h[GH_WARP_FWD] = ppad + (st_fwd > scratch ? st_fwd : scratch);
  h[GH_STAGE] = round4(tiles);
  h[GH_WARP_BWD] = ppad + h[GH_STAGE] + (st_bwd > scratch ? st_bwd : scratch);
  // K5's gradient sum (G x pstride, leaf-major) and a spare word per warp
  const int acc = flags & TF_ACC_GLOBAL ? 0 : G * g.pstride + round4(G);
  const size_t geom = sizeof(int) * REPRO_GEOM_INTS;
  *smem_fwd = geom + sizeof(float) * (size_t)G * h[GH_WARP_FWD];
  *smem_bwd = geom + sizeof(float) * ((size_t)G * h[GH_WARP_BWD] + acc);
}

struct TrainPlan {
  TrainGeom fwd, bwd;        // each kernel's geometry, its G and flags
  size_t smem_fwd, smem_bwd;
  long long scratch;         // floats of K5's global sums (0: none)
  int tiles, cluster;        // row tiles; K5's ranks per neuron group
};

// The plan for S seeds x T rows x O neurons of geometry g (largest width
// nmax).  Returns 0 or REPRO_EINVAL.
static int train_plan(const SubnetGeom& g, int nmax, int S, int T, int O,
                      TrainPlan* p) {
  const int tiles = T < 1 ? 0 : (T + REPRO_TRAIN_ROWS - 1) / REPRO_TRAIN_ROWS;
  if (S < 1 || S > 65535 || T < 1 || O < 1 || tiles > 65535 || nmax > 32)
    return REPRO_EINVAL;
  static const int fwd_choice[][2] = {
      {4, TF_STAGED}, {2, TF_STAGED}, {1, TF_STAGED}, {1, 0}};
  static const int bwd_choice[][2] = {
      {2, TF_STAGED}, {1, TF_STAGED}, {1, 0}, {1, TF_ACC_GLOBAL}};
  size_t fwd = 0, bwd = 0, unused;
  int k = 0;
  for (; k < 4; ++k) {
    train_geom(g, fwd_choice[k][0], fwd_choice[k][1], &p->fwd, &fwd, &unused);
    if (fwd <= REPRO_MAX_SMEM) break;
  }
  if (k == 4) return REPRO_EINVAL;
  for (k = 0; k < 4; ++k) {
    train_geom(g, bwd_choice[k][0], bwd_choice[k][1], &p->bwd, &unused, &bwd);
    if (bwd <= REPRO_MAX_SMEM) break;
  }
  if (k == 4) return REPRO_EINVAL;
  p->smem_fwd = fwd;
  p->smem_bwd = bwd;
  p->tiles = tiles;
  p->cluster = tiles < REPRO_MAX_CLUSTER ? tiles : REPRO_MAX_CLUSTER;
  const int G = p->bwd.w[GH_G];
  p->scratch = p->bwd.w[GH_FLAGS] & TF_ACC_GLOBAL
                   ? (long long)S * ((O + G - 1) / G) * p->cluster *
                         (G * g.pstride + round4(G))
                   : 0;
  return 0;
}

// The plan as numbers, in this order.
enum { TP_FWD_G, TP_FWD_FLAGS, TP_BWD_G, TP_BWD_FLAGS, TP_TILES, TP_CLUSTER,
       TP_SMEM_FWD, TP_SMEM_BWD, TP_SCRATCH, TP_PSTRIDE, TP_WORDS };

// The plan of a K4 and a K5 launch of S seeds x T rows x O neurons at
// (nlayers, widths, skip) into out[TP_WORDS].  Returns 0 or REPRO_EINVAL
// (the entries then refuse the launch too).
extern "C" int repro_subnet_train_plan(int S, int T, int O, int nlayers,
                                       const int* widths, int skip,
                                       long long* out) {
  SubnetGeom g;
  int nmax = 0;
  int rc = repro_subnet_layout(nlayers, widths, skip, &g, &nmax);
  if (rc) return rc;
  TrainPlan p;
  if ((rc = train_plan(g, nmax, S, T, O, &p))) return rc;
  out[TP_FWD_G] = p.fwd.w[GH_G];
  out[TP_FWD_FLAGS] = p.fwd.w[GH_FLAGS];
  out[TP_BWD_G] = p.bwd.w[GH_G];
  out[TP_BWD_FLAGS] = p.bwd.w[GH_FLAGS];
  out[TP_TILES] = p.tiles;
  out[TP_CLUSTER] = p.cluster;
  out[TP_SMEM_FWD] = (long long)p.smem_fwd;
  out[TP_SMEM_BWD] = (long long)p.smem_bwd;
  out[TP_SCRATCH] = p.scratch;
  out[TP_PSTRIDE] = g.pstride;
  return 0;
}
