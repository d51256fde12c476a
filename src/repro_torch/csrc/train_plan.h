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
#define REPRO_MAX_CLUSTER 8        // portable cluster size

// The geometry for G neurons per block and the TF_* flags; *smem_fwd /
// *smem_bwd: the two kernels' dynamic shared memory with it.
static void train_geom(const SubnetGeom& g, int G, int flags, GeomRecord* tg,
                       size_t* smem_fwd, size_t* smem_bwd) {
  subnet_record(g, tg);
  int* h = tg->w;
  const int nl = g.nlayers, nch = h[GH_NCH];
  const int R = REPRO_TRAIN_ROWS;
  h[GH_G] = G;
  h[GH_FLAGS] = flags;
  const int ppad = h[GH_PPAD];
  int ldg_max = 4;
  for (int u = 0; u < nl + nch; ++u) {
    const int ldg = h[GH_WORDS + u * SU_WORDS + SU_LDG];
    ldg_max = ldg > ldg_max ? ldg : ldg_max;
  }
  const int act = h[GH_ACT];
  h[GH_USED] = act + nl * AC_WORDS;
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
  // a staging tile (R x (nst | 1), at least the 32 floats past the
  // weights that the forward walk, dense4, may read); K5 the weights,
  // the activation tiles and a gm (or dx) staging tile.  A staged packed
  // row first passes through the staging tile as it comes (pstride + 3
  // floats).
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
  GeomRecord fwd, bwd;       // each kernel's geometry, its G and flags
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
