// Geometry of the grouped sub-network's packed weights, host side:
// shared by the inference kernel's launch plan (mlp_plan.h) and the
// training kernels' (train_plan.h).  Plain C++ with no CUDA header, so
// that the launch plans also build with a host compiler (the CPU tests
// check them that way).
//
// A neuron's parameters are packed by the wrapper into one row of
// pstride floats: every layer's w (n_l x n_{l+1}, row-major) then b
// (n_{l+1}), then every skip chunk's w then b.  The offsets below walk
// that row.
//
// The kernels walk a compact record of the geometry instead (the
// header, one record per sub-layer, one per saved activation; GH_*,
// SU_*, AC_* below), which every block copies into shared memory: the
// sub-layers are the L layers, then the skip chunks, and each is spread
// in shared memory into rows padded to a multiple of 4 floats with its
// bias as the row after its weights (subnet_geom.cuh).
#pragma once
#include <stddef.h>

#define REPRO_MAX_DEPTH 16
#define REPRO_MAX_SUBS (2 * REPRO_MAX_DEPTH)
#define REPRO_MAX_SMEM 232448      // dynamic shared memory of a block
#define REPRO_EINVAL 1   // cudaErrorInvalidValue

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

// Fill g from (nlayers, widths, skip); g->pstride is the packed row's
// length.  Returns 0 or REPRO_EINVAL; *nmax gets the largest width.
static inline int repro_subnet_layout(int nlayers, const int* widths,
                                      int skip, SubnetGeom* g, int* nmax) {
  if (nlayers < 1 || nlayers > REPRO_MAX_DEPTH || skip < 0 ||
      (skip > 0 && nlayers % skip)) {
    return REPRO_EINVAL;
  }
  g->nlayers = nlayers;
  g->skip = skip;
  *nmax = 0;
  for (int l = 0; l <= nlayers; ++l) {
    if (widths[l] < 1) return REPRO_EINVAL;
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
  g->pstride = off;
  return 0;
}

// repro_subnet_layout, checking that the caller's pstride equals the
// packed row's length.
static inline int repro_subnet_geom(int nlayers, const int* widths,
                                    int skip, int pstride, SubnetGeom* g,
                                    int* nmax) {
  const int rc = repro_subnet_layout(nlayers, widths, skip, g, nmax);
  if (rc) return rc;
  return g->pstride == pstride ? 0 : REPRO_EINVAL;
}

// The compact record.  Header: depth, skip period, chunks, packed and
// padded row lengths, neurons per block, K4's and K5's shared floats per
// warp, where the activation records start, words used, where K5's gm
// staging tile starts after the activation tiles, and the TF_* flags
// (the training fields are set by train_plan.h alone).
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

struct GeomRecord {
  int w[REPRO_GEOM_INTS];
};

static inline int round4(int n) { return (n + 3) & ~3; }

// udiv's divisor for d: ceil(2^32 / d), or 0 for d = 1.
static inline int udiv_magic(int d) {
  return d == 1 ? 0 : (int)(unsigned)((0x100000000ull + d - 1) / d);
}

// The record's header and sub-layer records as far as the padded weight
// walk needs them (every field but the training ones: GH_G and after,
// SU_LDA, SU_TILE), GH_ACT and GH_USED as if no activation record
// followed; the rest is zero.
static inline void subnet_record(const SubnetGeom& g, GeomRecord* rec) {
  for (int k = 0; k < REPRO_GEOM_INTS; ++k) rec->w[k] = 0;
  int* h = rec->w;
  const int nl = g.nlayers, skip = g.skip, nch = skip ? nl / skip : 0;
  h[GH_NL] = nl;
  h[GH_SKIP] = skip;
  h[GH_NCH] = nch;
  h[GH_PSTRIDE] = g.pstride;
  int ppad = 0;
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
  }
  h[GH_PPAD] = ppad;
  h[GH_ACT] = GH_WORDS + (nl + nch) * SU_WORDS;
  h[GH_USED] = h[GH_ACT];
}
