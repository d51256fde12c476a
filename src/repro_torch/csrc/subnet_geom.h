// Geometry of the grouped sub-network's packed weights, host side:
// shared by the inference kernel (neuralut_mlp.cu) and the training
// kernels' launch plan (train_plan.h).  Plain C++ with no CUDA header, so
// that the launch plan also builds with a host compiler (the CPU tests
// check it that way).
//
// A neuron's parameters are packed by the wrapper into one row of
// pstride floats: every layer's w (n_l x n_{l+1}, row-major) then b
// (n_{l+1}), then every skip chunk's w then b.  The offsets below walk
// that row.
#pragma once

#define REPRO_MAX_DEPTH 16
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
