// The launch plan of the grouped sub-network kernel K2 (neuralut_mlp.cu):
// rows per thread R, neurons and rows per block, whether the packed
// weights are staged, and the block's shared-memory layout.  Host code
// in plain C++ with no CUDA header: the kernel's entry launches what
// mlp_plan returns, and the CPU tests build this header alone with a
// host compiler and check the plan through repro_grouped_subnet_plan.
//
// A block is G <= 8 consecutive neurons (warp k: neuron k) x `rows`
// consecutive rows; lane l of a warp takes rows l, l + 32, ..., R at a
// time.  Its shared memory, in floats, each part 16-byte aligned:
//   the geometry record (REPRO_GEOM_INTS),
//   per warp its neuron's padded weights (wfl),
//   the block's input tile: rows x xld (row r: its G neurons' F inputs,
//     contiguous as in the (T, O, F) input; xld odd),
//   a region that first holds every warp's packed row as it comes in
//     (raw floats each, staged plans only) and then the block's output
//     tile: rows x yld (yld odd).
// Choices, from what the card reports (SM count, the registers of each
// R's instantiation): G = min(8, O); R, the largest whose smallest tile
// (32 R rows) still gives every SM a block; rows, of 32 R x 2^k, the
// fewest waves of blocks x (rows an SM walks per wave + a block's
// start).  G halves until the block fits in 227 KB, staged rows before
// rows spread straight from global memory.  A tile sweep may force R,
// G and rows instead.  None of this changes any row's arithmetic: every
// plan gives the same bits.
#pragma once
#include <stddef.h>

#include "subnet_geom.h"

#define REPRO_MLP_MAX_G 8                  // neurons (warps) per block
#define REPRO_MLP_THREADS (32 * REPRO_MLP_MAX_G)
// A block's start (its weights and first inputs in, before any row
// runs) costs about as much as this many rows (the H100 tile sweep in
// chip_smoke.py, PERF.md).
#define REPRO_MLP_START_ROWS 64
#define REPRO_SM_REGS 65536
#define REPRO_SM_SMEM 233472               // 228 KB per SM
#define REPRO_SM_WARPS 64
#define REPRO_SM_BLOCKS 32

struct MlpTile {
  int G, rows, R, flags;   // neurons and rows per block, rows per thread,
                           // TF_STAGED or 0
  int xld, yld;            // input / output tile strides (odd)
  int wfl, raw;            // floats of a warp's padded weights / raw row
  int xoff, zoff;          // offsets of the input tile and the region
  int glog;                // log2 of G rounded up to a power of two
};

struct MlpPlan {
  GeomRecord geom;
  MlpTile tile;
  size_t smem;
  int grid_x, grid_y;      // neuron groups, row tiles
};

static inline int rpo(int x, int m) { return (x + m - 1) / m * m; }

// The tile for (G, rows, R, flags): its layout and shared bytes.
static size_t mlp_tile(const GeomRecord& rec, int F, int G, int rows, int R,
                       int flags, MlpTile* t) {
  t->G = G;
  t->rows = rows;
  t->R = R;
  t->flags = flags;
  t->xld = (G * F) | 1;
  t->yld = G | 1;
  t->wfl = round4(rec.w[GH_PPAD]);
  t->raw = flags & TF_STAGED ? round4(rec.w[GH_PSTRIDE] + 3) : 0;
  t->xoff = REPRO_GEOM_INTS + G * t->wfl;
  t->zoff = t->xoff + round4(rows * t->xld);
  const int z = G * t->raw > rows * t->yld ? G * t->raw : rows * t->yld;
  t->glog = G > 4 ? 3 : G > 2 ? 2 : G > 1 ? 1 : 0;
  return sizeof(float) * (size_t)(t->zoff + round4(z));
}

// Resident blocks per SM for a block of G warps at `regs` registers per
// thread and `smem` bytes (registers allocated per warp in 256s).
static int mlp_blocks_per_sm(int G, int regs, size_t smem) {
  const int warp_regs = rpo(regs * 32, 256);
  int b = REPRO_SM_REGS / (G * warp_regs);
  const int bs = (int)(REPRO_SM_SMEM / (smem + 1024));
  const int bw = REPRO_SM_WARPS / G;
  b = bs < b ? bs : b;
  b = bw < b ? bw : b;
  return b < REPRO_SM_BLOCKS ? b : REPRO_SM_BLOCKS;
}

// The plan for T rows x O neurons of geometry g (largest width nmax) on
// a card of `sms` SMs; regs[i]: the registers per thread of the kernel
// at R = 1 << i for this geometry's NMAX (0: no such instantiation).
// force: NULL, or {R, neurons per block, rows per block} to take instead
// of the choice (0: choose), for a tile sweep.  Returns 0 or
// REPRO_EINVAL.
static int mlp_plan(const SubnetGeom& g, int nmax, int T, int O, int sms,
                    const int regs[3], const int* force, MlpPlan* p) {
  static const int none[3] = {0, 0, 0};
  if (!force) force = none;
  if (T < 1 || O < 1 || nmax > 32 || sms < 1 || regs[0] < 1 ||
      force[1] < 0 || force[1] > REPRO_MLP_MAX_G)
    return REPRO_EINVAL;
  subnet_record(g, &p->geom);
  const int F = g.width[0];
  int G = force[1] ? force[1] : O < REPRO_MLP_MAX_G ? O : REPRO_MLP_MAX_G;
  // R: the largest whose smallest tile (32 R rows) still gives every SM
  // a block
  int ri = -1;
  for (int i = 2; i >= 0; --i) {
    if (regs[i] < 1) continue;
    const int R = 1 << i;
    if (force[0]) {
      if (force[0] == R) ri = i;
      continue;
    }
    const long long blocks =
        (long long)((O + G - 1) / G) * ((T + 32 * R - 1) / (32 * R));
    if (i == 0 || blocks >= sms) {
      ri = i;
      break;
    }
  }
  if (ri < 0) return REPRO_EINVAL;
  const int R = 1 << ri;
  if (force[2] && (force[2] % (32 * R) || force[2] > 65535))
    return REPRO_EINVAL;
  // G, staged first, the largest at which the smallest tile fits: 32 R
  // rows, or enough for at most 65535 row tiles
  MlpTile t;
  int flags = TF_STAGED;
  const int rows0 = force[2] ? force[2] : rpo(rpo(T, 65535) / 65535, 32 * R);
  while (mlp_tile(p->geom, F, G, rows0, R, flags, &t) > REPRO_MAX_SMEM) {
    if (flags) {
      flags = 0;
    } else if (G > 1 && !force[1]) {
      G /= 2;
      flags = TF_STAGED;
    } else {
      return REPRO_EINVAL;
    }
  }
  // rows: of rows0 x 2^k, the fewest waves of blocks x (the rows an SM
  // walks per wave + a block's start)
  int rows = rows0;
  long long best = -1;
  for (long long cand = rows0; !force[2] && cand <= 65535; cand *= 2) {
    const size_t smem = mlp_tile(p->geom, F, G, (int)cand, R, flags, &t);
    if (smem > REPRO_MAX_SMEM) break;
    const long long blocks = (long long)((O + G - 1) / G) * ((T + cand - 1) /
                                                           cand);
    const int bps = mlp_blocks_per_sm(G, regs[ri], smem);
    const long long slots = (long long)sms * (bps > 0 ? bps : 1);
    const long long est = (blocks + slots - 1) / slots *
                          (cand * bps + REPRO_MLP_START_ROWS);
    if (best < 0 || est < best) {
      best = est;
      rows = (int)cand;
    }
    if (cand >= T) break;
  }
  p->smem = mlp_tile(p->geom, F, G, rows, R, flags, &p->tile);
  p->geom.w[GH_G] = G;
  p->geom.w[GH_FLAGS] = flags;
  p->grid_x = (O + G - 1) / G;
  p->grid_y = (T + rows - 1) / rows;
  if (p->grid_y > 65535) return REPRO_EINVAL;
  return 0;
}

// The plan as numbers, in this order.
enum { MP_R, MP_G, MP_ROWS, MP_FLAGS, MP_SMEM, MP_GRID_X, MP_GRID_Y,
       MP_PSTRIDE, MP_PPAD, MP_WORDS };

static void mlp_plan_words(const MlpPlan& p, long long* out) {
  out[MP_R] = p.tile.R;
  out[MP_G] = p.tile.G;
  out[MP_ROWS] = p.tile.rows;
  out[MP_FLAGS] = p.tile.flags;
  out[MP_SMEM] = (long long)p.smem;
  out[MP_GRID_X] = p.grid_x;
  out[MP_GRID_Y] = p.grid_y;
  out[MP_PSTRIDE] = p.geom.w[GH_PSTRIDE];
  out[MP_PPAD] = p.geom.w[GH_PPAD];
}

// The plan of a K2 launch of T rows x O neurons at (nlayers, widths,
// skip) on a card of `sms` SMs whose kernels at R = 1, 2, 4 take regs[0
// .. 2] registers (0: none), into out[MP_WORDS]; force as for mlp_plan.
// Returns 0 or REPRO_EINVAL (the entry then refuses the launch too).
extern "C" int repro_grouped_subnet_plan(int T, int O, int nlayers,
                                         const int* widths, int skip,
                                         int sms, const int* regs,
                                         const int* force, long long* out) {
  SubnetGeom g;
  int nmax = 0;
  int rc = repro_subnet_layout(nlayers, widths, skip, &g, &nmax);
  if (rc) return rc;
  MlpPlan p;
  if ((rc = mlp_plan(g, nmax, T, O, sms, regs, force, &p))) return rc;
  mlp_plan_words(p, out);
  return 0;
}
