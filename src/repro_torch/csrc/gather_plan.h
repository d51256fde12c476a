// The launch plan of the per-layer lookup kernel K3 (lut_gather.cu): how
// many neurons and rows a block takes.  Host code in plain C++ with no
// CUDA header: the kernel's entries launch what gather_plan returns, and
// the CPU tests build this header alone with a host compiler and check
// the plan through repro_lut_layer_plan.
//
// A block is G consecutive neurons (threadIdx.x) x ng consecutive rows
// (threadIdx.y), G * ng <= 256 threads, one lookup per thread: the
// threads of a warp take neighbouring neurons of one row (or, for
// G < 32, neighbouring rows), so their code loads share the row's
// sectors and their stores are contiguous.  The kernel needs no shared
// memory.
// Choices: G = min(O, 256); ng = 256 / G, no more than the batch.  On the
// H100, at every batch from 1 to 4096, two rows per thread were never
// more than 0.0001 ms faster and four or eight were slower (PERF.md,
// section 6), so a thread takes one row.
#pragma once

#define REPRO_GATHER_THREADS 256
#define REPRO_GATHER_MAX_F 30      // in_bits * F <= 30, in_bits >= 1
#ifndef REPRO_EINVAL
#define REPRO_EINVAL 1             // cudaErrorInvalidValue
#endif

struct GatherPlan {
  int G, ng;               // neurons, rows per block
  int grid_x, grid_y;      // row tiles, neuron groups
};

// The plan for B rows x O neurons at fan-in F (0: addresses given).
// Returns 0 or REPRO_EINVAL.
static inline int gather_plan(int B, int O, int F, GatherPlan* p) {
  if (B < 1 || O < 1 || F < 0 || F > REPRO_GATHER_MAX_F) return REPRO_EINVAL;
  const int G = O < REPRO_GATHER_THREADS ? O : REPRO_GATHER_THREADS;
  const int ng = REPRO_GATHER_THREADS / G < B ? REPRO_GATHER_THREADS / G : B;
  const long long grid_y = (O + G - 1) / G;
  if (grid_y > 65535) return REPRO_EINVAL;
  p->G = G;
  p->ng = ng;
  p->grid_x = (B + ng - 1) / ng;
  p->grid_y = (int)grid_y;
  return 0;
}

// The plan as numbers, in this order.
enum { GP_G, GP_NG, GP_GRID_X, GP_GRID_Y, GP_WORDS };

// The plan of a K3 launch (B, O and F as for gather_plan), into
// out[GP_WORDS].  Returns 0 or REPRO_EINVAL (the entries then refuse the
// launch too).
extern "C" int repro_lut_layer_plan(int B, int O, int F, long long* out) {
  GatherPlan p;
  const int rc = gather_plan(B, O, F, &p);
  if (rc) return rc;
  out[GP_G] = p.G;
  out[GP_NG] = p.ng;
  out[GP_GRID_X] = p.grid_x;
  out[GP_GRID_Y] = p.grid_y;
  return 0;
}
