// Per-layer truth-table lookup for Hopper (sm_90a), in two entries that
// share one kernel body:
//   repro_lut_layer:  out[b, o] = tables[o, clamp(sum_j codes[b, conn[o, j]]
//                     << (in_bits (F - 1 - j)), 0, T - 1)], the whole step of
//                     one chain layer (gather, pack, look up) in one launch;
//   repro_lut_gather: out[b, o] = tables[o, clamp(addr[b, o], 0, T - 1)],
//                     addresses given.
//
// Replaces the Pallas kernel src/repro/kernels/lut_gather.py (lut_lookup,
// body _kernel), which the reference's per-layer serving route
// (layer_kernel) runs once per layer after gathering and packing the
// layer's input codes in the same jit.  repro_lut_layer does that whole
// step; repro_lut_gather is lut_lookup itself.
//
// What bounds it on the card: memory, and at serving batches the latency
// of its dependent loads (connections, codes, table entry).  Each lookup
// writes a 4-byte code and reads a table entry that costs a whole 32-byte
// sector (neighbouring lookups hit unrelated table rows); each row's
// input codes are read once.  The jsc-5l tables (13.7 MB) fit the 50 MB
// L2.
//
// Design (the launch plan is in gather_plan.h):
//  * The TPU kernel broadcasts a VMEM-resident table tile over the batch
//    tile and halves it log2(T) times with a binary mux tree, because the
//    TPU's vector unit cannot address memory by data.  A GPU thread can
//    load tables[o * T + addr] directly.
//  * Gathering mode: each thread loads its neuron's F connections, then
//    the F codes they name in each of its rows, then the table entry.
//    The F loads of a row hit one row of codes (512 B for I = 128), so the
//    threads of a warp, 32 neurons of one row, share its sectors through
//    L1.  Staging the block's connections and code rows in shared memory
//    first (one barrier, 1-8 rows per thread: probes/k3_staged.cu)
//    measured slower at every shape and batch on the H100 (PERF.md,
//    section 6): the barrier and the shared-memory round trip cost more
//    than the extra dependent load they save.
//  * Addresses: the int32 sum of codes at place values
//    2^(in_bits (F - 1 - j)) (as lut_infer.shift_weights), wrapped modulo
//    2^32 as PyTorch's int32 products and sum wrap, then clamped into
//    [0, T) as kernels/ref.lut_gather_ref clamps.  An out-of-range code
//    therefore gives exactly the plain route's answer.  A connection
//    outside [0, I) is clamped into it, so no load leaves the codes.
//  * A thread looks up one neuron in one row, its loads in a dependent
//    chain (connections, codes, table entry); index math is 32-bit (the
//    wrappers keep B * I and B * O below 2^31) apart from one 64-bit
//    table-row offset per thread.
//  * Ragged edges are masked: rows past B and neurons past O are never
//    loaded or stored.  Any B, I and O are accepted; T is a power of two.
#include <cuda_runtime.h>

#include "gather_plan.h"

// KF: the compile-time bound on the fan-in F (connections and codes held
// in registers, indexed only inside unrolled loops); 0 = addresses given.
template <int KF>
__global__ void __launch_bounds__(REPRO_GATHER_THREADS)
lut_gather_kernel(const int* __restrict__ src, const int* __restrict__ conn,
                  const int* __restrict__ tables, int* __restrict__ out,
                  int B, int I, int O, int F, int in_bits, int T) {
  const int r = blockIdx.x * blockDim.y + threadIdx.y;
  const int o = blockIdx.y * blockDim.x + threadIdx.x;
  if (o >= O || r >= B) return;
  int addr;
  if constexpr (KF > 0) {
    int c[KF];
#pragma unroll
    for (int j = 0; j < KF; ++j)
      c[j] = j < F ? min(max(__ldg(conn + o * F + j), 0), I - 1) : 0;
    const int* row = src + r * I;
    int code[KF];
#pragma unroll
    for (int j = 0; j < KF; ++j) code[j] = j < F ? __ldg(row + c[j]) : 0;
    unsigned acc = 0;
#pragma unroll
    for (int j = 0; j < KF; ++j)
      if (j < F) acc = (acc << in_bits) + (unsigned)code[j];
    addr = (int)acc;
  } else {
    addr = __ldg(src + r * O + o);
  }
  out[r * O + o] = __ldg(tables + (size_t)o * T + min(max(addr, 0), T - 1));
}

template <int KF>
static int plan_and_launch(int device, const int* src, const int* conn,
                           const int* tables, int* out, int B, int I, int O,
                           int F, int in_bits, int T, cudaStream_t s) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  GatherPlan p;
  if (gather_plan(B, O, KF > 0 ? F : 0, &p))
    return (int)cudaErrorInvalidValue;
  lut_gather_kernel<KF><<<dim3(p.grid_x, p.grid_y), dim3(p.G, p.ng), 0, s>>>(
      src, conn, tables, out, B, I, O, F, in_bits, T);
  return (int)cudaGetLastError();
}

static bool sizes_ok(int B, int n, int O, int T) {
  return B >= 1 && n >= 1 && O >= 1 && T >= 1 && !(T & (T - 1)) &&
         (long long)B * n < 0x80000000LL && (long long)B * O < 0x80000000LL;
}

// tables: (O, T) int32 row-major; addr, out: (B, O) int32 row-major.
extern "C" int repro_lut_gather(int device, const int* tables,
                                const int* addr, int* out, int B, int O,
                                int T, void* stream) {
  if (!sizes_ok(B, O, O, T)) return (int)cudaErrorInvalidValue;
  return plan_and_launch<0>(device, addr, nullptr, tables, out, B, 0, O, 0,
                            0, T, (cudaStream_t)stream);
}

// tables: (O, T = 2^(in_bits F)) int32; codes: (B, I) int32; conn: (O, F)
// int32; out: (B, O) int32; all row-major.  in_bits * F <= 30.
extern "C" int repro_lut_layer(int device, const int* tables,
                               const int* codes, const int* conn, int* out,
                               int B, int I, int O, int F, int in_bits,
                               void* stream) {
  if (in_bits < 1 || F < 1 || in_bits * F > REPRO_GATHER_MAX_F ||
      !sizes_ok(B, I, O, 1 << (in_bits * F)))
    return (int)cudaErrorInvalidValue;
  const int T = 1 << (in_bits * F);
  cudaStream_t s = (cudaStream_t)stream;
  if (F <= 2)
    return plan_and_launch<2>(device, codes, conn, tables, out, B, I, O, F,
                              in_bits, T, s);
  if (F <= 4)
    return plan_and_launch<4>(device, codes, conn, tables, out, B, I, O, F,
                              in_bits, T, s);
  if (F <= 8)
    return plan_and_launch<8>(device, codes, conn, tables, out, B, I, O, F,
                              in_bits, T, s);
  return plan_and_launch<REPRO_GATHER_MAX_F>(device, codes, conn, tables, out,
                                             B, I, O, F, in_bits, T, s);
}
