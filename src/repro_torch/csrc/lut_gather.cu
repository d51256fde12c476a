// Per-layer truth-table lookup for Hopper (sm_90a):
// out[b, o] = tables[o, addr[b, o]] for every (row, neuron) of a batch.
//
// Replaces the Pallas kernel src/repro/kernels/lut_gather.py (lut_lookup,
// body _kernel), which the reference's per-layer serving route
// (layer_kernel) runs once per layer.
//
// What bounds it on the card: bytes, and in practice the latency of one
// data-dependent load.  Each lookup reads its 4-byte address, one table
// entry and writes a 4-byte code; the table entry costs a whole 32-byte
// sector, since neighbouring lookups hit unrelated rows.  The jsc-5l
// tables (3.4 M int32 entries, 13.7 MB) fit the 50 MB L2.
//
// Design: the TPU kernel broadcasts a VMEM-resident table tile over the
// batch tile and halves it log2(T) times with a binary mux tree, because
// the TPU's vector unit cannot address memory by data.  A GPU thread
// can: one thread per (b, o) loads addr[b, o] and then
// tables[o * T + addr].  Consecutive threads take consecutive neurons of
// one row, so the address and output accesses are coalesced.  The
// address is clamped into [0, T) (T is a power of two), so a bad address
// never reads outside its table row; the plain version clamps the same
// way.  Any B and O are accepted: there are no tiles to pad.
#include <cuda_runtime.h>

#define REPRO_GATHER_THREADS 256

__global__ void __launch_bounds__(REPRO_GATHER_THREADS)
lut_gather_kernel(const int* __restrict__ tables, const int* __restrict__ addr,
                  int* __restrict__ out, long long n, int O, int T) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int o = (int)(i % O);
  const int a = min(max(__ldg(addr + i), 0), T - 1);
  out[i] = __ldg(tables + (size_t)o * T + a);
}

// tables: (O, T) int32 row-major; addr, out: (B, O) int32 row-major.
extern "C" int repro_lut_gather(int device, const int* tables,
                                const int* addr, int* out, int B, int O,
                                int T, void* stream) {
  if (B < 1 || O < 1 || T < 1 || (T & (T - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)B * O;
  const long long blocks = (n + REPRO_GATHER_THREADS - 1) /
                           REPRO_GATHER_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  lut_gather_kernel<<<(unsigned)blocks, REPRO_GATHER_THREADS, 0,
                      (cudaStream_t)stream>>>(tables, addr, out, n, O, T);
  return (int)cudaGetLastError();
}
