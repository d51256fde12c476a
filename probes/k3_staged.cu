// A staged variant of K3's layer entry (csrc/lut_gather.cu,
// repro_lut_layer), kept only to time it against the shipped direct
// design (probes/k3_staged.py); no path of the port launches it.
//
// Same function: out[b, o] = tables[o, clamp(sum_j codes[b, conn[o, j]]
// << (in_bits (F - 1 - j)), 0, T - 1)], int32 sums wrapping modulo 2^32,
// connections clamped into [0, I).
//
// Design: a block is G neurons (threadIdx.x) x ng row groups
// (threadIdx.y) over a tile of rows = ng * RPT consecutive rows.  The
// block first copies its neurons' connections and the tile's code rows
// (contiguous in memory) into shared memory with coalesced loads, waits
// at one barrier, then each thread builds the addresses of its neuron for
// RPT rows from shared memory and keeps the RPT table loads in flight
// together.
#include <cuda_runtime.h>

template <int KF, int RPT>
__global__ void __launch_bounds__(256)
k3_staged_kernel(const int* __restrict__ codes, const int* __restrict__ conn,
                 const int* __restrict__ tables, int* __restrict__ out,
                 int B, int I, int O, int F, int in_bits, int T) {
  extern __shared__ int smem[];
  const int G = blockDim.x, ng = blockDim.y, rows = ng * RPT;
  const int o0 = blockIdx.y * G, r0 = blockIdx.x * rows;
  const int nrows = min(rows, B - r0);
  int* sconn = smem;             // G * F
  int* scode = smem + G * F;     // nrows * I
  const int tid = threadIdx.y * G + threadIdx.x, nthr = G * ng;
  for (int k = tid; k < G * F; k += nthr) {
    const int o = o0 + k / F;
    sconn[k] = o < O ? min(max(__ldg(conn + o0 * F + k), 0), I - 1) : 0;
  }
  const int* tile = codes + r0 * I;
  for (int k = tid; k < nrows * I; k += nthr) scode[k] = __ldg(tile + k);
  __syncthreads();
  const int o = o0 + threadIdx.x;
  if (o >= O) return;
  int c[KF];
#pragma unroll
  for (int j = 0; j < KF; ++j) c[j] = j < F ? sconn[threadIdx.x * F + j] : 0;
  const int* trow = tables + (size_t)o * T;
  int v[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int r = threadIdx.y + k * ng;
    unsigned acc = 0;
#pragma unroll
    for (int j = 0; j < KF; ++j)
      if (j < F && r < nrows) acc = (acc << in_bits) + (unsigned)scode[r * I + c[j]];
    v[k] = r < nrows ? __ldg(trow + min(max((int)acc, 0), T - 1)) : 0;
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int r = threadIdx.y + k * ng;
    if (r < nrows) out[(r0 + r) * O + o] = v[k];
  }
}

template <int KF, int RPT>
static int launch(const int* codes, const int* conn, const int* tables,
                  int* out, int B, int I, int O, int F, int in_bits,
                  cudaStream_t s) {
  const int G = O < 256 ? O : 256;
  const int ng = 256 / G < B ? 256 / G : B;
  const int rows = ng * RPT;
  const size_t smem = sizeof(int) * ((size_t)G * F + (size_t)rows * I);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(k3_staged_kernel<KF, RPT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((B + rows - 1) / rows, (O + G - 1) / G);
  k3_staged_kernel<KF, RPT><<<grid, dim3(G, ng), smem, s>>>(
      codes, conn, tables, out, B, I, O, F, in_bits, 1 << (in_bits * F));
  return (int)cudaGetLastError();
}

template <int KF>
static int by_rpt(int rpt, const int* codes, const int* conn,
                  const int* tables, int* out, int B, int I, int O, int F,
                  int in_bits, cudaStream_t s) {
  switch (rpt) {
    case 1: return launch<KF, 1>(codes, conn, tables, out, B, I, O, F, in_bits, s);
    case 2: return launch<KF, 2>(codes, conn, tables, out, B, I, O, F, in_bits, s);
    case 4: return launch<KF, 4>(codes, conn, tables, out, B, I, O, F, in_bits, s);
    case 8: return launch<KF, 8>(codes, conn, tables, out, B, I, O, F, in_bits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As repro_lut_layer, with rpt (1, 2, 4 or 8) rows per thread; F <= 8.
extern "C" int k3_staged_layer(const int* tables, const int* codes,
                               const int* conn, int* out, int B, int I,
                               int O, int F, int in_bits, int rpt,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || I < 1 || O < 1 || F < 1 || F > 8 || in_bits * F > 30)
    return (int)cudaErrorInvalidValue;
  if (F <= 4)
    return by_rpt<4>(rpt, codes, conn, tables, out, B, I, O, F, in_bits, s);
  return by_rpt<8>(rpt, codes, conn, tables, out, B, I, O, F, in_bits, s);
}
