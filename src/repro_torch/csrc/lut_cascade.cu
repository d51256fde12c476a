// Fused LUT cascade for Hopper (sm_90a): the whole converted network,
// every node of a batch tile, in one launch.  The network is a DAG of LUT
// nodes (PolyLUT-Add adder trees, concatenated sources); a chain of
// layers is the degenerate case.
//
// Replaces the Pallas kernel src/repro/kernels/lut_cascade.py
// (lut_cascade, body _cascade_kernel, mux _mux_word) and its Mosaic-GPU
// twin src/repro/kernels/lut_cascade_gpu.py (lut_cascade_gpu).
//
// What bounds it on the card: not arithmetic (a lookup is a few integer
// ops) and not HBM bytes (the packed tables, 1.7 MB for neuralut-jsc-5l
// and 3.5 MB for polylut-add-jsc-5l, are read once into the 50 MB L2),
// but the latency of dependent loads: every node gathers one packed word
// per (row, neuron, branch) at a data-dependent address, and a node
// cannot start before the codes it reads exist.
//
// Design:
//  * Gather form.  The TPU kernel forms addresses with an f32
//    shift-matmul and selects words with a binary mux tree because its
//    vector unit cannot address by data.  A GPU thread can: it reads the
//    F connected codes, forms the address with integer shifts (slot 0 =
//    MSB, as lut_infer.pack_index), loads word `packed[o][addr >>
//    slot_bits]` and shifts out slot `addr & (P - 1)`.  No float is
//    involved, so the result is bit-identical to lut_infer.lut_forward
//    and graph_lut_forward.
//  * Tables stay in global memory and are served from L2 (an SM gets at
//    most 227 KB of shared memory).
//  * A block owns `rows_per_block` batch rows.  Each row has `stride`
//    uint16 code columns in shared memory; the host gives every buffer
//    that a later node reads its own slice of those columns, reusing the
//    slice of a buffer whose last reader has run (a chain ping-pongs
//    between two slices).  The input codes (buffer 0) are read from
//    global memory wherever a node names them, and the last node writes
//    its codes to global memory.  So no node's codes are overwritten
//    before their last reader, whatever the DAG.
//  * The host rewrites each branch's connectivity into columns: c >= 0
//    is shared-memory column c of the row, c < 0 is input column -1 - c.
//    A node that concatenates several sources is then one gather.
//  * The node descriptors (geometry and branch pointers, D_* below)
//    live in one device array that the block copies into shared memory
//    once, at its start: a node's fields are then shared loads, not
//    parameter-space loads on every node's dependent chain.
//  * Per node, the loop over its (row, neuron) items is specialized on
//    where its codes come from (all shared columns, all input, or both)
//    and on its arity (1, 2 or 4, unrolled, the branch pointers in
//    registers), so a lookup tests neither: its dependent chain is
//    column, code, table word, as in a chain.  Both choices were
//    measured against the chain-only kernel this one replaced (PERF.md,
//    K1); the arity-4 path sets the register count (59, against that
//    kernel's 40), which costs occupancy only at one row per block and
//    thousands of rows, a batch the serving engine never sends.
//  * An arity-A node (adder tree) looks up A branch tables and sums the
//    A beta-bit codes in a register before its one store; the sum is a
//    (beta + log2 A)-bit code, checked on the host to fit the uint16.
//  * Consecutive threads take consecutive neurons of one row, so column
//    and output accesses are contiguous.  The last tile may be ragged: a
//    block handles min(rows, B - row0) rows, so any B is accepted.
#include <cuda_runtime.h>

#define REPRO_MAX_NODES 16
#define REPRO_MAX_ARITY 4
#define REPRO_CASCADE_THREADS 256

// Where a node's codes come from: all from shared columns, all from the
// input, or both (a node that concatenates the input with other nodes).
// Uniform across the block, so the choice costs no divergence.
#define REPRO_SRC_SHARED 0
#define REPRO_SRC_INPUT 1
#define REPRO_SRC_MIXED 2

// One node's descriptor, as the host lays it out: REPRO_DESC_WORDS
// 64-bit words, the geometry then the branch pointers.
enum {
  D_OUT_WIDTH,  // O
  D_FAN_IN,     // F
  D_IN_BITS,    // bits of each input code: the per-slot shift
  D_WORDS,      // packed words per neuron: T / P
  D_SLOT_BITS,  // log2 P
  D_OUT_BITS,   // beta: bits of each table entry
  D_ARITY,      // branches summed into the stored code
  D_OUT_COL,    // first shared column of the output (last node: -1)
  D_SRC,        // REPRO_SRC_*
  D_COL,        // REPRO_MAX_ARITY pointers: (O, F) code columns
  D_PACKED = D_COL + REPRO_MAX_ARITY,  // ... (O, words) packed tables
  REPRO_DESC_WORDS = D_PACKED + REPRO_MAX_ARITY
};

// One node for the block's rows, specialized on where its codes come
// from and on its arity, so the per-lookup code carries no test of
// either: every (row, neuron) item sums its branches' looked-up codes
// and stores the sum.
template <int SRC, int ARITY>
__device__ __forceinline__ void run_node(
    const long long* d, bool last, const int* __restrict__ codes,
    int in_width, int row0, int nrows, unsigned short* bufs, int stride,
    int* __restrict__ out) {
  const int out_width = (int)d[D_OUT_WIDTH];
  const int fan_in = (int)d[D_FAN_IN];
  const int in_bits = (int)d[D_IN_BITS];
  const int words = (int)d[D_WORDS];
  const int slot_bits = (int)d[D_SLOT_BITS];
  const int out_bits = (int)d[D_OUT_BITS];
  const int out_col = (int)d[D_OUT_COL];
  const int* col_base[ARITY];
  const int* tab_base[ARITY];
#pragma unroll
  for (int a = 0; a < ARITY; ++a) {
    col_base[a] = (const int*)d[D_COL + a];
    tab_base[a] = (const int*)d[D_PACKED + a];
  }
  const unsigned slot_mask = (1u << slot_bits) - 1u;
  const unsigned code_mask = (1u << out_bits) - 1u;
  const unsigned max_word = (unsigned)(words - 1);
  const int total = nrows * out_width;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int r = idx / out_width;
    const int o = idx - r * out_width;
    const int* in_row = codes + (size_t)(row0 + r) * in_width;
    const unsigned short* row_codes = bufs + r * stride;
    unsigned sum = 0;
#pragma unroll
    for (int a = 0; a < ARITY; ++a) {
      const int* c = col_base[a] + (size_t)o * fan_in;
      unsigned addr = 0;
      for (int j = 0; j < fan_in; ++j) {
        const int col = __ldg(c + j);
        unsigned v;
        if (SRC == REPRO_SRC_SHARED) {
          v = row_codes[col];
        } else if (SRC == REPRO_SRC_INPUT) {
          v = (unsigned)__ldg(in_row - 1 - col);
        } else {
          v = col < 0 ? (unsigned)__ldg(in_row - 1 - col)
                      : (unsigned)row_codes[col];
        }
        addr = (addr << in_bits) + v;
      }
      // Valid codes keep addr < T; the clamp only keeps a bad input
      // inside the table row.
      const unsigned wsel = min(addr >> slot_bits, max_word);
      const unsigned word =
          (unsigned)__ldg(tab_base[a] + (size_t)o * words + wsel);
      sum += (word >> (out_bits * (addr & slot_mask))) & code_mask;
    }
    if (last) {
      out[(size_t)(row0 + r) * out_width + o] = (int)sum;
    } else {
      bufs[r * stride + out_col + o] = (unsigned short)sum;
    }
  }
}

template <int SRC>
__device__ __forceinline__ void run_node_src(
    const long long* d, bool last, const int* __restrict__ codes,
    int in_width, int row0, int nrows, unsigned short* bufs, int stride,
    int* __restrict__ out) {
  switch ((int)d[D_ARITY]) {
    case 1:
      run_node<SRC, 1>(d, last, codes, in_width, row0, nrows, bufs, stride,
                       out);
      break;
    case 2:
      run_node<SRC, 2>(d, last, codes, in_width, row0, nrows, bufs, stride,
                       out);
      break;
    default:
      run_node<SRC, 4>(d, last, codes, in_width, row0, nrows, bufs, stride,
                       out);
  }
}

__global__ void __launch_bounds__(REPRO_CASCADE_THREADS)
lut_cascade_kernel(const int* __restrict__ codes, int batch, int in_width,
                   int nnodes, const long long* __restrict__ desc,
                   int rows_per_block, int stride, int* __restrict__ out) {
  __shared__ long long node_desc[REPRO_MAX_NODES * REPRO_DESC_WORDS];
  extern __shared__ unsigned short bufs[];
  const int desc_words = nnodes * REPRO_DESC_WORDS;
  for (int i = threadIdx.x; i < desc_words; i += blockDim.x) {
    node_desc[i] = __ldg(desc + i);
  }
  __syncthreads();
  const int row0 = blockIdx.x * rows_per_block;
  const int nrows = min(rows_per_block, batch - row0);
  for (int n = 0; n < nnodes; ++n) {
    const long long* d = node_desc + n * REPRO_DESC_WORDS;
    const bool last = (n == nnodes - 1);
    switch ((int)d[D_SRC]) {
      case REPRO_SRC_SHARED:
        run_node_src<REPRO_SRC_SHARED>(d, last, codes, in_width, row0,
                                       nrows, bufs, stride, out);
        break;
      case REPRO_SRC_INPUT:
        run_node_src<REPRO_SRC_INPUT>(d, last, codes, in_width, row0, nrows,
                                      bufs, stride, out);
        break;
      default:
        run_node_src<REPRO_SRC_MIXED>(d, last, codes, in_width, row0, nrows,
                                      bufs, stride, out);
    }
    __syncthreads();
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// `desc` is the device array of `nnodes` node descriptors (see D_*), in
// schedule order; `stride` is the shared-memory row pitch in codes.  The
// wrapper has checked every shape, column and pointer.
extern "C" int repro_lut_cascade(int device, const int* codes, int batch,
                                 int in_width, int nnodes,
                                 const long long* desc, int rows_per_block,
                                 int stride, int* out, void* stream) {
  if (nnodes < 1 || nnodes > REPRO_MAX_NODES || rows_per_block < 1 ||
      batch < 1 || stride < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem =
      (size_t)rows_per_block * stride * sizeof(unsigned short);
  if (smem > 32 * 1024) {
    e = cudaFuncSetAttribute(
        lut_cascade_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (batch + rows_per_block - 1) / rows_per_block;
  lut_cascade_kernel<<<blocks, REPRO_CASCADE_THREADS, smem,
                       (cudaStream_t)stream>>>(
      codes, batch, in_width, nnodes, desc, rows_per_block, stride, out);
  return (int)cudaGetLastError();
}
