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
// cannot start before the codes it reads exist.  So the design keeps
// everything but that table word off a node's dependent chain.
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
//  * One prologue, every copy in flight at once and one wait: the block
//    copies the network's program (the node descriptors, D_* below, and
//    every branch's code columns, 16-bit) into shared memory with 16-byte
//    cp.async copies, and its batch rows' input codes into the first W_0
//    16-bit columns of each row's code array.  A lookup's dependent chain
//    is then: shared columns, shared codes, one L2 table word, a shared
//    store.
//  * A row's code array holds the input codes, then `stride` columns for
//    the nodes' outputs: the host gives every buffer that a later node
//    reads its own slice of those columns, reusing the slice of a buffer
//    whose last reader has run (a chain ping-pongs between two slices),
//    and the last node writes its codes to global memory.  So no node's
//    codes are overwritten before their last reader, whatever the DAG.
//  * The host rewrites each branch's connectivity into positions in the
//    row's code array (input column j is position j; buffer column c is
//    W_0 + c), per neuron padded to a multiple of 4, so a neuron's first
//    4 columns are one 8-byte shared load.  A node that concatenates
//    several sources, the input among them, is then one gather.
//  * The kernel is specialized on the schedule's largest arity (1, 2 or
//    4, chosen on the host): a chain compiles none of the adder paths'
//    registers.  Within it, a node's loop is specialized on the node's
//    arity (unrolled, the branch pointers in registers).
//  * An arity-A node (adder tree) looks up A branch tables and sums the
//    A beta-bit codes in a register before its one store; the sum is a
//    (beta + log2 A)-bit code, checked on the host to fit the uint16.
//  * Consecutive threads take consecutive neurons of one row, so column
//    and output accesses are contiguous; the row of an item comes from
//    one multiply by a host-made divisor, not a division.  The last tile
//    may be ragged: a block handles min(rows, B - row0) rows, so any B is
//    accepted.
#include "subnet_geom.cuh"

#define REPRO_MAX_NODES 16
#define REPRO_MAX_ARITY 4
#define REPRO_CASCADE_THREADS 256

// One node's descriptor, as the host lays it out: REPRO_DESC_WORDS
// 64-bit words, the geometry then the branches.
enum {
  D_OUT_WIDTH,  // O
  D_FAN_IN,     // F
  D_IN_BITS,    // bits of each input code: the per-slot shift
  D_WORDS,      // packed words per neuron: T / P
  D_SLOT_BITS,  // log2 P
  D_OUT_BITS,   // beta: bits of each table entry
  D_ARITY,      // branches summed into the stored code
  D_OUT_COL,    // position of the output's first code in a row (last: -1)
  D_MAGIC,      // udiv's divisor for O
  D_COL,        // REPRO_MAX_ARITY offsets: (O, round4(F)) code columns
                // in the program's column area, in 16-bit entries
  D_PACKED = D_COL + REPRO_MAX_ARITY,  // ... (O, words) packed tables
  REPRO_DESC_WORDS = D_PACKED + REPRO_MAX_ARITY + 1   // 16-byte multiple
};

// One node for the block's rows, specialized on its arity: every (row,
// neuron) item sums its branches' looked-up codes and stores the sum.
template <int ARITY>
__device__ __forceinline__ void run_node(const long long* d,
                                         const unsigned short* colarea,
                                         unsigned short* rows, int pitch,
                                         int row0, int nrows,
                                         int* __restrict__ out) {
  const int out_width = (int)d[D_OUT_WIDTH];
  const int fan_in = (int)d[D_FAN_IN];
  const int in_bits = (int)d[D_IN_BITS];
  const int words = (int)d[D_WORDS];
  const int slot_bits = (int)d[D_SLOT_BITS];
  const int out_bits = (int)d[D_OUT_BITS];
  const int out_col = (int)d[D_OUT_COL];
  const int magic = (int)d[D_MAGIC];
  const int f4 = (fan_in + 3) & ~3;
  const unsigned short* col_base[ARITY];
  const int* tab_base[ARITY];
#pragma unroll
  for (int a = 0; a < ARITY; ++a) {
    col_base[a] = colarea + d[D_COL + a];
    tab_base[a] = (const int*)d[D_PACKED + a];
  }
  const unsigned slot_mask = (1u << slot_bits) - 1u;
  const unsigned code_mask = (1u << out_bits) - 1u;
  const unsigned max_word = (unsigned)(words - 1);
  const int total = nrows * out_width;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int r = udiv(idx, magic);
    const int o = idx - r * out_width;
    unsigned short* row = rows + r * pitch;
    unsigned sum = 0;
#pragma unroll
    for (int a = 0; a < ARITY; ++a) {
      const unsigned short* c = col_base[a] + o * f4;
      unsigned addr = 0;
      for (int j0 = 0; j0 < fan_in; j0 += 4) {
        const uint2 cc = *reinterpret_cast<const uint2*>(c + j0);
        const unsigned col[4] = {cc.x & 0xffffu, cc.x >> 16, cc.y & 0xffffu,
                                 cc.y >> 16};
        unsigned v[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) v[m] = row[col[m]];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (j0 + m < fan_in) addr = (addr << in_bits) + v[m];
      }
      // Valid codes keep addr < T; the clamp only keeps a bad input
      // inside the table row.
      const unsigned wsel = min(addr >> slot_bits, max_word);
      const unsigned word =
          (unsigned)__ldg(tab_base[a] + (size_t)o * words + wsel);
      sum += (word >> (out_bits * (addr & slot_mask))) & code_mask;
    }
    if (out_col < 0) {
      out[(size_t)(row0 + r) * out_width + o] = (int)sum;
    } else {
      row[out_col + o] = (unsigned short)sum;
    }
  }
}

// Shared memory: the program (prog_chunks x 16 bytes: the descriptors,
// then the column area), then rows_per_block code arrays of `pitch`
// 16-bit codes.
template <int MAXA>
__global__ void __launch_bounds__(REPRO_CASCADE_THREADS)
lut_cascade_kernel(const int* __restrict__ codes, int batch, int in_width,
                   int nnodes, const long long* __restrict__ prog,
                   int prog_chunks, int rows_per_block, int pitch,
                   int* __restrict__ out) {
  extern __shared__ __align__(16) long long sprog[];
  unsigned short* rows =
      reinterpret_cast<unsigned short*>(sprog + 2 * prog_chunks);
  for (int i = threadIdx.x; i < prog_chunks; i += blockDim.x)
    cp_async16(sprog + 2 * i, prog + 2 * i);
  const int row0 = blockIdx.x * rows_per_block;
  const int nrows = min(rows_per_block, batch - row0);
  const int* src = codes + (size_t)row0 * in_width;
  for (int i = threadIdx.x; i < nrows * in_width; i += blockDim.x) {
    const int r = i / in_width;
    rows[r * pitch + i - r * in_width] = (unsigned short)__ldg(src + i);
  }
  cp_async_wait();
  __syncthreads();
  const unsigned short* colarea =
      reinterpret_cast<const unsigned short*>(sprog +
                                              nnodes * REPRO_DESC_WORDS);
  for (int n = 0; n < nnodes; ++n) {
    const long long* d = sprog + n * REPRO_DESC_WORDS;
    const int arity = (int)d[D_ARITY];
    if (MAXA >= 4 && arity == 4) {
      run_node<(MAXA >= 4 ? 4 : 1)>(d, colarea, rows, pitch, row0, nrows,
                                    out);
    } else if (MAXA >= 2 && arity == 2) {
      run_node<(MAXA >= 2 ? 2 : 1)>(d, colarea, rows, pitch, row0, nrows,
                                    out);
    } else {
      run_node<1>(d, colarea, rows, pitch, row0, nrows, out);
    }
    if (n < nnodes - 1) __syncthreads();
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

template <int MAXA>
static int launch(const int* codes, int batch, int in_width, int nnodes,
                  const long long* prog, int prog_chunks, int threads,
                  int rows_per_block, int pitch, size_t smem, int* out,
                  cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lut_cascade_kernel<MAXA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (batch + rows_per_block - 1) / rows_per_block;
  lut_cascade_kernel<MAXA><<<blocks, threads, smem, stream>>>(
      codes, batch, in_width, nnodes, prog, prog_chunks, rows_per_block,
      pitch, out);
  return (int)cudaGetLastError();
}

// `prog` is the device array of the network's program: `nnodes` node
// descriptors (see D_*) in schedule order, then the column area,
// prog_chunks x 16 bytes in all.  max_arity: the schedule's largest
// arity (1, 2 or 4); max_width: its widest node, which sets the threads
// per block; `pitch`: a row's code array, in codes (W_0 + the nodes'
// columns).  The wrapper has checked every shape, column and pointer.
extern "C" int repro_lut_cascade(int device, const int* codes, int batch,
                                 int in_width, int nnodes,
                                 const long long* prog, int prog_chunks,
                                 int max_arity, int max_width,
                                 int rows_per_block, int pitch, int* out,
                                 void* stream) {
  if (nnodes < 1 || nnodes > REPRO_MAX_NODES || rows_per_block < 1 ||
      batch < 1 || pitch < in_width || prog_chunks < 1 || max_width < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)prog_chunks * 16 +
                      (size_t)rows_per_block * pitch * sizeof(unsigned short);
  const long long items = (long long)rows_per_block * max_width;
  const int threads =
      items >= REPRO_CASCADE_THREADS ? REPRO_CASCADE_THREADS
                                     : (int)((items + 31) / 32 * 32);
  cudaStream_t s = (cudaStream_t)stream;
  switch (max_arity) {
    case 1:
      return launch<1>(codes, batch, in_width, nnodes, prog, prog_chunks,
                       threads, rows_per_block, pitch, smem, out, s);
    case 2:
      return launch<2>(codes, batch, in_width, nnodes, prog, prog_chunks,
                       threads, rows_per_block, pitch, smem, out, s);
    case 4:
      return launch<4>(codes, batch, in_width, nnodes, prog, prog_chunks,
                       threads, rows_per_block, pitch, smem, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
