// Fused LUT cascade for Hopper (sm_90a): the whole converted network,
// every layer of a batch tile, in one launch.
//
// Replaces the Pallas kernel src/repro/kernels/lut_cascade.py
// (lut_cascade, body _cascade_kernel, mux _mux_word) and its Mosaic-GPU
// twin src/repro/kernels/lut_cascade_gpu.py (lut_cascade_gpu).
//
// What bounds it on the card: not arithmetic (a lookup is a few integer
// ops) and not HBM bytes (the packed jsc-5l stack is 1.7 MB, read once
// into the 50 MB L2), but the latency of dependent loads: every layer
// gathers one packed word per (row, neuron) at a data-dependent address,
// and layer l+1 cannot start before layer l's codes exist.
//
// Design:
//  * Gather form.  The TPU kernel forms addresses with an f32
//    shift-matmul and selects words with a binary mux tree because its
//    vector unit cannot address by data.  A GPU thread can: it reads the
//    F connected codes by `conn`, forms the address with integer shifts
//    (slot 0 = MSB, as lut_infer.pack_index), loads word
//    `packed[o][addr >> slot_bits]` and shifts out slot
//    `addr & (P - 1)`.  No float is involved, so the result is
//    bit-identical to lut_infer.lut_forward.
//  * Tables stay in global memory and are served from L2 (an SM gets at
//    most 227 KB of shared memory; the stack is 1.7 MB).
//  * A block owns `rows_per_block` batch rows.  Their inter-layer codes
//    ping-pong between two uint16 buffers in shared memory (codes are
//    < 2^beta <= 2^16) and never go back to HBM: the first layer reads
//    the input codes from global memory, the last writes its codes to
//    global memory.  Consecutive threads take consecutive neurons of one
//    row, so `conn` and output accesses are contiguous.
//  * The last tile may be ragged: a block handles min(rows, B - row0)
//    rows, so any B is accepted.
//  * Chain schedules only: layer l reads layer l-1's codes.
#include <cuda_runtime.h>

#define REPRO_MAX_LAYERS 16
#define REPRO_CASCADE_THREADS 256

struct CascadeLayer {
  const int* conn;    // (O, F) source index of each fan-in slot
  const int* packed;  // (O, words) bit-packed table rows
  int out_width;      // O
  int fan_in;         // F
  int in_bits;        // bits of each input code: the per-slot shift
  int words;          // packed words per neuron: T / P
  int slot_bits;      // log2 P
  int out_bits;       // beta: bits of each stored code
};

struct CascadeArgs {
  int nlayers;
  CascadeLayer layer[REPRO_MAX_LAYERS];
};

__global__ void __launch_bounds__(REPRO_CASCADE_THREADS)
lut_cascade_kernel(const int* __restrict__ codes, int batch, int in_width,
                   int rows_per_block, int stride, CascadeArgs args,
                   int* __restrict__ out) {
  extern __shared__ unsigned short bufs[];
  unsigned short* cur = bufs;
  unsigned short* nxt = bufs + rows_per_block * stride;
  const int row0 = blockIdx.x * rows_per_block;
  const int nrows = min(rows_per_block, batch - row0);
  for (int l = 0; l < args.nlayers; ++l) {
    const CascadeLayer L = args.layer[l];
    const bool first = (l == 0);
    const bool last = (l == args.nlayers - 1);
    const unsigned slot_mask = (1u << L.slot_bits) - 1u;
    const unsigned code_mask = (1u << L.out_bits) - 1u;
    const unsigned max_word = (unsigned)(L.words - 1);
    const int total = nrows * L.out_width;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int r = idx / L.out_width;
      const int o = idx - r * L.out_width;
      const int* c = L.conn + (size_t)o * L.fan_in;
      const int* in_row = codes + (size_t)(row0 + r) * in_width;
      const unsigned short* cur_row = cur + r * stride;
      unsigned addr = 0;
      for (int j = 0; j < L.fan_in; ++j) {
        const int src = __ldg(c + j);
        const unsigned v = first ? (unsigned)__ldg(in_row + src)
                                 : (unsigned)cur_row[src];
        addr = (addr << L.in_bits) + v;
      }
      // Valid codes keep addr < T; the clamp only keeps a bad input
      // inside the table row.
      const unsigned wsel = min(addr >> L.slot_bits, max_word);
      const unsigned word =
          (unsigned)__ldg(L.packed + (size_t)o * L.words + wsel);
      const unsigned code =
          (word >> (L.out_bits * (addr & slot_mask))) & code_mask;
      if (last) {
        out[(size_t)(row0 + r) * L.out_width + o] = (int)code;
      } else {
        nxt[r * stride + o] = (unsigned short)code;
      }
    }
    __syncthreads();
    unsigned short* t = cur;
    cur = nxt;
    nxt = t;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// geom holds 6 ints per layer: O, F, in_bits, words, slot_bits, out_bits.
// `stride` is the widest intermediate layer (the shared-memory row
// pitch); the wrapper has checked every shape and pointer.
extern "C" int repro_lut_cascade(int device, const int* codes, int batch,
                                 int in_width,
                                 int nlayers, const void* const* conn_ptrs,
                                 const void* const* packed_ptrs,
                                 const int* geom, int rows_per_block,
                                 int stride, int* out, void* stream) {
  if (nlayers < 1 || nlayers > REPRO_MAX_LAYERS || rows_per_block < 1 ||
      batch < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  CascadeArgs args;
  args.nlayers = nlayers;
  for (int l = 0; l < nlayers; ++l) {
    CascadeLayer& L = args.layer[l];
    L.conn = (const int*)conn_ptrs[l];
    L.packed = (const int*)packed_ptrs[l];
    L.out_width = geom[6 * l + 0];
    L.fan_in = geom[6 * l + 1];
    L.in_bits = geom[6 * l + 2];
    L.words = geom[6 * l + 3];
    L.slot_bits = geom[6 * l + 4];
    L.out_bits = geom[6 * l + 5];
  }
  const size_t smem =
      2 * (size_t)rows_per_block * stride * sizeof(unsigned short);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(
        lut_cascade_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (batch + rows_per_block - 1) / rows_per_block;
  lut_cascade_kernel<<<blocks, REPRO_CASCADE_THREADS, smem,
                       (cudaStream_t)stream>>>(
      codes, batch, in_width, rows_per_block, stride, args, out);
  return (int)cudaGetLastError();
}
