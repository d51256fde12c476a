// An empty kernel: its device time is the floor under any launch on the
// card, against which the cascade (K1) and per-layer lookup (K3) kernels'
// times are read (chip_smoke.py).  Not a port of any TPU kernel.
#include <cuda_runtime.h>

__global__ void launch_floor_kernel() {}

extern "C" int repro_launch_floor(int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  launch_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
