// A dependent shared-memory chase, to measure the chain floor of the
// staged walks (csrc/traceback_walk.cu): one thread follows x = s[x]
// through a shuffled ring of 4,096 int32 in shared memory for `steps`
// steps, as a staged walk follows its moves through a box. Built and timed
// by tools/chain_floor.py (nvcc -shared, ctypes).
#include <cuda_runtime.h>

__global__ void smem_chase_kernel(const int* ring, int n, long long steps, int* out) {
  __shared__ int s[4096];
  for (int q = 0; q < n; ++q) s[q] = ring[q];
  int x = 0;
  for (long long t = 0; t < steps; ++t) x = s[x];
  *out = x;
}

extern "C" int smem_chase_launch(const void* ring, int n, long long steps, void* out,
                                 void* stream) {
  if (n < 1 || n > 4096) return (int)cudaErrorInvalidValue;
  smem_chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int*)ring, n, steps, (int*)out);
  return (int)cudaGetLastError();
}
