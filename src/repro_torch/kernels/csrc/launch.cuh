// Shared launch helper of the port's C entry points.
#pragma once
#include <cuda_runtime.h>

// Make `device` current, calling cudaSetDevice only when another device is
// current: the caller's thread almost always has it current already, and
// cudaGetDevice is a thread-local read where cudaSetDevice is not free.
inline cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}
