// Shared by the port's kernels. Each source builds into its own shared
// library with a plain C interface (loaded with ctypes): a launcher
// returns the cudaError_t of its launch, and error_string() turns that
// code into text for the Python wrapper's exception.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#define PRTP_EXPORT extern "C" __attribute__((visibility("default")))

PRTP_EXPORT const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Threads over a row's channels (x) and rows per block (y): a warp
// spans one row's contiguous channels, so loads and stores coalesce.
inline dim3 row_block(int64_t per_row, int threads = 256) {
  int tx = 32;
  while (tx < per_row && tx < threads) tx *= 2;
  if (per_row < 32) {
    tx = 1;
    while (tx < per_row) tx *= 2;
  }
  return dim3(tx, threads / tx);
}
