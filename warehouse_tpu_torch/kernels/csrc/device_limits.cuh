// What the current device lets one CTA have. The kernels whose shared-memory
// need grows with the model's widths pick their route, or their tile's rows,
// against it.
#pragma once

#include <cuda_runtime.h>

namespace {

// Bytes of shared memory a CTA may opt in to on the current device (227 KB
// on an H100), or 0 when the device cannot be asked.
inline size_t smem_optin_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return (size_t)bytes;
}

}  // namespace
