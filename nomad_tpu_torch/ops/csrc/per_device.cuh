// One-time launch state kept per device, not per process.
//
// cudaFuncSetAttribute applies to the current device only, and a card's
// SM count is its own: a process that launches on several cards sets the
// attribute and reads the count once on each of them.  The wrappers in
// ops/kernels.py make the tensor's card current around every launch.
#pragma once

#include <cuda_runtime.h>

#define NOMAD_MAX_DEVICES 64

// The current device's ordinal, or -1 when it is not one this table holds.
static inline int nomad_current_device() {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  return (dev >= 0 && dev < NOMAD_MAX_DEVICES) ? dev : -1;
}

// Raise `kernel`'s dynamic shared memory limit to `bytes` on the current
// device, once per device; `done` holds NOMAD_MAX_DEVICES flags.
template <class K>
static inline cudaError_t nomad_smem_once(bool* done, K kernel, int bytes) {
  const int dev = nomad_current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done[dev] = true;
  return e;
}

// The current device's SM count (132 when it cannot be read).
static inline int nomad_sm_count() {
  static int counts[NOMAD_MAX_DEVICES];
  const int dev = nomad_current_device();
  if (dev < 0) return 132;
  if (counts[dev] <= 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}
