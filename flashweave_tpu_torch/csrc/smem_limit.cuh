// Raising a kernel's dynamic shared-memory limit, once per device.
//
// cudaFuncSetAttribute(cudaFuncAttributeMaxDynamicSharedMemorySize) sets the
// attribute of the function in the CURRENT device's context only.  A
// process-wide once (a function-local static initialised by the call) would
// leave every other device at the default 48 KB limit, and a launch there
// asking for more fails.  Each call site keeps one flag per device ordinal
// and sets the attribute the first time a device launches the kernel; an
// error is returned each time, and the flag stays unset, so a later launch
// tries again.  Racing first launches on one device both set the same value.
#pragma once

#include <cuda_runtime.h>

namespace fw_smem {

constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t raise_limit_once(Kernel kernel, int bytes,
                             bool (&raised)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && raised[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < kMaxDevices) raised[dev] = true;
  return err;
}

}  // namespace fw_smem
