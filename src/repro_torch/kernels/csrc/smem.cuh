// The dynamic shared-memory limit of a kernel, raised once per device and
// size: cudaFuncSetAttribute is called only when a launch needs more than
// the largest size set so far on the current device (a high-water mark the
// caller keeps, one per kernel instantiation), so a steady run of launches
// calls nothing. Its error is returned (above 227 KB it fails).
#pragma once
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kSmemDevices = 64;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t (&high)[kSmemDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kSmemDevices && bytes <= high[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kSmemDevices) high[dev] = bytes;
  return err;
}

}  // namespace
