// A kernel's dynamic shared-memory limit, raised once per device and size.
//
// A kernel that takes more than 48 KB of dynamic shared memory needs
// cudaFuncSetAttribute(..., cudaFuncAttributeMaxDynamicSharedMemorySize, n)
// on each device before it launches with n bytes. The attribute holds until
// it is set again, so a launch path calls reserve_shared, which makes that
// driver call only when a launch needs more than the device has been given
// so far, not before every launch.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace ffn {

constexpr int kMaxDevices = 64;

// One per kernel instantiation: the bytes reserved on each device so far.
struct SharedLimit {
  std::mutex lock;
  int bytes[kMaxDevices] = {};
};

template <typename Kernel>
cudaError_t reserve_shared(Kernel* kernel, size_t bytes, SharedLimit& limit) {
  const int wanted = static_cast<int>(bytes);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wanted);
  }
  std::lock_guard<std::mutex> guard(limit.lock);
  if (limit.bytes[device] >= wanted) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wanted);
  if (err == cudaSuccess) limit.bytes[device] = wanted;
  return err;
}

}  // namespace ffn
