// Host-side launch helpers shared by the kernels' launchers.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <mutex>

namespace dm {

// Lets one kernel take `smem` bytes of dynamic shared memory, with the
// carve-out at the most shared memory, on the current device.  The
// attributes are set once per device and again only for a larger `smem`,
// so a launch at a size already allowed makes no attribute call.  Keep one
// static instance per kernel.
class SmemAllowance {
 public:
  explicit SmemAllowance(const void* kernel) : kernel_(kernel) {}

  cudaError_t allow(int smem) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::atomic<int>* done = dev < kMaxDevices ? &allowed_[dev] : nullptr;
    if (done && smem <= done->load(std::memory_order_acquire))
      return cudaSuccess;
    std::lock_guard<std::mutex> lock(mu_);
    const int had = done ? done->load(std::memory_order_relaxed) : 0;
    if (smem <= had) return cudaSuccess;
    if (had == 0)
      err = cudaFuncSetAttribute(kernel_,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel_, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess && done)
      done->store(smem, std::memory_order_release);
    return err;
  }

 private:
  static constexpr int kMaxDevices = 64;
  const void* kernel_;
  std::atomic<int> allowed_[kMaxDevices] = {};  // bytes; 0: nothing set
  std::mutex mu_;
};

// Blocks of `kernel` one SM of the current device holds at `threads` per
// block and `smem` bytes of dynamic shared memory, once `allowance` lets
// it take them (cudaOccupancyMaxActiveBlocksPerMultiprocessor); negative:
// a CUDA error.
inline int blocks_per_sm(SmemAllowance& allowance, const void* kernel,
                         int threads, int smem) {
  cudaError_t err = allowance.allow(smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace dm
