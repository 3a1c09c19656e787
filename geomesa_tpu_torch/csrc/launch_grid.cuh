// launch_grid.cuh: grid sizes from the current device's own SM count and a
// kernel's occupancy, cached per device.
//
// The wrappers in geomesa_tpu_torch/ops/kernels.py launch under the
// tensors' device (torch.cuda.device), so the current device here is the
// one the kernel runs on. Both lookups cost a CUDA runtime query, so each is
// kept per device (and, for the occupancy, per kernel and the last shared
// memory size asked for), under a lock: ctypes releases the GIL around a
// call.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace launch_grid {

constexpr int kMaxDevices = 64;
constexpr int kMaxEntries = 64;

inline std::mutex& lock() {
  static std::mutex mu;
  return mu;
}

inline cudaError_t sms_of(int dev, int* sms) {
  static int cache[kMaxDevices] = {};
  if (dev >= kMaxDevices) return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (!cache[dev]) {
    cudaError_t err = cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = cache[dev];
  return cudaSuccess;
}

// The SM count of the current device.
inline cudaError_t device_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock());
  return sms_of(dev, sms);
}

// The blocks of `kern` that the current device holds at once with
// `threads` threads and `smem` bytes of dynamic shared memory a block: its
// SM count times the kernel's resident blocks per SM.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kern, int threads, size_t smem, long long* blocks) {
  struct Entry {
    int dev;
    const void* kern;
    int threads;
    size_t smem;
    long long blocks;
  };
  static Entry cache[kMaxEntries];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* key = reinterpret_cast<const void*>(kern);
  std::lock_guard<std::mutex> guard(lock());
  Entry* slot = nullptr;
  for (int i = 0; i < used; ++i) {
    if (cache[i].dev == dev && cache[i].kern == key) slot = &cache[i];
  }
  if (slot && slot->threads == threads && slot->smem == smem) {
    *blocks = slot->blocks;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = sms_of(dev, &sms);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = (long long)sms * per_sm;
  if (!slot && used < kMaxEntries) slot = &cache[used++];
  if (slot) *slot = Entry{dev, key, threads, smem, *blocks};
  return cudaSuccess;
}

}  // namespace launch_grid
