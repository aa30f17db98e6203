// A stand-in for the CUDA runtime, for compiling the kernels of this
// directory with a host C++20 compiler and running them on the CPU: the
// kernels' index, stride, shared-memory and barrier logic and the
// arithmetic of field.cuh can then be checked where there is no card
// (tools/host_kernels.py builds with it; it is never used on the card).
//
// A launch runs its blocks one after another; inside a block every CUDA
// thread is a std::thread, `__syncthreads` is a std::barrier over the block
// and `__syncwarp` one over the thread's warp (32 threads), and dynamic
// shared memory is one global array that the kernels' `extern __shared__
// uint32_t sh[]` names. A kernel must not return before its last barrier in
// some threads only; none here does. The `<<<...>>>` launch syntax is
// rewritten by tools/host_kernels.py into `host_launch`.
#pragma once

#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

struct HostDim3 {
  unsigned x, y, z;
};
inline thread_local HostDim3 threadIdx, blockIdx, blockDim, gridDim;
inline std::barrier<>* host_block_barrier = nullptr;
inline thread_local std::barrier<>* host_warp_barrier = nullptr;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__

alignas(16) inline uint32_t sh[57 * 1024];   // 228 KB, an SM's shared memory

inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }
inline void __syncwarp() { host_warp_barrier->arrive_and_wait(); }
inline unsigned __brev(unsigned v) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) {
    r = (r << 1) | (v & 1u);
    v >>= 1;
  }
  return r;
}
using std::max;
using std::min;

typedef void* cudaStream_t;
typedef int cudaError_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8
};
template <class Kernel>
inline cudaError_t cudaFuncSetAttribute(Kernel, int, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// `kernel<<<blocks, threads, smem, stream>>>(args)` becomes
// `host_launch(blocks, threads, smem, [&] { kernel(args); })`.
inline void host_launch(long long blocks, int threads, size_t smem,
                        const std::function<void()>& body) {
  if (smem > sizeof(sh)) {
    fprintf(stderr, "host_launch: %zu bytes of shared memory\n", smem);
    abort();
  }
  for (long long b = 0; b < blocks; ++b) {
    // poison, so that a read of shared memory nobody wrote shows
    std::fill(sh, sh + sizeof(sh) / sizeof(sh[0]), 0xDEADBEEFu);
    std::barrier<> barrier(threads);
    host_block_barrier = &barrier;
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    for (int w = 0; w < (threads + 31) / 32; ++w)
      warps.push_back(
          std::make_unique<std::barrier<>>(std::min(32, threads - 32 * w)));
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, t, b] {
        host_warp_barrier = warps[t / 32].get();
        threadIdx = {(unsigned)t, 0, 0};
        blockIdx = {(unsigned)b, 0, 0};
        blockDim = {(unsigned)threads, 1, 1};
        gridDim = {(unsigned)blocks, 1, 1};
        body();
        host_warp_barrier->arrive_and_drop();
        barrier.arrive_and_drop();
      });
    for (auto& th : pool) th.join();
  }
}
