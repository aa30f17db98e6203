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
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <cstring>
#include <memory>
#include <mutex>
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
#define __constant__

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
// the funnel shift right: the low 32 bits of (hi:lo) >> (s mod 32)
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned s) {
  s &= 31u;
  return s ? (lo >> s) | (hi << (32u - s)) : lo;
}
// the high 32 bits of the 64-bit product
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}
using std::max;
using std::min;

// ---- Hopper's asynchronous machinery, as kernel 8 (mxu_ntt.cu) uses it --
// A shared-memory address is the offset into `sh`. An mbarrier is a slot
// of 8 bytes in shared memory; its state (expected and pending arrivals,
// the transaction bytes still due, the phase) lives in a host table keyed
// by the slot, behind a mutex, and a wait spins on the phase. A bulk copy
// is a memcpy that then completes its bytes on the barrier. The warpgroup
// product reads both tiles through their descriptors (start address, LBO,
// SBO, no swizzle) and writes the thread's own accumulator entries, so it
// is complete when it returns: commit, wait, the fences and `setmaxnreg`
// have nothing left to do.
inline uint32_t smem_addr(const void* p) {
  return (uint32_t)((const char*)p - (const char*)sh);
}
struct HostMbar {
  std::mutex mu;
  int expected = 0, pending = 0;
  long long tx = 0;
  std::atomic<unsigned> phase{0};
};
inline HostMbar host_mbars[64];
inline HostMbar& host_mbar(const uint64_t* bar) {
  return host_mbars[(smem_addr(bar) / 8) % 64];
}
inline void host_mbar_settle(HostMbar& b) {
  if (b.pending == 0 && b.tx == 0) {
    b.pending = b.expected;
    b.phase.fetch_xor(1u);
  }
}
inline void mbar_init(uint64_t* bar, uint32_t count) {
  HostMbar& b = host_mbar(bar);
  std::lock_guard<std::mutex> lock(b.mu);
  b.expected = b.pending = (int)count;
  b.tx = 0;
  b.phase.store(0u);
}
inline void mbar_fence_init() {}
inline void mbar_arrive(uint64_t* bar) {
  HostMbar& b = host_mbar(bar);
  std::lock_guard<std::mutex> lock(b.mu);
  --b.pending;
  host_mbar_settle(b);
}
inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  HostMbar& b = host_mbar(bar);
  std::lock_guard<std::mutex> lock(b.mu);
  b.tx += bytes;
  --b.pending;
  host_mbar_settle(b);
}
inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  HostMbar& b = host_mbar(bar);
  while ((b.phase.load() & 1u) == parity) std::this_thread::yield();
  std::lock_guard<std::mutex> lock(b.mu);   // the writers' data, seen
}
inline void bulk_load(void* dst, const void* src, uint32_t bytes,
                      uint64_t* bar) {
  std::memcpy(dst, src, bytes);
  HostMbar& b = host_mbar(bar);
  std::lock_guard<std::mutex> lock(b.mu);
  b.tx -= bytes;
  host_mbar_settle(b);
}
// `bar.sync id, count` / `bar.arrive id, count`: a std::barrier of
// `count` threads a block and id, made at its first use
inline std::mutex host_named_mu;
inline std::unique_ptr<std::barrier<>> host_named[16];
inline std::barrier<>& host_named_barrier(int id, int count) {
  std::lock_guard<std::mutex> lock(host_named_mu);
  if (!host_named[id]) host_named[id] = std::make_unique<std::barrier<>>(count);
  return *host_named[id];
}
inline void named_sync(int id, int count) {
  host_named_barrier(id, count).arrive_and_wait();
}
inline void named_arrive(int id, int count) {
  auto token = host_named_barrier(id, count).arrive();
  (void)token;
}
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
struct alignas(8) uint2 {
  unsigned x, y;
};
inline void fence_async_smem() {}
inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int N>
inline void wgmma_wait() {}
inline void fence_operand(uint32_t&) {}
template <int N>
inline void regs_inc() {}
template <int N>
inline void regs_dec() {}
// d (+)= A B, 64 x 64 x 32 unsigned bytes, K-major tiles in shared memory:
// element (row, k) of a tile at start + (row / 8) SBO + (k / 16) LBO +
// (row % 8) 16 + k % 16. The thread's entries: row 16 warp + lane/4 + 8 i,
// column 8 n + 2 (lane % 4) + e, in d[4 n + 2 i + e].
inline void wgmma_u8_m64n64k32(uint32_t (&d)[32], uint64_t da, uint64_t db,
                               uint32_t accumulate) {
  const uint8_t* smem = (const uint8_t*)sh;
  auto at = [smem](uint64_t desc, int row, int k) {
    const uint32_t start = (uint32_t)(desc & 0x3FFFu) << 4;
    const uint32_t lbo = (uint32_t)((desc >> 16) & 0x3FFFu) << 4;
    const uint32_t sbo = (uint32_t)((desc >> 32) & 0x3FFFu) << 4;
    return (uint32_t)smem[start + (row / 8) * sbo + (k / 16) * lbo +
                          (row % 8) * 16 + k % 16];
  };
  const int t = threadIdx.x % 128, lane = t % 32;
  for (int n = 0; n < 8; ++n)
    for (int i = 0; i < 2; ++i)
      for (int e = 0; e < 2; ++e) {
        const int row = 16 * (t / 32) + lane / 4 + 8 * i;
        const int col = 8 * n + 2 * (lane % 4) + e;
        uint32_t s = 0;
        for (int k = 0; k < 32; ++k) s += at(da, row, k) * at(db, col, k);
        uint32_t& out = d[4 * n + 2 * i + e];
        out = (accumulate ? out : 0u) + s;
      }
}

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
    for (auto& named : host_named) named.reset();
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
