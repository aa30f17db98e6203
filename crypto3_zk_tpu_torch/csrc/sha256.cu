// Kernel 7, block and node forms (the design: sha256.cuh).
#include "sha256.cuh"

__global__ void __launch_bounds__(ZK_SHA256_THREADS)
    sha256_blocks_kernel(const uint32_t* __restrict__ words, long long n,
                         int nblocks, int padded, const ZkSha256Pad pad,
                         uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t st[8], w[16], next[16];
  zk_sha256_init(st);
  auto load = [&](int b, uint32_t (&dst)[16]) {
    const uint32_t* blk = words + (long long)b * 16 * n + i;
#pragma unroll
    for (int j = 0; j < 16; ++j) dst[j] = blk[j * n];
  };
  // the next block's words load while the current one is compressed
  if (nblocks > 0) load(0, next);
#pragma unroll 1
  for (int b = 0; b < nblocks; ++b) {
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = next[j];
    if (b + 1 < nblocks) load(b + 1, next);
    zk_sha256_compress<true>(st, w);
  }
  if (padded) zk_sha256_compress_pad<true>(st, pad);
  zk_sha256_store(st, out, n, i);
}

__global__ void __launch_bounds__(ZK_SHA256_THREADS)
    sha256_nodes_kernel(const uint32_t* __restrict__ level, long long m,
                        const ZkSha256Pad pad, uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const long long n_in = 2 * m;
  uint32_t st[8], w[16];
  zk_sha256_init(st);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    w[j] = level[j * n_in + 2 * i];
    w[8 + j] = level[j * n_in + 2 * i + 1];
  }
  zk_sha256_compress<false>(st, w);
  zk_sha256_compress_pad<false>(st, pad);
  zk_sha256_store(st, out, m, i);
}

// words: (nblocks * 16, n) big-endian words of padded messages, or of all
// but their last block when pad_kw is given: then that block is pure
// padding and pad_kw its 64 words K[r] + W[r]. out: (8, n).
extern "C" int zk_sha256_blocks(const void* words, long long n, int nblocks,
                                const void* pad_kw, void* out, void* stream) {
  if (n < 1 || nblocks < 0 || (nblocks == 0 && !pad_kw) ||
      n > (long long)ZK_SHA256_THREADS * 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  sha256_blocks_kernel<<<zk_sha256_grid(n), ZK_SHA256_THREADS, 0,
                         (cudaStream_t)stream>>>(
      (const uint32_t*)words, n, nblocks, pad_kw != nullptr,
      zk_sha256_pad(pad_kw), (uint32_t*)out);
  return (int)cudaGetLastError();
}

// level: (8, 2m) digests; pad_kw: K + W of the padding block of a 64-byte
// message; out: (8, m), the digest of each pair.
extern "C" int zk_sha256_nodes(const void* level, long long m,
                               const void* pad_kw, void* out, void* stream) {
  if (m < 1 || !pad_kw || m > (long long)ZK_SHA256_THREADS * 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  sha256_nodes_kernel<<<zk_sha256_grid(m), ZK_SHA256_THREADS, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)level, m, zk_sha256_pad(pad_kw), (uint32_t*)out);
  return (int)cudaGetLastError();
}
