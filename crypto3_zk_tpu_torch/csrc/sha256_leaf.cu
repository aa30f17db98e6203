// Kernel 7, leaf form: Merkle leaves of k field elements hashed from their
// canonical digit planes (the design: sha256.cuh).
#include "sha256.cuh"

// Halfword h < k * HALF of a leaf message: digit HALF - 1 - (h mod HALF) of
// element h / HALF, at index (HALF - 1 - h) * sd + e * (se + HALF * sd) + i
// (32-bit arithmetic, which wraps to the right index: the wrapper keeps
// every index below 2^31).
template <int HALF>
__device__ __forceinline__ uint32_t zk_leaf_half(
    const int32_t* __restrict__ digits, uint32_t h, uint32_t sd,
    uint32_t step, uint32_t i) {
  const uint32_t e = h / HALF;
  return (uint32_t)digits[(HALF - 1 - h) * sd + e * step + i];
}

// Word w of a leaf message that holds data only (2w + 1 < k * HALF).
template <int HALF>
__device__ __forceinline__ uint32_t zk_leaf_word(
    const int32_t* __restrict__ digits, uint32_t w, uint32_t sd,
    uint32_t step, uint32_t i) {
  const uint32_t h = 2 * w;
  uint32_t hi, lo;
  if (HALF % 2 == 0) {
    // both halfwords in one element, on neighbouring planes
    const uint32_t e = h / HALF;
    const uint32_t at = (HALF - 1 - h) * sd + e * step + i;
    hi = (uint32_t)digits[at];
    lo = (uint32_t)digits[at - sd];
  } else {
    hi = zk_leaf_half<HALF>(digits, h, sd, step, i);
    lo = zk_leaf_half<HALF>(digits, h + 1, sd, step, i);
  }
  return zk_mad_lo(hi, ZK_SHA256_SHL16, lo);       // (hi << 16) | lo
}

// Word j of block b, the last data block or after it: data, the 0x80 byte
// (halfword 0x8000 at halfword `len`), zeros, and in the last block the bit
// length 16 * len as a big-endian 64-bit integer.
template <int HALF>
__device__ __forceinline__ uint32_t zk_leaf_tail_word(
    const int32_t* __restrict__ digits, int b, int j, int nb, uint32_t len,
    uint32_t sd, uint32_t step, uint32_t i) {
  if (b == nb - 1 && j == 15) return 16u * len;
  if (b == nb - 1 && j == 14) return 0u;           // the length's high word
  const uint32_t h = 32u * b + 2u * j;
  const uint32_t hi = h < len ? zk_leaf_half<HALF>(digits, h, sd, step, i)
                              : (h == len ? 0x8000u : 0u);
  const uint32_t lo = h + 1 < len
                          ? zk_leaf_half<HALF>(digits, h + 1, sd, step, i)
                          : (h + 1 == len ? 0x8000u : 0u);
  return (hi << 16) | lo;
}

template <int HALF>
__global__ void __launch_bounds__(ZK_SHA256_THREADS)
    sha256_field_rows_kernel(const int32_t* __restrict__ digits, long long n,
                             int k, uint32_t sd, uint32_t se,
                             const ZkSha256Pad pad,
                             uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t len = (uint32_t)k * HALF;     // halfwords of the message
  const int full = (int)(len / 32);            // blocks of data only
  const bool pure = len % 32 == 0;             // then one block of padding
  const int nb = pure ? full : (int)((2 * len + 8) / 64 + 1);
  const uint32_t step = se + HALF * sd, ii = (uint32_t)i;
  uint32_t st[8], w[16], next[16];
  zk_sha256_init(st);
  auto load = [&](int b, uint32_t (&dst)[16]) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      dst[j] = zk_leaf_word<HALF>(digits, 16u * b + j, sd, step, ii);
  };
  // the next block's words load while the current one is compressed
  if (full > 0) load(0, next);
#pragma unroll 1
  for (int b = 0; b < full; ++b) {
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = next[j];
    if (b + 1 < full) load(b + 1, next);
    zk_sha256_compress<true>(st, w);
  }
#pragma unroll 1
  for (int b = full; b < nb; ++b) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      w[j] = zk_leaf_tail_word<HALF>(digits, b, j, nb, len, sd, step, ii);
    zk_sha256_compress<true>(st, w);
  }
  if (pure) zk_sha256_compress_pad<true>(st, pad);
  zk_sha256_store(st, out, n, i);
}

// digits: canonical 16-bit digits of n leaves of k elements, digit d of
// element e of leaf i at d*sd + e*se + i (every index below 2^31); half:
// the element's bytes / 2, one of 4, 16, 19, 24; pad_kw: K + W of the
// padding block when k * 2 * half is a multiple of 64, else unused.
// out: (8, n).
extern "C" int zk_sha256_field_rows(const void* digits, long long n, int k,
                                    int half, long long sd, long long se,
                                    const void* pad_kw, void* out,
                                    void* stream) {
  if (n < 1 || k < 1 || sd < 1 || se < 1 || sd > 0x7fffffff ||
      se > 0x7fffffff || n > (long long)ZK_SHA256_THREADS * 0x7fffffff ||
      (2LL * k * half % 64 == 0 && !pad_kw))
    return (int)cudaErrorInvalidValue;
  const ZkSha256Pad pad = zk_sha256_pad(pad_kw);
  const unsigned grid = zk_sha256_grid(n);
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* d = (const int32_t*)digits;
  uint32_t* o = (uint32_t*)out;
  switch (half) {
    case 4:
      sha256_field_rows_kernel<4><<<grid, ZK_SHA256_THREADS, 0, s>>>(
          d, n, k, (uint32_t)sd, (uint32_t)se, pad, o);
      break;
    case 16:
      sha256_field_rows_kernel<16><<<grid, ZK_SHA256_THREADS, 0, s>>>(
          d, n, k, (uint32_t)sd, (uint32_t)se, pad, o);
      break;
    case 19:
      sha256_field_rows_kernel<19><<<grid, ZK_SHA256_THREADS, 0, s>>>(
          d, n, k, (uint32_t)sd, (uint32_t)se, pad, o);
      break;
    case 24:
      sha256_field_rows_kernel<24><<<grid, ZK_SHA256_THREADS, 0, s>>>(
          d, n, k, (uint32_t)sd, (uint32_t)se, pad, o);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
