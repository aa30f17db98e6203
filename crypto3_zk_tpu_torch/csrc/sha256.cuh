// Kernel 7: SHA-256 compression of a batch of equal-length messages, one
// thread a message, in three forms: the block and node forms in
// sha256.cu, the leaf form in sha256_leaf.cu (two sources, so that `nvcc`
// builds them side by side); this header holds what they share.
//
// It replaces `crypto3_zk_tpu/ops/sha256.py:39 sha256_batch_blocks`, which
// has no Pallas kernel: the JAX package runs the 64 rounds as a `lax.scan`
// of uint32 lane math and leaves the fusion to XLA. Its users are the sha2
// Merkle trees of `commitments/merkle.py`: a leaf is the big-endian bytes of
// a row of field elements, a node the 64 bytes of its two children.
//
// Layout: word planes, word index first and messages innermost, as the
// port keeps limb planes, so that neighbouring threads read neighbouring
// words:
// - block form, `zk_sha256_blocks`: padded messages as (nb * 16, n)
//   big-endian words, word j of block b of message i at (b*16 + j)*n + i;
// - node form, `zk_sha256_nodes`: a tree level's (8, 2m) digest words read
//   in place, message i being digests 2i and 2i + 1 (word j of digest d at
//   j*2m + d);
// - leaf form, `zk_sha256_field_rows`: a leaf of k field elements of nb
//   bytes (nb even) read from its canonical 16-bit digit planes, digit d of
//   element e of leaf i at d*sd + e*se + i; halfword h of the message is
//   digit HALF - 1 - (h mod HALF) of element h / HALF (HALF = nb / 2), and
//   the padding is written in registers;
// - the digests come out as (8, n) words, word j of message i at j*n + i.
//
// What bounds it: the integer pipes. A compression reads 64 bytes and
// issues at least 1,384 instructions (64 rounds of 14 with three-input
// LOP3 / IADD3 and funnel shifts, 48 schedule steps of 10, 8 additions),
// so the memory is two orders of magnitude away. An SM issues 128 lanes a
// clock, but the ALU pipe, which runs SHF, LOP3 and IADD3, takes only 64;
// written plainly, 89 % of a compression is ALU work and the kernel runs at
// the ALU pipe's rate, with the FMA pipe (another 64 lanes) nearly idle.
//
// The design moves the additions to the FMA pipe. Measured on the H100
// (`csrc/rate.cu`'s streams): `IMAD` issues beside `SHF`, `LOP3` or `IADD3`
// (a stream of `IMAD` and `SHF` runs at twice either's rate), but `IMAD.HI`
// runs at half rate and issues beside nothing, so a shift or rotation made
// of products (hi(x * 2^(32-n)) + lo(x * 2^(32-n))) costs more than the
// `SHF` it replaces (builds that did so were slower at every share). So
// rotations, shifts and logic stay on the ALU (672 `SHF` and 352 `LOP3` a
// compression with a schedule), and in the block and leaf forms every
// addition is an `IMAD` with a multiplier of one (600 a compression), a
// three-input sum two of them, ordered by when their terms are ready. The
// node form, two compressions a thread and mostly small launches on a tree's
// upper levels, leaves its additions to `ptxas`: an `IMAD` on the round's
// chain makes a small launch slower (a level of 2^12 pairs 5.7 us against
// 6.5 with every addition there), and at 2^18 pairs the placements differ
// by 4 % at most. `ptxas` turns a product by a one it can see back into an
// add, so the multiplier is read from `ZK_SHA256_ONE`, a `__constant__` it
// cannot see into, and the products are PTX `mad.lo`.
//
// A message whose length is a multiple of 64 bytes ends in a block of pure
// padding, whose schedule depends only on the length: the host computes its
// 64 words K[r] + W[r] once (`ops/sha256.py::padding_schedule`) and passes
// them as a 256-byte kernel argument, so that block's rounds read one
// constant-bank operand a round and run no schedule. The node form's second
// block is such a block (length 64); the block and leaf forms take it when
// the length allows, by shape. Other lengths run their padding through the
// ordinary rounds.
//
// Nothing is shared between threads: 128 threads a block, (n + 127) / 128
// blocks; the state and the rolling 16-word schedule window stay in
// registers (the rounds are unrolled, so every index is a constant). The
// block and leaf forms load the next block's 16 words before compressing
// the current one, so that their loads are in flight during a compression.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#define ZK_SHA256_THREADS 128

__constant__ uint32_t ZK_SHA256_K[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
    0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
    0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
    0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
    0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
    0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
    0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
    0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
    0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

// the multipliers of an addition (1) and of a 16-bit shift left (2^16) as
// `IMAD`s, in memory that `ptxas` cannot see into
__constant__ uint32_t ZK_SHA256_ONE = 1u;
__constant__ uint32_t ZK_SHA256_SHL16 = 1u << 16;

// K[r] + W[r] of a block of pure padding
struct ZkSha256Pad {
  uint32_t kw[64];
};

#ifdef __CUDACC__
__device__ __forceinline__ uint32_t zk_mad_lo(uint32_t a, uint32_t b,
                                              uint32_t c) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
#else
inline uint32_t zk_mad_lo(uint32_t a, uint32_t b, uint32_t c) {
  return a * b + c;
}
#endif

// a + b: an `IMAD` on the FMA pipe, or where `ptxas` puts it
template <bool FMA>
__device__ __forceinline__ uint32_t zk_add(uint32_t a, uint32_t b) {
  return FMA ? zk_mad_lo(a, ZK_SHA256_ONE, b) : a + b;
}

__device__ __forceinline__ uint32_t zk_rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ void zk_sha256_init(uint32_t (&st)[8]) {
  st[0] = 0x6a09e667u;
  st[1] = 0xbb67ae85u;
  st[2] = 0x3c6ef372u;
  st[3] = 0xa54ff53au;
  st[4] = 0x510e527fu;
  st[5] = 0x9b05688cu;
  st[6] = 0x1f83d9abu;
  st[7] = 0x5be0cd19u;
}

// One round on v = (a, ..., h); kw = K[r] + W[r]. With FMA, h + kw is
// summed first (off the chain that links e from round to round), then ch,
// then S1.
template <bool FMA>
__device__ __forceinline__ void zk_sha256_round(uint32_t (&v)[8],
                                                uint32_t kw) {
  const uint32_t a = v[0], b = v[1], c = v[2], d = v[3];
  const uint32_t e = v[4], f = v[5], g = v[6], h = v[7];
  const uint32_t s1 = zk_rotr(e, 6) ^ zk_rotr(e, 11) ^ zk_rotr(e, 25);
  const uint32_t ch = (e & f) ^ (~e & g);
  const uint32_t t1 = zk_add<FMA>(s1, zk_add<FMA>(ch, zk_add<FMA>(h, kw)));
  const uint32_t s0 = zk_rotr(a, 2) ^ zk_rotr(a, 13) ^ zk_rotr(a, 22);
  const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
  v[7] = g;
  v[6] = f;
  v[5] = e;
  v[4] = zk_add<FMA>(t1, d);
  v[3] = c;
  v[2] = b;
  v[1] = a;
  v[0] = zk_add<FMA>(s0, zk_add<FMA>(maj, t1));
}

template <bool FMA>
__device__ __forceinline__ void zk_sha256_finish(uint32_t (&st)[8],
                                                 const uint32_t (&v)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) st[j] = zk_add<FMA>(v[j], st[j]);
}

// One compression of the 16 words `w` into the state, its schedule
// computed in the rolling window `w` (overwritten).
template <bool FMA>
__device__ __forceinline__ void zk_sha256_compress(uint32_t (&st)[8],
                                                   uint32_t (&w)[16]) {
  uint32_t v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = st[j];
#pragma unroll
  for (int r = 0; r < 64; ++r) {
    if (r >= 16) {
      // w[r & 15] holds W[r-16]; W[r-15], W[r-7], W[r-2] sit at +1, +9, +14
      const uint32_t w15 = w[(r + 1) & 15], w2 = w[(r + 14) & 15];
      const uint32_t s0 =
          zk_rotr(w15, 7) ^ zk_rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = zk_rotr(w2, 17) ^ zk_rotr(w2, 19) ^ (w2 >> 10);
      // W[r-2] is the newest term: its sigma comes last
      w[r & 15] = zk_add<FMA>(
          s1, zk_add<FMA>(zk_add<FMA>(s0, w[r & 15]), w[(r + 9) & 15]));
    }
    zk_sha256_round<FMA>(v, zk_add<FMA>(w[r & 15], ZK_SHA256_K[r]));
  }
  zk_sha256_finish<FMA>(st, v);
}

// One compression of a block of pure padding: its K + W from the host, no
// schedule.
template <bool FMA>
__device__ __forceinline__ void zk_sha256_compress_pad(
    uint32_t (&st)[8], const ZkSha256Pad& pad) {
  uint32_t v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = st[j];
#pragma unroll
  for (int r = 0; r < 64; ++r) zk_sha256_round<FMA>(v, pad.kw[r]);
  zk_sha256_finish<FMA>(st, v);
}

__device__ __forceinline__ void zk_sha256_store(const uint32_t (&st)[8],
                                                uint32_t* out, long long n,
                                                long long i) {
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j * n + i] = st[j];
}

static inline unsigned zk_sha256_grid(long long n) {
  return (unsigned)((n + ZK_SHA256_THREADS - 1) / ZK_SHA256_THREADS);
}

static inline ZkSha256Pad zk_sha256_pad(const void* kw) {
  ZkSha256Pad pad;
  if (kw)
    std::memcpy(pad.kw, kw, sizeof(pad.kw));
  else
    std::memset(pad.kw, 0, sizeof(pad.kw));
  return pad;
}
