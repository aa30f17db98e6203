// Prime-field device routines shared by every kernel of the port.
//
// Storage contract (same as the Python layer): a batch of field elements is
// NL planes of 16-bit digits, each digit in an int32, limb axis first. A
// thread fuses digit pairs into NW = NL/2 32-bit words in registers, works
// on words with 64-bit products, and splits back to digits on store. The
// Montgomery radix is R = 2^(32*NW) = 2^(16*NL), so values are bit-identical
// to the 16-bit-digit arithmetic they replace.
//
// One source serves every field with an even digit count: NW = 8 (254/255-bit
// fields) and NW = 12 (381-bit). The constants travel by value as a kernel
// argument (`FieldConst`), filled on the host from the field's parameters.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

template <int NW>
struct FieldConst {
  uint32_t p[NW];    // modulus, little-endian words
  uint32_t one[NW];  // R mod p  (Montgomery form of 1)
  uint32_t ninv;     // -p^{-1} mod 2^32
};

// Host side: `consts` is NW words of p, NW words of R mod p, one word -p^-1.
template <int NW>
static inline FieldConst<NW> make_const(const uint32_t* consts) {
  FieldConst<NW> F;
  for (int j = 0; j < NW; ++j) {
    F.p[j] = consts[j];
    F.one[j] = consts[NW + j];
  }
  F.ninv = consts[2 * NW];
  return F;
}

// Digit planes -> words. `base` points at digit 0 of the element, digit j
// lives `j * limb_stride` int32s further.
template <int NW>
__device__ __forceinline__ void load_digits(uint32_t (&w)[NW],
                                            const int32_t* base,
                                            long long limb_stride) {
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint32_t lo = (uint32_t)base[(2 * j) * limb_stride];
    uint32_t hi = (uint32_t)base[(2 * j + 1) * limb_stride];
    w[j] = (lo & 0xFFFFu) | (hi << 16);
  }
}

template <int NW>
__device__ __forceinline__ void store_digits(int32_t* base,
                                             long long limb_stride,
                                             const uint32_t (&w)[NW]) {
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    base[(2 * j) * limb_stride] = (int32_t)(w[j] & 0xFFFFu);
    base[(2 * j + 1) * limb_stride] = (int32_t)(w[j] >> 16);
  }
}

// ---------------------------------------------------------------------------
// Carry chains. The card adds with carry through a flag that C cannot name,
// so the chains are PTX: `mad.lo.cc` / `madc.hi.cc` on a register pair become
// one 64-bit multiply-add with carry in and out. Every statement that reads
// or writes the flag is `asm volatile`, which keeps them in program order; the
// compiler itself never emits an instruction that touches the flag. A host
// compiler sees the same functions with the flag as a thread-local variable,
// which is how the arithmetic is checked without the card.
// ---------------------------------------------------------------------------
#ifdef __CUDACC__
// (hi:lo) += a * b, carry out
__device__ __forceinline__ void mad_wide_cc(uint32_t& lo, uint32_t& hi,
                                            uint32_t a, uint32_t b) {
  asm volatile("mad.lo.cc.u32 %0, %2, %3, %0; madc.hi.cc.u32 %1, %2, %3, %1;"
               : "+r"(lo), "+r"(hi) : "r"(a), "r"(b));
}
// (hi:lo) += a * b + carry, carry out
__device__ __forceinline__ void madc_wide_cc(uint32_t& lo, uint32_t& hi,
                                             uint32_t a, uint32_t b) {
  asm volatile("madc.lo.cc.u32 %0, %2, %3, %0; madc.hi.cc.u32 %1, %2, %3, %1;"
               : "+r"(lo), "+r"(hi) : "r"(a), "r"(b));
}
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t d;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t d;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t d;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t d;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t d;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// a - b - borrow; for a = b = 0 that is 0 or 0xFFFFFFFF: the borrow as a mask
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t d;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
#else
// The flag as PTX defines it: the carry out of an add, the borrow out of a
// subtract.
inline thread_local uint32_t zk_flag = 0;
inline void madc_wide_cc(uint32_t& lo, uint32_t& hi, uint32_t a, uint32_t b) {
  unsigned __int128 s = (unsigned __int128)(((uint64_t)hi << 32) | lo) +
                        (uint64_t)a * b + zk_flag;
  lo = (uint32_t)s;
  hi = (uint32_t)(s >> 32);
  zk_flag = (uint32_t)(s >> 64);
}
inline void mad_wide_cc(uint32_t& lo, uint32_t& hi, uint32_t a, uint32_t b) {
  zk_flag = 0;
  madc_wide_cc(lo, hi, a, b);
}
inline uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint64_t s = (uint64_t)a + b + zk_flag;
  zk_flag = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
inline uint32_t add_cc(uint32_t a, uint32_t b) {
  zk_flag = 0;
  return addc_cc(a, b);
}
inline uint32_t addc(uint32_t a, uint32_t b) { return a + b + zk_flag; }
inline uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint64_t s = (uint64_t)a - b - zk_flag;
  zk_flag = (uint32_t)(s >> 63);
  return (uint32_t)s;
}
inline uint32_t sub_cc(uint32_t a, uint32_t b) {
  zk_flag = 0;
  return subc_cc(a, b);
}
inline uint32_t subc(uint32_t a, uint32_t b) { return a - b - zk_flag; }
#endif

// r = t - p if t >= p else t, for t < 2p that fits NW words.
template <int NW>
__device__ __forceinline__ void cond_sub_p(uint32_t (&r)[NW],
                                           const uint32_t (&t)[NW],
                                           const FieldConst<NW>& F) {
  uint32_t d[NW];
  d[0] = sub_cc(t[0], F.p[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) d[j] = subc_cc(t[j], F.p[j]);
  const bool below = subc(0u, 0u) != 0;     // a borrow: t < p
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = below ? t[j] : d[j];
}

// a + b mod p. Both fields leave the top bit of the top word free, so the
// sum of two values below p fits NW words.
template <int NW>
__device__ __forceinline__ void add_mod(uint32_t (&r)[NW],
                                        const uint32_t (&a)[NW],
                                        const uint32_t (&b)[NW],
                                        const FieldConst<NW>& F) {
  uint32_t t[NW];
  t[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < NW - 1; ++j) t[j] = addc_cc(a[j], b[j]);
  t[NW - 1] = addc(a[NW - 1], b[NW - 1]);
  cond_sub_p<NW>(r, t, F);
}

template <int NW>
__device__ __forceinline__ void sub_mod(uint32_t (&r)[NW],
                                        const uint32_t (&a)[NW],
                                        const uint32_t (&b)[NW],
                                        const FieldConst<NW>& F) {
  uint32_t d[NW];
  d[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) d[j] = subc_cc(a[j], b[j]);
  const uint32_t mask = subc(0u, 0u);       // all ones if a < b
  r[0] = add_cc(d[0], F.p[0] & mask);
#pragma unroll
  for (int j = 1; j < NW - 1; ++j) r[j] = addc_cc(d[j], F.p[j] & mask);
  r[NW - 1] = addc(d[NW - 1], F.p[NW - 1] & mask);
}

// acc += v * s * 2^(32*i), where acc is the sum of two word arrays E and O
// indexed by absolute word: the product v[j]*s sits at words (i+j, i+j+1) and
// goes to E when i+j is even, to O when it is odd, so each array is a row of
// 64-bit accumulators that never overlap and one carry chain runs along each.
// With `fold`, the carry out of word i-1 of the sum (whose two halves are
// E[i-1] and O[i-1]) enters the chain that starts at word i.
template <int NW>
__device__ __forceinline__ void mad_row(uint32_t (&E)[2 * NW],
                                        uint32_t (&O)[2 * NW],
                                        const uint32_t (&v)[NW], uint32_t s,
                                        int i, bool fold) {
  uint32_t (&X)[2 * NW] = (i & 1) ? O : E;    // holds words i, i+2, ...
  uint32_t (&Y)[2 * NW] = (i & 1) ? E : O;
  if (fold) {
    add_cc(E[i - 1], O[i - 1]);
    madc_wide_cc(X[i], X[i + 1], v[0], s);
  } else {
    mad_wide_cc(X[i], X[i + 1], v[0], s);
  }
#pragma unroll
  for (int j = 2; j < NW; j += 2) madc_wide_cc(X[i + j], X[i + j + 1], v[j], s);
  // the chain ends at word i+NW-1; its carry belongs to word i+NW, the top
  // live word
  X[i + NW] = addc(X[i + NW], 0u);
  mad_wide_cc(Y[i + 1], Y[i + 2], v[1], s);
#pragma unroll
  for (int j = 3; j < NW; j += 2) madc_wide_cc(Y[i + j], Y[i + j + 1], v[j], s);
  // this chain ends at word i+NW, above which the sum has nothing
}

// Montgomery product r = a * b * R^{-1} mod p, for a, b < p, R = 2^(32*NW),
// p below 2^(32*NW - 1). Row i adds a*b[i] and then m*p at word i, m chosen
// so that word i of the sum becomes 0; nothing is shifted, the rows move up
// instead. After row i the sum is below 2p * 2^(32*(i+1)), so neither array
// ever carries beyond word i+NW. Word i of the sum is E[i] + O[i]: after the
// row it is 0 or 2^32, and that carry is folded into the next row.
template <int NW>
__device__ __forceinline__ void mont_mul(uint32_t (&r)[NW],
                                         const uint32_t (&a)[NW],
                                         const uint32_t (&b)[NW],
                                         const FieldConst<NW>& F) {
  uint32_t E[2 * NW], O[2 * NW];
#pragma unroll
  for (int j = 0; j < 2 * NW; ++j) E[j] = O[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    mad_row<NW>(E, O, a, b[i], i, i > 0);
    const uint32_t m = (E[i] + O[i]) * F.ninv;
    mad_row<NW>(E, O, F.p, m, i, false);
  }
  uint32_t t[NW];
  add_cc(E[NW - 1], O[NW - 1]);
#pragma unroll
  for (int j = 0; j < NW - 1; ++j) t[j] = addc_cc(E[NW + j], O[NW + j]);
  t[NW - 1] = addc(E[2 * NW - 1], O[2 * NW - 1]);
  cond_sub_p<NW>(r, t, F);
}

// Dispatch a templated launch on the word count. Fields with another word
// count are refused (the Python wrapper refuses them first).
#define ZK_DISPATCH_NW(nw, CALL)      \
  switch (nw) {                       \
    case 8: { constexpr int NW = 8; CALL; } break;   \
    case 12: { constexpr int NW = 12; CALL; } break; \
    default: return (int)cudaErrorInvalidValue;      \
  }
