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

// r = t - p if (carry || t >= p) else t.
template <int NW>
__device__ __forceinline__ void cond_sub_p(uint32_t (&r)[NW],
                                           const uint32_t (&t)[NW],
                                           uint32_t carry,
                                           const FieldConst<NW>& F) {
  uint32_t d[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)t[j] - F.p[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  bool use_d = (carry != 0) || (borrow == 0);
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = use_d ? d[j] : t[j];
}

template <int NW>
__device__ __forceinline__ void add_mod(uint32_t (&r)[NW],
                                        const uint32_t (&a)[NW],
                                        const uint32_t (&b)[NW],
                                        const FieldConst<NW>& F) {
  uint32_t t[NW];
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)a[j] + b[j] + c;
    t[j] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
  cond_sub_p<NW>(r, t, c, F);
}

template <int NW>
__device__ __forceinline__ void sub_mod(uint32_t (&r)[NW],
                                        const uint32_t (&a)[NW],
                                        const uint32_t (&b)[NW],
                                        const FieldConst<NW>& F) {
  uint32_t d[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)d[j] + (borrow ? F.p[j] : 0u) + c;
    r[j] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
}

// Word-level CIOS Montgomery product r = a * b * R^{-1} mod p, for a, b < p.
// Each inner step is one 32x32->64 multiply-add; the running value stays
// below 2p, so one conditional subtract (with the carry word) finishes it.
template <int NW>
__device__ __forceinline__ void mont_mul(uint32_t (&r)[NW],
                                         const uint32_t (&a)[NW],
                                         const uint32_t (&b)[NW],
                                         const FieldConst<NW>& F) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[NW] + c;
    t[NW] = (uint32_t)s;
    t[NW + 1] = (uint32_t)(s >> 32);

    uint32_t m = t[0] * F.ninv;
    s = (uint64_t)m * F.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = (uint64_t)m * F.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[NW] + c;
    t[NW - 1] = (uint32_t)s;
    t[NW] = t[NW + 1] + (uint32_t)(s >> 32);
  }
  uint32_t lo[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) lo[j] = t[j];
  cond_sub_p<NW>(r, lo, t[NW], F);
}

// Dispatch a templated launch on the word count. Fields with another word
// count are refused (the Python wrapper refuses them first).
#define ZK_DISPATCH_NW(nw, CALL)      \
  switch (nw) {                       \
    case 8: { constexpr int NW = 8; CALL; } break;   \
    case 12: { constexpr int NW = 12; CALL; } break; \
    default: return (int)cudaErrorInvalidValue;      \
  }
