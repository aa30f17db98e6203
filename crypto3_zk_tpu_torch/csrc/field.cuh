// Prime-field device routines shared by every kernel of the port.
//
// Storage contract (same as the Python layer): a batch of field elements is
// NL planes of 16-bit digits, each digit in an int32, limb axis first. A
// thread fuses digit pairs into NW = NL/2 32-bit words in registers, works
// on words with 64-bit products, and splits back to digits on store. The
// Montgomery radix is R = 2^(32*NW) = 2^(16*NL), so values are bit-identical
// to the 16-bit-digit arithmetic they replace.
//
// One source serves four instances, told apart at compile time by
// `FieldShape<NW>`:
// - NW = 8 (254/255-bit fields) and NW = 12 (381-bit): p leaves the top bit
//   of its top word free, so a sum of two residues fits NW words;
// - NW = 2, Goldilocks (p = 2^64 - 2^32 + 1): p fills its top word, so a sum
//   of two residues and the Montgomery accumulator carry out of NW words; the
//   add and the product keep that carry and hand it to `cond_sub_p`;
// - NW = 10, the MNT4/MNT6 scalar fields (298 bits, 19 digits): the storage
//   contract's radix is R = 2^(16*19) = 2^304, not 2^320, so digit 19 does
//   not exist (it is never read or written) and the product's last reduction
//   row is a half-word row: its multiplier m has 16 bits and the result is
//   the sum shifted down by 304 bits, not 320.
// The constants travel by value as a kernel argument (`FieldConst`), filled
// on the host from the field's parameters.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

template <int NW>
struct FieldShape {
  static constexpr bool full_top = NW == 2;    // p may set every bit
  static constexpr bool half_top = NW == 10;   // R = 2^(32*NW - 16)
  static constexpr int digits = 2 * NW - (half_top ? 1 : 0);
  static constexpr int acc_words = 2 * NW + (full_top ? 1 : 0);
};

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
// lives `j * limb_stride` int32s further. With an odd digit count the top
// word has one digit; the missing one reads as 0 and is never touched.
template <int NW>
__device__ __forceinline__ void load_digits(uint32_t (&w)[NW],
                                            const int32_t* base,
                                            long long limb_stride) {
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint32_t lo = (uint32_t)base[(2 * j) * limb_stride];
    uint32_t hi = 2 * j + 1 < FieldShape<NW>::digits
                      ? (uint32_t)base[(2 * j + 1) * limb_stride] : 0u;
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
    if (2 * j + 1 < FieldShape<NW>::digits)
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

// r = t - p if t >= p else t, for t < 2p given as NW words and a carry
// word `top` (0 or 1) above them, which only a full-top-word field uses.
template <int NW>
__device__ __forceinline__ void cond_sub_p(uint32_t (&r)[NW],
                                           const uint32_t (&t)[NW],
                                           const FieldConst<NW>& F,
                                           uint32_t top = 0u) {
  uint32_t d[NW];
  d[0] = sub_cc(t[0], F.p[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) d[j] = subc_cc(t[j], F.p[j]);
  const bool below = subc(0u, 0u) != 0 && top == 0u;   // t < p
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = below ? t[j] : d[j];
}

// a + b mod p. Where p leaves the top bit of its top word free the sum of
// two values below p fits NW words; a full top word keeps the carry out.
template <int NW>
__device__ __forceinline__ void add_mod(uint32_t (&r)[NW],
                                        const uint32_t (&a)[NW],
                                        const uint32_t (&b)[NW],
                                        const FieldConst<NW>& F) {
  uint32_t t[NW];
  t[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < NW - 1; ++j) t[j] = addc_cc(a[j], b[j]);
  if constexpr (FieldShape<NW>::full_top) {
    t[NW - 1] = addc_cc(a[NW - 1], b[NW - 1]);
    const uint32_t top = addc(0u, 0u);
    cond_sub_p<NW>(r, t, F, top);
  } else {
    t[NW - 1] = addc(a[NW - 1], b[NW - 1]);
    cond_sub_p<NW>(r, t, F);
  }
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
// E[i-1] and O[i-1]) enters the chain that starts at word i. With `WIDE`
// (a full top word, or a sum of several products before one reduction) the
// sum may reach into word i+NW+1 and both chains run on to it; the arrays
// then have 2*NW+1 words.
template <int NW, bool WIDE = FieldShape<NW>::full_top, int A>
__device__ __forceinline__ void mad_row(uint32_t (&E)[A], uint32_t (&O)[A],
                                        const uint32_t (&v)[NW], uint32_t s,
                                        int i, bool fold) {
  static_assert(A >= 2 * NW + (WIDE ? 1 : 0), "accumulator too short");
  uint32_t (&X)[A] = (i & 1) ? O : E;    // holds words i, i+2, ...
  uint32_t (&Y)[A] = (i & 1) ? E : O;
  if (fold) {
    add_cc(E[i - 1], O[i - 1]);
    madc_wide_cc(X[i], X[i + 1], v[0], s);
  } else {
    mad_wide_cc(X[i], X[i + 1], v[0], s);
  }
#pragma unroll
  for (int j = 2; j < NW; j += 2) madc_wide_cc(X[i + j], X[i + j + 1], v[j], s);
  if constexpr (WIDE) {
    // the sum may reach into word i+NW+1: both chains run on to it
    X[i + NW] = addc_cc(X[i + NW], 0u);
    X[i + NW + 1] = addc(X[i + NW + 1], 0u);
    mad_wide_cc(Y[i + 1], Y[i + 2], v[1], s);
#pragma unroll
    for (int j = 3; j < NW; j += 2)
      madc_wide_cc(Y[i + j], Y[i + j + 1], v[j], s);
    Y[i + NW + 1] = addc(Y[i + NW + 1], 0u);
  } else {
    // the chain ends at word i+NW-1; its carry belongs to word i+NW, the
    // top live word
    X[i + NW] = addc(X[i + NW], 0u);
    mad_wide_cc(Y[i + 1], Y[i + 2], v[1], s);
#pragma unroll
    for (int j = 3; j < NW; j += 2)
      madc_wide_cc(Y[i + j], Y[i + j + 1], v[j], s);
    // this chain ends at word i+NW, above which the sum has nothing
  }
}

// Montgomery product r = a * b * R^{-1} mod p, for a, b < p. Row i adds
// a*b[i] and then m*p at word i, m chosen so that word i of the sum becomes
// 0; nothing is shifted, the rows move up instead. After row i the sum is
// below 2p * 2^(32*(i+1)): with the top bit of p free neither array carries
// beyond word i+NW, with a full top word (R = 2^(32*NW)) one bit more, which
// the arrays' extra word takes. Word i of the sum is E[i] + O[i]: after the
// row it is 0 or 2^32, and that carry is folded into the next row.
// With a half top word (R = 2^(32*NW - 16)) the last row's m is the low 16
// bits of the usual one, which clears the low half of word NW-1 only, and
// the result is the sum from word NW-1 up, shifted down by 16 bits.
template <int NW>
__device__ __forceinline__ void mont_mul(uint32_t (&r)[NW],
                                         const uint32_t (&a)[NW],
                                         const uint32_t (&b)[NW],
                                         const FieldConst<NW>& F) {
  constexpr int A = FieldShape<NW>::acc_words;
  uint32_t E[A], O[A];
#pragma unroll
  for (int j = 0; j < A; ++j) E[j] = O[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    mad_row<NW>(E, O, a, b[i], i, i > 0);
    uint32_t m = (E[i] + O[i]) * F.ninv;
    if (FieldShape<NW>::half_top && i == NW - 1) m &= 0xFFFFu;
    mad_row<NW>(E, O, F.p, m, i, false);
  }
  uint32_t t[NW];
  if constexpr (FieldShape<NW>::half_top) {
    const uint32_t low = add_cc(E[NW - 1], O[NW - 1]);
#pragma unroll
    for (int j = 0; j < NW - 1; ++j) t[j] = addc_cc(E[NW + j], O[NW + j]);
    t[NW - 1] = addc(E[2 * NW - 1], O[2 * NW - 1]);
    // the sum is below 2p * 2^304 < 2^600: t[NW-1] is 0
    uint32_t s[NW];
    s[0] = (low >> 16) | (t[0] << 16);
#pragma unroll
    for (int j = 1; j < NW; ++j) s[j] = (t[j - 1] >> 16) | (t[j] << 16);
    cond_sub_p<NW>(r, s, F);
  } else if constexpr (FieldShape<NW>::full_top) {
    add_cc(E[NW - 1], O[NW - 1]);
#pragma unroll
    for (int j = 0; j < NW; ++j) t[j] = addc_cc(E[NW + j], O[NW + j]);
    const uint32_t top = addc(E[2 * NW], O[2 * NW]);
    cond_sub_p<NW>(r, t, F, top);
  } else {
    add_cc(E[NW - 1], O[NW - 1]);
#pragma unroll
    for (int j = 0; j < NW - 1; ++j) t[j] = addc_cc(E[NW + j], O[NW + j]);
    t[NW - 1] = addc(E[2 * NW - 1], O[2 * NW - 1]);
    cond_sub_p<NW>(r, t, F);
  }
}

// r = the one of t, t - p, t - 2p that is below p, for t < 3p given as NW
// words and a carry word `top` (0 or 1) above them.
template <int NW>
__device__ __forceinline__ void sub_p_twice(uint32_t (&r)[NW],
                                            const uint32_t (&t)[NW],
                                            const FieldConst<NW>& F,
                                            uint32_t top) {
  uint32_t d[NW], e[NW];
  d[0] = sub_cc(t[0], F.p[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) d[j] = subc_cc(t[j], F.p[j]);
  const uint32_t top1 = subc(top, 0u);     // 1 or 0 if t >= p, else all ones
  e[0] = sub_cc(d[0], F.p[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) e[j] = subc_cc(d[j], F.p[j]);
  const uint32_t top2 = subc(top1, 0u);    // 0 or 1 if t >= 2p
  const bool two = top2 <= 1u, one = top1 <= 1u;
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = two ? e[j] : (one ? d[j] : t[j]);
}

// Montgomery sum of three products, r = (x0 c0 + x1 c1 + x2 c2) R^{-1} mod p,
// all operands below p: one reduction for the three. Row i adds x_k * c_k[i]
// for k = 0, 1, 2 and then m*p, so it is `mont_mul` with three product rows
// to each reduction row. After row i the sum is below (3p + p) 2^(32(i+1)),
// under 2R 2^(32(i+1)) where p < R/2: it may reach one bit into word
// i+NW+1, so the rows run `WIDE` over 2*NW+1 words. The result is below
// 3p^2/R + p < 2.5p (bls12-381 Fr, p/R = 0.453: 2.36p; it may pass R), so
// up to two subtractions of p end it.
// The 8- and 12-word instances (p < R/2) take this form. The 2-word one
// (p fills its top word, a row of three reduces below 4p) and the 10-word
// one (R = 2^304 splits a word) reduce each product and add the three.
template <int NW>
__device__ __forceinline__ void mont_dot3(
    uint32_t (&r)[NW], const uint32_t (&x0)[NW], const uint32_t (&c0)[NW],
    const uint32_t (&x1)[NW], const uint32_t (&c1)[NW],
    const uint32_t (&x2)[NW], const uint32_t (&c2)[NW],
    const FieldConst<NW>& F) {
  if constexpr (FieldShape<NW>::full_top || FieldShape<NW>::half_top) {
    uint32_t t[NW];
    mont_mul<NW>(r, x0, c0, F);
    mont_mul<NW>(t, x1, c1, F);
    add_mod<NW>(r, r, t, F);
    mont_mul<NW>(t, x2, c2, F);
    add_mod<NW>(r, r, t, F);
  } else {
    constexpr int A = 2 * NW + 1;
    uint32_t E[A], O[A];
#pragma unroll
    for (int j = 0; j < A; ++j) E[j] = O[j] = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      mad_row<NW, true>(E, O, x0, c0[i], i, i > 0);
      mad_row<NW, true>(E, O, x1, c1[i], i, false);
      mad_row<NW, true>(E, O, x2, c2[i], i, false);
      const uint32_t m = (E[i] + O[i]) * F.ninv;
      mad_row<NW, true>(E, O, F.p, m, i, false);
    }
    uint32_t t[NW];
    add_cc(E[NW - 1], O[NW - 1]);
#pragma unroll
    for (int j = 0; j < NW; ++j) t[j] = addc_cc(E[NW + j], O[NW + j]);
    const uint32_t top = addc(E[2 * NW], O[2 * NW]);
    sub_p_twice<NW>(r, t, F, top);
  }
}

// Dispatch a templated launch on the word count. Fields with another word
// count are refused (the Python wrapper refuses them first).
#define ZK_DISPATCH_NW(nw, CALL)                     \
  switch (nw) {                                      \
    case 2: { constexpr int NW = 2; CALL; } break;   \
    case 8: { constexpr int NW = 8; CALL; } break;   \
    case 10: { constexpr int NW = 10; CALL; } break; \
    case 12: { constexpr int NW = 12; CALL; } break; \
    default: return (int)cudaErrorInvalidValue;      \
  }
