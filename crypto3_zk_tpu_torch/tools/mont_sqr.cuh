// A Montgomery squaring for `field.cuh`'s word planes, which no kernel of
// the library uses: `tools/poseidon_times.py` inserts this text after
// `#include "field.cuh"` in its `new_mont_sqr` build of `csrc/poseidon.cu`,
// whose S-box then squares by `mont_sqr` instead of `mont_mul`. On an H100
// that build was slower (PERF.md, section 6, runs T1 to T4): the doubling,
// the split and the carries cost more ALU work and a longer dependent chain
// than the 28 (NW = 8) word products saved. The tool holds the build's
// output against the plain permutation before it times it.

// w = a * a over 2*NW words: each product a[i]*a[j], i < j, once, at word
// i+j (row i in two carry chains, one on E for even words, one on O for
// odd), the two arrays added, the sum doubled, then the squares a[i]^2 at
// words 2i, 2i+1 in one chain: NW(NW+1)/2 word products where a general
// product has NW^2. After row i the rows' sum is below 2^(32(i+1+NW)), so a
// chain that ends below word i+NW hands its carry to word i+NW and no chain
// carries past it.
template <int NW>
__device__ __forceinline__ void sqr_wide(uint32_t (&w)[2 * NW],
                                         const uint32_t (&a)[NW]) {
  uint32_t E[2 * NW], O[2 * NW];
#pragma unroll
  for (int j = 0; j < 2 * NW; ++j) E[j] = O[j] = 0;
#pragma unroll
  for (int i = 0; i < NW - 1; ++i) {
#pragma unroll
    for (int j0 = i + 1; j0 <= i + 2 && j0 < NW; ++j0) {
      uint32_t (&X)[2 * NW] = ((i + j0) & 1) ? O : E;
      mad_wide_cc(X[i + j0], X[i + j0 + 1], a[j0], a[i]);
#pragma unroll
      for (int j = j0 + 2; j < NW; j += 2)
        madc_wide_cc(X[i + j], X[i + j + 1], a[j], a[i]);
      const int last = j0 + 2 * ((NW - 1 - j0) / 2);
      if (last < NW - 1) X[i + NW] = addc(X[i + NW], 0u);
    }
  }
  // words 1 .. 2NW-2 hold the products; their sum is below a^2 / 2
  uint32_t c[2 * NW];
  c[0] = c[2 * NW - 1] = 0;
  c[1] = add_cc(E[1], O[1]);
#pragma unroll
  for (int k = 2; k < 2 * NW - 2; ++k) c[k] = addc_cc(E[k], O[k]);
  c[2 * NW - 2] = addc(E[2 * NW - 2], O[2 * NW - 2]);
  w[0] = 0;
#pragma unroll
  for (int k = 1; k < 2 * NW; ++k) w[k] = (c[k] << 1) | (c[k - 1] >> 31);
  mad_wide_cc(w[0], w[1], a[0], a[0]);
#pragma unroll
  for (int i = 1; i < NW; ++i) madc_wide_cc(w[2 * i], w[2 * i + 1], a[i], a[i]);
}

// Montgomery square r = a^2 R^{-1} mod p, a < p: `sqr_wide`, then the low
// half w_lo of the square reduced by NW rows of m*p, (w_lo + m p) / R <= p,
// and the high half w_hi added, below p^2/R < p. Row i's m covers word i of
// the sum with the carry out of word i-1 (which the row folds in): after row
// i-1 that word is 0 or 2^32, so the carry is 1 exactly where E[i-1] is not
// 0. Where p < R/2 the sum is below 1.5p + 1; where p fills its top word,
// below 2p, with a carry word. The 10-word instance (R = 2^304 splits a
// word) squares by `mont_mul`.
template <int NW>
__device__ __forceinline__ void mont_sqr(uint32_t (&r)[NW],
                                         const uint32_t (&a)[NW],
                                         const FieldConst<NW>& F) {
  if constexpr (FieldShape<NW>::half_top) {
    mont_mul<NW>(r, a, a, F);
  } else {
    uint32_t w[2 * NW];
    sqr_wide<NW>(w, a);
    constexpr int A = FieldShape<NW>::acc_words;
    uint32_t E[A], O[A];
#pragma unroll
    for (int j = 0; j < A; ++j) {
      E[j] = j < NW ? w[j] : 0u;
      O[j] = 0u;
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      uint32_t m = E[i] + O[i];
      if (i > 0) m += E[i - 1] != 0u ? 1u : 0u;
      m *= F.ninv;
      mad_row<NW>(E, O, F.p, m, i, i > 0);
    }
    uint32_t u[NW], t[NW];
    add_cc(E[NW - 1], O[NW - 1]);
#pragma unroll
    for (int j = 0; j < NW - 1; ++j) u[j] = addc_cc(E[NW + j], O[NW + j]);
    if constexpr (FieldShape<NW>::full_top) {
      u[NW - 1] = addc_cc(E[2 * NW - 1], O[2 * NW - 1]);
      const uint32_t utop = addc(E[2 * NW], O[2 * NW]);
      t[0] = add_cc(u[0], w[NW]);
#pragma unroll
      for (int j = 1; j < NW; ++j) t[j] = addc_cc(u[j], w[NW + j]);
      const uint32_t top = addc(utop, 0u);
      cond_sub_p<NW>(r, t, F, top);
    } else {
      u[NW - 1] = addc(E[2 * NW - 1], O[2 * NW - 1]);
      t[0] = add_cc(u[0], w[NW]);
#pragma unroll
      for (int j = 1; j < NW - 1; ++j) t[j] = addc_cc(u[j], w[NW + j]);
      t[NW - 1] = addc(u[NW - 1], w[2 * NW - 1]);
      cond_sub_p<NW>(r, t, F);
    }
  }
}
