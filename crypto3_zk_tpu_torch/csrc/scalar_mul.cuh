// Kernel 6: batched variable-base scalar multiplication, [k_i] P_i for N
// points, each by its own scalar or all by one broadcast scalar. The kernel
// and its launcher live here; `scalar_mul.cu` (G1) and `scalar_mul_g2.cu`
// (G2) each bind the launcher for the 8- and 12-word fields, as two sources
// that nvcc builds side by side.
//
// It has no Pallas counterpart: the JAX package does this work with host
// `g1_mul` / `g2_mul` loops (`commitments/powers_of_tau.py` transform and
// group iNTT, `models/groth16/mpc.py` keypair and contributions). One thread
// runs one point's whole multiplication, so a batch is one launch.
//
// Curves: a = 0 only (the formulas below drop the a term). G1 over the 8-
// and 12-word instances of field.cuh (alt_bn128, bls12-381 Fq), G2 over
// Fq2 = Fq[u] / (u^2 + 1) of the same two fields. The Python wrapper refuses
// any other curve first.
//
// Layout: the points are one contiguous (C, NL, N) int32 tensor of 16-bit
// digits in Montgomery form, C = 3 coordinates (X, Y, Z) for G1 and 6
// (X.c0, X.c1, Y.c0, Y.c1, Z.c0, Z.c1) for G2; Jacobian, Z = 0 for infinity.
// The output has the same layout. The scalars are canonical (not
// Montgomery) 16-digit values, (16, Ns) with Ns = N, or Ns = 1 for one
// scalar broadcast to every point; their bits from `nbits` up read as 0.
//
// Schedule: signed fixed windows of w bits. The scalar is recoded into
// nbits / w + 1 digits d_i in [-2^(w-1), 2^(w-1)] with k = sum d_i 2^(w i):
// digit i is read off bits w i - 1 to w i + w - 1 (Booth's recoding: no
// carry runs between windows, and the top digit, which reads the bit below
// it, takes the carry out of the window under it). A table T[j] = [j] P,
// j = 1 .. 2^(w-1), built once a point (T[j] = T[1] + T[j-1]), lives in
// dynamic shared memory; then from acc = sign(d_top) T[|d_top|] (infinity
// for 0), each lower window doubles acc w times and adds sign(d) T[|d|]
// where d != 0, Y negated on the fly for d < 0. Every lane adds at the same
// step: a warp diverges on a zero digit (one window in 2^w) and on add-
// 2007-bl's rare operands only, where the double-and-add ladder this
// replaces ran the addition wherever any of its 32 lanes had a bit set.
// The table is laid out [entry][coordinate word][thread], so a warp's 32
// loads hit 32 banks whatever entry each lane reads; the point is no longer
// held in registers beside the accumulator.
//
// Formulas: those of `ops/curve.py`, dbl-2009-l and add-2007-bl, with
// their infinity / equal / opposite operand cases taken as branches where
// the plain version selects, infinity returned as (1, 1, 0) as there, and
// the addition's first operand the table's entry, its second the
// accumulator, as the plain version calls `jac_add(T, acc)`. So the
// Jacobian output is digit for digit the plain version's. Squarings in Fq2
// take two products ((a0 + a1)(a0 - a1), 2 a0 a1), the same values as the
// plain version's.
//
// Bound: per G1 point about nbits doublings of 7 products and (nbits / w)
// (1 - 2^-w) additions of 16, plus the table (16 products an entry); a G2
// doubling is 16 Fq products, an addition 44. Against 2 * 3 * NL * 4 bytes
// of points and 64 bytes of scalar a point, the operations bound it by far.
// The table costs occupancy instead: 2^(w-1) * 3 * DEG * NW words of shared
// memory a thread. Window, block size and the blocks an SM is asked to hold
// are per instance (`ScalarMulShape`), chosen by `tools/scalar_mul_shapes.py`
// on the card.
#pragma once

#include "field.cuh"

template <int NW, int DEG>
struct Ext {
  uint32_t c[DEG][NW];
};

template <int NW, int DEG>
__device__ __forceinline__ void e_add(Ext<NW, DEG>& r, const Ext<NW, DEG>& a,
                                      const Ext<NW, DEG>& b,
                                      const FieldConst<NW>& F) {
#pragma unroll
  for (int d = 0; d < DEG; ++d) add_mod<NW>(r.c[d], a.c[d], b.c[d], F);
}

template <int NW, int DEG>
__device__ __forceinline__ void e_sub(Ext<NW, DEG>& r, const Ext<NW, DEG>& a,
                                      const Ext<NW, DEG>& b,
                                      const FieldConst<NW>& F) {
#pragma unroll
  for (int d = 0; d < DEG; ++d) sub_mod<NW>(r.c[d], a.c[d], b.c[d], F);
}

template <int NW, int DEG>
__device__ __forceinline__ void e_dbl(Ext<NW, DEG>& r, const Ext<NW, DEG>& a,
                                      const FieldConst<NW>& F) {
  e_add<NW, DEG>(r, a, a, F);
}

// Fq2 with u^2 = -1: (a0 b0 - a1 b1, (a0 + a1)(b0 + b1) - a0 b0 - a1 b1)
template <int NW, int DEG>
__device__ __forceinline__ void e_mul(Ext<NW, DEG>& r, const Ext<NW, DEG>& a,
                                      const Ext<NW, DEG>& b,
                                      const FieldConst<NW>& F) {
  if constexpr (DEG == 1) {
    mont_mul<NW>(r.c[0], a.c[0], b.c[0], F);
  } else {
    uint32_t t0[NW], t1[NW], sa[NW], sb[NW], t2[NW];
    mont_mul<NW>(t0, a.c[0], b.c[0], F);
    mont_mul<NW>(t1, a.c[1], b.c[1], F);
    add_mod<NW>(sa, a.c[0], a.c[1], F);
    add_mod<NW>(sb, b.c[0], b.c[1], F);
    mont_mul<NW>(t2, sa, sb, F);
    sub_mod<NW>(r.c[0], t0, t1, F);
    sub_mod<NW>(t2, t2, t0, F);
    sub_mod<NW>(r.c[1], t2, t1, F);
  }
}

// Fq2: ((a0 + a1)(a0 - a1), 2 a0 a1), two products
template <int NW, int DEG>
__device__ __forceinline__ void e_sqr(Ext<NW, DEG>& r, const Ext<NW, DEG>& a,
                                      const FieldConst<NW>& F) {
  if constexpr (DEG == 1) {
    mont_mul<NW>(r.c[0], a.c[0], a.c[0], F);
  } else {
    uint32_t s[NW], d[NW], t[NW];
    add_mod<NW>(s, a.c[0], a.c[1], F);
    sub_mod<NW>(d, a.c[0], a.c[1], F);
    mont_mul<NW>(t, a.c[0], a.c[1], F);
    mont_mul<NW>(r.c[0], s, d, F);
    add_mod<NW>(r.c[1], t, t, F);
  }
}

template <int NW, int DEG>
__device__ __forceinline__ bool e_is_zero(const Ext<NW, DEG>& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int d = 0; d < DEG; ++d)
#pragma unroll
    for (int j = 0; j < NW; ++j) acc |= a.c[d][j];
  return acc == 0;
}

template <int NW, int DEG>
struct Jac {
  Ext<NW, DEG> X, Y, Z;
};

// (1, 1, 0): the plain version's infinity, Montgomery one in c0
template <int NW, int DEG>
__device__ __forceinline__ void set_inf(Jac<NW, DEG>& P,
                                        const FieldConst<NW>& F) {
#pragma unroll
  for (int d = 0; d < DEG; ++d)
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      P.X.c[d][j] = d == 0 ? F.one[j] : 0u;
      P.Y.c[d][j] = d == 0 ? F.one[j] : 0u;
      P.Z.c[d][j] = 0u;
    }
}

// dbl-2009-l (a = 0): 5 squarings + 2 products, ordered so that each input
// coordinate dies at its last use (Z first, then Y, then X): fewer values
// live at once, for the registers of G2
template <int NW, int DEG>
__device__ __forceinline__ void jac_double(Jac<NW, DEG>& R,
                                           const Jac<NW, DEG>& P,
                                           const FieldConst<NW>& F) {
  Ext<NW, DEG> A, B, C, T, Z3;
  e_mul<NW, DEG>(Z3, P.Y, P.Z, F);
  e_dbl<NW, DEG>(Z3, Z3, F);
  e_sqr<NW, DEG>(B, P.Y, F);
  e_sqr<NW, DEG>(A, P.X, F);
  e_add<NW, DEG>(T, P.X, B, F);
  e_sqr<NW, DEG>(T, T, F);
  e_sqr<NW, DEG>(C, B, F);
  e_sub<NW, DEG>(T, T, A, F);
  e_sub<NW, DEG>(T, T, C, F);
  Ext<NW, DEG> D, E;
  e_dbl<NW, DEG>(D, T, F);
  e_dbl<NW, DEG>(E, A, F);
  e_add<NW, DEG>(E, E, A, F);
  e_sqr<NW, DEG>(R.X, E, F);         // F = E^2
  e_dbl<NW, DEG>(T, D, F);
  e_sub<NW, DEG>(R.X, R.X, T, F);
  e_dbl<NW, DEG>(C, C, F);
  e_dbl<NW, DEG>(C, C, F);
  e_dbl<NW, DEG>(C, C, F);           // 8C
  e_sub<NW, DEG>(T, D, R.X, F);
  e_mul<NW, DEG>(R.Y, E, T, F);
  e_sub<NW, DEG>(R.Y, R.Y, C, F);
  R.Z = Z3;
}

// One thread's table column in dynamic shared memory: word w of entry e
// (coordinate c, Fq2 component d, word j: w = (c * DEG + d) * NW + j) sits
// at base[(e * entry_words + w) * THREADS], base = sh + threadIdx.x.
template <int NW, int DEG, int THREADS>
struct Table {
  static constexpr int entry_words = 3 * DEG * NW;
  uint32_t* base;

  __device__ __forceinline__ uint32_t* at(int e, int c, int d, int j) const {
    return base + ((e * entry_words + (c * DEG + d) * NW + j) * THREADS);
  }
  __device__ __forceinline__ void load(Ext<NW, DEG>& r, int e, int c) const {
#pragma unroll
    for (int d = 0; d < DEG; ++d)
#pragma unroll
      for (int j = 0; j < NW; ++j) r.c[d][j] = *at(e, c, d, j);
  }
  // Y of sign(d) T[e]: p - Y for a negative digit (0 stays 0)
  __device__ __forceinline__ void load_y(Ext<NW, DEG>& r, int e, bool neg,
                                         const FieldConst<NW>& F) const {
    load(r, e, 1);
    if (neg) {
      Ext<NW, DEG> zero;
#pragma unroll
      for (int d = 0; d < DEG; ++d)
#pragma unroll
        for (int j = 0; j < NW; ++j) zero.c[d][j] = 0u;
      e_sub<NW, DEG>(r, zero, r, F);
    }
  }
  __device__ __forceinline__ void load_point(Jac<NW, DEG>& P, int e, bool neg,
                                             const FieldConst<NW>& F) const {
    load(P.X, e, 0);
    load_y(P.Y, e, neg, F);
    load(P.Z, e, 2);
  }
  __device__ __forceinline__ void store(int e, const Jac<NW, DEG>& P) const {
#pragma unroll
    for (int d = 0; d < DEG; ++d)
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        *at(e, 0, d, j) = P.X.c[d][j];
        *at(e, 1, d, j) = P.Y.c[d][j];
        *at(e, 2, d, j) = P.Z.c[d][j];
      }
  }
};

// acc = add-2007-bl(P1 = sign T[e], P2 = acc), P1 read from the table as
// each coordinate is needed. P1 = infinity leaves acc, acc = infinity
// takes P1, P1 = -acc gives (1, 1, 0). P1 = acc is the doubling case: acc
// becomes P1 and the function returns true; the caller doubles it (one
// doubling in the kernel's code, not a second copy here). The order lets
// acc's X and Y die first, then Z1 and acc's Z once Z3 is made.
template <int NW, int DEG, int THREADS>
__device__ __forceinline__ bool add_from_table(
    Jac<NW, DEG>& acc, const Table<NW, DEG, THREADS>& T, int e, bool neg,
    const FieldConst<NW>& F) {
  Ext<NW, DEG> Z1;
  T.load(Z1, e, 2);
  if (e_is_zero<NW, DEG>(Z1)) return false;
  if (e_is_zero<NW, DEG>(acc.Z)) {
    T.load_point(acc, e, neg, F);
    return false;
  }
  Ext<NW, DEG> U1, S1, H, rr, t;
  e_sqr<NW, DEG>(t, Z1, F);                  // Z1Z1
  e_mul<NW, DEG>(H, acc.X, t, F);            // U2
  e_mul<NW, DEG>(rr, acc.Y, Z1, F);
  e_mul<NW, DEG>(rr, rr, t, F);              // S2
  e_sqr<NW, DEG>(t, acc.Z, F);               // Z2Z2
  T.load(U1, e, 0);
  e_mul<NW, DEG>(U1, U1, t, F);
  T.load_y(S1, e, neg, F);
  e_mul<NW, DEG>(S1, S1, acc.Z, F);
  e_mul<NW, DEG>(S1, S1, t, F);
  e_sub<NW, DEG>(H, H, U1, F);
  e_sub<NW, DEG>(rr, rr, S1, F);
  e_dbl<NW, DEG>(rr, rr, F);
  if (e_is_zero<NW, DEG>(H)) {
    if (e_is_zero<NW, DEG>(rr)) {
      T.load_point(acc, e, neg, F);
      return true;
    }
    set_inf<NW, DEG>(acc, F);
    return false;
  }
  e_mul<NW, DEG>(acc.Z, Z1, acc.Z, F);
  e_dbl<NW, DEG>(t, H, F);
  e_mul<NW, DEG>(acc.Z, acc.Z, t, F);        // Z3 = Z1 Z2 2H
  Ext<NW, DEG> I, J;
  e_sqr<NW, DEG>(I, t, F);                   // (2H)^2
  e_mul<NW, DEG>(J, H, I, F);
  e_mul<NW, DEG>(U1, U1, I, F);              // V
  e_sqr<NW, DEG>(acc.X, rr, F);
  e_sub<NW, DEG>(acc.X, acc.X, J, F);
  e_dbl<NW, DEG>(t, U1, F);
  e_sub<NW, DEG>(acc.X, acc.X, t, F);        // X3 = rr^2 - J - 2V
  e_sub<NW, DEG>(t, U1, acc.X, F);
  e_mul<NW, DEG>(acc.Y, rr, t, F);
  e_mul<NW, DEG>(t, S1, J, F);
  e_dbl<NW, DEG>(t, t, F);
  e_sub<NW, DEG>(acc.Y, acc.Y, t, F);        // Y3 = rr (V - X3) - 2 S1 J
  return false;
}

template <int NW, int DEG>
__device__ __forceinline__ void load_ext(Ext<NW, DEG>& e, const int32_t* pts,
                                         int coord, long long i, long long n) {
  constexpr int NL = FieldShape<NW>::digits;
#pragma unroll
  for (int d = 0; d < DEG; ++d)
    load_digits<NW>(e.c[d], pts + (long long)(coord * DEG + d) * NL * n + i,
                    n);
}

template <int NW, int DEG>
__device__ __forceinline__ void store_ext(int32_t* pts, const Ext<NW, DEG>& e,
                                          int coord, long long i,
                                          long long n) {
  constexpr int NL = FieldShape<NW>::digits;
#pragma unroll
  for (int d = 0; d < DEG; ++d)
    store_digits<NW>(pts + (long long)(coord * DEG + d) * NL * n + i, n,
                     e.c[d]);
}

// Digit i of the signed recoding: v = bits w i - 1 .. w i + w - 1 of k
// (bit -1 reads 0), d = ceil(v / 2) - 2^w * (top bit of v), in
// [-2^(w-1), 2^(w-1)]. The words are picked by selects, not by an index,
// which would move k out of registers.
template <int W>
__device__ __forceinline__ int signed_digit(const uint32_t (&k)[8], int i) {
  const int lo = W * i - 1;
  const int word = lo < 0 ? 0 : lo >> 5, off = lo < 0 ? 0 : lo & 31;
  uint32_t a = 0u, b = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a = j == word ? k[j] : a;
    b = j == word + 1 ? k[j] : b;
  }
  uint32_t v = lo < 0 ? a << 1 : a >> off;
  if (off > 31 - W) v |= b << (32 - off);
  v &= (1u << (W + 1)) - 1u;
  return (int)((v + 1u) >> 1) - (int)((v >> W) << W);
}

// The shape of an instance: window bits, threads a block, and the blocks
// an SM is asked to hold (`__launch_bounds__`' second argument, which caps
// the registers a thread may take): by default as many as the table's
// shared memory lets in, at most 2,048 threads. Chosen by
// `tools/scalar_mul_shapes.py` on the H100 at 2^16 points (PERF.md): G1
// w = 4 (w = 3 was 2 to 29 % slower), G2 w = 3 (w = 4 was 1.4 to 1.5
// times slower: its table halves the warps an SM holds); 64 threads but
// for the 8-word G1 instance, where 128 were 1 % faster (for 12 words, 128
// threads leave one block an SM and were 12 % slower). That tool builds
// variants with the ZK_SCALAR_MUL_* macros, which override every instance
// of a source.
template <int NW, int DEG>
struct ScalarMulShape {
#ifdef ZK_SCALAR_MUL_WINDOW
  static constexpr int window = ZK_SCALAR_MUL_WINDOW;
#else
  static constexpr int window = DEG == 1 ? 4 : 3;
#endif
#ifdef ZK_SCALAR_MUL_THREADS
  static constexpr int threads = ZK_SCALAR_MUL_THREADS;
#else
  static constexpr int threads = DEG == 1 && NW == 8 ? 128 : 64;
#endif
  static constexpr int entries = 1 << (window - 1);
  static constexpr size_t smem =
      (size_t)threads * entries * Table<NW, DEG, threads>::entry_words * 4;
  static constexpr int sm_blocks = (int)(233472 / (smem + 1024));
  static constexpr int fit = sm_blocks * threads > 2048 ? 2048 / threads
                                                        : sm_blocks;
#ifdef ZK_SCALAR_MUL_MIN_BLOCKS
  static constexpr int min_blocks = ZK_SCALAR_MUL_MIN_BLOCKS;
#else
  static constexpr int min_blocks = fit;
#endif
  static_assert(window >= 2 && window <= 6, "window of 2 to 6 bits");
  static_assert(threads % 32 == 0, "whole warps");
  static_assert(smem <= 232448, "the table exceeds a block's shared memory");
  static_assert(min_blocks >= 1, "at least one block an SM");
};

// THREADS and MIN_BLOCKS repeat the shape's (`__launch_bounds__` takes no
// qualified template names)
template <int NW, int DEG, int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
scalar_mul_kernel(FieldConst<NW> F, const int32_t* __restrict__ pts,
                  const int32_t* __restrict__ scalars, long long ns,
                  int32_t* __restrict__ out, long long n, int nbits) {
  using S = ScalarMulShape<NW, DEG>;
  static_assert(S::threads == THREADS && S::min_blocks == MIN_BLOCKS);
  constexpr int W = S::window;
  extern __shared__ uint32_t sh[];
  const long long idx = (long long)blockIdx.x * S::threads + threadIdx.x;
  if (idx >= n) return;
  const Table<NW, DEG, S::threads> T{sh + threadIdx.x};
  // the scalar as 8 words, digit pairs fused, bits from nbits up cleared
  const long long s = ns == 1 ? 0 : idx;
  uint32_t k[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    k[j] = ((uint32_t)scalars[(2 * j) * ns + s] & 0xFFFFu) |
           ((uint32_t)scalars[(2 * j + 1) * ns + s] << 16);
    const int keep = nbits - 32 * j;
    if (keep <= 0) k[j] = 0u;
    else if (keep < 32) k[j] &= (1u << keep) - 1u;
  }
  Jac<NW, DEG> acc;
  load_ext<NW, DEG>(acc.X, pts, 0, idx, n);
  load_ext<NW, DEG>(acc.Y, pts, 1, idx, n);
  load_ext<NW, DEG>(acc.Z, pts, 2, idx, n);
  T.store(0, acc);
  // Steps 0 .. entries - 2 build T[j + 2] = T[1] + T[j + 1] (the first is
  // T[1] + T[1], the doubling case); the rest are the windows below the
  // top one, w doublings and an addition each. An addition that meets the
  // doubling case leaves the step unfinished (`owed`): the next pass of the
  // loop runs one doubling in place of the step's own and then finishes it.
  const int nwin = nbits / W + 1;
  const int steps = S::entries - 1 + nwin - 1;
  bool owed = false;
#pragma unroll 1
  for (int step = 0; step < steps;) {
    const bool table = step < S::entries - 1;
    const int dbls = owed ? 1 : table ? 0 : W;
#pragma unroll 1
    for (int t = 0; t < dbls; ++t) jac_double<NW, DEG>(acc, acc, F);
    if (!owed) {
      const int d = table ? 1 : signed_digit<W>(k, steps - 1 - step);
      if (d != 0 && add_from_table<NW, DEG, S::threads>(
                        acc, T, (d < 0 ? -d : d) - 1, d < 0, F)) {
        owed = true;
        continue;
      }
    }
    owed = false;
    if (table) {
      T.store(step + 1, acc);
      if (step == S::entries - 2) {
        const int d = signed_digit<W>(k, nwin - 1);
        if (d == 0) set_inf<NW, DEG>(acc, F);
        else T.load_point(acc, (d < 0 ? -d : d) - 1, d < 0, F);
      }
    }
    ++step;
  }
  store_ext<NW, DEG>(out, acc.X, 0, idx, n);
  store_ext<NW, DEG>(out, acc.Y, 1, idx, n);
  store_ext<NW, DEG>(out, acc.Z, 2, idx, n);
}

template <int NW, int DEG>
static int scalar_mul_launch_nw(const uint32_t* consts, const void* pts,
                                const void* scalars, long long ns, void* out,
                                long long n, int nbits, cudaStream_t stream) {
  using S = ScalarMulShape<NW, DEG>;
  auto* kernel = &scalar_mul_kernel<NW, DEG, S::threads, S::min_blocks>;
  static bool attr_set = false;   // once per instance, not per launch
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  long long blocks = (n + S::threads - 1) / S::threads;
  kernel<<<(unsigned)blocks, S::threads, S::smem, stream>>>(
      make_const<NW>(consts), (const int32_t*)pts, (const int32_t*)scalars,
      ns, (int32_t*)out, n, nbits);
  return (int)cudaGetLastError();
}

// The shape of the instance for nw words: window, threads, blocks an SM,
// shared bytes a block (`tools/scalar_mul_shapes.py` prints it).
template <int DEG>
static int scalar_mul_shape(int nw, int* shape) {
  auto fill = [&](int w, int t, int b, size_t smem) {
    shape[0] = w;
    shape[1] = t;
    shape[2] = b;
    shape[3] = (int)smem;
    return 0;
  };
  if (nw == 8) {
    using S = ScalarMulShape<8, DEG>;
    return fill(S::window, S::threads, S::min_blocks, S::smem);
  }
  if (nw == 12) {
    using S = ScalarMulShape<12, DEG>;
    return fill(S::window, S::threads, S::min_blocks, S::smem);
  }
  return (int)cudaErrorInvalidValue;
}

// The C entry of scalar_mul.cu (DEG = 1) and scalar_mul_g2.cu (DEG = 2):
// nw 8 or 12 words; scalars (16, ns) digits, ns = n or 1.
template <int DEG>
static int scalar_mul_launch(int nw, const uint32_t* consts, const void* pts,
                             const void* scalars, long long ns, void* out,
                             long long n, int nbits, void* stream) {
  if (n < 1 || nbits < 1 || nbits > 256 || (ns != 1 && ns != n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (nw == 8)
    return scalar_mul_launch_nw<8, DEG>(consts, pts, scalars, ns, out, n,
                                        nbits, st);
  if (nw == 12)
    return scalar_mul_launch_nw<12, DEG>(consts, pts, scalars, ns, out, n,
                                         nbits, st);
  return (int)cudaErrorInvalidValue;
}
