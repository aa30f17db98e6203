// The mxu_ntt block pass: a length-M NTT of every column of an (NL, M, B)
// batch as int8 digit-plane matrix products on the tensor cores.
//
// Replaces XLA's int8 `dot_general` and the fused Montgomery sweep of
// `_block_ntt` (ops/mxu_ntt.py:198) in the JAX package; that module has no
// `pallas_call`, XLA compiled it for the TPU's matrix unit.
//
// What it computes: out[k, b] = sum_j W'[k, j] x[j, b] 2^-(16 (NL+1)) mod p,
// with W'[k, j] = w^(kj) 2^(16 (NL+1)) mod p given as ND = ceil(16 NL / 7)
// base-128 digit planes W_a (int8, (ND, M, M), the plan's table). x's digits
// x_b are cut here, so the value is sum_s P_s 2^(7 s) with the plane
// P_s = sum_{a+b=s} W_a x_b: ND^2 int8 products, 2 ND - 1 planes.
//
// A block takes 16 output rows (k) and 32 columns (b), one warp per 8
// columns. It walks j in chunks of 32 (the depth of one mma):
// - the block stages W_a[k-tile, chunk] for every a and cuts its columns'
//   x[:, chunk] into digits, both as int8 tiles in shared memory (rows of 48
//   bytes: the fragment loads hit 32 different banks); rows or columns past
//   M or B are zeros, which pads a block of M < 32;
// - each warp forms the planes four at a time with
//   `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32` (one A fragment
//   W_a serves the four planes a + b), and folds each group's four partial
//   plane sums, Q = sum_g P_{s+g} 2^(7g) < 2^47, into 16-bit lazy columns
//   held in registers (35 for each of a thread's four outputs at NL = 16;
//   249 registers, no spills);
// after the last chunk each thread runs NL + 1 Montgomery rounds of 16 bits
// over its four elements' columns (each clears one column), a carry sweep
// and one conditional subtract, and writes canonical digits. The
// (2 ND - 1, M, B) int32 accumulator of the JAX version never exists.
//
// Bounds (NL = 16, ND = 37): a partial plane of one chunk is below
// 32 * 127^2 * 37 < 2^25, a group below 2^47 and, shifted into place,
// below 2^62, so it adds four pieces below 2^16 to its columns; a column
// receives pieces from at most 3 groups a chunk, so after M / 32 <= 32
// chunks it is below 2^23, and the rounds add below 17 * 2^17 more: no
// 32-bit column overflows. The value is below M p 2^(16 NL) < 2^(16 (NL+1)) p,
// so the rounds leave it below 2p.
//
// What bounds it on the H100: ND^2 M multiply-adds an element (1.4e6 at
// M = 1024) at the tensor cores' 1,979 T int8 ops/s; the sweep's
// (NL+1) NL 16-bit products an element at the integer rate; and 128 bytes an
// element a pass (the digits in, the digits out) besides W, which stays in
// L2. The products dominate by far. The digits are the JAX table's 7-bit
// ones; the card's mma also takes unsigned 8-bit operands (`.u8`), with
// which 32^2 M multiply-adds an element would do (a quarter fewer), and
// the bound `chip_smoke.py` states counts those. This first form takes its
// fragments from shared memory for every product and runs one block of 4
// warps per 16 x 32 tile; `wgmma`, TMA and a persistent schedule are left
// for later.
//
// The tensor-core product lives in `mma_tile` alone. Without `__CUDACC__`
// (the host stand-in, `tools/host_kernels.py`) a fragment is a pointer to
// its tile in shared memory and `mma_tile` computes the same 16 x 8 x 32
// product from the tiles, entry by entry of the thread's four outputs (the
// C layout of `SM80_16x8x32_S32S8S8S32_TN`), so the CPU tests run the
// staging, the digit cut, the plane merge and the sweep of this file.
#include <cstdint>
#include <utility>

#include "field.cuh"

namespace mxu {

constexpr int DIGIT_BITS = 7;
constexpr int KC = 32;           // depth of a chunk: one mma k-step
constexpr int ROWS = 16;         // output rows a block takes: one mma m
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int COLS = 8 * WARPS;  // output columns a block takes
constexpr int STRIDE = KC + 16;  // bytes a staged row takes
constexpr int G = 4;             // planes a warp forms at once

template <int NL>
struct Shape {
  static constexpr int ND = (16 * NL + DIGIT_BITS - 1) / DIGIT_BITS;
  static constexpr int NP = 2 * ND - 1;
  static constexpr int NQ = (NP + G - 1) / G;
  // the highest column a group's four pieces reach, and the columns the
  // rounds read (up to 2 NL + 1)
  static constexpr int TOP = (DIGIT_BITS * G * (NQ - 1)) / 16 + 3;
  static constexpr int NC = TOP + 1 > 2 * NL + 2 ? TOP + 1 : 2 * NL + 2;
  static constexpr int SMEM = ND * (ROWS + COLS) * STRIDE;
  // a chunk's partial plane: KC * 127^2 * ND < 2^25
  static_assert((long long)KC * 127 * 127 * ND < (1LL << 25), "plane bound");
};

#ifdef __CUDACC__
struct FragA {
  uint32_t r[4];
};
struct FragB {
  uint32_t r[2];
};

// A (16 x 32, k contiguous in rows of STRIDE bytes): thread (g, t) holds
// rows g and g + 8, bytes 4t..4t+3 and 16+4t..16+4t+3.
__device__ __forceinline__ void load_a(FragA& f, const int8_t* tile,
                                       int lane) {
  const int8_t* p = tile + (lane >> 2) * STRIDE + 4 * (lane & 3);
  f.r[0] = *reinterpret_cast<const uint32_t*>(p);
  f.r[1] = *reinterpret_cast<const uint32_t*>(p + 8 * STRIDE);
  f.r[2] = *reinterpret_cast<const uint32_t*>(p + 16);
  f.r[3] = *reinterpret_cast<const uint32_t*>(p + 8 * STRIDE + 16);
}

// B (32 x 8, stored as 8 columns of k contiguous): thread (g, t) holds
// column g, k = 4t..4t+3 and 16+4t..16+4t+3.
__device__ __forceinline__ void load_b(FragB& f, const int8_t* tile,
                                       int lane) {
  const int8_t* p = tile + (lane >> 2) * STRIDE + 4 * (lane & 3);
  f.r[0] = *reinterpret_cast<const uint32_t*>(p);
  f.r[1] = *reinterpret_cast<const uint32_t*>(p + 16);
}

// c += A B; thread (g, t) holds C rows g, g, g+8, g+8 and columns 2t, 2t+1,
// 2t, 2t+1.
__device__ __forceinline__ void mma_tile(int32_t (&c)[4], const FragA& a,
                                         const FragB& b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]),
        "r"(b.r[1]));
}
#else
struct FragA {
  const int8_t* p;
};
struct FragB {
  const int8_t* p;
};
inline void load_a(FragA& f, const int8_t* tile, int) { f.p = tile; }
inline void load_b(FragB& f, const int8_t* tile, int) { f.p = tile; }
inline void mma_tile(int32_t (&c)[4], const FragA& a, const FragB& b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) {
    const int8_t* row = a.p + (g + 8 * (i >> 1)) * STRIDE;
    const int8_t* col = b.p + (2 * t + (i & 1)) * STRIDE;
    int32_t s = 0;
    for (int k = 0; k < KC; ++k) s += int32_t(row[k]) * int32_t(col[k]);
    c[i] += s;
  }
}
#endif

// Stage W_a[k0 .. k0+15][j0 .. j0+31] of every a: 8-byte pieces when M is
// a multiple of 32, bytes otherwise (then M < 32 and j0 = 0).
template <int NL>
__device__ __forceinline__ void stage_w(int8_t* As, const int8_t* w, int M,
                                        int k0, int j0) {
  constexpr int ND = Shape<NL>::ND;
  if (M % KC == 0) {
    for (int i = threadIdx.x; i < ND * ROWS * (KC / 8); i += THREADS) {
      const int a = i / (ROWS * (KC / 8)), rr = (i / (KC / 8)) % ROWS,
                part = i % (KC / 8);
      const int row = k0 + rr;
      *reinterpret_cast<uint64_t*>(As + (a * ROWS + rr) * STRIDE + 8 * part) =
          row < M ? *reinterpret_cast<const uint64_t*>(
                        w + ((long long)a * M + row) * M + j0 + 8 * part)
                  : 0ull;
    }
  } else {
    for (int i = threadIdx.x; i < ND * ROWS * KC; i += THREADS) {
      const int a = i / (ROWS * KC), rr = (i / KC) % ROWS, kk = i % KC;
      const int row = k0 + rr, j = j0 + kk;
      As[(a * ROWS + rr) * STRIDE + kk] =
          row < M && j < M ? w[((long long)a * M + row) * M + j] : 0;
    }
  }
}

// Cut x[:, j0 .. j0+31, b0 .. b0+31] into digits: Xs[d][column][k]. A thread
// takes one column and four consecutive k, so it stores whole words, and
// cuts DB digits at a time (the loads of a limb that two digits share are
// one load); the loads are unit-stride across a warp's columns.
template <int NL>
__device__ __forceinline__ void stage_x(int8_t* Xs, const int32_t* x, int M,
                                        long long B, int j0, long long b0) {
  constexpr int ND = Shape<NL>::ND, DB = 10;
  const int cc = threadIdx.x % COLS;
  const long long col = b0 + cc;
  for (int kq = threadIdx.x / COLS; kq < KC / 4; kq += THREADS / COLS) {
#pragma unroll
    for (int d0 = 0; d0 < ND; d0 += DB) {
      uint32_t packed[DB];
#pragma unroll
      for (int dd = 0; dd < DB; ++dd) packed[dd] = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + 4 * kq + u;
        const bool in = j < M && col < B;
        const long long at = (long long)j * B + col;
        const long long plane = (long long)M * B;
#pragma unroll
        for (int dd = 0; dd < DB; ++dd) {
          const int pos = DIGIT_BITS * (d0 + dd), a = pos / 16, s = pos % 16;
          if (d0 + dd < ND && in) {
            uint32_t v = uint32_t(x[a * plane + at]) & 0xFFFFu;
            if (s > 16 - DIGIT_BITS && a + 1 < NL)
              v |= (uint32_t(x[(a + 1) * plane + at]) & 0xFFFFu) << 16;
            packed[dd] |= ((v >> s) & 0x7Fu) << (8 * u);
          }
        }
      }
#pragma unroll
      for (int dd = 0; dd < DB; ++dd)
        if (d0 + dd < ND)
          *reinterpret_cast<uint32_t*>(Xs + ((d0 + dd) * COLS + cc) * STRIDE +
                                       4 * kq) = packed[dd];
    }
  }
}

// Planes G q .. G q + 3 of one chunk for the warp's 16 x 8 tile, folded into
// the lazy columns t[element][column].
template <int NL, int Q>
__device__ __forceinline__ void plane_group(
    uint32_t (&t)[4][Shape<NL>::NC], const int8_t* As, const int8_t* Xw,
    int lane) {
  using S = Shape<NL>;
  constexpr int s0 = G * Q;
  constexpr int a_lo = s0 - (S::ND - 1) > 0 ? s0 - (S::ND - 1) : 0;
  constexpr int a_hi = s0 + G - 1 < S::ND - 1 ? s0 + G - 1 : S::ND - 1;
  int32_t acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[g][i] = 0;
#pragma unroll 1
  for (int a = a_lo; a <= a_hi; ++a) {
    FragA fa;
    load_a(fa, As + a * ROWS * STRIDE, lane);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int d = s0 + g - a;
      if (d >= 0 && d < S::ND) {
        FragB fb;
        load_b(fb, Xw + d * COLS * STRIDE, lane);
        mma_tile(acc[g], fa, fb);
      }
    }
  }
  constexpr int base = DIGIT_BITS * s0, c0 = base / 16, sh = base % 16;
  static_assert(c0 + 3 < S::NC, "column count");
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint64_t v = 0;
#pragma unroll
    for (int g = 0; g < G; ++g)
      v += uint64_t(uint32_t(acc[g][e])) << (DIGIT_BITS * g);
    v <<= sh;
    t[e][c0] += uint32_t(v) & 0xFFFFu;
    t[e][c0 + 1] += uint32_t(v >> 16) & 0xFFFFu;
    t[e][c0 + 2] += uint32_t(v >> 32) & 0xFFFFu;
    t[e][c0 + 3] += uint32_t(v >> 48);
  }
}

template <int NL, int... Q>
__device__ __forceinline__ void all_groups(
    uint32_t (&t)[4][Shape<NL>::NC], const int8_t* As, const int8_t* Xw,
    int lane, std::integer_sequence<int, Q...>) {
  (plane_group<NL, Q>(t, As, Xw, lane), ...);
}

// NL + 1 Montgomery rounds of 16 bits over one element's lazy columns, the
// carry sweep and the conditional subtract: canonical digits in r.
template <int NL>
__device__ __forceinline__ void reduce(uint32_t (&t)[Shape<NL>::NC],
                                       uint32_t (&r)[NL],
                                       const uint32_t (&p)[NL],
                                       uint32_t ninv) {
#pragma unroll
  for (int k = 0; k <= NL; ++k) {
    const uint32_t m = (t[k] * ninv) & 0xFFFFu;
    uint32_t mp = m * p[0];
    t[k + 1] += (mp >> 16) + ((t[k] + (mp & 0xFFFFu)) >> 16);
#pragma unroll
    for (int i = 1; i < NL; ++i) {
      mp = m * p[i];
      t[k + i] += mp & 0xFFFFu;
      t[k + i + 1] += mp >> 16;
    }
  }
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const uint32_t v = t[NL + 1 + j] + c;
    r[j] = v & 0xFFFFu;
    c = v >> 16;
  }
  const uint32_t top = t[2 * NL + 1] + c;
  uint32_t e[NL], borrow = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const uint32_t v = r[j] - p[j] - borrow;
    e[j] = v & 0xFFFFu;
    borrow = v >> 31;
  }
  const bool take = top != 0 || borrow == 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) r[j] = take ? e[j] : r[j];
}

}  // namespace mxu

// (the kernel and its launch stay outside the namespace: the host stand-in
// names the shared-memory array and rewrites the launch at global scope)
template <int NL>
__global__ void __launch_bounds__(mxu::THREADS, 2)
mxu_block_kernel(FieldConst<NL / 2> F, const int32_t* __restrict__ x,
                 const int8_t* __restrict__ w, int32_t* __restrict__ out,
                 int M, long long B) {
  using namespace mxu;
  using S = Shape<NL>;
  extern __shared__ uint32_t sh[];
  int8_t* As = reinterpret_cast<int8_t*>(sh);     // [ND][ROWS][STRIDE]
  int8_t* Xs = As + S::ND * ROWS * STRIDE;        // [ND][COLS][STRIDE]
  const int row_tiles = (M + ROWS - 1) / ROWS;
  const int k0 = int(blockIdx.x % row_tiles) * ROWS;
  const long long b0 = (long long)(blockIdx.x / row_tiles) * COLS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int8_t* Xw = Xs + 8 * warp * STRIDE;      // the warp's 8 columns

  uint32_t t[4][S::NC];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int i = 0; i < S::NC; ++i) t[e][i] = 0;

  for (int j0 = 0; j0 < M; j0 += KC) {
    __syncthreads();                              // the last chunk is used
    stage_w<NL>(As, w, M, k0, j0);
    stage_x<NL>(Xs, x, M, B, j0, b0);
    __syncthreads();
    all_groups<NL>(t, As, Xw, lane, std::make_integer_sequence<int, S::NQ>{});
  }

  uint32_t p[NL];
#pragma unroll
  for (int j = 0; j < NL / 2; ++j) {
    p[2 * j] = F.p[j] & 0xFFFFu;
    p[2 * j + 1] = F.p[j] >> 16;
  }
  const uint32_t ninv = F.ninv & 0xFFFFu;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t r[NL];
    reduce<NL>(t[e], r, p, ninv);
    const int row = k0 + g + 8 * (e >> 1);
    const long long col = b0 + 8 * warp + 2 * tq + (e & 1);
    if (row < M && col < B) {
#pragma unroll
      for (int l = 0; l < NL; ++l)
        out[((long long)l * M + row) * B + col] = int32_t(r[l]);
    }
  }
}

// x, out: (NL, M, B) int32 digit planes, contiguous; w: the plan's
// (ND, M, M) int8 digit table. One launch is one block pass.
extern "C" int zk_mxu_block(int nw, const uint32_t* consts, const void* x,
                            const void* w, void* out, int M, long long B,
                            void* stream) {
  using S = mxu::Shape<16>;
  if (nw != 8 || M < 1 || B < 1 || (M > mxu::KC && M % mxu::KC != 0))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)((M + mxu::ROWS - 1) / mxu::ROWS) *
                           ((B + mxu::COLS - 1) / mxu::COLS);
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mxu_block_kernel<16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::SMEM);
  if (err != cudaSuccess) return (int)err;
  mxu_block_kernel<16><<<(unsigned)blocks, mxu::THREADS, S::SMEM,
                         (cudaStream_t)stream>>>(
      make_const<8>(consts), (const int32_t*)x, (const int8_t*)w,
      (int32_t*)out, M, B);
  return (int)cudaGetLastError();
}
