// Kernel 2: batched radix-2 NTTs of length B <= 2^10 over M rows, with the
// four-step transform's transposes and multipliers folded in.
//
// Replaces the Pallas kernel `_ntt_rows_kernel` (ops/pallas_field.py) of the
// JAX package. It computes the unscaled transform of every row, natural
// order in and out, and optionally multiplies each output element by an
// entry of a table before the store.
//
// Bound: one read and one write of every row (8*NL bytes per element)
// against (B/2)*log B butterflies per row, each one Montgomery product plus
// an add and a subtract. The bytes are few (a 2^17 transform is 8 MiB, it
// stays in L2); what the card spends its time on is the products on the
// integer pipes and, in a stage-at-a-time kernel, a shared-memory round trip
// and a barrier per stage, which measured as half of the time. So:
// - stages in registers: a thread gathers 4 elements, runs 2 butterfly
//   stages on them and scatters them back, so a row of 2^9 takes 5 barrier
//   rounds, not 9 (an odd log B ends with one radix-2 round). With 8
//   elements and 3 stages the 8-word instance needs all 255 registers and
//   spills, and measured slower. A butterfly whose twiddle is w^0 skips its
//   product: 3 of the 4 in a first round;
// - twiddles staged once: the host keeps the table w^j, j < B/2, already
//   fused to words and in bit-reversed order; the block copies it to shared
//   memory once. In that order stage t reads slots [0, 2^(t-1)), so the
//   threads of a warp read neighbouring words instead of a power-of-two
//   stride;
// - positions in shared memory are swizzled (bits 5 and 6 of a position are
//   folded into its bank bits) so that the gathers of every round, whose
//   threads step through a row by 4, 16, 64 or 1 positions, spread over
//   the banks;
// - a block takes G = 2^g neighbouring rows, so that short rows still fill a
//   block and a block that reads columns (row stride 1, element stride C)
//   reads runs of G neighbouring words;
// - input and output come with their own limb, row and element strides, and
//   the multiplier is a (limb, row, element)-strided table, stride 0 where it
//   broadcasts (a single constant is the table with both strides 0). The
//   four-step transform of N = R*C is then two launches and nothing else:
//   columns in, times w_N^(c*k2), rows out; columns in, times 1/N on the
//   inverse, columns out.
// Asynchronous copies (cp.async, TMA) are not used: digits pass through
// registers to be fused and bit-reversed on their way into shared memory.
#include "field.cuh"

#define ZK_NTT_MAX_LOG 10
#define ZK_NTT_MAX_THREADS 256

struct RowStrides {
  long long limb, row, elem;   // in int32 elements
};

// Bank bits b0..b4 of position bits p0..p6: b0 ^= p5, b1 ^= p6, b2 ^= p5,
// b3 ^= p6, b4 ^= p6. For each round's thread-to-position map (threads vary
// p2..p6, or p0 p1 p4 p5 p6, or p0..p3 p6, or p0..p4) the 32 threads of a
// warp then fall on 32 different banks.
__device__ __forceinline__ int swizzle(int pos) {
  return pos ^ (((pos >> 5) & 1) * 5) ^ (((pos >> 6) & 1) * 26);
}

// S butterfly stages, numbers d+1 .. d+S, on the 2^S elements of group `grp`
// of one row: positions (hi << (d+S)) | (q << d) | lo, q < 2^S, where
// lo = grp mod 2^d and hi = grp >> d. `row` points at the row's word 0 in
// shared memory, words are `ws` apart. Stage t pairs q with q + 2^(t-d-1)
// and multiplies the upper one by w^(j * B / 2^t), j = position mod 2^(t-1),
// which the bit-reversed table keeps in slot brev_(t-1)(j).
template <int NW, int S>
__device__ __forceinline__ void radix_round(uint32_t* row, int ws,
                                            const uint32_t* twsh, int half_b,
                                            int d, int grp,
                                            const FieldConst<NW>& F) {
  constexpr int E = 1 << S;
  const int lo = grp & ((1 << d) - 1);
  const int base = ((grp >> d) << (d + S)) | lo;
  uint32_t v[E][NW];
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const int pos = swizzle(base | (q << d));
#pragma unroll
    for (int k = 0; k < NW; ++k) v[q][k] = row[k * ws + pos];
  }
#pragma unroll
  for (int u = 1; u <= S; ++u) {
#pragma unroll
    for (int q = 0; q < E; ++q) {
      if (q & (1 << (u - 1))) continue;
      const int q1 = q | (1 << (u - 1));
      const int j = ((q & ((1 << (u - 1)) - 1)) << d) | lo;
      uint32_t m[NW], a[NW], b[NW];
      if (j == 0) {
#pragma unroll
        for (int k = 0; k < NW; ++k) m[k] = v[q1][k];
      } else {
        const int slot = (int)(__brev((unsigned)j) >> (33 - d - u));
        uint32_t w[NW];
#pragma unroll
        for (int k = 0; k < NW; ++k) w[k] = twsh[k * half_b + slot];
        mont_mul<NW>(m, v[q1], w, F);
      }
      add_mod<NW>(a, v[q], m, F);
      sub_mod<NW>(b, v[q], m, F);
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        v[q][k] = a[k];
        v[q1][k] = b[k];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const int pos = swizzle(base | (q << d));
#pragma unroll
    for (int k = 0; k < NW; ++k) row[k * ws + pos] = v[q][k];
  }
}

// Element e of the block's tile as (row g, index i): rows fastest when the
// rows are the closer ones in memory, so that neighbouring threads touch
// neighbouring addresses either way.
__device__ __forceinline__ void tile_coords(int e, bool rows_fastest,
                                            int log_b, int log_g, int& g,
                                            int& i) {
  if (rows_fastest) {
    g = e & ((1 << log_g) - 1);
    i = e >> log_g;
  } else {
    i = e & ((1 << log_b) - 1);
    g = e >> log_b;
  }
}

// Dynamic shared memory: NW * (G*B + B/2) words.
template <int NW>
__global__ void __launch_bounds__(ZK_NTT_MAX_THREADS)
ntt_rows_kernel(FieldConst<NW> F, const int32_t* __restrict__ x,
                RowStrides xs, const uint32_t* __restrict__ tww,
                const int32_t* __restrict__ mul, RowStrides ms,
                int32_t* __restrict__ out, RowStrides os, long long rows,
                int log_b, int log_g) {
  extern __shared__ uint32_t sh[];
  const int B = 1 << log_b;
  const int half_b = B >> 1;
  const int TB = B << log_g;               // elements of the block's tile
  uint32_t* twsh = sh + NW * TB;
  const long long row0 = (long long)blockIdx.x << log_g;

  for (int i = threadIdx.x; i < NW * half_b; i += blockDim.x)
    twsh[i] = tww[i];

  const bool in_rows_fastest = xs.row < xs.elem;
  for (int e = threadIdx.x; e < TB; e += blockDim.x) {
    int g, i;
    tile_coords(e, in_rows_fastest, log_b, log_g, g, i);
    uint32_t w[NW];
    if (row0 + g < rows) {
      load_digits<NW>(w, x + (row0 + g) * xs.row + i * xs.elem, xs.limb);
    } else {
#pragma unroll
      for (int k = 0; k < NW; ++k) w[k] = 0;
    }
    const int pos = swizzle((int)(__brev((unsigned)i) >> (32 - log_b)));
#pragma unroll
    for (int k = 0; k < NW; ++k) sh[k * TB + g * B + pos] = w[k];
  }
  __syncthreads();

  for (int d = 0; d < log_b; d += 2) {
    const int s = min(2, log_b - d);               // stages of this round
    const int log_gpr = log_b - s;                 // groups per row, log2
    const int groups = 1 << (log_g + log_gpr);
    for (int gi = threadIdx.x; gi < groups; gi += blockDim.x) {
      uint32_t* row = sh + (gi >> log_gpr) * B;
      const int grp = gi & ((1 << log_gpr) - 1);
      if (s == 2)
        radix_round<NW, 2>(row, TB, twsh, half_b, d, grp, F);
      else
        radix_round<NW, 1>(row, TB, twsh, half_b, d, grp, F);
    }
    __syncthreads();
  }

  const bool out_rows_fastest = os.row < os.elem;
  for (int e = threadIdx.x; e < TB; e += blockDim.x) {
    int g, i;
    tile_coords(e, out_rows_fastest, log_b, log_g, g, i);
    if (row0 + g >= rows) continue;
    uint32_t w[NW];
    const int pos = swizzle(i);
#pragma unroll
    for (int k = 0; k < NW; ++k) w[k] = sh[k * TB + g * B + pos];
    if (mul != nullptr) {
      uint32_t t[NW], r[NW];
      load_digits<NW>(t, mul + (row0 + g) * ms.row + i * ms.elem, ms.limb);
      mont_mul<NW>(r, w, t, F);
#pragma unroll
      for (int k = 0; k < NW; ++k) w[k] = r[k];
    }
    store_digits<NW>(out + (row0 + g) * os.row + i * os.elem, os.limb, w);
  }
}

template <int NW>
static int launch_ntt_rows(const uint32_t* consts, const void* x,
                           RowStrides xs, const void* tww, const void* mul,
                           RowStrides ms, void* out, RowStrides os,
                           long long rows, int log_b, int log_g, int threads,
                           cudaStream_t stream) {
  const size_t smem_max = 200 * 1024;
  size_t smem = (size_t)NW * (((size_t)1 << (log_b + log_g)) +
                              ((size_t)1 << (log_b - 1))) * sizeof(uint32_t);
  if (smem > smem_max) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;   // once per instance, not per launch
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        ntt_rows_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_max);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  long long blocks = (rows + (1LL << log_g) - 1) >> log_g;
  ntt_rows_kernel<NW><<<(unsigned)blocks, threads, smem, stream>>>(
      make_const<NW>(consts), (const int32_t*)x, xs, (const uint32_t*)tww,
      (const int32_t*)mul, ms, (int32_t*)out, os, rows, log_b, log_g);
  return (int)cudaGetLastError();
}

// x, out: M rows of B = 2^log_b elements, strides {limb, row, element} in
// int32s. tww: (NW, B/2) fused twiddle words in bit-reversed order. mul: null
// or a strided table like x (stride 0 on an axis it broadcasts over). A block
// takes 2^log_g rows and `threads` threads.
extern "C" int zk_ntt_rows(int nw, const uint32_t* consts, const void* x,
                           const long long* xs, const void* tww,
                           const void* mul, const long long* ms, void* out,
                           const long long* os, long long rows, int log_b,
                           int log_g, int threads, void* stream) {
  if (log_b < 1 || log_b > ZK_NTT_MAX_LOG || log_g < 0 || rows < 1 ||
      threads < 32 || threads > ZK_NTT_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  RowStrides X{xs[0], xs[1], xs[2]};
  RowStrides O{os[0], os[1], os[2]};
  RowStrides Mu{0, 0, 0};
  if (mul != nullptr) Mu = RowStrides{ms[0], ms[1], ms[2]};
  cudaStream_t st = (cudaStream_t)stream;
  ZK_DISPATCH_NW(nw, return launch_ntt_rows<NW>(
      consts, x, X, tww, mul, Mu, out, O, rows, log_b, log_g, threads, st));
  return 0;
}
