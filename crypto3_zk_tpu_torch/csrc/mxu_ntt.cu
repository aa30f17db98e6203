// Kernel 8: one pass of the digit-plane NTT (`ops/mxu_ntt.py`) on the
// H100's tensor cores, `wgmma` on unsigned 8-bit digits.
//
// Replaces XLA's int8 `dot_general` and the fused Montgomery sweep of
// `_block_ntt` (ops/mxu_ntt.py:198) in the JAX package; that module has no
// `pallas_call`, XLA compiled it for the TPU's matrix unit.
//
// What a pass computes (`PassGeom` in ops/mxu_ntt.py): the input is the
// natural array x[j, c, b], j < M transformed, vector v = c B + b; out[k,
// c, b] = sum_j W''[k, j] x[j, c, b] 2^-288 mod p, W''[k, j] =
// w_M^(kj) 2^288 mod p, times the four-step twiddle w_(M C)^(c k) if asked,
// written to the natural position (c M + k) B + b: as int32 digit planes,
// or packed for the next pass. A transform is a chain of such passes.
//
// Products. Elements (< p < 2^255) and W'' are cut into 32 unsigned 8-bit
// digits; plane s = sum_{a+b=s} W''_a x_b (63 planes) and the value is
// sum_s P_s 2^(8s). One `wgmma.m64n64k32.s32.u8.u8` takes as A one digit b
// of 64 vectors over 32 j (a tile of shared memory, K-major) and as B the
// table's digits a = s-b .. s-b+7 of 8 outputs k (N = 8 planes x 8
// outputs: the table keeps the 8 outputs of a group under each digit, so
// 8 consecutive digits are one contiguous N = 64 tile; 7 zero digits pad
// each side). Walking b accumulates the complete planes 8q .. 8q+7 of the
// 64 x 8 tile in the accumulator; the accumulator layout puts all 8 planes
// of an output in the thread that owns that output, so the planes merge
// in registers: each group's value (< 2^84) is added at bit 64 q of a
// running 17-word integer (< 2^517), words 2q .. 2q+2, no carry beyond.
// A tile of 8 outputs issues 156 `wgmma`s (the 32 x 32 digit pairs and
// 224 zero pairs at the groups' edges, 22 % more); a side-64 pass twice
// that (two k-steps), a side-16 pass the same 156 with half of each
// k-step's j zero. Choice of G = 8 planes and 8 outputs: a thread then
// holds 4 elements (4 x 17 words) beside two accumulators of 32 registers
// (a group's merge runs under the next group's products); G = 16 would
// need 64 a group and waste 45 %. Every `wgmma` is an unrolled
// instruction of its own, so the accumulators stay in place. `ptxas -v`
// (sm_90a): 168 registers at launch, 208 for the consumers by
// `setmaxnreg`, 196 / 196 / 936 bytes of spill stores at sides 16 / 32 /
// 64 (PERF.md, kernel 8).
//
// Epilogue, the thread's four elements together, their twiddle loads
// first: nine 32-bit Montgomery rounds (2^-288) in plain C on 64-bit sums,
// one conditional subtract, the four-step twiddle (one compact table
// lo[e] where the pass's n is at most 2^20, else lo[e mod 2^h] hi[e >> h],
// e = c k, two tables of 32-byte words, 256 KB at 2^24) by one or two
// `field.cuh` Montgomery products, then the store: int32 digits, or the
// 32 bytes of the element into the packed tiles of the next pass, through
// a staging buffer and out as whole 64-byte runs of the destination where
// the geometry gives them (`_runs` in ops/mxu_ntt.py).
//
// Data movement. Blocks are persistent (one an SM), of three warpgroups:
// a producer and two consumers (`setmaxnreg` 88 / 208). The block's part
// of the table (all of it up to side 32, a quarter at 64) is loaded once
// by a bulk copy and stays in shared memory. The producer keeps a ring of
// 128 KB full (4 stages of a side-16 tile, 2 of side 32, 1 of side 64):
// one `cp.async.bulk` of a whole packed tile onto an `mbarrier`, or, in a
// pass that reads int32 digits, all 128 producer threads cut them into
// the tile (4 j of a row a thread, then `fence.proxy.async`). Both consumer
// warpgroups work on the same tile, on alternate output groups, and take
// turns on the tensor cores (named barriers); each releases the stage
// after its last `wgmma` on it, before its last epilogue. No
// `__syncthreads` stands between the loads and the products.
//
// Packed tiles (ops/mxu_ntt.py::pack_plain): 64 vectors x M j x 32 digits,
// [j / 32][digit][(j % 32) / 16][row][j % 16]: a digit of a k-step is
// wgmma's canonical K-major layout without swizzle (8 rows x 16 bytes a
// core matrix, LBO 1024 between the two K halves, SBO 128 between row
// groups), so a tile is the A operand as it lies. Row r = 4 jq + kl holds
// v = base + jq 2^lsj + kl 2^lsk: the J lanes are 16 consecutive values of
// the next pass's transform index and the K lanes 4 consecutive outputs of
// the pass before, so a pass's output pieces are 4 rows x 16 bytes.
//
// Bounds: a plane of a group sums at most 32 b x 64 j products below 2^16:
// below 2^27 in a 32-bit accumulator. The value is below 64 p 2^256, so
// after the nine rounds it is below 2p.
//
// What bounds it on the H100: 32^2 M multiply-adds an element at the
// int8 tensor rate (0.0347 ms for 2^20 elements at M = 32), and integer
// work (rounds, twiddle, stores); 32 bytes an element in and out of a
// middle pass. A `wgmma` of N = 64 reads 4 KB of shared memory in its 32
// clocks, the rate shared memory gives, so every other access to it slows
// the products. Measured (PERF.md, kernel 8): the products alone and the
// epilogue alone each take about half of a pass, and the turns of the two
// consumer warpgroups overlap them only in part; an epilogue warpgroup of
// its own was slower still.
//
// ZK_MXU_PARTS (a build macro, 0 unless set): 1 builds a kernel that runs
// the products alone, 2 one that runs the epilogue alone; their outputs
// are not the pass's. Only tools/mxu_pass_times.py builds them, to time a
// pass's parts; the library is built with 0 and has no such test. The
// part is skipped by a kernel parameter (`Geom::skip`), not at compile
// time: the compiler then keeps the other part's inputs and outputs as in
// the pass (skipped at compile time, the products' results and the
// epilogue's input are dead, and most of the work goes with them).
//
// Without `__CUDACC__` (tools/host_kernels.py) the tensor-core product,
// the bulk copy, the mbarriers, the fences and `setmaxnreg` are the host
// definitions of csrc/host/cuda_runtime.h: the product is computed from the
// shared-memory tiles through the same descriptors, entry by entry of the
// thread's accumulator layout, so the CPU tests run the staging, the
// layouts, the merge, the rounds, the twiddle and the stores of this file.
#include <cstdint>

#include "field.cuh"

#ifndef ZK_MXU_PARTS
#define ZK_MXU_PARTS 0
#endif

#ifdef __CUDACC__
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// barrier `id` of `count` threads of the block: wait, or arrive and go on
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
// d (+)= A B for the 64 x 64 x 32 tile: A, B K-major u8 in shared memory
// by their descriptors, d the s32 accumulator (thread's layout: row
// 16 warp + lane/4 + 8 i, column 8 n + 2 (lane % 4) + e in d[4 n + 2 i + e]).
__device__ __forceinline__ void wgmma_u8_m64n64k32(uint32_t (&d)[32],
                                                   uint64_t da, uint64_t db,
                                                   uint32_t accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ int ilog2(long long v) { return 63 - __clzll(v); }
#else
inline int ilog2(long long v) { return 63 - __builtin_clzll(v); }
#endif

namespace mxu {

constexpr int DIGITS = 32;          // 8-bit digits of an element
constexpr int PAD = 7;              // zero digits each side of a table slab
constexpr int G = 8;                // planes a wgmma forms: N = 8 G
constexpr int GROUPS = 8;           // plane groups: planes 0 .. 63
constexpr int ROWS = 64;            // vectors a tile holds: wgmma's m
constexpr int THREADS = 384;        // producer + two consumer warpgroups
constexpr int SLAB = 256 * (DIGITS + 2 * PAD);   // a (group, k-step) slab
constexpr int RING = 128 * 1024;
// `setmaxnreg` moves registers only within what the launch gave the
// block (168 a thread at 384 threads), or a request is never granted
constexpr int PRODUCER_REGS = 88, CONSUMER_REGS = 208;
static_assert(PRODUCER_REGS + 2 * CONSUMER_REGS <= 3 * 168, "registers");
// a consumer warpgroup's output staging: 8 runs blocks of 32 x 64 bytes
// (packed) or 32 blocks of 8 x 64 bytes (int32, half the limbs), each
// block padded by 16 bytes against bank conflicts
constexpr int PACKED_BLK = DIGITS * 64 + 16;     // 2064
constexpr int INT32_BLK = 8 * 64 + 16;           // 528
constexpr int STAGING = 32 * INT32_BLK;          // 16,896 >= 8 * 2064
// named barriers: 1, 2 a consumer warpgroup's staging; 3, 4 the turns of
// the tensor cores (ping-pong)
constexpr int BAR_STAGING = 1, BAR_TURN = 3;

// One pass, as `pass_launch` in ops/mxu_ntt.py fills it.
struct Geom {
  long long m, c, b, tiles;
  int lsj, lsk, in_packed, out_packed, twiddle, tw_split;
  long long m2;
  int lsj2, lsk2;
  long long blocks;
  int log_b, staged, tw_one;
  int skip;   // ZK_MXU_PARTS of the build: the part a measurement skips
};

template <int TM>   // the table's side: 16 (also for M < 16), 32 or 64
struct Shape {
  static constexpr int JH = TM >= 64 ? TM / 32 : 1;   // k-steps of 32 j
  static constexpr int KI = TM >= 32 ? 2 : 1;         // 16-byte j pieces
  static constexpr int TILE = ROWS * TM * DIGITS;     // packed tile bytes
  static constexpr int STAGES = RING / TILE;
  static constexpr int KG = TM >= 64 ? 2 : TM / 8;    // groups kept a block
  static constexpr int SLABS = TM / 8 / KG;           // 1, or 4 at TM = 64
  static constexpr int TABLE = KG * JH * SLAB;
  static constexpr int SMEM = RING + TABLE + 2 * STAGING +
                              8 * (2 * STAGES + 1);
};

// wgmma matrix descriptor, no swizzle: start, LBO, SBO in 16-byte units
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ long long insert_bits(long long t, int pos,
                                                 int width) {
  const long long low = (1LL << pos) - 1;
  return ((t >> pos) << (pos + width)) | (t & low);
}
__device__ __forceinline__ long long remove_bits(long long v, int pos,
                                                 int width) {
  const long long low = (1LL << pos) - 1;
  return ((v >> (pos + width)) << pos) | (v & low);
}
// the vector of row 0 of a tile, and a vector's (tile, row)
__device__ __forceinline__ long long tile_base(long long t, int lsj,
                                               int lsk) {
  return lsj < lsk ? insert_bits(insert_bits(t, lsj, 4), lsk, 2)
                   : insert_bits(insert_bits(t, lsk, 2), lsj, 4);
}
__device__ __forceinline__ long long tile_of(long long v, int lsj, int lsk) {
  return lsj < lsk ? remove_bits(remove_bits(v, lsk, 2), lsj, 4)
                   : remove_bits(remove_bits(v, lsj, 4), lsk, 2);
}
__device__ __forceinline__ int row_of(long long v, int lsj, int lsk) {
  return (int)(((v >> lsj) & 15) * 4 + ((v >> lsk) & 3));
}
__device__ __forceinline__ long long row_vector(long long base, int r,
                                                int lsj, int lsk) {
  return base + ((long long)(r >> 2) << lsj) + ((long long)(r & 3) << lsk);
}

// Where output (v, k) goes: the byte of digit 0 in the next pass's packed
// tiles, or the int32 index of limb 0.
__device__ __forceinline__ long long out_offset(const Geom& g, long long v,
                                               long long k) {
  const int log_m = ilog2(g.m);
  const long long c = g.log_b >= 0 ? v >> g.log_b : 0;
  const long long b = g.log_b >= 0 ? v & (g.b - 1) : v;
  if (!g.out_packed) return ((c << log_m) + k) * g.b + b;
  const int log_c2 = ilog2(g.c) - ilog2(g.m2);
  const long long jn = c >> log_c2, cn = c & ((1LL << log_c2) - 1);
  const long long vn = ((cn << log_m) + k) * g.b + b;
  const int ki2 = g.m2 >= 32 ? 2 : 1;
  return tile_of(vn, g.lsj2, g.lsk2) * (ROWS * DIGITS * g.m2) +
         (jn >> 5) * (DIGITS * ki2 * 1024) + ((jn >> 4) & 1) * 1024 +
         row_of(vn, g.lsj2, g.lsk2) * 16 + (jn & 15);
}

// Cut the int32 digits of one tile into the stage (a pass that reads the
// port's layout): 128 threads, four consecutive j of one row at a time, so
// that each digit is one 32-bit store (a side below 4 by bytes).
template <int TM>
__device__ __forceinline__ void stage_int32(uint8_t* dst, const int32_t* x,
                                            const Geom& g, long long tile,
                                            int pt) {
  using S = Shape<TM>;
  const long long V = g.c * g.b, plane = g.m * V;
  const long long base = tile_base(tile, g.lsj, g.lsk);
  const int quads = g.m >= 4 ? (int)g.m / 4 : 1, per = g.m >= 4 ? 4 : (int)g.m;
  for (int idx = pt; idx < ROWS * quads; idx += 128) {
    const int r = idx % ROWS, j0 = (idx / ROWS) * per;
    const long long v = row_vector(base, r, g.lsj, g.lsk);
    if (v >= V) continue;
    const int32_t* src = x + (long long)j0 * V + v;
    uint8_t* d = dst + (j0 >> 5) * (DIGITS * S::KI * 1024) +
                 ((j0 >> 4) & 1) * 1024 + r * 16 + (j0 & 15);
#pragma unroll 4
    for (int l = 0; l < 16; ++l) {
      uint32_t limb[4], lo = 0, hi = 0;   // bytes 2l, 2l+1 of `per` elements
#pragma unroll
      for (int u = 0; u < 4; ++u)
        limb[u] = u < per ? (uint32_t)src[l * plane + u * V] : 0u;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        lo |= (limb[u] & 0xFFu) << (8 * u);
        hi |= ((limb[u] >> 8) & 0xFFu) << (8 * u);
      }
      if (per == 4) {
        *reinterpret_cast<uint32_t*>(d + (2 * l) * S::KI * 1024) = lo;
        *reinterpret_cast<uint32_t*>(d + (2 * l + 1) * S::KI * 1024) = hi;
      } else {
        for (int u = 0; u < per; ++u) {
          d[(2 * l) * S::KI * 1024 + u] = (uint8_t)(lo >> (8 * u));
          d[(2 * l + 1) * S::KI * 1024 + u] = (uint8_t)(hi >> (8 * u));
        }
      }
    }
  }
}

// Group q's value sum_g acc_g 2^(8g) (< 2^84) added at bit 64 q of each
// element's running integer; its words above 2q are still 0.
template <int Q>
__device__ __forceinline__ void fold(uint32_t (&R)[4][17],
                                     const uint32_t (&acc)[32]) {
#pragma unroll
  for (int el = 0; el < 4; ++el) {
    const int o = 2 * (el >> 1) + (el & 1);
    const uint64_t lo = (uint64_t)acc[o] + ((uint64_t)acc[4 + o] << 8) +
                        ((uint64_t)acc[8 + o] << 16) +
                        ((uint64_t)acc[12 + o] << 24);
    const uint64_t hi = (uint64_t)acc[16 + o] + ((uint64_t)acc[20 + o] << 8) +
                        ((uint64_t)acc[24 + o] << 16) +
                        ((uint64_t)acc[28 + o] << 24);
    uint64_t s = (uint64_t)R[el][2 * Q] + (uint32_t)lo;
    R[el][2 * Q] = (uint32_t)s;
    s = (s >> 32) + (lo >> 32) + (uint32_t)hi;
    R[el][2 * Q + 1] = (uint32_t)s;
    R[el][2 * Q + 2] = (uint32_t)((s >> 32) + (hi >> 32));
  }
}

template <int Q>
constexpr int b_first = Q * G > DIGITS - 1 ? Q * G - (DIGITS - 1) : 0;
template <int Q>
constexpr int b_last = Q * G + G - 1 < DIGITS - 1 ? Q * G + G - 1
                                                  : DIGITS - 1;

// The wgmmas of group Q from digit B on: every B and k-step an unrolled
// instruction of its own, so the accumulator stays in place.
template <int TM, int Q, int B>
__device__ __forceinline__ void issue_digits(uint32_t (&acc)[32], uint32_t a0,
                                             uint32_t t0) {
  using S = Shape<TM>;
#pragma unroll
  for (int jh = 0; jh < S::JH; ++jh)
    wgmma_u8_m64n64k32(
        acc, desc(a0 + jh * (DIGITS * S::KI * 1024) + B * (S::KI * 1024),
                  1024, 128),
        desc(t0 + jh * SLAB + (Q * G - B + PAD) * 256, 128, 256),
        (B != b_first<Q> || jh != 0) ? 1u : 0u);
  if constexpr (B < b_last<Q>) issue_digits<TM, Q, B + 1>(acc, a0, t0);
}

template <int TM, int Q>
__device__ __forceinline__ void issue_group(uint32_t (&acc)[32], uint32_t a0,
                                            uint32_t t0) {
#pragma unroll
  for (int i = 0; i < 32; ++i) fence_operand(acc[i]);
  wgmma_fence();
  issue_digits<TM, Q, b_first<Q>>(acc, a0, t0);
  wgmma_commit();
}

// Group Q was issued into `cur`; issue group Q + 1 into `nxt`, wait for Q
// alone and fold it while Q + 1 runs on the tensor cores.
template <int TM, int Q>
__device__ __forceinline__ void products(uint32_t (&R)[4][17],
                                         uint32_t (&cur)[32],
                                         uint32_t (&nxt)[32], uint32_t a0,
                                         uint32_t t0) {
  if constexpr (Q + 1 < GROUPS) {
    issue_group<TM, Q + 1>(nxt, a0, t0);
    wgmma_wait<1>();
  } else {
    wgmma_wait<0>();
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) fence_operand(cur[i]);
  fold<Q>(R, cur);
  if constexpr (Q + 1 < GROUPS) products<TM, Q + 1>(R, nxt, cur, a0, t0);
}

// Nine word rounds (x 2^-288) and the conditional subtract: canonical
// words of the element in w. Plain C on 64-bit sums, no carry flag, so
// that the four elements of a thread interleave.
__device__ __forceinline__ void reduce(uint32_t (&R)[17], uint32_t (&w)[8],
                                       const FieldConst<8>& F) {
  uint32_t pend = 0;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const uint32_t m = R[i] * F.ninv;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint64_t t = (uint64_t)m * F.p[j] + R[i + j] + c;
      R[i + j] = (uint32_t)t;
      c = t >> 32;
    }
    if (i < 8) {
      const uint64_t t = (uint64_t)R[i + 8] + c + pend;
      R[i + 8] = (uint32_t)t;
      pend = (uint32_t)(t >> 32);
    } else {
      R[16] += (uint32_t)c + pend;   // the value is below 2p: no carry out
    }
  }
  uint32_t s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = R[9 + j];
  cond_sub_p<8>(w, s, F);
}

// The thread's 4 elements of one output group, canonical and times their
// twiddles: the twiddle loads first (their latency under the rounds), the
// rounds of all four (plain C, free to interleave), then the products.
// The twiddle is lo[e] alone where the pass's table is one compact table
// (`tw_one`), else lo[e mod 2^h] hi[e >> h]. Element el is row
// 16 warp + lane/4 + 8 (el/2) and output 8 group + 2 (lane % 4) + el % 2.
__device__ __forceinline__ void finish4(const FieldConst<8>& F, const Geom& g,
                                        uint32_t (&R)[4][17],
                                        const long long (&v)[4],
                                        const long long (&k)[4],
                                        uint32_t (&w)[4][8],
                                        const uint4* __restrict__ tw_lo,
                                        const uint4* __restrict__ tw_hi) {
  if (!g.twiddle) {
#pragma unroll
    for (int el = 0; el < 4; ++el) reduce(R[el], w[el], F);
    return;
  }
  uint4 lo[4][2];
#pragma unroll
  for (int el = 0; el < 4; ++el) {
    const long long e = (v[el] >> g.log_b) * k[el];
    const uint4* l = tw_lo + (e & ((1LL << g.tw_split) - 1)) * 2;
    lo[el][0] = l[0];
    lo[el][1] = l[1];
  }
#pragma unroll
  for (int el = 0; el < 4; ++el) reduce(R[el], w[el], F);
#pragma unroll
  for (int el = 0; el < 4; ++el) {
    uint32_t tw[8] = {lo[el][0].x, lo[el][0].y, lo[el][0].z, lo[el][0].w,
                      lo[el][1].x, lo[el][1].y, lo[el][1].z, lo[el][1].w};
    if (!g.tw_one) {
      const long long e = (v[el] >> g.log_b) * k[el];
      const uint4* h = tw_hi + (e >> g.tw_split) * 2;
      const uint4 h0 = h[0], h1 = h[1];
      const uint32_t hw[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
      uint32_t t2[8];
      mont_mul<8>(t2, tw, hw, F);
#pragma unroll
      for (int j = 0; j < 8; ++j) tw[j] = t2[j];
    }
    uint32_t y[8];
    mont_mul<8>(y, w[el], tw, F);
#pragma unroll
    for (int j = 0; j < 8; ++j) w[el][j] = y[j];
  }
}

// Reduce, twiddle and store the thread's 4 elements of one output group.
// Staged: through the warpgroup's staging buffer in whole 64-byte runs of
// the destination (packed: 4 rows x 16 j' bytes of one digit; int32: 16
// consecutive limbs of one plane), copied out 16 bytes a thread,
// consecutive threads on consecutive bytes.
__device__ __forceinline__ void epilogue(
    const FieldConst<8>& F, const Geom& g, uint32_t (&R)[4][17],
    long long tile, int group, int wg, int warp, int lane,
    const uint4* __restrict__ tw_lo, const uint4* __restrict__ tw_hi,
    int32_t* __restrict__ out32, uint8_t* __restrict__ out8,
    uint8_t* stage) {
  const long long V = g.c * g.b, plane = g.m * V;
  const long long base = tile_base(tile, g.lsj, g.lsk);
  const int t = 32 * warp + lane;
  const int ki2 = g.m2 >= 32 ? 2 : 1;
  long long v[4], k[4];
#pragma unroll
  for (int el = 0; el < 4; ++el) {
    v[el] = row_vector(base, 16 * warp + (lane >> 2) + 8 * (el >> 1), g.lsj,
                       g.lsk);
    k[el] = group * 8 + 2 * (lane & 3) + (el & 1);
    // rows past the vectors and outputs past M compute garbage, never
    // stored; keep their twiddle index in range
    if (v[el] >= V) v[el] = 0;
  }
  uint32_t w[4][8];
  finish4(F, g, R, v, k, w, tw_lo, tw_hi);
  if (g.staged == 0) {
#pragma unroll
    for (int el = 0; el < 4; ++el) {
      const int r = 16 * warp + (lane >> 2) + 8 * (el >> 1);
      if (row_vector(base, r, g.lsj, g.lsk) >= V || k[el] >= g.m) continue;
      const long long off = out_offset(g, v[el], k[el]);
      if (!g.out_packed) {
#pragma unroll
        for (int l = 0; l < 16; ++l)
          out32[off + l * plane] =
              (int32_t)((w[el][l >> 1] >> (16 * (l & 1))) & 0xFFFFu);
      } else {
#pragma unroll
        for (int d = 0; d < DIGITS; ++d)
          out8[off + (long long)d * ki2 * 1024] =
              (uint8_t)(w[el][d >> 2] >> (8 * (d & 3)));
      }
    }
    return;
  }
  const int jq = 4 * warp + ((lane >> 2) >> 2);   // element el: + 2 (el / 2)
  const int kl = (lane >> 2) & 3;
  if (g.staged == 1) {
    named_sync(BAR_STAGING + wg, 128);   // the last copy-out has read it
#pragma unroll
    for (int el = 0; el < 4; ++el) {
      const int kk = 2 * (lane & 3) + (el & 1);
      uint8_t* dst = stage + (kl * 2 + (kk >> 2)) * PACKED_BLK +
                     (kk & 3) * 16 + jq + 2 * (el >> 1);
#pragma unroll
      for (int d = 0; d < DIGITS; ++d)
        dst[d * 64] = (uint8_t)(w[el][d >> 2] >> (8 * (d & 3)));
    }
    named_sync(BAR_STAGING + wg, 128);
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int u = t + 128 * s, run = u >> 2, part = u & 3;
      const int blk = run >> 5, d = run & 31;
      const long long rv = row_vector(base, blk >> 1, g.lsj, g.lsk);
      const long long off = out_offset(g, rv, group * 8 + 4 * (blk & 1)) +
                            (long long)d * ki2 * 1024 + part * 16;
      *reinterpret_cast<uint4*>(out8 + off) = *reinterpret_cast<const uint4*>(
          stage + blk * PACKED_BLK + d * 64 + part * 16);
    }
    return;
  }
  // int32, staged in two halves of 8 limbs
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    named_sync(BAR_STAGING + wg, 128);
#pragma unroll
    for (int el = 0; el < 4; ++el) {
      const int kk = 2 * (lane & 3) + (el & 1);
      uint32_t* dst = reinterpret_cast<uint32_t*>(
                          stage + (kl * 8 + kk) * INT32_BLK) +
                      jq + 2 * (el >> 1);
#pragma unroll
      for (int lh = 0; lh < 8; ++lh) {
        const int l = 8 * half + lh;
        dst[lh * 16] = (w[el][l >> 1] >> (16 * (l & 1))) & 0xFFFFu;
      }
    }
    named_sync(BAR_STAGING + wg, 128);
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int u = t + 128 * s, run = u >> 2, part = u & 3;
      const int blk = run >> 3, lh = run & 7;
      const long long rv = row_vector(base, (blk >> 3), g.lsj, g.lsk);
      const long long off = out_offset(g, rv, group * 8 + (blk & 7)) +
                            (8 * half + lh) * plane;
      *reinterpret_cast<uint4*>(out32 + off + 4 * part) =
          *reinterpret_cast<const uint4*>(stage + blk * INT32_BLK + lh * 64 +
                                          part * 16);
    }
  }
}

}  // namespace mxu

// (the kernel and its launch stay outside the namespace: the host stand-in
// names the shared-memory array and rewrites the launch at global scope)
template <int TM>
__global__ void __launch_bounds__(mxu::THREADS, 1)
mxu_pass_kernel(FieldConst<8> F, mxu::Geom g, const int32_t* x32,
                const uint8_t* x8, const uint8_t* table,
                const uint4* __restrict__ tw_lo,
                const uint4* __restrict__ tw_hi, int32_t* out32,
                uint8_t* out8) {
  using namespace mxu;
  using S = Shape<TM>;
  extern __shared__ uint32_t sh[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(sh);
  uint8_t* tbl = ring + RING;
  uint8_t* staging = tbl + S::TABLE;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * STAGING);
  uint64_t* empty = full + S::STAGES;
  uint64_t* tbar = empty + S::STAGES;
  const int slab = (int)(blockIdx.x % S::SLABS);
  const long long first = blockIdx.x / S::SLABS;
  const long long stride = g.blocks / S::SLABS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full[s], g.in_packed ? 1u : 128u);
      mbar_init(&empty[s], 8u);   // one arrival a consumer warp
    }
    mbar_init(tbar, 1u);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup ----
    regs_dec<PRODUCER_REGS>();
    const int pt = threadIdx.x;
    if (pt == 0) {
      mbar_expect_tx(tbar, S::TABLE);
      bulk_load(tbl, table + (long long)slab * S::TABLE, S::TABLE, tbar);
    }
    long long it = 0;
    for (long long tile = first; tile < g.tiles; tile += stride, ++it) {
      const int stage = (int)(it % S::STAGES);
      const uint32_t round = (uint32_t)(it / S::STAGES) & 1u;
      mbar_wait(&empty[stage], round ^ 1u);
      uint8_t* dst = ring + stage * S::TILE;
      if (g.in_packed) {
        if (pt == 0) {
          mbar_expect_tx(&full[stage], S::TILE);
          bulk_load(dst, x8 + tile * S::TILE, S::TILE, &full[stage]);
        }
      } else {
        stage_int32<TM>(dst, x32, g, tile, pt);
        fence_async_smem();
        mbar_arrive(&full[stage]);
      }
    }
  } else {
    // ---- two consumer warpgroups: the same tile, alternate groups, their
    // product phases taking turns on the tensor cores ----
    regs_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x / 128 - 1;
    const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
    const uint32_t ring_a = smem_addr(ring), tbl_a = smem_addr(tbl);
    uint8_t* stage_buf = staging + wg * STAGING;
    mbar_wait(tbar, 0u);
    uint32_t acc0[32], acc1[32];
    long long it = 0, phase = 0;
    const long long phases =
        (g.tiles > first ? (g.tiles - first + stride - 1) / stride : 0) *
        (S::KG / 2);
    for (long long tile = first; tile < g.tiles; tile += stride, ++it) {
      const int stage = (int)(it % S::STAGES);
      const uint32_t round = (uint32_t)(it / S::STAGES) & 1u;
      mbar_wait(&full[stage], round);
      const uint32_t a0 = ring_a + stage * S::TILE;
      for (int kk = wg; kk < S::KG; kk += 2, ++phase) {
        uint32_t R[4][17];
#pragma unroll
        for (int el = 0; el < 4; ++el)
#pragma unroll
          for (int i = 0; i < 17; ++i) R[el][i] = 0;
        if (wg == 1 || phase > 0)
          named_sync(BAR_TURN + wg, 256);
        const uint32_t t0 = tbl_a + kk * S::JH * SLAB;
        if (ZK_MXU_PARTS == 0 || g.skip != 2) {
          issue_group<TM, 0>(acc0, a0, t0);
          products<TM, 0>(R, acc0, acc1, a0, t0);
        }
        if (wg == 0 || phase + 1 < phases)
          named_arrive(BAR_TURN + 1 - wg, 256);
        if (kk + 2 >= S::KG) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[stage]);
        }
        if (ZK_MXU_PARTS == 0 || g.skip != 1)
          epilogue(F, g, R, tile, slab * S::KG + kk, wg, warp, lane, tw_lo,
                   tw_hi, out32, out8, stage_buf);
      }
    }
  }
}

namespace mxu {

template <int TM>
int launch(const uint32_t* consts, const Geom& g, const void* x,
           const void* table, const void* tw_lo, const void* tw_hi,
           void* out, void* stream) {
  using S = Shape<TM>;
  if (TM == 64 && g.blocks % S::SLABS != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mxu_pass_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::SMEM);
  if (err != cudaSuccess) return (int)err;
  mxu_pass_kernel<TM><<<(unsigned)g.blocks, THREADS, S::SMEM,
                        (cudaStream_t)stream>>>(
      make_const<8>(consts), g, (const int32_t*)x, (const uint8_t*)x,
      (const uint8_t*)table, (const uint4*)tw_lo, (const uint4*)tw_hi,
      (int32_t*)out, (uint8_t*)out);
  return (int)cudaGetLastError();
}

inline bool pow2(long long v) { return v > 0 && (v & (v - 1)) == 0; }

inline bool lanes_ok(long long v, int lsj, int lsk) {
  if (lsj == 2 && lsk == 0) return true;
  if (!pow2(v) || lsj < 0 || lsk < 0) return false;
  int bits = 0;
  while ((1LL << bits) < v) ++bits;
  if (lsj + 4 > bits || lsk + 2 > bits) return false;
  return lsk + 2 <= lsj || lsj + 4 <= lsk;
}

}  // namespace mxu

// One pass. geom: the 17 int64 of `GEOM_FIELDS` in ops/mxu_ntt.py. x:
// (16, M V) int32 digits or packed tiles; table: the plan's `table_u8`;
// tw_lo / tw_hi: the twiddle tables' 8-word entries (read only with the
// twiddle); out: (16, M V) int32 digits or the next pass's packed tiles.
// `staged`: whole 64-byte runs, which `pass_launch` checks the geometry
// gives.
extern "C" int zk_mxu_pass(int nw, const uint32_t* consts,
                           const long long* geom, const void* x,
                           const void* table, const void* tw_lo,
                           const void* tw_hi, void* out, void* stream) {
  using namespace mxu;
  Geom g;
  g.m = geom[0];
  g.c = geom[1];
  g.b = geom[2];
  g.tiles = geom[3];
  g.lsj = (int)geom[4];
  g.lsk = (int)geom[5];
  g.in_packed = (int)geom[6];
  g.out_packed = (int)geom[7];
  g.twiddle = (int)geom[8];
  g.tw_split = (int)geom[9];
  g.m2 = geom[10];
  g.lsj2 = (int)geom[11];
  g.lsk2 = (int)geom[12];
  g.blocks = geom[13];
  g.log_b = (int)geom[14];
  g.staged = (int)geom[15];
  g.tw_one = (int)geom[16];
  g.skip = ZK_MXU_PARTS;
  const long long V = g.c * g.b;
  const bool ok =
      nw == 8 && pow2(g.m) && g.m >= 2 && g.m <= 64 && g.c >= 1 &&
      g.b >= 1 && g.tiles == (V + ROWS - 1) / ROWS && g.blocks >= 1 &&
      g.blocks <= 0x7FFFFFFF &&
      (g.log_b >= 0 ? g.log_b < 62 && (1LL << g.log_b) == g.b : g.c == 1) &&
      (g.c == 1 || pow2(g.c)) && lanes_ok(V, g.lsj, g.lsk) &&
      (!g.in_packed || g.m >= 16) &&
      (!g.twiddle || (g.tw_split >= 0 && g.tw_split < 31 && g.log_b >= 0 &&
                      (!g.tw_one || (1LL << g.tw_split) >= g.m * g.c))) &&
      (!g.out_packed ||
       (pow2(g.m2) && g.m2 >= 16 && g.m2 <= 64 && g.c % g.m2 == 0 &&
        lanes_ok(V * g.m / g.m2, g.lsj2, g.lsk2))) &&
      g.staged >= 0 && g.staged <= 2 &&
      (g.staged == 0 || (g.m >= 16 && V % ROWS == 0 &&
                         (g.staged == 1) == (g.out_packed != 0)));
  if (!ok) return (int)cudaErrorInvalidValue;
  switch (g.m <= 16 ? 16 : (int)g.m) {
    case 16: return launch<16>(consts, g, x, table, tw_lo, tw_hi, out, stream);
    case 32: return launch<32>(consts, g, x, table, tw_lo, tw_hi, out, stream);
    default: return launch<64>(consts, g, x, table, tw_lo, tw_hi, out, stream);
  }
}
