// Kernel 5: the width-3 Poseidon permutation of a batch of states, one launch
// for the whole permutation, in three forms.
//
// It has no Pallas counterpart: the JAX package composes the permutation
// from its elementwise field ops (`ops/poseidon.py::permute_batch`,
// `ops/nil_poseidon.py::permute_batch`) and leaves the fusion to XLA.
// Composed the same way here it would be about 1,200 launches a permutation
// (828 products and some 400 additions for 8 full and 57 partial rounds in
// the textbook schedule), so the rounds run inside one kernel, with their
// constants staged once per block in shared memory.
//
// The schedule (`sched` of the entry): rounds; p_begin, p_end (rounds r with
// p_begin <= r < p_end are partial: the S-box on element 0 only); alpha, the
// S-box exponent; rc_first, 1: round = add rc -> S-box -> MDS (original
// Poseidon), 0: round = S-box -> MDS -> add rc (the nil flavour, all rounds
// full, x^7); lanes_out.
//
// Inputs for the Merkle shapes, so that no state is assembled in memory:
// element i of the state is read from plane pointer in[i] with its own lane
// stride and limb stride (a level's even and odd digests are strided views;
// a null pointer is the zero capacity element), and add[0], add[1], where
// not null, are added to elements 0 and 1 first (the sponge's absorb). With
// `lanes_out` = 1 only element 0 is written ((NL, n)), else the whole state
// ((NL, 3, n), element i of lane l at i*n + l). Lanes are innermost in every
// load and store.
//
// What bounds it. A state moves 6*NL*4 bytes for hundreds of Montgomery
// products: the operations, by three orders of magnitude. Inside one thread
// every product is one carry chain (the PTX carry flag orders every
// instruction of it, and the next product needs its result). Two regimes
// follow: a large level (tens of thousands of states) fills the card and
// the rate of the integer pipes bounds it; a small level is pure latency,
// a thread's instructions in sequence, whether the level has 1 state or
// 2^13.
//
// The three forms:
// - `poseidon_kernel` (lanes): one thread a state, all three elements in
//   registers: the fewest instructions a state, so the form for large
//   levels. Templated on the word count, alpha and the flavour, the round
//   loop branch-free:
//   * original flavour: sparse partial rounds (`ops/hopper_hash.py::
//     sparse_schedule`, Grassi et al., eprint 2019/458, Appendix B). A
//     partial round adds one constant to element 0, raises it, and mixes by
//     a sparse matrix: s0' = m00 s0 + w1 s1 + w2 s2, s1' = s1 + v1 s0,
//     s2' = s2 + v2 s0, five products instead of nine; the last full round
//     before them mixes by the dense pre-sparse matrix, the first after
//     them adds the constants they pushed forward. Table: the full rounds'
//     rc vectors, M, the pre-sparse matrix, then (k, m00, w1, w2, v1, v2)
//     a partial round: 384 entries, 12 KB at NW = 8, 18 KB at NW = 12;
//   * nil flavour: the dense schedule on the dense table (rounds*3 + 9
//     entries: rc[r][i] at r*3 + i, then M[i][j]);
//   * both: the S-box unrolled on alpha's bits (its squarings general
//     products: a Montgomery squaring measured slower here), each row of a
//     mix as `mont_dot3` (three products, one reduction, in the 8- and
//     12-word instances, p < R/2; the 2- and 10-word ones reduce each
//     product, see `field.cuh`), constants read as 16-byte (8-byte at
//     NW = 2, 10) shared loads.
//   bls12-381 Fr (alpha 5, 8 full and 57 partial rounds): 600 products, 438
//   reductions, 139,872 multiply-add instructions by `chip_smoke.py`'s
//   count, against 828 products and 225,216 in the textbook schedule; the
//   permutation's floor, with squarings of NW (NW + 1) / 2 word products,
//   is 130,800 (`ops/hopper_hash.py::lanes_counts`).
// - `poseidon_shared_kernel` (shared): three threads a state, thread e
//   owning element e, on the lanes form's table and schedule and its six
//   instances. Every thread runs the same instructions (a warp's threads
//   share them), so what one thread of a state needs, each computes. A full
//   round: each thread raises its own element whole (x^2, x^4, x^5 at
//   alpha 5), one exchange of NW words through shared memory within the
//   warp, and its row of the mix as one `mont_dot3`: 4 products in sequence
//   at x^5 where the textbook's is 6. A sparse partial round folds the mix
//   constant into the S-box's last product, m y^5 = y^4 (m y): every thread
//   raises y = s0 + k itself and forms its own coefficient times y beside
//   the squarings; thread 0's dot is s0' = y^4 (m00 y) + w1 s1 + w2 s2,
//   thread i's s_i' = y^4 (v_i y) + s_i, one exchange a round, 3 products
//   deep. bls12-381 Fr: 203 products in sequence a permutation, the
//   textbook's 390 (`ops/hopper_hash.py::shared_chain`). With one warp a
//   sub-partition a warp's multiply-adds, not this chain, set its time: the
//   form runs at about 0.14 ms where the chain's bound is 0.09 (an H100,
//   `tools/poseidon_times.py`). It is the form for small levels, up to
//   `SHARED_MAX` in `ops/hopper_hash.py` (by measurement).
// - `poseidon_tree_kernel` (tree): the shared form in ONE block that hashes
//   a Merkle tree's last levels, from at most ZK_TREE_MAX states down to the
//   root, with a barrier between levels. Each level is one latency of the
//   shared form's chain, but one launch replaces one a level, and each
//   level's digests go to their own plane, because proofs read every level.
// Past one warp an SM sub-partition, the warps' multiply-adds share that
// sub-partition's integer pipe (16.2 T multiply-adds a second measured for
// the card). On an H100, with x^5's full rounds then folded, the tree took
// 0.9002 ms from 32 states (6 levels, 4 warps) and 1.1197 from 64 (7 warps:
// its first level, two warps on three sub-partitions, ran about twice as
// long), while a launch of the shared form on 64 states took 0.1502; from
// 128 states (13 warps) 1.5323. So the
// tree takes at most 32 states, and the level of 64 is a launch of the
// shared form (`tools/poseidon_times.py`).
#include <type_traits>

#include "field.cuh"

struct PoseidonPlane {
  const int32_t* ptr;
  long long lane, limb;     // strides in int32s
};

struct PoseidonArgs {
  PoseidonPlane in[3];
  PoseidonPlane add[2];
  int rounds, p_begin, p_end, alpha, rc_first, lanes_out;
};

// ---------------------------------------------------------------------------
// the lanes form
// ---------------------------------------------------------------------------

// The piece a shared-memory load of the lanes form moves: 16 bytes where a
// constant (NW words, at a multiple of NW words) is 16-byte aligned, else 8.
template <int NW>
using ConstPiece = std::conditional_t<NW % 4 == 0, uint4, uint2>;

template <int NW>
__device__ __forceinline__ void load_words(uint32_t (&w)[NW],
                                           const uint32_t* src) {
  using V = ConstPiece<NW>;
  constexpr int k = sizeof(V) / 4;
#pragma unroll
  for (int j = 0; j < NW; j += k) {
    const V v = reinterpret_cast<const V*>(src)[j / k];
    w[j] = v.x;
    w[j + 1] = v.y;
    if constexpr (k == 4) {
      w[j + 2] = v.z;
      w[j + 3] = v.w;
    }
  }
}

// x <- x^ALPHA, square-and-multiply on ALPHA's bits below the top one,
// unrolled (x^5: two squarings and a product). The squarings are general
// products: a Montgomery squaring (off-diagonal word products once, then
// doubled) measured 2.7 % slower at 2^17 states on an H100.
template <int NW, int ALPHA>
__device__ __forceinline__ void sbox_pow(uint32_t (&x)[NW],
                                         const FieldConst<NW>& F) {
  static_assert(ALPHA >= 2 && ALPHA < 256, "alpha");
  uint32_t acc[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) acc[j] = x[j];
#pragma unroll
  for (int b = 7; b >= 0; --b) {
    if ((ALPHA >> (b + 1)) == 0) continue;     // the top bit and above
    mont_mul<NW>(acc, acc, acc, F);            // the square
    if ((ALPHA >> b) & 1) mont_mul<NW>(acc, acc, x, F);
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) x[j] = acc[j];
}

// s <- M s, M's nine entries at m (row-major), a row a `mont_dot3`
template <int NW>
__device__ __forceinline__ void mix_dense(uint32_t (&s0)[NW],
                                          uint32_t (&s1)[NW],
                                          uint32_t (&s2)[NW],
                                          const uint32_t* m,
                                          const FieldConst<NW>& F) {
  uint32_t r[3][NW], c0[NW], c1[NW], c2[NW];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    load_words<NW>(c0, m + (3 * i) * NW);
    load_words<NW>(c1, m + (3 * i + 1) * NW);
    load_words<NW>(c2, m + (3 * i + 2) * NW);
    mont_dot3<NW>(r[i], s0, c0, s1, c1, s2, c2, F);
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    s0[j] = r[0][j];
    s1[j] = r[1][j];
    s2[j] = r[2][j];
  }
}

// s <- s + rc, rc's three entries at c
template <int NW>
__device__ __forceinline__ void add_rc(uint32_t (&s0)[NW], uint32_t (&s1)[NW],
                                       uint32_t (&s2)[NW], const uint32_t* c,
                                       const FieldConst<NW>& F) {
  uint32_t k[NW];
  load_words<NW>(k, c);
  add_mod<NW>(s0, s0, k, F);
  load_words<NW>(k, c + NW);
  add_mod<NW>(s1, s1, k, F);
  load_words<NW>(k, c + 2 * NW);
  add_mod<NW>(s2, s2, k, F);
}

// One partial round of the sparse schedule; q: (k, m00, w1, w2, v1, v2)
template <int NW, int ALPHA>
__device__ __forceinline__ void partial_round(uint32_t (&s0)[NW],
                                              uint32_t (&s1)[NW],
                                              uint32_t (&s2)[NW],
                                              const uint32_t* q,
                                              const FieldConst<NW>& F) {
  uint32_t c0[NW], c1[NW], c2[NW], r0[NW];
  load_words<NW>(c0, q);
  add_mod<NW>(s0, s0, c0, F);
  sbox_pow<NW, ALPHA>(s0, F);
  load_words<NW>(c0, q + NW);
  load_words<NW>(c1, q + 2 * NW);
  load_words<NW>(c2, q + 3 * NW);
  mont_dot3<NW>(r0, s0, c0, s1, c1, s2, c2, F);
  load_words<NW>(c1, q + 4 * NW);
  mont_mul<NW>(c0, s0, c1, F);
  add_mod<NW>(s1, s1, c0, F);
  load_words<NW>(c2, q + 5 * NW);
  mont_mul<NW>(c0, s0, c2, F);
  add_mod<NW>(s2, s2, c0, F);
#pragma unroll
  for (int j = 0; j < NW; ++j) s0[j] = r0[j];
}

// Entries (constants of NW words) of the table every form reads.
__host__ __device__ inline int table_entries(const PoseidonArgs& A) {
  const int partial = A.p_end - A.p_begin;
  return A.rc_first ? (A.rounds - partial) * 3 + 18 + partial * 6
                    : A.rounds * 3 + 9;
}

// Stage the table (`table_entries` constants of NW words) in shared
// memory in 16-byte (8-byte) pieces; returns the exchange areas after it.
template <int NW>
__device__ __forceinline__ uint32_t* stage_table(uint32_t* sh,
                                                 const uint32_t* consts,
                                                 const PoseidonArgs& A) {
  using V = ConstPiece<NW>;
  constexpr int k = sizeof(V) / 4;
  const int pieces = table_entries(A) * NW / k;
#pragma unroll 1
  for (int i = threadIdx.x; i < pieces; i += blockDim.x)
    reinterpret_cast<V*>(sh)[i] = reinterpret_cast<const V*>(consts)[i];
  return sh + table_entries(A) * NW;
}

// SPARSE: the original flavour on `sparse_schedule`'s table (full rounds
// f < p_begin, the partial rounds after full round p_begin - 1, then the
// rest; the partial loop sits inside the full one and runs once). Else the
// nil flavour on the dense table.
template <int NW, int ALPHA, bool SPARSE>
__global__ void __launch_bounds__(128)
poseidon_kernel(FieldConst<NW> F, PoseidonArgs A,
                const uint32_t* __restrict__ consts, int32_t* __restrict__ out,
                long long n) {
  extern __shared__ uint32_t sh[];
  stage_table<NW>(sh, consts, A);
  __syncthreads();
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;

  uint32_t s0[NW], s1[NW], s2[NW], c[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) s0[j] = s1[j] = s2[j] = 0;
  if (A.in[0].ptr)
    load_digits<NW>(s0, A.in[0].ptr + idx * A.in[0].lane, A.in[0].limb);
  if (A.in[1].ptr)
    load_digits<NW>(s1, A.in[1].ptr + idx * A.in[1].lane, A.in[1].limb);
  if (A.in[2].ptr)
    load_digits<NW>(s2, A.in[2].ptr + idx * A.in[2].lane, A.in[2].limb);
  if (A.add[0].ptr) {
    load_digits<NW>(c, A.add[0].ptr + idx * A.add[0].lane, A.add[0].limb);
    add_mod<NW>(s0, s0, c, F);
  }
  if (A.add[1].ptr) {
    load_digits<NW>(c, A.add[1].ptr + idx * A.add[1].lane, A.add[1].limb);
    add_mod<NW>(s1, s1, c, F);
  }

  if constexpr (SPARSE) {
    const int partial = A.p_end - A.p_begin, full = A.rounds - partial;
    const uint32_t* mds = sh + full * 3 * NW;
    const uint32_t* pre = mds + 9 * NW;
    const uint32_t* part = pre + 9 * NW;
#pragma unroll 1
    for (int f = 0; f < full; ++f) {
      add_rc<NW>(s0, s1, s2, sh + f * 3 * NW, F);
      sbox_pow<NW, ALPHA>(s0, F);
      sbox_pow<NW, ALPHA>(s1, F);
      sbox_pow<NW, ALPHA>(s2, F);
      const bool last_before = f == A.p_begin - 1;
      mix_dense<NW>(s0, s1, s2, last_before ? pre : mds, F);
      if (last_before) {
#pragma unroll 1
        for (int q = 0; q < partial; ++q)
          partial_round<NW, ALPHA>(s0, s1, s2, part + q * 6 * NW, F);
      }
    }
  } else {
    const uint32_t* mds = sh + A.rounds * 3 * NW;
#pragma unroll 1
    for (int r = 0; r < A.rounds; ++r) {
      sbox_pow<NW, ALPHA>(s0, F);
      sbox_pow<NW, ALPHA>(s1, F);
      sbox_pow<NW, ALPHA>(s2, F);
      mix_dense<NW>(s0, s1, s2, mds, F);
      add_rc<NW>(s0, s1, s2, sh + r * 3 * NW, F);
    }
  }

  if (A.lanes_out == 1) {
    store_digits<NW>(out + idx, n, s0);
  } else {
    store_digits<NW>(out + idx, 3 * n, s0);
    store_digits<NW>(out + n + idx, 3 * n, s1);
    store_digits<NW>(out + 2 * n + idx, 3 * n, s2);
  }
}

#define ZK_GROUP_LANES 30        // a warp holds 10 states of 3 threads
#define ZK_SHARED_THREADS 128    // 40 states a block
#define ZK_TREE_MAX 32           // states at the first level the tree takes
#define ZK_TREE_LEVELS 6         // log2(ZK_TREE_MAX) + 1
#define ZK_TREE_THREADS 128      // 4 warps: 40 states >= ZK_TREE_MAX

// Where a thread of the shared forms sits: state `grp` of its warp (10 a
// warp), element e of it, and `base`, the block thread that owns element 0.
// The last two lanes of a warp own no state; they run element 0 of a state
// of nobody's, reading the exchange slots of lanes 28..31 of their own warp
// (never past the warp, nor past the block's exchange area), and store
// nothing.
struct SharedSeat {
  int e, base, grp;
  bool idle;
};

__device__ __forceinline__ SharedSeat shared_seat() {
  const int lane = threadIdx.x & 31;
  SharedSeat s;
  s.idle = lane >= ZK_GROUP_LANES;
  s.grp = (threadIdx.x >> 5) * (ZK_GROUP_LANES / 3) + lane / 3;
  s.e = s.idle ? 0 : lane % 3;
  s.base = (int)threadIdx.x - (s.idle ? 2 : s.e);
  return s;
}

// A thread's element of the state of lane `idx` (zero where the plane is
// null or idx is past n), the absorb added.
template <int NW>
__device__ __forceinline__ void load_element(uint32_t (&x)[NW],
                                             const PoseidonArgs& A, int e,
                                             long long idx, long long n,
                                             const FieldConst<NW>& F) {
#pragma unroll
  for (int j = 0; j < NW; ++j) x[j] = 0;
  if (idx >= n) return;
  const PoseidonPlane& in = A.in[e];
  if (in.ptr) load_digits<NW>(x, in.ptr + idx * in.lane, in.limb);
  if (e < 2 && A.add[e].ptr) {
    uint32_t c[NW];
    load_digits<NW>(c, A.add[e].ptr + idx * A.add[e].lane, A.add[e].limb);
    add_mod<NW>(x, x, c, F);
  }
}

// x^ALPHA = x^(2^K) x^REST with REST 1 or 3: x^5 = x^4 x, x^7 = x^4 x^3,
// x^11 = x^8 x^3. The shared forms' partial rounds fold a mix constant m
// into the last factor, m x^ALPHA = x^(2^K) (m x^REST), so that the S-box's
// last product is one of the row's three.
template <int ALPHA>
struct SboxSplit {
  static constexpr int K = ALPHA >= 16 ? 4 : ALPHA >= 8 ? 3 : ALPHA >= 4 ? 2
                                                                         : 1;
  static constexpr int REST = ALPHA - (1 << K);
  static_assert(REST == 1 || REST == 3, "alpha: 2^K + 1 or 2^K + 3");
};

// The exchange of the shared forms: each thread hands `v` to the threads of
// its state and gets the state's three values, x[k] from thread base + k.
// Two areas of NW words a thread (word j of thread t at j * stride + t),
// used in turn, so that one warp barrier an exchange suffices: a thread
// writes an area again only after the barrier of the exchange between,
// which every thread of the warp reaches after its last read of it.
template <int NW>
struct Exchange {
  uint32_t* area;
  int flip;

  __device__ __forceinline__ void operator()(uint32_t (&x)[3][NW],
                                             const uint32_t (&v)[NW],
                                             const SharedSeat& seat) {
    const int stride = blockDim.x;
    uint32_t* a = area + flip * NW * stride;
    flip ^= 1;
#pragma unroll
    for (int j = 0; j < NW; ++j) a[j * stride + threadIdx.x] = v[j];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < NW; ++j) x[k][j] = a[j * stride + seat.base + k];
  }
};

// A full round's S-box and mix with three threads a state. `s` is this
// thread's element e (its round constant added, in the original flavour);
// `row` points at row e of the round's matrix. Each thread raises its own
// element whole (x^2 .. x^(2^K), beside them x^3 = x^2 x where REST = 3,
// then x^ALPHA), one exchange, and row e is sum_i M[e][i] x_i^ALPHA as one
// `mont_dot3`: K + 2 products deep. Folding M[e][i] into the S-box's last
// product, as the partial rounds do, would make it K + 1 deep but cost a
// thread two more products at x^5 (six at x^7), and a warp alone on its
// sub-partition pays for every multiply-add it issues: the folded round was
// slower at every alpha (`tools/poseidon_times.py` on an H100, 0.1490
// against 0.1423 ms a launch of 64 states at x^5, 0.2350 against 0.1446 at
// 2^12 states at x^7).
template <int NW, int ALPHA>
__device__ __forceinline__ void full_round_shared(uint32_t (&s)[NW],
                                                  const uint32_t* row,
                                                  Exchange<NW>& xch,
                                                  const SharedSeat& seat,
                                                  const FieldConst<NW>& F) {
  using S = SboxSplit<ALPHA>;
  uint32_t x[3][NW], c[3][NW], p[NW];
  mont_mul<NW>(p, s, s, F);
  if constexpr (S::REST == 3) mont_mul<NW>(s, p, s, F);   // s: x^3
#pragma unroll
  for (int k = 1; k < S::K; ++k) mont_mul<NW>(p, p, p, F);
  mont_mul<NW>(s, p, s, F);
  xch(x, s, seat);
#pragma unroll
  for (int i = 0; i < 3; ++i) load_words<NW>(c[i], row + i * NW);
  mont_dot3<NW>(s, x[0], c[0], x[1], c[1], x[2], c[2], F);
}

// A partial round of the sparse schedule with three threads a state; q:
// (k, m00, w1, w2, v1, v2). Every thread raises y = s0 + k itself; then
// thread 0: s0' = y^(2^K) (m00 y^REST) + w1 s1 + w2 s2,
// thread 1: s1' = y^(2^K) (v1 y^REST) + 1 s1 + 0 s2,
// thread 2: s2' = y^(2^K) (v2 y^REST) + 0 s1 + 1 s2,
// each one `mont_dot3`. Threads 1 and 2 read their (1, 0) and (0, 1) from
// `unit` in shared memory (`stage_units`): were they constants the
// compiler could see, it could specialise the dot by element, and the warp
// would run three dots one after another. In sequence: the squarings and
// the dot, K + 1 products deep.
template <int NW, int ALPHA>
__device__ __forceinline__ void partial_round_shared(uint32_t (&s)[NW],
                                                     const uint32_t* q,
                                                     const uint32_t* unit,
                                                     Exchange<NW>& xch,
                                                     const SharedSeat& seat,
                                                     const FieldConst<NW>& F) {
  using S = SboxSplit<ALPHA>;
  uint32_t x[3][NW], y[NW], a[NW], c[NW], w1[NW], w2[NW];
  xch(x, s, seat);
  load_words<NW>(c, q);
  add_mod<NW>(y, x[0], c, F);
  mont_mul<NW>(s, y, y, F);                       // s: the powers of y
  load_words<NW>(c, q + (seat.e == 0 ? 1 : seat.e + 3) * NW);
  mont_mul<NW>(a, y, c, F);
  if constexpr (S::REST == 3) mont_mul<NW>(a, a, s, F);
#pragma unroll
  for (int k = 1; k < S::K; ++k) mont_mul<NW>(s, s, s, F);
  const uint32_t* w = seat.e == 0 ? q + 2 * NW : unit;
  load_words<NW>(w1, w);
  load_words<NW>(w2, w + NW);
  mont_dot3<NW>(s, s, a, x[1], w1, x[2], w2, F);
}

// The permutation with three threads a state, on the lanes form's table
// (`sh`, staged) and schedule: SPARSE, the original flavour's full rounds
// with the partial ones after full round p_begin - 1; else the nil
// flavour's dense rounds, S-box and mix, then the round constant. `s` is
// this thread's element e, in and out. Every thread of a warp runs it (the
// exchanges are warp barriers), on the same instructions.
template <int NW, int ALPHA, bool SPARSE>
__device__ void permute_shared(uint32_t (&s)[NW], const SharedSeat& seat,
                               Exchange<NW>& xch, const uint32_t* sh,
                               const PoseidonArgs& A,
                               const FieldConst<NW>& F) {
  uint32_t c[NW];
  if constexpr (SPARSE) {
    const int partial = A.p_end - A.p_begin, full = A.rounds - partial;
    const uint32_t* mds = sh + full * 3 * NW + seat.e * 3 * NW;
    const uint32_t* pre = mds + 9 * NW;
    const uint32_t* part = sh + full * 3 * NW + 18 * NW;
    const uint32_t* unit = sh + table_entries(A) * NW +
                           (seat.e == 2 ? 2 : 0) * NW;
#pragma unroll 1
    for (int f = 0; f < full; ++f) {
      load_words<NW>(c, sh + (f * 3 + seat.e) * NW);
      add_mod<NW>(s, s, c, F);
      const bool last_before = f == A.p_begin - 1;
      full_round_shared<NW, ALPHA>(s, last_before ? pre : mds, xch, seat, F);
      if (last_before) {
#pragma unroll 1
        for (int q = 0; q < partial; ++q)
          partial_round_shared<NW, ALPHA>(s, part + q * 6 * NW, unit, xch,
                                          seat, F);
      }
    }
  } else {
    const uint32_t* mds = sh + A.rounds * 3 * NW + seat.e * 3 * NW;
#pragma unroll 1
    for (int r = 0; r < A.rounds; ++r) {
      full_round_shared<NW, ALPHA>(s, mds, xch, seat, F);
      load_words<NW>(c, sh + (r * 3 + seat.e) * NW);
      add_mod<NW>(s, s, c, F);
    }
  }
}

// After the table, the shared forms' unit rows: (1, 0) for thread 1 and
// (0, 1) for thread 2 of a partial round (1 is R mod p, the Montgomery
// form); returns the exchange areas after them.
template <int NW>
__device__ __forceinline__ uint32_t* stage_units(uint32_t* unit,
                                                 const FieldConst<NW>& F) {
#pragma unroll 1
  for (int i = threadIdx.x; i < 4 * NW; i += blockDim.x)
    unit[i] = i < NW || i >= 3 * NW ? F.one[i % NW] : 0u;
  return unit + 4 * NW;
}

// Dynamic shared memory: the table, the unit rows, then two exchange areas
// of NW words a thread.
template <int NW, int ALPHA, bool SPARSE>
__global__ void __launch_bounds__(ZK_SHARED_THREADS)
poseidon_shared_kernel(FieldConst<NW> F, PoseidonArgs A,
                       const uint32_t* __restrict__ consts,
                       int32_t* __restrict__ out, long long n) {
  extern __shared__ uint32_t sh[];
  uint32_t* area = stage_units<NW>(stage_table<NW>(sh, consts, A), F);
  Exchange<NW> xch{area, 0};
  __syncthreads();
  const SharedSeat seat = shared_seat();
  const long long idx =
      (long long)blockIdx.x * (ZK_SHARED_THREADS / 32) * (ZK_GROUP_LANES / 3)
      + seat.grp;
  // whole warps past n leave; in a warp that stays every lane runs on
  const long long warp0 = idx - (threadIdx.x & 31) / 3;
  if (warp0 >= n) return;
  uint32_t s[NW];
  load_element<NW>(s, A, seat.e, seat.idle ? n : idx, n, F);
  permute_shared<NW, ALPHA, SPARSE>(s, seat, xch, sh, A, F);
  if (seat.idle || idx >= n) return;
  if (A.lanes_out == 1) {
    if (seat.e == 0) store_digits<NW>(out + idx, n, s);
  } else {
    store_digits<NW>(out + seat.e * n + idx, 3 * n, s);
  }
}

struct TreeOuts {
  int32_t* level[ZK_TREE_LEVELS];
};

// One block. Level 0 hashes the S states given by A (a level's even and
// odd digests, element 0 out) into outs.level[0] ((NL, S)); level l > 0
// hashes the pairs of level l-1 into outs.level[l] ((NL, S >> l)), down to
// one digest. A barrier separates the levels; a warp with no state in a
// level skips it. Dynamic shared memory as the shared form's.
template <int NW, int ALPHA, bool SPARSE>
__global__ void __launch_bounds__(ZK_TREE_THREADS)
poseidon_tree_kernel(FieldConst<NW> F, PoseidonArgs A,
                     const uint32_t* __restrict__ consts, TreeOuts outs,
                     int S, int levels) {
  extern __shared__ uint32_t sh[];
  uint32_t* area = stage_units<NW>(stage_table<NW>(sh, consts, A), F);
  Exchange<NW> xch{area, 0};
  __syncthreads();
  const SharedSeat seat = shared_seat();
  const int warp_state0 = (threadIdx.x >> 5) * (ZK_GROUP_LANES / 3);
  for (int l = 0; l < levels; ++l) {
    const int n = S >> l;
    if (l > 0) {
      const int32_t* prev = outs.level[l - 1];
      A.in[0] = PoseidonPlane{prev, 2, 2LL * n};
      A.in[1] = PoseidonPlane{prev + 1, 2, 2LL * n};
    }
    if (warp_state0 < n) {
      uint32_t s[NW];
      load_element<NW>(s, A, seat.e, seat.idle ? n : seat.grp, n, F);
      permute_shared<NW, ALPHA, SPARSE>(s, seat, xch, sh, A, F);
      if (!seat.idle && seat.e == 0 && seat.grp < n)
        store_digits<NW>(outs.level[l] + seat.grp, n, s);
    }
    __syncthreads();
  }
}

// The instances of every form, (words, alpha, sparse): the parameter sets
// of `ops/poseidon.py` (original flavour, sparse partial rounds) over the
// fields with a kernel instance, bls12-381 Fr, alt_bn128, Pallas and Vesta
// (8 words, x^5), bls12-381 Fq (12, x^5), MNT4 and MNT6 Fr (10, x^5 and
// x^11) and Goldilocks (2, x^7), and the nil flavour of
// `ops/nil_poseidon.py` (Pallas Fq, 8 words, x^7, dense). Each instance is
// a few thousand unrolled instructions, and every one adds to the build,
// so no other is compiled; another schedule is refused.
#define ZK_POSEIDON_INSTANCES(X) \
  X(2, 7, true) X(8, 5, true) X(8, 7, false) X(10, 5, true) X(10, 11, true) \
  X(12, 5, true)

template <int W, int AL, bool SP>
struct PoseidonInstance {
  static constexpr int NW = W, ALPHA = AL;
  static constexpr bool SPARSE = SP;
};

// Calls launch(PoseidonInstance<...>{}) for the instance of (nw, A), or
// refuses. The sparse schedule needs a full round before the partial ones,
// and one after them where there are any; the dense one has no partial
// rounds.
template <class Launch>
static int dispatch_instance(int nw, const PoseidonArgs& A, Launch&& launch) {
  const bool sparse = A.rc_first != 0;
  if (sparse ? (A.p_begin < 1 || A.p_end < A.p_begin || A.p_end > A.rounds ||
                (A.p_end == A.rounds && A.p_end > A.p_begin))
             : A.p_begin != A.p_end)
    return (int)cudaErrorInvalidValue;
#define ZK_POSEIDON_CASE(W, AL, SP)                \
  if (nw == W && A.alpha == AL && sparse == SP)    \
    return launch(PoseidonInstance<W, AL, SP>{});
  ZK_POSEIDON_INSTANCES(ZK_POSEIDON_CASE)
#undef ZK_POSEIDON_CASE
  return (int)cudaErrorInvalidValue;
}

template <int NW, int ALPHA, bool SPARSE>
static int launch_lanes(const uint32_t* fconsts, const PoseidonArgs& A,
                        const void* consts, void* out, long long n,
                        cudaStream_t stream) {
  const size_t smem = (size_t)table_entries(A) * NW * sizeof(uint32_t);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  poseidon_kernel<NW, ALPHA, SPARSE><<<(unsigned)blocks, threads, smem,
                                       stream>>>(
      make_const<NW>(fconsts), A, (const uint32_t*)consts, (int32_t*)out, n);
  return (int)cudaGetLastError();
}

// The shared forms' dynamic shared memory: the table, the unit rows and
// two exchange areas for `threads` threads.
template <int NW>
static size_t shared_smem(const PoseidonArgs& A, int threads) {
  return ((size_t)table_entries(A) + 4 + 2 * (size_t)threads) * NW *
         sizeof(uint32_t);
}

template <int NW, int ALPHA, bool SPARSE>
static int launch_shared(const uint32_t* fconsts, const PoseidonArgs& A,
                         const void* consts, void* out, long long n,
                         cudaStream_t stream) {
  const size_t smem = shared_smem<NW>(A, ZK_SHARED_THREADS);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long per_block = (ZK_SHARED_THREADS / 32) * (ZK_GROUP_LANES / 3);
  const long long blocks = (n + per_block - 1) / per_block;
  poseidon_shared_kernel<NW, ALPHA, SPARSE><<<(unsigned)blocks,
                                              ZK_SHARED_THREADS, smem,
                                              stream>>>(
      make_const<NW>(fconsts), A, (const uint32_t*)consts, (int32_t*)out, n);
  return (int)cudaGetLastError();
}

static bool read_args(PoseidonArgs& A, const void* const* ptrs,
                      const long long* strides, const int* sched) {
  for (int i = 0; i < 5; ++i) {
    PoseidonPlane& pl = i < 3 ? A.in[i] : A.add[i - 3];
    pl.ptr = (const int32_t*)ptrs[i];
    pl.lane = strides[2 * i];
    pl.limb = strides[2 * i + 1];
  }
  A.rounds = sched[0];
  A.p_begin = sched[1];
  A.p_end = sched[2];
  A.alpha = sched[3];
  A.rc_first = sched[4];
  A.lanes_out = sched[5];
  return A.rounds >= 1 && A.rounds <= 1024 && A.alpha >= 2 &&
         A.alpha <= 255 && (A.lanes_out == 1 || A.lanes_out == 3);
}

// ptrs: the five plane pointers {in0, in1, in2, add0, add1}, null where
// absent; strides: {lane, limb} for each of the five, in int32s; sched:
// {rounds, p_begin, p_end, alpha, rc_first, lanes_out}; consts: the table
// every form reads (`ops/hopper_hash.py::_table_words`); form: 0 one
// thread a state, 1 three threads a state.
extern "C" int zk_poseidon_permute(int nw, const uint32_t* fconsts,
                                   const void* const* ptrs,
                                   const long long* strides, const int* sched,
                                   const void* consts, void* out, long long n,
                                   int form, void* stream) {
  PoseidonArgs A;
  if (n < 1 || !read_args(A, ptrs, strides, sched) || form < 0 || form > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return dispatch_instance(nw, A, [&](auto I) {
    using In = decltype(I);
    return form == 0
        ? launch_lanes<In::NW, In::ALPHA, In::SPARSE>(fconsts, A, consts, out,
                                                      n, st)
        : launch_shared<In::NW, In::ALPHA, In::SPARSE>(fconsts, A, consts,
                                                       out, n, st);
  });
}

template <int NW, int ALPHA, bool SPARSE>
static int launch_tree(const uint32_t* fconsts, const PoseidonArgs& A,
                       const void* consts, const TreeOuts& outs, int S,
                       int levels, cudaStream_t stream) {
  const int warps = (S + ZK_GROUP_LANES / 3 - 1) / (ZK_GROUP_LANES / 3);
  const size_t smem = shared_smem<NW>(A, 32 * warps);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  poseidon_tree_kernel<NW, ALPHA, SPARSE><<<1, 32 * warps, smem, stream>>>(
      make_const<NW>(fconsts), A, (const uint32_t*)consts, outs, S, levels);
  return (int)cudaGetLastError();
}

// ptrs, strides, sched, consts as for zk_poseidon_permute, with in2, add0
// and add1 null and lanes_out 1: level 0's even and odd digests. outs:
// `levels` pointers, level l a contiguous (NL, S >> l) plane; S a power of
// two of at most ZK_TREE_MAX, levels = log2(S) + 1.
extern "C" int zk_poseidon_tree(int nw, const uint32_t* fconsts,
                                const void* const* ptrs,
                                const long long* strides, const int* sched,
                                const void* consts, void* const* outs, int S,
                                int levels, void* stream) {
  PoseidonArgs A;
  if (!read_args(A, ptrs, strides, sched) || S < 1 || S > ZK_TREE_MAX ||
      (S & (S - 1)) != 0 || (1 << (levels - 1)) != S || A.lanes_out != 1 ||
      A.in[2].ptr || A.add[0].ptr || A.add[1].ptr)
    return (int)cudaErrorInvalidValue;
  TreeOuts O;
  for (int l = 0; l < ZK_TREE_LEVELS; ++l)
    O.level[l] = l < levels ? (int32_t*)outs[l] : nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  return dispatch_instance(nw, A, [&](auto I) {
    using In = decltype(I);
    return launch_tree<In::NW, In::ALPHA, In::SPARSE>(fconsts, A, consts, O,
                                                      S, levels, st);
  });
}
