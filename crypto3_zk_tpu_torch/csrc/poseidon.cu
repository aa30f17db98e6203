// Kernel 5: the width-3 Poseidon permutation of a batch of states, one launch
// for the whole permutation, in three forms.
//
// It has no Pallas counterpart: the JAX package composes the permutation
// from its elementwise field ops (`ops/poseidon.py::permute_batch`,
// `ops/nil_poseidon.py::permute_batch`) and leaves the fusion to XLA.
// Composed the same way here it would be about 1,200 launches a permutation
// (828 products and some 400 additions for 8 full and 57 partial rounds), so
// the rounds run inside one kernel, the round constants and the MDS matrix
// staged once per block in shared memory.
//
// One schedule serves both flavours; it is data:
//   rounds            number of rounds
//   p_begin, p_end    rounds r with p_begin <= r < p_end are partial (the
//                     S-box on element 0 only); the MDS mix is full always
//   alpha             the S-box exponent, raised by square-and-multiply on
//                     its bits (5, 7, 11, 13, 17 all run)
//   rc_first          1: round = add rc -> S-box -> MDS (original Poseidon)
//                     0: round = S-box -> MDS -> add rc (the nil flavour)
// consts: (rounds*3 + 9) elements of NW fused words, Montgomery form: the
// round constants rc[r][i] at r*3 + i, then the matrix M[i][j] at
// rounds*3 + i*3 + j.
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
// What bounds it. A state moves 6*NL*4 bytes for (rounds*9 + S-box
// products) Montgomery products: the operations, by three orders of
// magnitude. Inside one thread every product is one carry chain (the PTX
// carry flag orders every instruction of it, and the next product needs its
// result), so a thread's products follow one another at about 0.44 us each
// at NW = 8 on an H100. Two regimes follow:
// - a large level (tens of thousands of states) fills the card, and the
//   rate of the integer pipes bounds it;
// - a small level is pure latency: the old form, one thread a state, takes
//   828 products in sequence, about 0.36 ms, whether the level has 1 state
//   or 2^14, and a tree of 2^17 leaves has about 15 such levels, one launch
//   each.
// The three forms:
// - `poseidon_kernel` (lanes): one thread a state, all three elements in
//   registers. The fewest products a state (828), so the best where the
//   rate bounds: large levels.
// - `poseidon_shared_kernel` (shared): three threads a state, thread e
//   owning element e. In a full round each applies the S-box to its own
//   element; in a partial round each applies it to element 0 (all three at
//   once, so no thread waits for another); then each computes its own row
//   of the MDS mix from the three S-box outputs, exchanged through shared
//   memory within the warp. That is 6 products in sequence a round, 390 a
//   permutation instead of 828, for about 1.4 times the products in all: the
//   better form where latency bounds, up to the level size where the rate
//   takes over (`SHARED_MAX` in `ops/hopper_hash.py`, by measurement).
// - `poseidon_tree_kernel` (tree): the shared form in ONE block that hashes
//   a Merkle tree's last levels, from at most ZK_TREE_MAX states down to the
//   root, with a barrier between levels. Each level is still one latency of
//   390 products, but one launch replaces one a level, and each level's
//   digests go to their own plane, because proofs read every level.
// Measured on an H100 (`chip_smoke.py`): the one-thread form 0.376 ms on 64
// or 4,096 states and 2.265 ms on 2^17; the shared form 0.189 ms on 64 or
// 4,096 and 2.970 ms on 2^17, where its extra products cost more than its
// shorter chain saves. Past about 1.5 warps an SM sub-partition, the
// multiply-adds of the warps' chains share that sub-partition's integer pipe
// (16.2 T multiply-adds a second measured for the card, about 0.55 warp
// instructions a cycle a sub-partition, against one every 2.8 cycles that a
// chain asks for). A block of 13 warps (128 states) hashed its 8 levels in
// 1.89 ms, not 8 x 0.19: its first level, 3 to 4 warps a sub-partition, ran
// twice as long. So the tree takes at most 64 states (7 warps on one SM,
// 7 levels in 1.40 ms against a latency bound of 1.21), and the level of
// 128 is a launch of the shared form.
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

template <int NW>
__device__ __forceinline__ void load_const(uint32_t (&w)[NW],
                                           const uint32_t* src) {
#pragma unroll
  for (int j = 0; j < NW; ++j) w[j] = src[j];
}

// x <- x^alpha, alpha >= 2, by its bits below the top one
template <int NW>
__device__ __forceinline__ void sbox(uint32_t (&x)[NW], int alpha, int top,
                                     const FieldConst<NW>& F) {
  uint32_t acc[NW], t[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) acc[j] = x[j];
#pragma unroll 1
  for (int b = top - 1; b >= 0; --b) {
    mont_mul<NW>(t, acc, acc, F);
    if ((alpha >> b) & 1) {
      mont_mul<NW>(acc, t, x, F);
    } else {
#pragma unroll
      for (int j = 0; j < NW; ++j) acc[j] = t[j];
    }
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) x[j] = acc[j];
}

template <int NW>
__global__ void __launch_bounds__(128)
poseidon_kernel(FieldConst<NW> F, PoseidonArgs A,
                const uint32_t* __restrict__ consts, int32_t* __restrict__ out,
                long long n) {
  extern __shared__ uint32_t sh[];
  const int total = (A.rounds * 3 + 9) * NW;
  for (int i = threadIdx.x; i < total; i += blockDim.x) sh[i] = consts[i];
  __syncthreads();
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;

  uint32_t s0[NW], s1[NW], s2[NW], c[NW], t[NW];
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

  int top = 0;
  while ((A.alpha >> (top + 1)) != 0) ++top;
  const uint32_t* mds = sh + A.rounds * 3 * NW;

#pragma unroll 1
  for (int r = 0; r < A.rounds; ++r) {
    const uint32_t* rc = sh + r * 3 * NW;
    if (A.rc_first) {
      load_const<NW>(c, rc);
      add_mod<NW>(s0, s0, c, F);
      load_const<NW>(c, rc + NW);
      add_mod<NW>(s1, s1, c, F);
      load_const<NW>(c, rc + 2 * NW);
      add_mod<NW>(s2, s2, c, F);
    }
    sbox<NW>(s0, A.alpha, top, F);
    if (r < A.p_begin || r >= A.p_end) {
      sbox<NW>(s1, A.alpha, top, F);
      sbox<NW>(s2, A.alpha, top, F);
    }
    // the MDS mix: row i is M[i][0]*s0 + M[i][1]*s1 + M[i][2]*s2
    uint32_t m0[NW], m1[NW], m2[NW];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      uint32_t (&m)[NW] = i == 0 ? m0 : (i == 1 ? m1 : m2);
      load_const<NW>(c, mds + (i * 3 + 0) * NW);
      mont_mul<NW>(m, c, s0, F);
      load_const<NW>(c, mds + (i * 3 + 1) * NW);
      mont_mul<NW>(t, c, s1, F);
      add_mod<NW>(m, m, t, F);
      load_const<NW>(c, mds + (i * 3 + 2) * NW);
      mont_mul<NW>(t, c, s2, F);
      add_mod<NW>(m, m, t, F);
    }
    if (A.rc_first) {
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        s0[j] = m0[j];
        s1[j] = m1[j];
        s2[j] = m2[j];
      }
    } else {
      load_const<NW>(c, rc);
      add_mod<NW>(s0, m0, c, F);
      load_const<NW>(c, rc + NW);
      add_mod<NW>(s1, m1, c, F);
      load_const<NW>(c, rc + 2 * NW);
      add_mod<NW>(s2, m2, c, F);
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
#define ZK_TREE_MAX 64           // states at the first level the tree takes
#define ZK_TREE_LEVELS 7         // log2(ZK_TREE_MAX) + 1
#define ZK_TREE_THREADS 224      // 7 warps: 70 states >= ZK_TREE_MAX

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

// The permutation with three threads a state. `s` is this thread's element
// e, in and out; `xch` is the block's exchange area (NW words a thread,
// word j of thread t at j * blockDim.x + t); `sh` the staged constants.
// Every thread of a warp runs it (the exchanges are warp barriers).
template <int NW>
__device__ void permute_shared(uint32_t (&s)[NW], const SharedSeat& seat,
                               uint32_t* xch, const uint32_t* sh,
                               const PoseidonArgs& A, int top,
                               const FieldConst<NW>& F) {
  const int stride = blockDim.x;
  const int tid = threadIdx.x;
  const uint32_t* mds = sh + A.rounds * 3 * NW + seat.e * 3 * NW;
  uint32_t x[NW], c[NW], t[NW], m[NW];
#pragma unroll 1
  for (int r = 0; r < A.rounds; ++r) {
    const uint32_t* rc = sh + (r * 3 + seat.e) * NW;
    if (A.rc_first) {
      load_const<NW>(c, rc);
      add_mod<NW>(s, s, c, F);
    }
    const bool partial = r >= A.p_begin && r < A.p_end;
    if (partial) {           // every thread raises element 0
#pragma unroll
      for (int j = 0; j < NW; ++j) xch[j * stride + tid] = s[j];
      __syncwarp();
#pragma unroll
      for (int j = 0; j < NW; ++j) x[j] = xch[j * stride + seat.base];
      __syncwarp();
    } else {
#pragma unroll
      for (int j = 0; j < NW; ++j) x[j] = s[j];
    }
    sbox<NW>(x, A.alpha, top, F);
    if (partial && seat.e != 0) {
#pragma unroll
      for (int j = 0; j < NW; ++j) x[j] = s[j];
    }
    // row e of the MDS mix over the three S-box outputs
#pragma unroll
    for (int j = 0; j < NW; ++j) xch[j * stride + tid] = x[j];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int j = 0; j < NW; ++j) x[j] = xch[j * stride + seat.base + k];
      load_const<NW>(c, mds + k * NW);
      if (k == 0) {
        mont_mul<NW>(m, c, x, F);
      } else {
        mont_mul<NW>(t, c, x, F);
        add_mod<NW>(m, m, t, F);
      }
    }
    __syncwarp();
    if (A.rc_first) {
#pragma unroll
      for (int j = 0; j < NW; ++j) s[j] = m[j];
    } else {
      load_const<NW>(c, rc);
      add_mod<NW>(s, m, c, F);
    }
  }
}

template <int NW>
__device__ __forceinline__ void stage_consts(uint32_t* sh, const uint32_t* consts,
                                             int rounds) {
  const int total = (rounds * 3 + 9) * NW;
  for (int i = threadIdx.x; i < total; i += blockDim.x) sh[i] = consts[i];
}

__device__ __forceinline__ int sbox_top(int alpha) {
  int top = 0;
  while ((alpha >> (top + 1)) != 0) ++top;
  return top;
}

// Dynamic shared memory: (rounds*3 + 9) * NW words of constants, then NW
// words a thread for the exchange.
template <int NW>
__global__ void __launch_bounds__(ZK_SHARED_THREADS)
poseidon_shared_kernel(FieldConst<NW> F, PoseidonArgs A,
                       const uint32_t* __restrict__ consts,
                       int32_t* __restrict__ out, long long n) {
  extern __shared__ uint32_t sh[];
  stage_consts<NW>(sh, consts, A.rounds);
  uint32_t* xch = sh + (A.rounds * 3 + 9) * NW;
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
  permute_shared<NW>(s, seat, xch, sh, A, sbox_top(A.alpha), F);
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
template <int NW>
__global__ void __launch_bounds__(ZK_TREE_THREADS)
poseidon_tree_kernel(FieldConst<NW> F, PoseidonArgs A,
                     const uint32_t* __restrict__ consts, TreeOuts outs,
                     int S, int levels) {
  extern __shared__ uint32_t sh[];
  stage_consts<NW>(sh, consts, A.rounds);
  uint32_t* xch = sh + (A.rounds * 3 + 9) * NW;
  __syncthreads();
  const SharedSeat seat = shared_seat();
  const int top = sbox_top(A.alpha);
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
      permute_shared<NW>(s, seat, xch, sh, A, top, F);
      if (!seat.idle && seat.e == 0 && seat.grp < n)
        store_digits<NW>(outs.level[l] + seat.grp, n, s);
    }
    __syncthreads();
  }
}

template <int NW>
static int launch_poseidon(const uint32_t* fconsts, const PoseidonArgs& A,
                           const void* consts, void* out, long long n,
                           int form, cudaStream_t stream) {
  size_t smem = (size_t)(A.rounds * 3 + 9) * NW * sizeof(uint32_t);
  if (form == 0) {
    const int threads = 128;
    long long blocks = (n + threads - 1) / threads;
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    poseidon_kernel<NW><<<(unsigned)blocks, threads, smem, stream>>>(
        make_const<NW>(fconsts), A, (const uint32_t*)consts, (int32_t*)out,
        n);
  } else {
    const long long per_block = (ZK_SHARED_THREADS / 32) * (ZK_GROUP_LANES / 3);
    long long blocks = (n + per_block - 1) / per_block;
    smem += (size_t)NW * ZK_SHARED_THREADS * sizeof(uint32_t);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    poseidon_shared_kernel<NW><<<(unsigned)blocks, ZK_SHARED_THREADS, smem,
                                 stream>>>(
        make_const<NW>(fconsts), A, (const uint32_t*)consts, (int32_t*)out,
        n);
  }
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
// {rounds, p_begin, p_end, alpha, rc_first, lanes_out}; form: 0 one thread
// a state, 1 three threads a state.
extern "C" int zk_poseidon_permute(int nw, const uint32_t* fconsts,
                                   const void* const* ptrs,
                                   const long long* strides, const int* sched,
                                   const void* consts, void* out, long long n,
                                   int form, void* stream) {
  PoseidonArgs A;
  if (n < 1 || !read_args(A, ptrs, strides, sched) || form < 0 || form > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  ZK_DISPATCH_NW(nw, return launch_poseidon<NW>(fconsts, A, consts, out, n,
                                                form, st));
  return 0;
}

template <int NW>
static int launch_tree(const uint32_t* fconsts, const PoseidonArgs& A,
                       const void* consts, const TreeOuts& outs, int S,
                       int levels, cudaStream_t stream) {
  size_t smem = (size_t)(A.rounds * 3 + 9) * NW * sizeof(uint32_t) +
                (size_t)NW * ZK_TREE_THREADS * sizeof(uint32_t);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int warps = (S + ZK_GROUP_LANES / 3 - 1) / (ZK_GROUP_LANES / 3);
  poseidon_tree_kernel<NW><<<1, 32 * warps, smem, stream>>>(
      make_const<NW>(fconsts), A, (const uint32_t*)consts, outs, S, levels);
  return (int)cudaGetLastError();
}

// ptrs, strides, sched as for zk_poseidon_permute, with in2, add0 and add1
// null and lanes_out 1: level 0's even and odd digests. outs: `levels`
// pointers, level l a contiguous (NL, S >> l) plane; S a power of two of at
// most ZK_TREE_MAX, levels = log2(S) + 1.
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
  ZK_DISPATCH_NW(nw, return launch_tree<NW>(fconsts, A, consts, O, S, levels,
                                            st));
  return 0;
}
