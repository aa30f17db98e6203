// Kernel 5: the width-3 Poseidon permutation of a batch of states, one launch
// for the whole permutation.
//
// It has no Pallas counterpart: the JAX package composes the permutation
// from its elementwise field ops (`ops/poseidon.py::permute_batch`,
// `ops/nil_poseidon.py::permute_batch`) and leaves the fusion to XLA.
// Composed the same way here it would be about 1,200 launches a permutation
// (828 products and some 400 additions for 8 full and 57 partial rounds), so
// the rounds run inside one kernel: one thread per state, the three elements
// in registers as NW words each (see field.cuh), the round constants and the
// MDS matrix staged once per block in shared memory.
//
// One entry serves both flavours; the schedule is data:
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
// Bound: 6*NL*4 bytes a state against (rounds*9 + S-box products) Montgomery
// products of NW*(2*NW+1) multiply-adds each: the operations are the limit
// by three orders of magnitude, and they follow one another inside a thread,
// so what counts is enough states in flight to fill the multipliers.
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

template <int NW>
static int launch_poseidon(const uint32_t* fconsts, const PoseidonArgs& A,
                           const void* consts, void* out, long long n,
                           cudaStream_t stream) {
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  size_t smem = (size_t)(A.rounds * 3 + 9) * NW * sizeof(uint32_t);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  poseidon_kernel<NW><<<(unsigned)blocks, threads, smem, stream>>>(
      make_const<NW>(fconsts), A, (const uint32_t*)consts, (int32_t*)out, n);
  return (int)cudaGetLastError();
}

// ptrs: the five plane pointers {in0, in1, in2, add0, add1}, null where
// absent; strides: {lane, limb} for each of the five, in int32s; sched:
// {rounds, p_begin, p_end, alpha, rc_first, lanes_out}.
extern "C" int zk_poseidon_permute(int nw, const uint32_t* fconsts,
                                   const void* const* ptrs,
                                   const long long* strides, const int* sched,
                                   const void* consts, void* out, long long n,
                                   void* stream) {
  PoseidonArgs A;
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
  if (n < 1 || A.rounds < 1 || A.rounds > 1024 || A.alpha < 2 ||
      A.alpha > 255 || (A.lanes_out != 1 && A.lanes_out != 3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  ZK_DISPATCH_NW(nw, return launch_poseidon<NW>(fconsts, A, consts, out, n, st));
  return 0;
}
