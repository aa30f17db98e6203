// Kernel 3: the batched inversion's chunk scans, and its one-launch tail.
//
// Replaces the Pallas kernel `_inv_scan_kernel` (ops/pallas_msm.py) of the
// JAX package. Two entries:
//
// zk_inv_scans: for each chunk of K elements, the exclusive prefix products
// f, the exclusive suffix products g and the chunk total.
//
//   Layout, stated by this port: x, f, g are (NL, K, C) and tot is (NL, C),
//   the chunk axis C innermost. Element k of chunk c sits at k*C + c.
//
//   Bound: one read of x and one write each of f and g (12*NL bytes per
//   element); the products (two per element at the least, three here) take
//   about as long on the integer pipes as those three sweeps, so both have
//   to be kept busy at once. One thread per chunk cannot do that: it has C
//   threads in all, each a chain of 2K dependent products with a trip to
//   device memory inside every step. So:
//   - a block takes 32 neighbouring chunks and T threads share each chunk
//     (warp s of the block owns elements [s*L, (s+1)*L) of its 32 chunks,
//     L = ceil(K/T)), which makes T*C threads and keeps every load and store
//     a full 128-byte line per digit plane;
//   - x is read from device memory once: each thread fuses its own L
//     elements to words and parks them in shared memory (it is the only
//     reader of what it parks, so no barrier is needed for them). That pass
//     is loads only, all independent of one another. Asynchronous copies
//     (cp.async, TMA) are not used: a digit pair has to pass through
//     registers to be fused, and with three blocks resident on an SM one
//     block's loads already overlap another's products;
//   - each thread multiplies its segment up, the T segment totals of a chunk
//     are exchanged through shared memory (one barrier: the T owners of a
//     chunk sit in T different warps), and the forward walk then starts from
//     the product of the segments before, the backward walk from the product
//     of those after. Both walks run in one loop, two independent chains.
//
// zk_inv_tail: every element's inverse for a batch of at most
// ZK_INV_TAIL_MAX elements, the whole of Montgomery's trick in one launch of
// one block: a product tree built upwards in shared memory, x^(p-2) of the
// root by a 4-bit fixed-window ladder in one thread, and the inverses
// pushed back down (a node's children get inv(parent) * sibling). It is
// bound by latency, not by a rate: about 2*log2(S) + 330 products follow one
// another and nothing else can run meanwhile.
#include "field.cuh"

#define ZK_SCAN_TILE 32         // chunks a block takes
#define ZK_SCAN_MAX_T 8         // threads that share a chunk, at most
#define ZK_INV_TAIL_MAX 1024    // elements the tail takes, at most
#define ZK_INV_TAIL_THREADS 512

template <int NW>
__device__ __forceinline__ void copy_words(uint32_t (&d)[NW],
                                           const uint32_t (&s)[NW]) {
#pragma unroll
  for (int j = 0; j < NW; ++j) d[j] = s[j];
}

// Shared-memory element `slot` of a word-major array with `stride` slots.
template <int NW>
__device__ __forceinline__ void sh_load(uint32_t (&w)[NW], const uint32_t* sh,
                                        int stride, int slot) {
#pragma unroll
  for (int j = 0; j < NW; ++j) w[j] = sh[j * stride + slot];
}

template <int NW>
__device__ __forceinline__ void sh_store(uint32_t* sh, int stride, int slot,
                                         const uint32_t (&w)[NW]) {
#pragma unroll
  for (int j = 0; j < NW; ++j) sh[j * stride + slot] = w[j];
}

template <int NW>
__device__ __forceinline__ void mul_into(uint32_t (&acc)[NW],
                                         const uint32_t (&v)[NW],
                                         const FieldConst<NW>& F) {
  uint32_t r[NW];
  mont_mul<NW>(r, acc, v, F);
  copy_words<NW>(acc, r);
}

// blockDim.x = 32 * T. Dynamic shared memory: NW * (K + T) * 32 words.
template <int NW>
__global__ void __launch_bounds__(32 * ZK_SCAN_MAX_T)
inv_scans_kernel(FieldConst<NW> F, const int32_t* __restrict__ x,
                 int32_t* __restrict__ f, int32_t* __restrict__ g,
                 int32_t* __restrict__ tot, int K, long long C) {
  extern __shared__ uint32_t sh[];
  const int lane = threadIdx.x & 31;
  const int seg = threadIdx.x >> 5;
  const int T = blockDim.x >> 5;
  const int xs = K * ZK_SCAN_TILE;          // slots of the x tile
  const int ts = T * ZK_SCAN_TILE;          // slots of the segment totals
  uint32_t* totals = sh + NW * xs;
  const long long c = (long long)blockIdx.x * ZK_SCAN_TILE + lane;
  const bool live = c < C;
  const long long limb = (long long)K * C;
  const int len = (K + T - 1) / T;
  const int k0 = min(seg * len, K);
  const int k1 = min(k0 + len, K);

  // pass 1: device memory -> words in shared memory, loads only
  if (live) {
    for (int k = k0; k < k1; ++k) {
      uint32_t v[NW];
      load_digits<NW>(v, x + (long long)k * C + c, limb);
      sh_store<NW>(sh, xs, k * ZK_SCAN_TILE + lane, v);
    }
  }
  // pass 2: the segment's product
  uint32_t acc[NW], v[NW];
  copy_words<NW>(acc, F.one);
  if (live) {
    for (int k = k0; k < k1; ++k) {
      sh_load<NW>(v, sh, xs, k * ZK_SCAN_TILE + lane);
      if (k == k0) copy_words<NW>(acc, v);
      else mul_into<NW>(acc, v, F);
    }
  }
  sh_store<NW>(totals, ts, seg * ZK_SCAN_TILE + lane, acc);
  __syncthreads();
  if (!live) return;

  // products of the segments before and after this one
  uint32_t fw[NW], bw[NW];
  copy_words<NW>(fw, F.one);
  copy_words<NW>(bw, F.one);
  for (int s = 0; s < T; ++s) {
    if (s == seg) continue;
    sh_load<NW>(v, totals, ts, s * ZK_SCAN_TILE + lane);
    if (s < seg) mul_into<NW>(fw, v, F);
    else mul_into<NW>(bw, v, F);
  }

  // pass 3: both walks, element k0+i forwards and k1-1-i backwards
  for (int i = 0; i < k1 - k0; ++i) {
    const int kf = k0 + i, kb = k1 - 1 - i;
    store_digits<NW>(f + (long long)kf * C + c, limb, fw);
    store_digits<NW>(g + (long long)kb * C + c, limb, bw);
    sh_load<NW>(v, sh, xs, kf * ZK_SCAN_TILE + lane);
    mul_into<NW>(fw, v, F);
    sh_load<NW>(v, sh, xs, kb * ZK_SCAN_TILE + lane);
    mul_into<NW>(bw, v, F);
  }
  // the last segment's forward product is the chunk total (an empty last
  // segment still holds the product of all segments before it)
  if (seg == T - 1) store_digits<NW>(tot + c, C, fw);
}

template <int NW>
static int launch_inv_scans(const uint32_t* consts, const void* x, void* f,
                            void* g, void* tot, int K, long long C, int T,
                            cudaStream_t stream) {
  const size_t smem_max = 200 * 1024;
  size_t smem = (size_t)NW * (K + T) * ZK_SCAN_TILE * sizeof(uint32_t);
  if (smem > smem_max) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;   // once per instance, not per launch
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        inv_scans_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_max);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  long long blocks = (C + ZK_SCAN_TILE - 1) / ZK_SCAN_TILE;
  inv_scans_kernel<NW><<<(unsigned)blocks, 32 * T, smem, stream>>>(
      make_const<NW>(consts), (const int32_t*)x, (int32_t*)f, (int32_t*)g,
      (int32_t*)tot, K, C);
  return (int)cudaGetLastError();
}

// T: threads that share a chunk, 1 <= T <= ZK_SCAN_MAX_T.
extern "C" int zk_inv_scans(int nw, const uint32_t* consts, const void* x,
                            void* f, void* g, void* tot, int K, long long C,
                            int T, void* stream) {
  if (K < 1 || C < 1 || T < 1 || T > ZK_SCAN_MAX_T)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  ZK_DISPATCH_NW(nw, return launch_inv_scans<NW>(consts, x, f, g, tot, K, C,
                                                 T, st));
  return 0;
}

// ---------------------------------------------------------------------------
// the tail
// ---------------------------------------------------------------------------

// r = x^(p-2): 4-bit fixed windows from the top, the table x^0..x^15 in
// shared memory (`table`, 16 slots). One thread runs it.
template <int NW>
__device__ void fermat_inverse(uint32_t (&r)[NW], const uint32_t (&x)[NW],
                               uint32_t* table, const FieldConst<NW>& F) {
  uint32_t e[NW];              // p - 2
  uint32_t borrow = 2;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)F.p[j] - borrow;
    e[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  uint32_t acc[NW], v[NW];
  copy_words<NW>(acc, F.one);
  sh_store<NW>(table, 16, 0, acc);
#pragma unroll 1
  for (int i = 1; i < 16; ++i) {
    mul_into<NW>(acc, x, F);
    sh_store<NW>(table, 16, i, acc);
  }
  bool started = false;
#pragma unroll 1
  for (int j = NW - 1; j >= 0; --j) {
#pragma unroll 1
    for (int sft = 28; sft >= 0; sft -= 4) {
      const int d = (int)((e[j] >> sft) & 15u);
      if (started) {
#pragma unroll 1
        for (int q = 0; q < 4; ++q) mul_into<NW>(acc, acc, F);
        if (d != 0) {
          sh_load<NW>(v, table, 16, d);
          mul_into<NW>(acc, v, F);
        }
      } else if (d != 0) {
        sh_load<NW>(acc, table, 16, d);
        started = true;
      }
    }
  }
  copy_words<NW>(r, acc);
}

// One block. Heap-ordered product tree over SP = 2^log_sp >= S leaves (node
// 1 is the root, node n has children 2n and 2n+1, leaf i is node SP + i;
// leaves beyond S hold one). Dynamic shared memory: NW * (2*SP + 16) words.
template <int NW>
__global__ void __launch_bounds__(ZK_INV_TAIL_THREADS)
inv_tail_kernel(FieldConst<NW> F, const int32_t* __restrict__ x,
                int32_t* __restrict__ out, int S, int log_sp) {
  extern __shared__ uint32_t sh[];
  const int SP = 1 << log_sp;
  const int ns = 2 * SP;                     // slots of the tree
  uint32_t* table = sh + NW * ns;
  uint32_t a[NW], b[NW], r[NW];

  for (int i = threadIdx.x; i < SP; i += blockDim.x) {
    if (i < S) load_digits<NW>(a, x + i, S);
    else copy_words<NW>(a, F.one);
    sh_store<NW>(sh, ns, SP + i, a);
  }
  __syncthreads();
  for (int n = SP >> 1; n >= 1; n >>= 1) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      sh_load<NW>(a, sh, ns, 2 * (n + i));
      sh_load<NW>(b, sh, ns, 2 * (n + i) + 1);
      mont_mul<NW>(r, a, b, F);
      sh_store<NW>(sh, ns, n + i, r);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    sh_load<NW>(a, sh, ns, 1);
    fermat_inverse<NW>(r, a, table, F);
    sh_store<NW>(sh, ns, 1, r);
  }
  __syncthreads();
  for (int n = 1; n < SP; n <<= 1) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      uint32_t inv[NW];
      sh_load<NW>(inv, sh, ns, n + i);
      sh_load<NW>(a, sh, ns, 2 * (n + i));
      sh_load<NW>(b, sh, ns, 2 * (n + i) + 1);
      mont_mul<NW>(r, inv, b, F);
      sh_store<NW>(sh, ns, 2 * (n + i), r);
      mont_mul<NW>(r, inv, a, F);
      sh_store<NW>(sh, ns, 2 * (n + i) + 1, r);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    sh_load<NW>(a, sh, ns, SP + i);
    store_digits<NW>(out + i, S, a);
  }
}

template <int NW>
static int launch_inv_tail(const uint32_t* consts, const void* x, void* out,
                           int S, cudaStream_t stream) {
  int log_sp = 0;
  while ((1 << log_sp) < S) ++log_sp;
  const size_t smem_max =
      (size_t)NW * (2 * ZK_INV_TAIL_MAX + 16) * sizeof(uint32_t);
  size_t smem = (size_t)NW * (2 * (1 << log_sp) + 16) * sizeof(uint32_t);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        inv_tail_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_max);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  inv_tail_kernel<NW><<<1, ZK_INV_TAIL_THREADS, smem, stream>>>(
      make_const<NW>(consts), (const int32_t*)x, (int32_t*)out, S, log_sp);
  return (int)cudaGetLastError();
}

// x, out: (NL, S) contiguous, every element nonzero, 1 <= S <= 1024.
extern "C" int zk_inv_tail(int nw, const uint32_t* consts, const void* x,
                           void* out, int S, void* stream) {
  if (S < 1 || S > ZK_INV_TAIL_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  ZK_DISPATCH_NW(nw, return launch_inv_tail<NW>(consts, x, out, S, st));
  return 0;
}
