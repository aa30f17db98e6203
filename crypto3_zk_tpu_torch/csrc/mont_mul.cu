// Kernel 1: elementwise Montgomery multiply over digit planes, plus the
// modular add and subtract that share its loader.
//
// Replaces the Pallas kernel `_mont_mul_kernel` (ops/pallas_field.py) of the
// JAX package. That kernel keeps a 16-bit lazy-carry CIOS in fast memory
// because its target has no wide multiply; here each thread owns one element,
// fuses the digits into 32-bit words and runs a word-level CIOS with 64-bit
// products (see field.cuh).
//
// Bound: 3*NL*4 bytes moved per element against NW*(2*NW+1) 32-bit
// multiply-adds. At NW = 8 that is 192 bytes for 136 multiply-adds: by the
// H100's published peaks (3.35 TB/s, 67 T op/s outside the tensor cores) the
// bytes are the limit, so each operand is read once and coalesced.
//
// Operands broadcast through strides: the batch is viewed as (d0, d1, d2)
// and each operand brings its own element strides (0 on a broadcast axis)
// and limb stride, so a constant of shape (NL, 1) or a transposed view is
// read in place. The output is contiguous (NL, d0*d1*d2).
#include "field.cuh"

enum { OP_MUL = 0, OP_ADD = 1, OP_SUB = 2 };

struct Strides {
  long long s0, s1, s2, limb;
};

template <int NW, int OP>
__global__ void __launch_bounds__(128)
elementwise_kernel(FieldConst<NW> F, const int32_t* __restrict__ a,
                   const int32_t* __restrict__ b, int32_t* __restrict__ out,
                   long long n, long long d1, long long d2, Strides sa,
                   Strides sb) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  long long i2 = idx % d2;
  long long t = idx / d2;
  long long i1 = t % d1;
  long long i0 = t / d1;
  uint32_t x[NW], y[NW], r[NW];
  load_digits<NW>(x, a + i0 * sa.s0 + i1 * sa.s1 + i2 * sa.s2, sa.limb);
  load_digits<NW>(y, b + i0 * sb.s0 + i1 * sb.s1 + i2 * sb.s2, sb.limb);
  if (OP == OP_MUL) mont_mul<NW>(r, x, y, F);
  if (OP == OP_ADD) add_mod<NW>(r, x, y, F);
  if (OP == OP_SUB) sub_mod<NW>(r, x, y, F);
  store_digits<NW>(out + idx, n, r);
}

template <int NW, int OP>
static int launch_elementwise(const uint32_t* consts, const void* a,
                              const void* b, void* out, long long d0,
                              long long d1, long long d2, Strides sa,
                              Strides sb, cudaStream_t stream) {
  long long n = d0 * d1 * d2;
  if (n == 0) return 0;
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  elementwise_kernel<NW, OP><<<(unsigned)blocks, threads, 0, stream>>>(
      make_const<NW>(consts), (const int32_t*)a, (const int32_t*)b,
      (int32_t*)out, n, d1, d2, sa, sb);
  return (int)cudaGetLastError();
}

template <int OP>
static int dispatch(int nw, const uint32_t* consts, const void* a,
                    const void* b, void* out, long long d0, long long d1,
                    long long d2, const long long* sa, const long long* sb,
                    void* stream) {
  Strides A{sa[0], sa[1], sa[2], sa[3]};
  Strides B{sb[0], sb[1], sb[2], sb[3]};
  cudaStream_t st = (cudaStream_t)stream;
  ZK_DISPATCH_NW(nw, return (launch_elementwise<NW, OP>(
                         consts, a, b, out, d0, d1, d2, A, B, st)));
  return 0;
}

// sa, sb: {stride d0, stride d1, stride d2, limb stride} in int32 elements.
extern "C" int zk_mont_mul(int nw, const uint32_t* consts, const void* a,
                           const void* b, void* out, long long d0,
                           long long d1, long long d2, const long long* sa,
                           const long long* sb, void* stream) {
  return dispatch<OP_MUL>(nw, consts, a, b, out, d0, d1, d2, sa, sb, stream);
}

extern "C" int zk_add(int nw, const uint32_t* consts, const void* a,
                      const void* b, void* out, long long d0, long long d1,
                      long long d2, const long long* sa, const long long* sb,
                      void* stream) {
  return dispatch<OP_ADD>(nw, consts, a, b, out, d0, d1, d2, sa, sb, stream);
}

extern "C" int zk_sub(int nw, const uint32_t* consts, const void* a,
                      const void* b, void* out, long long d0, long long d1,
                      long long d2, const long long* sa, const long long* sb,
                      void* stream) {
  return dispatch<OP_SUB>(nw, consts, a, b, out, d0, d1, d2, sa, sb, stream);
}
