// Kernel 4: the three-way product a * b * c with c broadcast over the scan
// axis.
//
// Replaces the Pallas kernel `_mul3_kernel` (ops/pallas_msm.py) of the JAX
// package: it turns the prefix and suffix products of kernel 3 and the
// per-chunk inverse term into every element's inverse. One thread per
// element, two Montgomery products.
//
// Layout: a, b, out are (NL, K, C), c is (NL, C); element (k, c) at k*C + c,
// so every load and store is unit-stride across a warp.
//
// Bound: two reads, one write (12*NL bytes per element) and the read of c
// against 2*NW*(2*NW+1) multiply-adds per element. By the H100's published
// peaks the bytes are the limit.
#include "field.cuh"

template <int NW>
__global__ void __launch_bounds__(128)
mul3_kernel(FieldConst<NW> F, const int32_t* __restrict__ a,
            const int32_t* __restrict__ b, const int32_t* __restrict__ c,
            int32_t* __restrict__ out, long long n, long long C) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  uint32_t x[NW], y[NW], z[NW], r[NW];
  load_digits<NW>(x, a + idx, n);
  load_digits<NW>(y, b + idx, n);
  load_digits<NW>(z, c + idx % C, C);
  mont_mul<NW>(r, x, y, F);
  mont_mul<NW>(x, r, z, F);
  store_digits<NW>(out + idx, n, x);
}

template <int NW>
static int launch_mul3(const uint32_t* consts, const void* a, const void* b,
                       const void* c, void* out, int K, long long C,
                       cudaStream_t stream) {
  long long n = (long long)K * C;
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  mul3_kernel<NW><<<(unsigned)blocks, threads, 0, stream>>>(
      make_const<NW>(consts), (const int32_t*)a, (const int32_t*)b,
      (const int32_t*)c, (int32_t*)out, n, C);
  return (int)cudaGetLastError();
}

extern "C" int zk_mul3(int nw, const uint32_t* consts, const void* a,
                       const void* b, const void* c, void* out, int K,
                       long long C, void* stream) {
  if (K < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  ZK_DISPATCH_NW(nw, return launch_mul3<NW>(consts, a, b, c, out, K, C, st));
  return 0;
}
