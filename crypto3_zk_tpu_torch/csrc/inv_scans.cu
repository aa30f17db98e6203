// Kernel 3: the two chunk scans of the batched inversion.
//
// Replaces the Pallas kernel `_inv_scan_kernel` (ops/pallas_msm.py) of the
// JAX package. For each chunk of K elements it emits the exclusive prefix
// products f, the exclusive suffix products g and the chunk total. One thread
// owns one chunk and walks it forward, then backward, with the running
// product in registers.
//
// Layout, stated by this port: x, f, g are (NL, K, C) and tot is (NL, C), the
// chunk axis C innermost. Element k of chunk c sits at k*C + c, so at every
// step of the walk neighbouring threads touch neighbouring addresses.
//
// Bound: one read of x and one write each of f and g (12*NL bytes per
// element) against 2*K Montgomery products per chunk. By the H100's
// published peaks the bytes are the limit; the walk is serial in K, so C has
// to be large enough to fill the card.
#include "field.cuh"

template <int NW>
__global__ void __launch_bounds__(128)
inv_scans_kernel(FieldConst<NW> F, const int32_t* __restrict__ x,
                 int32_t* __restrict__ f, int32_t* __restrict__ g,
                 int32_t* __restrict__ tot, int K, long long C) {
  long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const long long limb = (long long)K * C;
  uint32_t acc[NW], v[NW], r[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) acc[j] = F.one[j];
  for (int k = 0; k < K; ++k) {
    long long off = (long long)k * C + c;
    store_digits<NW>(f + off, limb, acc);
    load_digits<NW>(v, x + off, limb);
    mont_mul<NW>(r, acc, v, F);
#pragma unroll
    for (int j = 0; j < NW; ++j) acc[j] = r[j];
  }
  store_digits<NW>(tot + c, C, acc);
#pragma unroll
  for (int j = 0; j < NW; ++j) acc[j] = F.one[j];
  for (int k = K - 1; k >= 0; --k) {
    long long off = (long long)k * C + c;
    store_digits<NW>(g + off, limb, acc);
    load_digits<NW>(v, x + off, limb);
    mont_mul<NW>(r, acc, v, F);
#pragma unroll
    for (int j = 0; j < NW; ++j) acc[j] = r[j];
  }
}

template <int NW>
static int launch_inv_scans(const uint32_t* consts, const void* x, void* f,
                            void* g, void* tot, int K, long long C,
                            cudaStream_t stream) {
  const int threads = 128;
  long long blocks = (C + threads - 1) / threads;
  inv_scans_kernel<NW><<<(unsigned)blocks, threads, 0, stream>>>(
      make_const<NW>(consts), (const int32_t*)x, (int32_t*)f, (int32_t*)g,
      (int32_t*)tot, K, C);
  return (int)cudaGetLastError();
}

extern "C" int zk_inv_scans(int nw, const uint32_t* consts, const void* x,
                            void* f, void* g, void* tot, int K, long long C,
                            void* stream) {
  if (K < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  ZK_DISPATCH_NW(nw, return launch_inv_scans<NW>(consts, x, f, g, tot, K, C,
                                                 st));
  return 0;
}
