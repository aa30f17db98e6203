// Not a kernel of any path: a loop that measures the rate at which the card
// issues the 32-bit multiply-adds with carry that every Montgomery product
// of field.cuh is made of (`mad.lo.cc` / `madc.hi.cc` pairs). The bounds
// `chip_smoke.py` prints take the float32 rate of the data sheet for 32-bit
// operations; this measured rate gives the integer pipes' own bound beside
// it. Each thread runs one carry chain, as a product does; the launch holds
// enough warps on every SM to hide the chain's latency, so the time is the
// issue rate.
#include "field.cuh"

#define ZK_RATE_UNROLL 16

__global__ void __launch_bounds__(256)
imad_loop_kernel(uint32_t* __restrict__ out, int iters) {
  uint32_t lo = threadIdx.x, hi = blockIdx.x;
  const uint32_t a = 0x9E3779B9u ^ threadIdx.x;
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < ZK_RATE_UNROLL; ++k)
      madc_wide_cc(lo, hi, a, 0x85EBCA6Bu + k);
  }
  out[(long long)blockIdx.x * blockDim.x + threadIdx.x] = lo ^ hi;
}

// out: blocks * threads uint32 words. The loop issues
// blocks * threads * iters * 2 * ZK_RATE_UNROLL multiply-add instructions.
extern "C" int zk_imad_rate(void* out, int blocks, int threads, int iters,
                            void* stream) {
  if (blocks < 1 || threads < 32 || threads > 256 || iters < 1)
    return (int)cudaErrorInvalidValue;
  imad_loop_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, iters);
  return (int)cudaGetLastError();
}
