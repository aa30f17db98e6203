// Not a kernel of any path: loops that measure the rates at which the card
// issues integer instructions.
//
// `zk_imad_rate`: the 32-bit multiply-adds with carry that every Montgomery
// product of field.cuh is made of (`mad.lo.cc` / `madc.hi.cc` pairs). The
// bounds `chip_smoke.py` prints take the float32 rate of the data sheet for
// 32-bit operations; this measured rate gives the integer pipes' own bound
// beside it. Each thread runs one carry chain, as a product does; the launch
// holds enough warps on every SM to hide the chain's latency, so the time is
// the issue rate.
//
// `zk_int_rate`: the streams that a split of SHA-256's work between the
// pipes rests on (kernel 7, sha256.cu): mode 0 funnel shifts alone
// (`SHF.R.W`, the ALU pipe), mode 1 `IMAD` and `IMAD.HI` alone, one for one
// (the FMA pipe), mode 2 funnel shifts and `IMAD.HI` interleaved one for
// one; then mode 3 `IMAD` alone, mode 4 `IMAD.HI` alone, mode 5 funnel
// shifts and `IMAD` interleaved, mode 6 `LOP3` alone, mode 7 funnel shifts
// and `LOP3`, mode 8 `LOP3` and `IMAD`, mode 9 `IADD3` alone, mode 10
// `IADD3` and `IMAD`. If two pipes issue side by side, a mixed stream runs
// at about the sum of its parts' rates; if the two share a pipe, at the
// harmonic mean.
// Each thread runs eight values, each step of each reading its neighbour,
// so that no two steps fold into one and seven of eight are independent.
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

#ifdef __CUDACC__
__device__ __forceinline__ uint32_t rate_mad_lo(uint32_t a, uint32_t b,
                                                uint32_t c) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t rate_mad_hi(uint32_t a, uint32_t b,
                                                uint32_t c) {
  uint32_t d;
  asm("mad.hi.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
#else
inline uint32_t rate_mad_lo(uint32_t a, uint32_t b, uint32_t c) {
  return a * b + c;
}
inline uint32_t rate_mad_hi(uint32_t a, uint32_t b, uint32_t c) {
  return __umulhi(a, b) + c;
}
#endif

#define ZK_RATE_VALUES 8

// the instruction of a mode's even (first) and odd steps: 0 SHF, 1 IMAD,
// 2 IMAD.HI, 3 LOP3, 4 IADD3
__host__ __device__ constexpr int rate_op(int mode, bool first) {
  constexpr int kFirst[11] = {0, 1, 0, 1, 2, 0, 3, 0, 3, 4, 4};
  constexpr int kSecond[11] = {0, 2, 2, 1, 2, 1, 3, 3, 1, 4, 1};
  return first ? kFirst[mode] : kSecond[mode];
}

template <int MODE>
__global__ void __launch_bounds__(256)
int_loop_kernel(uint32_t* __restrict__ out, int iters, uint32_t c) {
  uint32_t v[ZK_RATE_VALUES];
#pragma unroll
  for (int j = 0; j < ZK_RATE_VALUES; ++j)
    v[j] = (threadIdx.x + 0x9E3779B9u * (j + 1)) ^ blockIdx.x;
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < ZK_RATE_UNROLL; ++k) {
#pragma unroll
      for (int j = 0; j < ZK_RATE_VALUES; ++j) {
        const uint32_t x = v[j], y = v[(j + 1) % ZK_RATE_VALUES];
        const int op = rate_op(MODE, j % 2 == 0);
        if (op == 0)
          v[j] = __funnelshift_r(x, y, 7);
        else if (op == 1)
          v[j] = rate_mad_lo(x, c, y);
        else if (op == 2)
          v[j] = rate_mad_hi(x, c, y);
        else if (op == 3)
          v[j] = (x & y) ^ (~x & c);
        else
          v[j] = x + y + c;
      }
    }
  }
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < ZK_RATE_VALUES; ++j) acc ^= v[j];
  out[(long long)blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

// mode 0 to 10 as above; out: blocks * threads uint32 words; mul: the
// multiplier (a launch argument, so that no product is by a constant). The
// loop issues blocks * threads * iters * ZK_RATE_UNROLL * 8 instructions of
// the stream.
extern "C" int zk_int_rate(int mode, void* out, int blocks, int threads,
                           int iters, int mul, void* stream) {
  if (blocks < 1 || threads < 32 || threads > 256 || iters < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* o = (uint32_t*)out;
  const uint32_t c = (uint32_t)mul;
  switch (mode) {
    case 0: int_loop_kernel<0><<<blocks, threads, 0, s>>>(o, iters, c); break;
    case 1: int_loop_kernel<1><<<blocks, threads, 0, s>>>(o, iters, c); break;
    case 2: int_loop_kernel<2><<<blocks, threads, 0, s>>>(o, iters, c); break;
    case 3: int_loop_kernel<3><<<blocks, threads, 0, s>>>(o, iters, c); break;
    case 4: int_loop_kernel<4><<<blocks, threads, 0, s>>>(o, iters, c); break;
    case 5: int_loop_kernel<5><<<blocks, threads, 0, s>>>(o, iters, c); break;
    case 6: int_loop_kernel<6><<<blocks, threads, 0, s>>>(o, iters, c); break;
    case 7: int_loop_kernel<7><<<blocks, threads, 0, s>>>(o, iters, c); break;
    case 8: int_loop_kernel<8><<<blocks, threads, 0, s>>>(o, iters, c); break;
    case 9: int_loop_kernel<9><<<blocks, threads, 0, s>>>(o, iters, c); break;
    case 10:
      int_loop_kernel<10><<<blocks, threads, 0, s>>>(o, iters, c);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
