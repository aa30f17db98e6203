// Kernel 2: batched radix-2 NTTs of length B over M rows, every stage in
// shared memory.
//
// Replaces the Pallas kernel `_ntt_rows_kernel` (ops/pallas_field.py) of the
// JAX package. One block transforms one row: it loads the row bit-reversed
// into shared memory as 32-bit words (word-major, so neighbouring threads
// touch neighbouring banks), runs the log B decimation-in-time stages with a
// barrier between them, and writes the row back in natural order. Stage
// twiddles are read from the plain table w^j, j < B/2, with stride B/m; no
// per-stage tiling is needed.
//
// Bound: one read and one write of the row (8*NL bytes per element) against
// (B/2)*log B butterflies per row, each one Montgomery product
// (NW*(2*NW+1) multiply-adds) plus an add and a subtract. By the H100's
// published peaks the bytes stay the limit up to B = 2^10.
//
// x, out: (NL, M, B) int32 digits, natural order. tw: (NL, B/2).
#include "field.cuh"

template <int NW>
__global__ void ntt_rows_kernel(FieldConst<NW> F,
                                const int32_t* __restrict__ x,
                                const int32_t* __restrict__ tw,
                                int32_t* __restrict__ out, int log_b,
                                long long limb_stride) {
  extern __shared__ uint32_t sh[];  // NW * B words
  const int B = 1 << log_b;
  const int half_b = B >> 1;
  const long long row_off = (long long)blockIdx.x * B;

  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    uint32_t w[NW];
    load_digits<NW>(w, x + row_off + i, limb_stride);
    int r = (int)(__brev((unsigned)i) >> (32 - log_b));
#pragma unroll
    for (int j = 0; j < NW; ++j) sh[j * B + r] = w[j];
  }
  __syncthreads();

  for (int s = 1; s <= log_b; ++s) {
    const int half = 1 << (s - 1);
    for (int t = threadIdx.x; t < half_b; t += blockDim.x) {
      int j = t & (half - 1);
      int i0 = ((t >> (s - 1)) << s) + j;
      int i1 = i0 + half;
      uint32_t e[NW], o[NW], w[NW], m[NW], lo[NW], hi[NW];
      load_digits<NW>(w, tw + ((long long)j << (log_b - s)), half_b);
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        e[k] = sh[k * B + i0];
        o[k] = sh[k * B + i1];
      }
      mont_mul<NW>(m, o, w, F);
      add_mod<NW>(lo, e, m, F);
      sub_mod<NW>(hi, e, m, F);
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        sh[k * B + i0] = lo[k];
        sh[k * B + i1] = hi[k];
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    uint32_t w[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) w[j] = sh[j * B + i];
    store_digits<NW>(out + row_off + i, limb_stride, w);
  }
}

template <int NW>
static int launch_ntt_rows(const uint32_t* consts, const void* x,
                           const void* tw, void* out, long long rows,
                           int log_b, cudaStream_t stream) {
  const int B = 1 << log_b;
  size_t smem = (size_t)NW * B * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      ntt_rows_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = B / 2;
  if (threads < 32) threads = 32;
  if (threads > 256) threads = 256;
  ntt_rows_kernel<NW><<<(unsigned)rows, threads, smem, stream>>>(
      make_const<NW>(consts), (const int32_t*)x, (const int32_t*)tw,
      (int32_t*)out, log_b, rows * B);
  return (int)cudaGetLastError();
}

extern "C" int zk_ntt_rows(int nw, const uint32_t* consts, const void* x,
                           const void* tw, void* out, long long rows,
                           int log_b, void* stream) {
  if (log_b < 1 || log_b > 10 || rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  ZK_DISPATCH_NW(nw, return launch_ntt_rows<NW>(consts, x, tw, out, rows,
                                                log_b, st));
  return 0;
}
