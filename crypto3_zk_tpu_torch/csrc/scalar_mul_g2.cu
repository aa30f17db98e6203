// Kernel 6 for G2 over Fq2 = Fq[u] / (u^2 + 1) of the 8- and
// 12-word fields (alt_bn128, bls12-381): see scalar_mul.cuh.
#include "scalar_mul.cuh"

extern "C" int zk_scalar_mul_g2(int nw, const uint32_t* consts,
                                const void* pts, const void* scalars,
                                long long ns, void* out, long long n,
                                int nbits, void* stream) {
  return scalar_mul_launch<2>(nw, consts, pts, scalars, ns, out, n, nbits,
                               stream);
}

// shape[0..3]: window bits, threads a block, blocks an SM, shared bytes a
// block of the nw-word instance
extern "C" int zk_scalar_mul_g2_shape(int nw, int* shape) {
  return scalar_mul_shape<2>(nw, shape);
}
