// The device helpers one CD-k step shares between its two routes: the
// cluster route (cd_cluster.cuh) and the global route (cd_grid.cuh), each
// run by the single-device run (cd_gibbs.cu, kernel #1) and the
// data-parallel statistics step (cd_gibbs_dp.cu, kernel #2), so that the
// four compute the same expressions and a data-parallel run at world size 1
// computes what the single-device run computes, bit for bit.
//
// Random numbers come from Philox4x32-10 in the kernel: key (seed, flat
// step), counter (col / 4, row0 + row, stream, 0), word col % 4, uniform =
// top 24 bits * 2^-24, where row0 is the global row of the step's first
// local row (0 on one device). Streams: 0 = h_pos; for sweep s, 1 + 3s = v
// (or the first Box-Muller uniform), 2 + 3s = the second Box-Muller
// uniform, 3 + 3s = h. ku_torch/core/rng.py::philox_uniforms draws the
// same numbers in torch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cd {

constexpr int kBernoulli = 0;
constexpr int kGaussian = 1;
constexpr int kComplex = 2;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float uniform_at(uint32_t seed, uint32_t row0,
                                            uint32_t t, uint32_t stream,
                                            uint32_t row, uint32_t col) {
  const uint4 r = philox4x32_10(make_uint4(col >> 2, row0 + row, stream, 0u),
                                seed, t);
  const uint32_t q = col & 3u;
  const uint32_t bits = q == 0 ? r.x : q == 1 ? r.y : q == 2 ? r.z : r.w;
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

// p + lr * d: the update both kernels apply to a parameter, so that the
// single-device run and a data-parallel run of one rank give the same bits.
__device__ __forceinline__ float sgd(float p, float lr, float d) {
  return fmaf(lr, d, p);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float softplus(float x) {
  return x > 30.0f ? x : log1pf(expf(fminf(x, 30.0f)));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace cd
