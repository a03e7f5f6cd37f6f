// The Gaussian head's sampler that K1 and K2 share on both routes (the chain
// in tc_chain.cu, the wide route in wide_chain.cu): the bounded log-variance,
// Philox4x32-10, 24-bit uniforms and Box-Muller as
// mbrl_tpu/ops/pallas_kernels.py:201-207 and :367-373.
#pragma once
#include <stdint.h>

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// logvar soft double-bounding (reference gaussian_mlp.py:150-154)
__device__ __forceinline__ float bound_logvar(float lv, float max_lv, float min_lv) {
  lv = max_lv - softplus(max_lv - lv);
  return min_lv + softplus(lv - min_lv);
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// standard normal from one Philox block: 24-bit uniforms, u1 in (0, 1]
// (log-safe), u2 in [0, 1), Box-Muller cosine branch
__device__ __forceinline__ float box_muller(uint4 bits) {
  const float u1 = (static_cast<float>(bits.x >> 8) + 1.0f) * 5.9604644775390625e-08f;
  const float u2 = static_cast<float>(bits.y >> 8) * 5.9604644775390625e-08f;
  return sqrtf(-2.0f * logf(u1)) * cosf(6.283185307179586f * u2);
}

// One Gaussian-head output: the mean, or mean + exp(logvar / 2) * N(0, 1)
// with the normal drawn from Philox at counter `ctr`.
__device__ __forceinline__ float head_draw(float mean, float raw_lv, float max_lv, float min_lv,
                                           bool sample, uint4 ctr, uint2 key) {
  if (!sample) return mean;
  const float lv = bound_logvar(raw_lv, max_lv, min_lv);
  return mean + expf(0.5f * lv) * box_muller(philox4x32_10(ctr, key));
}
