// The per-agent-row symmetric quantizer shared by the compressed-gossip
// kernels (K3 and K9 in quantize.cu, K5 in sparse_mix.cu).  Round half to even
// (rintf) or floor(u + noise), a true division by the scale (never a multiply
// by its reciprocal) and the _rn intrinsics under -fmad=false keep the q grid
// bit-identical to kernels/ref.py:quantize_rows_ref.
#pragma once

#include <stdint.h>

// s_j = max(absmax_j, 1e-12) / qmax
__device__ __forceinline__ float row_scale(const float* absmax, int64_t j, float qmax) {
  return __fdiv_rn(fmaxf(absmax[j], 1e-12f), qmax);
}

// Dequantised wire value q * s of m: round half to even, or
// floor(m / s + u) when stochastic (u uniform in [0, 1)).
__device__ __forceinline__ float quant_value(float m, float s, float qmax, bool stochastic,
                                             float u) {
  const float v = __fdiv_rn(m, s);
  float q = stochastic ? floorf(__fadd_rn(v, u)) : rintf(v);
  q = fminf(fmaxf(q, -qmax), qmax);
  return __fmul_rn(q, s);
}

// The same with the noise (when given) read at the element's own index idx
// (the form K3 and K5 inline into their gather loops).
__device__ __forceinline__ float quant(float m, float s, float qmax, const float* noise,
                                       int64_t idx) {
  const float u = __fdiv_rn(m, s);
  float q = noise ? floorf(__fadd_rn(u, noise[idx])) : rintf(u);
  q = fminf(fmaxf(q, -qmax), qmax);
  return __fmul_rn(q, s);
}
