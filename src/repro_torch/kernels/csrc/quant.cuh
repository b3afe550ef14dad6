// The per-agent-row symmetric quantizer shared by the compressed-gossip
// kernels (K3 in quantize.cu, K5 in sparse_mix.cu).  Round half to even
// (rintf) or floor(u + noise), a true division by the scale (never a multiply
// by its reciprocal) and the _rn intrinsics under -fmad=false keep the q grid
// bit-identical to kernels/ref.py:quantize_rows_ref.
#pragma once

#include <stdint.h>

// s_j = max(absmax_j, 1e-12) / qmax
__device__ __forceinline__ float row_scale(const float* absmax, int64_t j, float qmax) {
  return __fdiv_rn(fmaxf(absmax[j], 1e-12f), qmax);
}

// Dequantised wire value q * s of m; noise (uniform [0, 1)) selects
// stochastic rounding, read at the element's own index idx.
__device__ __forceinline__ float quant(float m, float s, float qmax, const float* noise,
                                       int64_t idx) {
  const float u = __fdiv_rn(m, s);
  float q = noise ? floorf(__fadd_rn(u, noise[idx])) : rintf(u);
  q = fminf(fmaxf(q, -qmax), qmax);
  return __fmul_rn(q, s);
}
