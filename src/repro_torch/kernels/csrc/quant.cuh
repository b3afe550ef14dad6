// The per-agent-row symmetric quantizer shared by the compressed-gossip
// kernels (the codes pass and K9 in quantize.cu; K3's and K5's second passes
// turn the codes back into q = c * s).  Round half to even
// (rintf) or floor(u + noise), a true division by the scale (never a multiply
// by its reciprocal) and the _rn intrinsics under -fmad=false keep the q grid
// bit-identical to kernels/ref.py:quantize_rows_ref.
#pragma once

#include <stdint.h>

// s_j = max(absmax_j, 1e-12) / qmax
__device__ __forceinline__ float row_scale(const float* absmax, int64_t j, float qmax) {
  return __fdiv_rn(fmaxf(absmax[j], 1e-12f), qmax);
}

// The integer code c of m on the grid of s: clip(rint(m / s), -qmax, qmax),
// or floor(m / s + u) when stochastic (u uniform in [0, 1)); a float that
// holds an integer of at most 7 bits, so exact in int8 and in bf16.
__device__ __forceinline__ float quant_code(float m, float s, float qmax, bool stochastic,
                                            float u) {
  const float v = __fdiv_rn(m, s);
  const float q = stochastic ? floorf(__fadd_rn(v, u)) : rintf(v);
  return fminf(fmaxf(q, -qmax), qmax);
}

// Dequantised wire value q = c * s of m.
__device__ __forceinline__ float quant_value(float m, float s, float qmax, bool stochastic,
                                             float u) {
  return __fmul_rn(quant_code(m, s, qmax, stochastic, u), s);
}

// Code k (0-3) of a word of four int8 codes, given the word with its sign
// bits flipped (w ^ 0x80808080, so byte k holds c + 128), as an exact float:
// the bits of 2^23 + c + 128 minus 2^23 + 128, an integer and a float add in
// place of a conversion instruction.
__device__ __forceinline__ float code_at(uint32_t biased, int k) {
  return __fsub_rn(__uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u | k)), 8388736.0f);
}

// The same with the noise (when given) read at the element's own index idx
// (K9's one-element path).
__device__ __forceinline__ float quant(float m, float s, float qmax, const float* noise,
                                       int64_t idx) {
  const float u = __fdiv_rn(m, s);
  float q = noise ? floorf(__fadd_rn(u, noise[idx])) : rintf(u);
  q = fminf(fmaxf(q, -qmax), qmax);
  return __fmul_rn(q, s);
}
