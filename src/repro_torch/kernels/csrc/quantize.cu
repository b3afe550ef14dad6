// K2, K3 and K9: the phases of compressed gossip with error feedback, for
// Hopper (sm_90a).  Float32 arithmetic throughout; K2 and K9 also read and
// write bfloat16.
//
// K2 `row_absmax` replaces the Pallas kernel src/repro/kernels/quantize.py:82
// `_row_scales` (pallas_call at :86): per agent row, max_j |x_ij + r_ij|
// (the residual r is optional), read from float32 or bfloat16 and summed in
// float32.  On the TPU a column-blocked grid carried the running max in VMEM
// from one grid step to the next.  Here a row is split across `parts` blocks
// (one when there are rows enough to fill the card; many when a row is a
// whole leaf of one agent, as on the collective path: 215.5 M elements for
// Mamba2-370m's in_proj); each block strides over its slice of the row and
// reduces with warp shuffles, and a split row's blocks meet in an atomicMax on
// the float's bits (non-negative floats order as their bit patterns, and max
// is exact in any order, so the result does not depend on the split).
// Bound: bytes (one read of x and r, one float written per row).
//
// K3 `compressed_mix` replaces src/repro/kernels/quantize.py:125
// `fused_compressed_mix` (pallas_call at :145), extended to the error-feedback
// and damped form CompressedGossip.__call__ computes
// (src/repro/core/compression.py:246-259):
//
//   m   = x + r                            (r optional)
//   s_j = max(absmax_j, 1e-12) / qmax
//   q   = clip(rint(m / s), -qmax, qmax) * s      or floor(m / s + noise)
//   out = x + (W^T q - q)                  (gamma == 1)
//   out = x + gamma * (W^T q - q)          (otherwise)
//   r'  = m - q                            (when r is given)
//
// It runs as two passes.  The first is the codes pass below, shared with
// K5; the second is a contraction of the codes on the tensor cores:
//
//   out_i = x_i + gamma (sum_j W'[j][i] c_j - q_i),   W'[j][i] = W[j][i] s_j
//
// the product Out = A B with A = W'^T (W' rounded once to f32) and B the
// codes.  The codes are exact in bf16 (|c| <= 127); W' is split into three
// bf16 terms (the f32 value exactly, as a rule), so three mma.sync m16n8k16
// products per tile carry the contraction at f32 accuracy.
//   - A pre-pass (code_mix_operand_kernel) forms W' once per call, split
//     and laid out in mma fragment order: 1.5 MB at n = 512, resident in L2.
//   - A block covers 128 output rows x 128 columns, eight warps of 32 x 64.
//     Each k-step's A fragments (12 KB) and its 16 x 128 codes are staged
//     with 16-byte cp.async in a three-stage ring (byte loads through
//     registers where d % 16 != 0 or a base is unaligned).
//   - The tensor cores truncate the f32 sums they form.  So each k-step sums
//     its 16 terms in a fresh f32 partial, W''s two small terms first, and
//     adds it to the running f32 sum with a rounded add.  Against an f64
//     contraction this is as accurate as cuBLAS's f32 matmul; the products
//     straight into the running sum are 3x less (tools/k3_k5_ablation.py).
//   - The codes become bf16 through integer and float adds (quant.cuh
//     code_at), not conversion instructions.  Within a k-step the sources,
//     and within a warp's 64 columns the eight n-tiles, are permuted: a
//     thread reads its B operand as four 8-byte shared loads, and its 16
//     output columns of a row are contiguous (16-byte epilogue accesses).
//
// Bound: bytes.  5 n d floats move (x, r, noise in; out, r' out), plus W:
// 0.258 GB at dense-q8's w1 leaf (n = 512, d = 25,088), 0.077 ms.  The three
// products are 3 x 2 n^2 d = 39.5 GFLOP, 0.040 ms at the bf16 rate.  The two
// passes move 26 n d bytes (the codes are written once and read by every
// row tile): 0.100 ms.
//
// Exactness: the q grid and the residual are the codes pass's, bit for bit,
// and the epilogue keeps the x + (W^T q - q) grouping.  Only the
// contraction's rounding differs from a library f32 matmul (TF32 stays off).
//
// The codes pass `quant_codes` (the first pass of K3 and K5): per agent row
// j, the int8 codes c = clip(rint(m / s_j), -qmax, qmax), or floor(m / s_j +
// u) in the stochastic form, of m = x (+ r), written into an (n, d) int8
// scratch; with a residual also r' = m - c s_j.  c s_j is the q of
// quantize_rows_ref bit for bit.  Bound: bytes (x, r, noise read; d bytes
// of codes and d floats of r' written per row).  A grid-stride pass, eight
// elements a thread per step with 16-byte reads and an 8-byte store of codes
// where d % 8 == 0 and the bases align, else one element.
//
// K9 `quant_dequant` replaces src/repro/kernels/quantize.py:96
// `rowwise_quant_dequant` (pallas_call at :111): the per-agent-row int8/int4
// round trip q = clip(rint(m / s), -qmax, qmax) * s of m = x (+ r), or
// floor(m / s + noise) in the stochastic form, with s from K2's row abs-max,
// written in x's dtype (what crosses the wire of a collective mixer), and
// with a residual the error-feedback update r' = m - q (q as sent).  Bound:
// bytes.  A grid-stride pass, 8 elements a thread per step with 16-byte
// accesses when rows are a multiple of 8 long and the pointers aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "quant.cuh"
#include "vec.cuh"

namespace {

constexpr int ABSMAX_THREADS = 256;

template <typename T>
__device__ __forceinline__ float abs_sum(T x, const T* r, int64_t j) {
  return fabsf(r ? __fadd_rn(to_f32(x), to_f32(r[j])) : to_f32(x));
}

// grid (rows, parts): block (row, p) reduces columns [p*span, (p+1)*span)
template <typename T, bool VEC>
__global__ void row_absmax_kernel(const T* __restrict__ x, const T* __restrict__ r,
                                  float* __restrict__ out, int64_t d, int64_t span) {
  const int64_t row = blockIdx.x;
  const int64_t c0 = (int64_t)blockIdx.y * span;
  const int64_t c1 = c0 + span < d ? c0 + span : d;
  const T* xr = x + row * d;
  const T* rr = r ? r + row * d : nullptr;
  float m = 0.0f;
  int64_t j = c0 + threadIdx.x;
  if (VEC) {  // span and d are multiples of 8
    for (j = c0 + 8 * threadIdx.x; j < c1; j += 8 * blockDim.x) {
      float a[8], b[8];
      load8(xr, j, a);
      if (rr) load8(rr, j, b);
#pragma unroll
      for (int k = 0; k < 8; ++k) m = fmaxf(m, fabsf(rr ? __fadd_rn(a[k], b[k]) : a[k]));
    }
  } else {
    for (; j < c1; j += blockDim.x) m = fmaxf(m, abs_sum(xr[j], rr, j));
  }
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_max[ABSMAX_THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < (int)(blockDim.x >> 5) ? warp_max[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) {
      if (gridDim.y == 1) out[row] = m;
      else atomicMax(reinterpret_cast<int*>(out) + row, __float_as_int(m));
    }
  }
}

template <typename T>
void launch_absmax(const void* x, const void* r, void* out, int64_t n_rows, int64_t d,
                   int parts, cudaStream_t s) {
  const bool vec = d % 8 == 0 && aligned16(x) && aligned16(r);
  int64_t span = (d + parts - 1) / parts;
  if (vec) span = (span + 7) / 8 * 8;
  const dim3 grid((unsigned)n_rows, (unsigned)parts);
  if (vec) {
    row_absmax_kernel<T, true><<<grid, ABSMAX_THREADS, 0, s>>>((const T*)x, (const T*)r,
                                                               (float*)out, d, span);
  } else {
    row_absmax_kernel<T, false><<<grid, ABSMAX_THREADS, 0, s>>>((const T*)x, (const T*)r,
                                                                (float*)out, d, span);
  }
}

template <typename T, bool VEC>
__global__ void quant_dequant_kernel(const T* __restrict__ x, const T* __restrict__ r,
                                     const float* __restrict__ absmax,
                                     const float* __restrict__ noise, T* __restrict__ q_out,
                                     T* __restrict__ r_out, int64_t total, int64_t d,
                                     float qmax) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (VEC) {  // d is a multiple of 8: a vector never straddles two rows
    for (int64_t v = tid; v < total / 8; v += stride) {
      const int64_t i = 8 * v;
      const float s = row_scale(absmax, i / d, qmax);
      float a[8], b[8], u[8] = {0}, q[8], res[8];
      load8(x, i, a);
      if (r) load8(r, i, b);
      if (noise) load8(noise, i, u);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float m = r ? __fadd_rn(a[k], b[k]) : a[k];
        // round q into the wire dtype first: the residual keeps what was sent
        q[k] = to_f32(from_f32<T>(quant_value(m, s, qmax, noise != nullptr, u[k])));
        res[k] = __fsub_rn(m, q[k]);
      }
      store8(q_out, i, q);
      if (r_out) store8(r_out, i, res);
    }
  } else {
    for (int64_t i = tid; i < total; i += stride) {
      const float s = row_scale(absmax, i / d, qmax);
      const float xv = to_f32(x[i]);
      const float m = r ? __fadd_rn(xv, to_f32(r[i])) : xv;
      const T q = from_f32<T>(quant(m, s, qmax, noise, i));
      q_out[i] = q;
      if (r_out) r_out[i] = from_f32<T>(__fsub_rn(m, to_f32(q)));
    }
  }
}

template <typename T>
void launch_qd(const void* x, const void* r, const void* absmax, const void* noise, void* q,
               void* r_out, int64_t n_rows, int64_t d, float qmax, cudaStream_t s) {
  const int64_t total = n_rows * d;
  const bool vec = d % 8 == 0 && aligned16(x) && aligned16(r) && aligned16(noise) &&
                   aligned16(q) && aligned16(r_out);
  const int threads = 256;
  int64_t blocks = ((vec ? total / 8 : total) + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  if (vec) {
    quant_dequant_kernel<T, true><<<(unsigned)blocks, threads, 0, s>>>(
        (const T*)x, (const T*)r, (const float*)absmax, (const float*)noise, (T*)q, (T*)r_out,
        total, d, qmax);
  } else {
    quant_dequant_kernel<T, false><<<(unsigned)blocks, threads, 0, s>>>(
        (const T*)x, (const T*)r, (const float*)absmax, (const float*)noise, (T*)q, (T*)r_out,
        total, d, qmax);
  }
}

// -- the codes pass ----------------------------------------------------------

constexpr int CODES_VEC = 8;       // elements a thread per step on the vector path
constexpr int CODES_BLOCKS = 132 * 16;  // the grid's cap: 16 blocks of 256 an SM

template <bool VEC>
__global__ void quant_codes_kernel(const float* __restrict__ x, const float* __restrict__ r,
                                   const float* __restrict__ absmax,
                                   const float* __restrict__ noise, int8_t* __restrict__ codes,
                                   float* __restrict__ r_out, int64_t total, int64_t d,
                                   float qmax) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool stochastic = noise != nullptr;
  if (VEC) {  // d is a multiple of CODES_VEC: a vector never straddles two rows
    for (int64_t v = tid; v < total / CODES_VEC; v += stride) {
      const int64_t i0 = CODES_VEC * v;
      const float s = row_scale(absmax, i0 / d, qmax);
      uint32_t word[CODES_VEC / 4] = {};
#pragma unroll
      for (int h = 0; h < CODES_VEC / 8; ++h) {
        const int64_t i = i0 + 8 * h;
        float a[8], b[8], u[8] = {0}, res[8];
        load8(x, i, a);
        if (r) load8(r, i, b);
        if (noise) load8(noise, i, u);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float m = r ? __fadd_rn(a[k], b[k]) : a[k];
          const float c = quant_code(m, s, qmax, stochastic, u[k]);
          res[k] = __fsub_rn(m, __fmul_rn(c, s));
          word[2 * h + k / 4] |= ((uint32_t)(int)c & 0xffu) << (8 * (k % 4));
        }
        if (r_out) store8(r_out, i, res);
      }
      if constexpr (CODES_VEC == 16) {
        *reinterpret_cast<uint4*>(codes + i0) = make_uint4(word[0], word[1], word[2], word[3]);
      } else {
        *reinterpret_cast<uint2*>(codes + i0) = make_uint2(word[0], word[1]);
      }
    }
  } else {
    for (int64_t i = tid; i < total; i += stride) {
      const float s = row_scale(absmax, i / d, qmax);
      const float m = r ? __fadd_rn(x[i], r[i]) : x[i];
      const float c = quant_code(m, s, qmax, stochastic, stochastic ? noise[i] : 0.0f);
      codes[i] = (int8_t)(int)c;
      if (r_out) r_out[i] = __fsub_rn(m, __fmul_rn(c, s));
    }
  }
}

// -- K3's contraction on the tensor cores ------------------------------------

constexpr int CM_BM = 128;                // output agent rows per block
constexpr int CM_BN = 128;                // output columns per block
constexpr int CM_STAGES = 3;              // k-steps (16 sources each) in the ring
constexpr int CM_THREADS = 256;           // 8 warps: 4 along rows x 2 along columns
constexpr int CM_MT = CM_BM / 16;         // m-tiles per block
constexpr int CM_FRAGS = CM_MT * 3 * 32;  // A fragments (uint4) per k-step and block
constexpr int CM_LDB = CM_BN + 32;        // pitch (bytes) of a codes row in shared memory:
                                          // the 8-byte B reads hit 32 distinct banks
constexpr uint32_t SIGN_BITS = 0x80808080u;

__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats that hold integers of at most 8 significant bits as a bf16
// pair (lo in the low half): their upper halves, exactly.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// W'^T in mma m16n8k16 A-fragment order.  Entry ((ks * mt_n + mt) * 3 + term)
// * 32 + lane holds the four registers of lane (g, t) = (lane / 4, lane % 4)
// for m-tile mt (output rows 16 mt ..) and k-step ks (sources 16 ks ..), as
// the term-th of three bf16 terms.  Within a k-step the mma's k = 2t, 2t+1,
// 2t+8, 2t+9 are sources t, t+4, t+8, t+12 (the codes are read so too).
// Rows or sources at or past n are zero.
__device__ __forceinline__ void operand_frag(const float* __restrict__ w,
                                             const float* __restrict__ absmax, int n, int mt,
                                             int ks, int lane, float qmax, uint4 frag[3]) {
  const int g = lane >> 2, t = lane & 3;
  // register p holds elements 2p, 2p + 1: rows g, g+8, g, g+8 of the m-tile;
  // sources t, t+4 (p = 0, 1) and t+8, t+12 (p = 2, 3) of the k-step
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int i = 16 * mt + g + 8 * ((e >> 1) & 1);
    const int j = 16 * ks + t + 4 * (e & 1) + 8 * (e >> 2);
    v[e] = i < n && j < n ? __fmul_rn(w[(int64_t)j * n + i], row_scale(absmax, j, qmax)) : 0.0f;
  }
  uint32_t reg[3][4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float lo = v[2 * p], hi = v[2 * p + 1];
#pragma unroll
    for (int term = 0; term < 3; ++term) {  // each the rounding of what the ones before leave
      const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
      reg[term][p] = *reinterpret_cast<const uint32_t*>(&h);
      lo = __fsub_rn(lo, __low2float(h));
      hi = __fsub_rn(hi, __high2float(h));
    }
  }
#pragma unroll
  for (int term = 0; term < 3; ++term)
    frag[term] = make_uint4(reg[term][0], reg[term][1], reg[term][2], reg[term][3]);
}

// The pre-pass: every fragment of W'^T, once per call.
__global__ void code_mix_operand_kernel(const float* __restrict__ w,
                                        const float* __restrict__ absmax,
                                        uint4* __restrict__ frag, int n, int mt_n, int ks_n,
                                        float qmax) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)mt_n * ks_n * 32) return;
  const int lane = (int)(idx & 31);
  const int mt = (int)((idx >> 5) % mt_n), ks = (int)((idx >> 5) / mt_n);
  uint4 f[3];
  operand_frag(w, absmax, n, mt, ks, lane, qmax, f);
#pragma unroll
  for (int term = 0; term < 3; ++term)
    frag[(((int64_t)ks * mt_n + mt) * 3 + term) * 32 + lane] = f[term];
}

// Stage k-step ks of row tile bm: its A fragments and codes rows 16 ks ..
// +16, columns c_blk .. +CM_BN (zeros past n or d).
template <bool VEC>
__device__ __forceinline__ void cm_stage(uint4* a_s, uint8_t* b_s, const uint4* __restrict__ frag,
                                         const int8_t* __restrict__ codes, int bm, int ks,
                                         int mt_n, int n, int64_t d, int64_t c_blk) {
  const uint4* src = frag + ((int64_t)ks * mt_n + (int64_t)bm * CM_MT) * 96;
  for (int e = threadIdx.x; e < CM_FRAGS; e += CM_THREADS) cp16(a_s + e, src + e, true);
  const int j0 = 16 * ks;
  if (VEC) {
    if (threadIdx.x < 16 * (CM_BN / 16)) {
      const int r = threadIdx.x / (CM_BN / 16), q = threadIdx.x % (CM_BN / 16);
      const int64_t c = c_blk + 16 * q;
      const bool in = j0 + r < n && c < d;
      cp16(b_s + r * CM_LDB + 16 * q, in ? codes + (int64_t)(j0 + r) * d + c : codes, in);
    }
  } else {
    for (int e = threadIdx.x; e < 16 * CM_BN; e += CM_THREADS) {
      const int r = e / CM_BN, cc = e % CM_BN;
      const int64_t c = c_blk + cc;
      b_s[r * CM_LDB + cc] = j0 + r < n && c < d ? (uint8_t)codes[(int64_t)(j0 + r) * d + c] : 0;
    }
  }
}

// Block b: row tile b % row_tiles (the fast index: the row tiles of one
// column tile share its codes in L2), column tile b / row_tiles.  Warp
// (wm, wn) = (warp % 4, warp / 4) owns rows 32 wm .. +32 and columns 64 wn
// .. +64 of the tile; n-tile nt's column n = g is column 8 g + nt of those
// 64, so lane (g, t) ends up with columns 16 t .. 16 t + 15 of each row.
template <bool VEC>
__global__ void __launch_bounds__(CM_THREADS)
code_mix_kernel(const float* __restrict__ x, const int8_t* __restrict__ codes,
                const uint4* __restrict__ frag, const float* __restrict__ absmax,
                float* __restrict__ out, int n, int64_t d, int mt_n, int ks_n, int row_tiles,
                float qmax, float gamma, int damped) {
  __shared__ __align__(16) uint4 a_s[CM_STAGES][CM_FRAGS];
  __shared__ __align__(16) uint8_t b_s[CM_STAGES][16 * CM_LDB];
  const int bm = blockIdx.x % row_tiles;
  const int64_t c_blk = (int64_t)(blockIdx.x / row_tiles) * CM_BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.0f;

#pragma unroll
  for (int st = 0; st < CM_STAGES - 1; ++st) {
    if (st < ks_n) cm_stage<VEC>(a_s[st], b_s[st], frag, codes, bm, st, mt_n, n, d, c_blk);
    cp_commit();
  }
  for (int ks = 0; ks < ks_n; ++ks) {
    cp_wait<CM_STAGES - 2>();  // this thread's copies of k-step ks have landed
    __syncthreads();           // everyone's have, and k-step ks - 1's stage is free
    const int nxt = ks + CM_STAGES - 1;
    if (nxt < ks_n) {
      cm_stage<VEC>(a_s[nxt % CM_STAGES], b_s[nxt % CM_STAGES], frag, codes, bm, nxt, mt_n, n,
                    d, c_blk);
    }
    cp_commit();
    const int st = ks % CM_STAGES;
    uint32_t a[2][3][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int term = 0; term < 3; ++term) {
        const uint4 v = a_s[st][(2 * wm + mi) * 96 + term * 32 + lane];
        a[mi][term][0] = v.x; a[mi][term][1] = v.y; a[mi][term][2] = v.z; a[mi][term][3] = v.w;
      }
    // source rows t, t+4, t+8, t+12; byte nt of each row pair is n-tile nt's
    uint32_t bw[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint2 v = *reinterpret_cast<const uint2*>(b_s[st] + (t + 4 * r) * CM_LDB +
                                                      64 * wn + 8 * g);
      bw[r][0] = v.x ^ SIGN_BITS;
      bw[r][1] = v.y ^ SIGN_BITS;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint32_t b[2] = {
          bf16_pair(code_at(bw[0][nt >> 2], nt & 3), code_at(bw[1][nt >> 2], nt & 3)),
          bf16_pair(code_at(bw[2][nt >> 2], nt & 3), code_at(bw[3][nt >> 2], nt & 3))};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // the small terms first
        mma16816(p, a[mi][2], b);
        mma16816(p, a[mi][1], b);
        mma16816(p, a[mi][0], b);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nt][e] = __fadd_rn(acc[mi][nt][e], p[e]);
      }
    }
  }

  // out = x + (acc - q) or x + gamma (acc - q), q = c s of the row's own codes
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = bm * CM_BM + (2 * wm + mi) * 16 + g + 8 * h;
      const int64_t cb = c_blk + 64 * wn + 16 * t;
      if (i >= n || cb >= d) continue;
      const float s = row_scale(absmax, i, qmax);
      float v[16];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        v[nt] = acc[mi][nt][2 * h];
        v[8 + nt] = acc[mi][nt][2 * h + 1];
      }
      const int64_t base = (int64_t)i * d + cb;
      if (VEC) {  // d % 16 == 0: the 16 columns are all in
        const uint4 cw = *reinterpret_cast<const uint4*>(codes + base);
        const uint32_t words[4] = {cw.x ^ SIGN_BITS, cw.y ^ SIGN_BITS, cw.z ^ SIGN_BITS,
                                   cw.w ^ SIGN_BITS};
        float xv[16];
        load8(x, base, xv);
        load8(x, base + 8, xv + 8);
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const float diff = __fsub_rn(v[k], __fmul_rn(code_at(words[k >> 2], k & 3), s));
          xv[k] = damped ? __fadd_rn(xv[k], __fmul_rn(gamma, diff)) : __fadd_rn(xv[k], diff);
        }
        store8(out, base, xv);
        store8(out, base + 8, xv + 8);
      } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          if (cb + k >= d) break;
          const float diff = __fsub_rn(v[k], __fmul_rn((float)codes[base + k], s));
          const float xk = x[base + k];
          out[base + k] = damped ? __fadd_rn(xk, __fmul_rn(gamma, diff)) : __fadd_rn(xk, diff);
        }
      }
    }
}

}  // namespace

// K2.  out must hold zeros when parts > 1 (the blocks of a row meet in an
// atomicMax).  dtype: 0 = float32, 1 = bfloat16 (x and r).
extern "C" int launch_row_absmax(const void* x, const void* r, void* out, long long n_rows,
                                 long long d, int parts, int dtype, void* stream) {
  if (n_rows <= 0 || parts <= 0) return n_rows <= 0 ? 0 : (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) launch_absmax<float>(x, r, out, n_rows, d, parts, s);
  else if (dtype == 1) launch_absmax<__nv_bfloat16>(x, r, out, n_rows, d, parts, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// K9.  r, noise and r_out may be null; q (and r_out) take x's dtype.
extern "C" int launch_quant_dequant(const void* x, const void* r, const void* absmax,
                                    const void* noise, void* q, void* r_out, long long n_rows,
                                    long long d, float qmax, int dtype, void* stream) {
  if (n_rows <= 0 || d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) launch_qd<float>(x, r, absmax, noise, q, r_out, n_rows, d, qmax, s);
  else if (dtype == 1) launch_qd<__nv_bfloat16>(x, r, absmax, noise, q, r_out, n_rows, d, qmax, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The codes pass.  r, noise and r_out may be null; codes is (n, d) int8.
extern "C" int launch_quant_codes(const void* x, const void* r, const void* absmax,
                                  const void* noise, void* codes, void* r_out, long long n_rows,
                                  long long d, float qmax, void* stream) {
  if (n_rows <= 0 || d <= 0) return 0;
  const int64_t total = n_rows * d;
  const bool vec = d % CODES_VEC == 0 && aligned16(x) && aligned16(r) && aligned16(noise) &&
                   aligned16(r_out) && aligned16(codes);
  const int threads = 256;
  int64_t blocks = ((vec ? total / CODES_VEC : total) + threads - 1) / threads;
  if (blocks > CODES_BLOCKS) blocks = CODES_BLOCKS;
  auto kernel = vec ? quant_codes_kernel<true> : quant_codes_kernel<false>;
  kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)r, (const float*)absmax, (const float*)noise,
      (int8_t*)codes, (float*)r_out, total, d, qmax);
  return (int)cudaGetLastError();
}

// Bytes of the A-fragment scratch launch_compressed_mix takes for n agents.
extern "C" long long compressed_mix_frag_bytes(int n) {
  const long long mt_n = (long long)((n + CM_BM - 1) / CM_BM) * CM_MT, ks_n = (n + 15) / 16;
  return mt_n * ks_n * 3 * 32 * (long long)sizeof(uint4);
}

// K3's second pass: W' into frag (compressed_mix_frag_bytes(n) bytes), then
// out = x + gamma (W'^T c - q) from the codes.  damped = (gamma != 1).
extern "C" int launch_compressed_mix(const void* x, const void* codes, const void* w,
                                     const void* absmax, void* frag, void* out, int n,
                                     long long d, float qmax, float gamma, int damped,
                                     void* stream) {
  if (n <= 0 || d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int row_tiles = (n + CM_BM - 1) / CM_BM;
  const int mt_n = row_tiles * CM_MT, ks_n = (n + 15) / 16;
  const long long col_tiles = (d + CM_BN - 1) / CM_BN;
  if (col_tiles > INT_MAX / row_tiles) return (int)cudaErrorInvalidValue;
  const long long frags = (long long)mt_n * ks_n * 32;
  code_mix_operand_kernel<<<(unsigned)((frags + 255) / 256), 256, 0, s>>>(
      (const float*)w, (const float*)absmax, (uint4*)frag, n, mt_n, ks_n, qmax);
  const bool vec = d % 16 == 0 && aligned16(x) && aligned16(out) && aligned16(codes);
  auto kernel = vec ? code_mix_kernel<true> : code_mix_kernel<false>;
  kernel<<<(unsigned)(row_tiles * col_tiles), CM_THREADS, 0, s>>>(
      (const float*)x, (const int8_t*)codes, (const uint4*)frag, (const float*)absmax,
      (float*)out, n, d, mt_n, ks_n, row_tiles, qmax, gamma, damped);
  return (int)cudaGetLastError();
}
