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
// Bound: operations.  The contraction is 2 n^2 d flops in float32 FMA (no
// TF32, which would break parity), against ~5 n d floats of traffic.  W
// (n <= 512, up to 1 MB) does not fit in shared memory the way it sat whole
// in VMEM, so the output is tiled over (64 agent rows x 128 columns) and the
// contraction runs over chunks of 32 agents: each chunk's q tile is
// dequantised on the fly from x (+ r) into shared memory together with the
// matching 32 x 64 block of W, and every thread keeps an 8 x 4 register tile
// of accumulators.  q never round-trips through device memory.
//
// Exactness: the quantizer of quant.cuh and the _rn intrinsics with
// -fmad=false keep the q grid, the residual and the epilogue bit-identical to
// the plain version; only the order of the W^T q sum differs from a library
// matmul.
//
// K9 `quant_dequant` replaces src/repro/kernels/quantize.py:96
// `rowwise_quant_dequant` (pallas_call at :111): the per-agent-row int8/int4
// round trip q = clip(rint(m / s), -qmax, qmax) * s of m = x (+ r), or
// floor(m / s + noise) in the stochastic form, with s from K2's row abs-max,
// written in x's dtype (what crosses the wire of a collective mixer), and
// with a residual the error-feedback update r' = m - q (q as sent).  Bound:
// bytes.  A grid-stride pass, 8 elements a thread per step with 16-byte
// accesses when rows are a multiple of 8 long and the pointers aligned.
#include <cuda_runtime.h>
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

constexpr int BI = 64;   // output agent rows per block
constexpr int BC = 128;  // output columns per block
constexpr int BJ = 32;   // contraction chunk (source agents)
constexpr int TX = 32;   // threads along columns
constexpr int TY = 8;    // threads along rows
constexpr int RI = BI / TY;  // 8 rows per thread
constexpr int RC = BC / TX;  // 4 columns per thread

__global__ void __launch_bounds__(TX * TY)
compressed_mix_kernel(const float* __restrict__ x, const float* __restrict__ r,
                      const float* __restrict__ w, const float* __restrict__ absmax,
                      const float* __restrict__ noise, float* __restrict__ out,
                      float* __restrict__ r_out, int n, int64_t d, float qmax,
                      float gamma, int damped) {
  __shared__ float q_tile[BJ][BC];
  __shared__ float w_tile[BJ][BI];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int64_t c0 = (int64_t)blockIdx.x * BC;
  const int i0 = blockIdx.y * BI;

  float acc[RI][RC];
#pragma unroll
  for (int a = 0; a < RI; ++a)
#pragma unroll
    for (int b = 0; b < RC; ++b) acc[a][b] = 0.0f;

  for (int j0 = 0; j0 < n; j0 += BJ) {
    for (int t = tid; t < BJ * BC; t += TX * TY) {
      const int jj = t / BC, cc = t % BC;
      const int j = j0 + jj;
      const int64_t c = c0 + cc;
      float v = 0.0f;
      if (j < n && c < d) {
        const int64_t idx = (int64_t)j * d + c;
        const float m = r ? __fadd_rn(x[idx], r[idx]) : x[idx];
        v = quant(m, row_scale(absmax, j, qmax), qmax, noise, idx);
      }
      q_tile[jj][cc] = v;
    }
    for (int t = tid; t < BJ * BI; t += TX * TY) {
      const int jj = t / BI, ii = t % BI;
      const int j = j0 + jj, i = i0 + ii;
      // out_i = sum_j W[j][i] q_j : the contraction with W^T
      w_tile[jj][ii] = (j < n && i < n) ? w[(int64_t)j * n + i] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < BJ; ++jj) {
      float wv[RI], qv[RC];
#pragma unroll
      for (int a = 0; a < RI; ++a) wv[a] = w_tile[jj][ty + TY * a];
#pragma unroll
      for (int b = 0; b < RC; ++b) qv[b] = q_tile[jj][tx + TX * b];
#pragma unroll
      for (int a = 0; a < RI; ++a)
#pragma unroll
        for (int b = 0; b < RC; ++b) acc[a][b] = fmaf(wv[a], qv[b], acc[a][b]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < RI; ++a) {
    const int i = i0 + ty + TY * a;
    if (i >= n) continue;
    const float s = row_scale(absmax, i, qmax);
#pragma unroll
    for (int b = 0; b < RC; ++b) {
      const int64_t c = c0 + tx + TX * b;
      if (c >= d) continue;
      const int64_t idx = (int64_t)i * d + c;
      const float xv = x[idx];
      const float m = r ? __fadd_rn(xv, r[idx]) : xv;
      const float q = quant(m, s, qmax, noise, idx);
      const float diff = __fsub_rn(acc[a][b], q);
      out[idx] = damped ? __fadd_rn(xv, __fmul_rn(gamma, diff)) : __fadd_rn(xv, diff);
      if (r_out) r_out[idx] = __fsub_rn(m, q);
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

// r, noise and r_out may be null.  damped = (gamma != 1).
extern "C" int launch_compressed_mix(const void* x, const void* r, const void* w,
                                     const void* absmax, const void* noise, void* out,
                                     void* r_out, int n, long long d, float qmax, float gamma,
                                     int damped, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  const dim3 block(TX, TY);
  const dim3 grid((unsigned)((d + BC - 1) / BC), (unsigned)((n + BI - 1) / BI));
  compressed_mix_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)r, (const float*)w, (const float*)absmax,
      (const float*)noise, (float*)out, (float*)r_out, n, d, qmax, gamma, damped);
  return (int)cudaGetLastError();
}
