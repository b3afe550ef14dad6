// K2 and K3: the two phases of compressed gossip with error feedback, for
// Hopper (sm_90a).  Float32 throughout.
//
// K2 `row_absmax` replaces the Pallas kernel src/repro/kernels/quantize.py:82
// `_row_scales` (pallas_call at :86): per agent row, max_j |x_ij + r_ij|
// (the residual r is optional).  On the TPU a column-blocked grid carried the
// running max in VMEM from one grid step to the next; here one block owns one
// row, strides over its columns, and reduces with warp shuffles.  Max is
// exact in any order, so no atomics and no second pass are needed.  Bound:
// bytes (one read of x and r, one float written per row).
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
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant.cuh"

namespace {

constexpr int ABSMAX_THREADS = 256;

__global__ void row_absmax_kernel(const float* __restrict__ x, const float* __restrict__ r,
                                  float* __restrict__ out, int64_t d) {
  const int64_t row = blockIdx.x;
  const float* xr = x + row * d;
  const float* rr = r ? r + row * d : nullptr;
  float m = 0.0f;
  for (int64_t j = threadIdx.x; j < d; j += blockDim.x) {
    const float v = rr ? __fadd_rn(xr[j], rr[j]) : xr[j];
    m = fmaxf(m, fabsf(v));
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
    if (lane == 0) out[row] = m;
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

extern "C" int launch_row_absmax(const void* x, const void* r, void* out, long long n_rows,
                                 long long d, void* stream) {
  if (n_rows <= 0) return 0;
  row_absmax_kernel<<<(unsigned)n_rows, ABSMAX_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)r, (float*)out, d);
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
