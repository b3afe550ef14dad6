// K4: sparse gossip over a CSR mixing matrix, for Hopper (sm_90a).  Float32.
//
// Replaces the Pallas kernel src/repro/kernels/sparse_mix.py:119 `sparse_mix`
// (pallas_call at :144):
//
//   out_i = self_w_i * x_i + sum_{e in row i} data_e * x_{indices_e}
//
// where row i of the CSR triple lists the senders into receiver i in the
// directed-edge order (src/repro/core/topology.py:489-495).  The TPU kernel
// scatter-accumulated edge blocks into a VMEM-resident output block across a
// sequential grid axis; blocks on the GPU run in no order, so this kernel
// gathers instead: one thread owns one (receiver, column) output, walks the
// receiver's CSR row in edge order and adds the self term last, exactly as
// tree_agent_mix_sparse (src/repro/utils/pytree.py:98-103) does.  No float
// atomics, so the result is deterministic.
//
// Bound on the H100: bytes.  The floor is one read of x and one write of
// out (2 n d floats), but each output gathers deg(i) + 1 rows of x, and on
// an expander those rows are spread over the whole fleet: if the blocks in
// flight covered all columns of a few receivers, every gather would miss L2
// and x would stream from device memory deg + 1 times.  So blockIdx.x walks
// the receivers and blockIdx.y the 256-wide column tiles: the blocks in
// flight share one column tile, whose slice of x (n x 256 floats, 10 MB at
// n = 10^4) stays in the 50 MB L2 while every receiver gathers from it.
// Neighbouring threads take neighbouring columns, so every gathered row is
// read coalesced.  Built with -fmad=false so each product is rounded before
// it is added, as in the plain version.
//
// K5: compressed sparse gossip, for the same CSR.  Replaces the Pallas kernel
// src/repro/kernels/sparse_mix.py:161 `sparse_compressed_mix` (pallas_call at
// :188), extended to the error-feedback and damped form that
// CompressedGossip runs over the sparse mixer
// (src/repro/core/compression.py:246-259):
//
//   m   = x + r                                  (r optional)
//   q   = quant(m) with s_i = max(absmax_i, 1e-12) / qmax   (quant.cuh)
//   out = x + gamma * ((self_w_i q_i + sum_{e in row i} data_e q_{indices_e}) - q_i)
//   r'  = m - q                                  (when r is given)
//
// grouped as CompressedGossip groups it (x + (mixed - q) when gamma == 1),
// not as the Pallas kernel (x + gamma (self_w - 1) q + gamma sum).  The layout
// is K4's: one thread per (receiver, column) output, the CSR row walked in
// edge order, the self term added last, no atomics.  q never touches device
// memory: every gathered neighbour value is re-quantised from x, r and noise
// with the neighbour's own scale.  That is exact, because the noise tensor
// fixes every sender's q whoever reads it.  Only the self element writes r'.
//
// Bound on the H100: bytes.  The EF form reads x, r and noise and writes out
// and r' (5 n d floats, 1.50 ms at n = 10^4, d = 25,088); the stateless form
// reads x and writes out (0.60 ms, as K4).  Each output gathers deg + 1 rows
// of three arrays, so the column tile is 128 wide, not K4's 256: the tile's
// slice of x, r and noise (3 x n x 128 floats, 15 MB at n = 10^4) stays in
// the 50 MB L2 while the receivers in flight gather from it.  Each block
// stages its row's sender offsets, weights and scales in shared memory once,
// so a gathered element costs one division (m / s), not two.
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_GRID_Y = 65535;
constexpr int CMIX_THREADS = 128;  // K5 column tile; also the edges staged per chunk

__global__ void sparse_mix_csr_kernel(const float* __restrict__ x,
                                      const int64_t* __restrict__ indptr,
                                      const int64_t* __restrict__ indices,
                                      const float* __restrict__ data,
                                      const float* __restrict__ self_w,
                                      float* __restrict__ out, int64_t n, int64_t d) {
  const int64_t i = blockIdx.x;  // receiver
  const int64_t beg = indptr[i], end = indptr[i + 1];
  for (int64_t c = (int64_t)blockIdx.y * blockDim.x + threadIdx.x; c < d;
       c += (int64_t)gridDim.y * blockDim.x) {
    float acc = 0.0f;
    for (int64_t e = beg; e < end; ++e) {
      acc = __fadd_rn(acc, __fmul_rn(data[e], x[indices[e] * d + c]));
    }
    out[i * d + c] = __fadd_rn(__fmul_rn(self_w[i], x[i * d + c]), acc);
  }
}

__global__ void __launch_bounds__(CMIX_THREADS)
sparse_compressed_mix_csr_kernel(const float* __restrict__ x, const float* __restrict__ r,
                                 const float* __restrict__ noise,
                                 const int64_t* __restrict__ indptr,
                                 const int64_t* __restrict__ indices,
                                 const float* __restrict__ data,
                                 const float* __restrict__ self_w,
                                 const float* __restrict__ absmax, float* __restrict__ out,
                                 float* __restrict__ r_out, int64_t d, float qmax, float gamma,
                                 int damped) {
  __shared__ int64_t e_row[CMIX_THREADS];  // sender row offset j * d
  __shared__ float e_w[CMIX_THREADS];
  __shared__ float e_s[CMIX_THREADS];
  const int64_t i = blockIdx.x;  // receiver
  const int64_t beg = indptr[i], end = indptr[i + 1];
  const float s_i = row_scale(absmax, i, qmax);
  // c0 is uniform across the block, so every thread reaches each barrier
  for (int64_t c0 = (int64_t)blockIdx.y * CMIX_THREADS; c0 < d;
       c0 += (int64_t)gridDim.y * CMIX_THREADS) {
    const int64_t c = c0 + threadIdx.x;
    const bool live = c < d;
    float acc = 0.0f;
    for (int64_t e0 = beg; e0 < end; e0 += CMIX_THREADS) {
      const int cnt = (int)(end - e0 < CMIX_THREADS ? end - e0 : CMIX_THREADS);
      __syncthreads();  // the previous chunk is consumed
      if (threadIdx.x < cnt) {
        const int64_t j = indices[e0 + threadIdx.x];
        e_row[threadIdx.x] = j * d;
        e_w[threadIdx.x] = data[e0 + threadIdx.x];
        e_s[threadIdx.x] = row_scale(absmax, j, qmax);
      }
      __syncthreads();
      if (live) {
        for (int k = 0; k < cnt; ++k) {
          const int64_t idx = e_row[k] + c;
          const float m = r ? __fadd_rn(x[idx], r[idx]) : x[idx];
          acc = __fadd_rn(acc, __fmul_rn(e_w[k], quant(m, e_s[k], qmax, noise, idx)));
        }
      }
    }
    if (live) {
      const int64_t idx = i * d + c;
      const float xv = x[idx];
      const float m = r ? __fadd_rn(xv, r[idx]) : xv;
      const float q = quant(m, s_i, qmax, noise, idx);
      const float diff = __fsub_rn(__fadd_rn(__fmul_rn(self_w[i], q), acc), q);
      out[idx] = damped ? __fadd_rn(xv, __fmul_rn(gamma, diff)) : __fadd_rn(xv, diff);
      if (r_out) r_out[idx] = __fsub_rn(m, q);
    }
  }
}

}  // namespace

extern "C" int launch_sparse_mix_csr(const void* x, const void* indptr, const void* indices,
                                     const void* data, const void* self_w, void* out,
                                     long long n, long long d, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  const long long tiles = (d + THREADS - 1) / THREADS;
  const dim3 grid((unsigned)n, (unsigned)(tiles < MAX_GRID_Y ? tiles : MAX_GRID_Y));
  sparse_mix_csr_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int64_t*)indptr, (const int64_t*)indices, (const float*)data,
      (const float*)self_w, (float*)out, n, d);
  return (int)cudaGetLastError();
}

// r, noise and r_out may be null.  damped = (gamma != 1).
extern "C" int launch_sparse_compressed_mix_csr(const void* x, const void* r, const void* noise,
                                                const void* indptr, const void* indices,
                                                const void* data, const void* self_w,
                                                const void* absmax, void* out, void* r_out,
                                                long long n, long long d, float qmax,
                                                float gamma, int damped, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  const long long tiles = (d + CMIX_THREADS - 1) / CMIX_THREADS;
  const dim3 grid((unsigned)n, (unsigned)(tiles < MAX_GRID_Y ? tiles : MAX_GRID_Y));
  sparse_compressed_mix_csr_kernel<<<grid, CMIX_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)r, (const float*)noise, (const int64_t*)indptr,
      (const int64_t*)indices, (const float*)data, (const float*)self_w, (const float*)absmax,
      (float*)out, (float*)r_out, d, qmax, gamma, damped);
  return (int)cudaGetLastError();
}
