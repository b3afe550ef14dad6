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
// gathers instead: each output walks its receiver's CSR row in edge order
// and adds the self term last, exactly as tree_agent_mix_sparse
// (src/repro/utils/pytree.py:98-103) does.  No float atomics, so the result
// is deterministic.  Built with -fmad=false so each product is rounded
// before it is added, as in the plain version.
//
// Bound on the H100: bytes.  The floor is one read of x and one write of
// out (2 n d floats), but each output gathers deg(i) + 1 rows of x, and on
// an expander those rows are spread over the whole fleet, so every row of x
// passes through L2 deg + 1 times.  The design:
//   - one warp per receiver, four receivers per block, so the 10-, 32- and
//     320-wide leaves of the MLP fill the card as the 25,088-wide one does;
//   - a warp covers a 256-column tile of its receiver: each lane 8 columns,
//     as two 16-byte loads (d % 4 == 0 and x, out 16-byte aligned) or eight
//     4-byte loads (any other d or base), chosen per launch: one kernel,
//     two load widths;
//   - the warp loads 32 of the row's (index, weight) pairs with one
//     coalesced access and hands them out by shuffle, so no lane rereads
//     them and they sit off the gathers' critical path;
//   - the self row and each edge's gathers are issued before the ordered
//     adds; the compiler unrolls the edge loop and keeps several edges'
//     gathers in flight (an explicit batch of 2 or 4 edges held more
//     registers and ran no faster on the card: tools/k4_ablation.py);
//   - the grid is 1-D with the column tile as the slow index: the blocks in
//     flight share one or two tiles, whose slice of x (n x 256 floats,
//     10 MB at n = 10^4) stays in the 50 MB L2 while every receiver gathers
//     from it.
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
#include <limits.h>
#include <stdint.h>

#include "quant.cuh"
#include "vec.cuh"

namespace {

constexpr int MAX_GRID_Y = 65535;
constexpr int CMIX_THREADS = 128;  // K5 column tile; also the edges staged per chunk

constexpr int MIX_WARPS = 4;               // receivers per block, one warp each
constexpr int MIX_VEC = 2;                 // 16-byte loads per lane and row
constexpr int MIX_COLS = 4 * MIX_VEC;      // columns per lane
constexpr int MIX_TILE = 32 * MIX_COLS;    // columns per warp: the column tile
constexpr int MIX_BATCH = 1;               // edges whose gathers are issued before their adds
constexpr unsigned FULL = 0xffffffffu;

// The lane's MIX_COLS columns of the tile at c0 in one row: with VEC, two
// runs of four (c0 + 128 k + 4 lane + q), else stride 32 (c0 + 32 k + lane);
// columns at or past d read as 0 and are never stored.
template <bool VEC>
__device__ __forceinline__ void load_cols(const float* __restrict__ row, int64_t c0, int lane,
                                          int64_t d, float v[MIX_COLS]) {
  if (VEC) {
#pragma unroll
    for (int k = 0; k < MIX_VEC; ++k) {
      const int64_t c = c0 + 128 * k + 4 * lane;
      const float4 a = c < d ? __ldg(reinterpret_cast<const float4*>(row + c))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * k] = a.x; v[4 * k + 1] = a.y; v[4 * k + 2] = a.z; v[4 * k + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < MIX_COLS; ++k) {
      const int64_t c = c0 + 32 * k + lane;
      v[k] = c < d ? __ldg(row + c) : 0.f;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void store_cols(float* __restrict__ row, int64_t c0, int lane,
                                           int64_t d, const float v[MIX_COLS]) {
  if (VEC) {
#pragma unroll
    for (int k = 0; k < MIX_VEC; ++k) {
      const int64_t c = c0 + 128 * k + 4 * lane;
      if (c < d)
        *reinterpret_cast<float4*>(row + c) =
            make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < MIX_COLS; ++k) {
      const int64_t c = c0 + 32 * k + lane;
      if (c < d) row[c] = v[k];
    }
  }
}

// Block b serves column tile b / recv_blocks and receivers
// (b % recv_blocks) * MIX_WARPS + warp.
template <bool VEC>
__global__ void __launch_bounds__(32 * MIX_WARPS)
sparse_mix_csr_kernel(const float* __restrict__ x, const int64_t* __restrict__ indptr,
                      const int64_t* __restrict__ indices, const float* __restrict__ data,
                      const float* __restrict__ self_w, float* __restrict__ out, int64_t n,
                      int64_t d, int64_t recv_blocks) {
  const int lane = threadIdx.x & 31;
  const int64_t tile = blockIdx.x / recv_blocks;
  const int64_t i = (blockIdx.x - tile * recv_blocks) * MIX_WARPS + (threadIdx.x >> 5);
  if (i >= n) return;  // the whole warp: i is uniform across it
  const int64_t c0 = tile * MIX_TILE;
  const int64_t beg = indptr[i], end = indptr[i + 1];
  float self[MIX_COLS], acc[MIX_COLS];
  load_cols<VEC>(x + i * d, c0, lane, d, self);
#pragma unroll
  for (int q = 0; q < MIX_COLS; ++q) acc[q] = 0.f;
  for (int64_t e0 = beg; e0 < end; e0 += 32) {
    const int cnt = end - e0 < 32 ? (int)(end - e0) : 32;
    const int64_t my_j = lane < cnt ? indices[e0 + lane] : 0;
    const float my_w = lane < cnt ? data[e0 + lane] : 0.f;
    for (int k0 = 0; k0 < cnt; k0 += MIX_BATCH) {
      float v[MIX_BATCH][MIX_COLS];
#pragma unroll
      for (int u = 0; u < MIX_BATCH; ++u) {  // every gather first ...
        const int64_t j = __shfl_sync(FULL, my_j, k0 + u);  // lane k0 + u mod 32
        if (k0 + u < cnt) load_cols<VEC>(x + j * d, c0, lane, d, v[u]);
      }
#pragma unroll
      for (int u = 0; u < MIX_BATCH; ++u) {  // ... then the adds, in edge order
        const float w = __shfl_sync(FULL, my_w, k0 + u);
        if (k0 + u < cnt) {
#pragma unroll
          for (int q = 0; q < MIX_COLS; ++q) acc[q] = __fadd_rn(acc[q], __fmul_rn(w, v[u][q]));
        }
      }
    }
  }
  const float sw = self_w[i];
#pragma unroll
  for (int q = 0; q < MIX_COLS; ++q) acc[q] = __fadd_rn(__fmul_rn(sw, self[q]), acc[q]);
  store_cols<VEC>(out + i * d, c0, lane, d, acc);
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
  const long long recv_blocks = (n + MIX_WARPS - 1) / MIX_WARPS;
  const long long tiles = (d + MIX_TILE - 1) / MIX_TILE;
  if (recv_blocks > INT_MAX / tiles) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(recv_blocks * tiles);
  const bool vec = d % 4 == 0 && aligned16(x) && aligned16(out);
  auto kernel = vec ? sparse_mix_csr_kernel<true> : sparse_mix_csr_kernel<false>;
  kernel<<<grid, 32 * MIX_WARPS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int64_t*)indptr, (const int64_t*)indices, (const float*)data,
      (const float*)self_w, (float*)out, n, d, recv_blocks);
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
