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
// not as the Pallas kernel (x + gamma (self_w - 1) q + gamma sum).
//
// It runs as two passes.  The first is the codes pass of quantize.cu
// (quant_codes): each row's int8 codes c and, with a residual, r' = m - c s.
// The second, below, is K4's gather over the codes: out needs q_j = c_j s_j
// of every sender, and a code is one byte where re-quantising it from x, r
// and noise read twelve and a true division.  Its layout is K4's:
//   - one warp per receiver, four receivers per block;
//   - a 1-D grid with the column tile as the slow index, so the tile's slice
//     of the codes (n x 256 bytes, 2.5 MB at n = 10^4) stays in L2;
//   - the row's (index, weight) pairs, and the senders' scales s_j, loaded
//     once per warp and handed out by shuffle;
//   - a 256-column tile per warp (128 for rows of up to 1,024 columns, so a
//     short row still spreads over the lanes), in K4's interleaved layout:
//     each lane runs of four columns, one 4-byte load of codes and one
//     16-byte load of x or out each, where d % 4 == 0 and the bases align,
//     else one element a load at a stride of 32 (one kernel, the width
//     chosen per launch);
//   - four edges' codes gathered before their ordered adds, so a warp keeps
//     four loads in flight (the CSR row of the degree-4 expander is four
//     edges);
//   - the codes become floats through integer and float adds (quant.cuh
//     code_at), not conversion instructions.
// The arithmetic is the plain version's, in its order: acc = sum_e
// data_e (c_j s_j) in edge order with _rn products and adds, the self term
// last, out = x + ((self_w q_i + acc) - q_i).  No atomics.
//
// Bound on the H100: bytes.  The one-pass floor: the EF form reads x, r and
// noise and writes out and r' (5 n d floats, 1.50 ms at n = 10^4, d =
// 25,088), the stateless form reads x and writes out (0.60 ms).  The two
// passes move more: the codes pass reads x (r, noise) and writes the codes
// (and r'), the gather reads the codes and x and writes out: 6.52 GB (EF,
// 1.95 ms) and 3.51 GB (stateless, 1.05 ms).  The gathered codes pass
// through L2 deg + 1 times: 1.25 GB, 0.17 ms at 7.4 TB/s.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "quant.cuh"
#include "vec.cuh"

namespace {

constexpr int MIX_WARPS = 4;               // receivers per block, one warp each
constexpr int MIX_VEC = 2;                 // 16-byte loads per lane and row
constexpr int MIX_COLS = 4 * MIX_VEC;      // columns per lane
constexpr int MIX_TILE = 32 * MIX_COLS;    // columns per warp: the column tile
constexpr int MIX_BATCH = 1;               // edges whose gathers are issued before their adds
constexpr unsigned FULL = 0xffffffffu;

constexpr int EDGE_BATCH = 4;       // K5: edges whose codes are gathered before their adds
constexpr long long LANE_SWITCH = 1024;  // K5: the longest row that takes 4 codes a lane
constexpr uint32_t SIGN_BITS = 0x80808080u;

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

// K5's second pass.  A lane's LANE columns of the tile at c0 (LANE = 4 or
// 8, a tile of 32 LANE columns): with VEC, K4's interleaved layout, runs of
// four at c0 + 128 q + 4 lane (q < LANE / 4), each one 4-byte load of codes
// and one 16-byte load of floats, so every access of a warp is contiguous;
// else stride 32 (c0 + 32 k + lane), one element a load.  Columns at or past
// d read as 0 and are never stored.  The codes come packed four to a word
// either way, the word q holding columns 4q .. 4q + 3 of the lane's LANE.
__device__ __forceinline__ int64_t vec_col(int64_t c0, int lane, int q) {
  return c0 + 128 * q + 4 * lane;
}

template <bool VEC, int LANE>
__device__ __forceinline__ void load_codes(const int8_t* __restrict__ row, int64_t c0, int lane,
                                           int64_t d, uint32_t w[LANE / 4]) {
#pragma unroll
  for (int q = 0; q < LANE / 4; ++q) {
    if (VEC) {
      const int64_t c = vec_col(c0, lane, q);
      w[q] = c < d ? __ldg(reinterpret_cast<const uint32_t*>(row + c)) : 0u;
    } else {
      w[q] = 0u;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int64_t c = c0 + 32 * (4 * q + r) + lane;
        if (c < d) w[q] |= (uint32_t)(uint8_t)__ldg(row + c) << (8 * r);
      }
    }
  }
}

// q = c s of LANE packed codes
template <int LANE>
__device__ __forceinline__ void codes_to_q(const uint32_t w[LANE / 4], float s, float q[LANE]) {
#pragma unroll
  for (int k = 0; k < LANE; ++k) q[k] = __fmul_rn(code_at(w[k / 4] ^ SIGN_BITS, k % 4), s);
}

template <bool VEC, int LANE>
__device__ __forceinline__ void load_x(const float* __restrict__ row, int64_t c0, int lane,
                                       int64_t d, float v[LANE]) {
#pragma unroll
  for (int q = 0; q < LANE / 4; ++q) {
    if (VEC) {
      const int64_t c = vec_col(c0, lane, q);
      const float4 a = c < d ? __ldg(reinterpret_cast<const float4*>(row + c))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * q] = a.x; v[4 * q + 1] = a.y; v[4 * q + 2] = a.z; v[4 * q + 3] = a.w;
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int64_t c = c0 + 32 * (4 * q + r) + lane;
        v[4 * q + r] = c < d ? __ldg(row + c) : 0.f;
      }
    }
  }
}

template <bool VEC, int LANE>
__device__ __forceinline__ void store_x(float* __restrict__ row, int64_t c0, int lane, int64_t d,
                                        const float v[LANE]) {
#pragma unroll
  for (int q = 0; q < LANE / 4; ++q) {
    if (VEC) {
      const int64_t c = vec_col(c0, lane, q);
      if (c < d)
        *reinterpret_cast<float4*>(row + c) =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int64_t c = c0 + 32 * (4 * q + r) + lane;
        if (c < d) row[c] = v[4 * q + r];
      }
    }
  }
}

// Block b serves column tile b / recv_blocks and receivers
// (b % recv_blocks) * MIX_WARPS + warp, as K4.  EDGE_BATCH edges' codes are
// gathered before their ordered adds, so a warp keeps that many loads in
// flight.
template <bool VEC, int LANE>
__global__ void __launch_bounds__(32 * MIX_WARPS)
sparse_code_mix_csr_kernel(const float* __restrict__ x, const int8_t* __restrict__ codes,
                           const int64_t* __restrict__ indptr,
                           const int64_t* __restrict__ indices, const float* __restrict__ data,
                           const float* __restrict__ self_w, const float* __restrict__ absmax,
                           float* __restrict__ out, int64_t n, int64_t d, int64_t recv_blocks,
                           float qmax, float gamma, int damped) {
  const int lane = threadIdx.x & 31;
  const int64_t tile = blockIdx.x / recv_blocks;
  const int64_t i = (blockIdx.x - tile * recv_blocks) * MIX_WARPS + (threadIdx.x >> 5);
  if (i >= n) return;  // the whole warp: i is uniform across it
  const int64_t c0 = tile * (32 * LANE);
  const int64_t beg = indptr[i], end = indptr[i + 1];
  float xs[LANE], qs[LANE], acc[LANE];
  uint32_t ws[LANE / 4];
  load_x<VEC, LANE>(x + i * d, c0, lane, d, xs);
  load_codes<VEC, LANE>(codes + i * d, c0, lane, d, ws);
#pragma unroll
  for (int k = 0; k < LANE; ++k) acc[k] = 0.f;
  for (int64_t e0 = beg; e0 < end; e0 += 32) {
    const int cnt = end - e0 < 32 ? (int)(end - e0) : 32;
    const int64_t my_j = lane < cnt ? indices[e0 + lane] : 0;
    const float my_w = lane < cnt ? data[e0 + lane] : 0.f;
    const float my_s = lane < cnt ? row_scale(absmax, my_j, qmax) : 1.f;
    for (int k0 = 0; k0 < cnt; k0 += EDGE_BATCH) {
      uint32_t w[EDGE_BATCH][LANE / 4];
#pragma unroll
      for (int u = 0; u < EDGE_BATCH; ++u) {  // every gather first ...
        const int64_t j = __shfl_sync(FULL, my_j, k0 + u);  // lane k0 + u mod 32
        if (k0 + u < cnt) load_codes<VEC, LANE>(codes + j * d, c0, lane, d, w[u]);
      }
#pragma unroll
      for (int u = 0; u < EDGE_BATCH; ++u) {  // ... then the adds, in edge order
        const float wt = __shfl_sync(FULL, my_w, k0 + u), s = __shfl_sync(FULL, my_s, k0 + u);
        if (k0 + u < cnt) {
          float q[LANE];
          codes_to_q<LANE>(w[u], s, q);
#pragma unroll
          for (int k = 0; k < LANE; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(wt, q[k]));
        }
      }
    }
  }
  codes_to_q<LANE>(ws, row_scale(absmax, i, qmax), qs);
  const float sw = self_w[i];
#pragma unroll
  for (int k = 0; k < LANE; ++k) {
    const float diff = __fsub_rn(__fadd_rn(__fmul_rn(sw, qs[k]), acc[k]), qs[k]);
    acc[k] = damped ? __fadd_rn(xs[k], __fmul_rn(gamma, diff)) : __fadd_rn(xs[k], diff);
  }
  store_x<VEC, LANE>(out + i * d, c0, lane, d, acc);
}

template <int LANE>
int launch_code_mix(const void* x, const void* codes, const void* indptr, const void* indices,
                    const void* data, const void* self_w, const void* absmax, void* out,
                    long long n, long long d, float qmax, float gamma, int damped,
                    cudaStream_t stream) {
  const long long recv_blocks = (n + MIX_WARPS - 1) / MIX_WARPS;
  const long long tiles = (d + 32 * LANE - 1) / (32 * LANE);
  if (recv_blocks > INT_MAX / tiles) return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && aligned16(x) && aligned16(out) && aligned16(codes);
  auto kernel = vec ? sparse_code_mix_csr_kernel<true, LANE>
                    : sparse_code_mix_csr_kernel<false, LANE>;
  kernel<<<(unsigned)(recv_blocks * tiles), 32 * MIX_WARPS, 0, stream>>>(
      (const float*)x, (const int8_t*)codes, (const int64_t*)indptr, (const int64_t*)indices,
      (const float*)data, (const float*)self_w, (const float*)absmax, (float*)out, n, d,
      recv_blocks, qmax, gamma, damped);
  return (int)cudaGetLastError();
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

// K5's second pass over the codes of quant_codes.  damped = (gamma != 1).
// Rows of up to LANE_SWITCH columns take four codes a lane, longer ones
// eight (tools/k3_k5_ablation.py times both, and 16, at every leaf).
extern "C" int launch_sparse_code_mix_csr(const void* x, const void* codes, const void* indptr,
                                          const void* indices, const void* data,
                                          const void* self_w, const void* absmax, void* out,
                                          long long n, long long d, float qmax, float gamma,
                                          int damped, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  auto launch = d <= LANE_SWITCH ? launch_code_mix<4> : launch_code_mix<8>;
  return launch(x, codes, indptr, indices, data, self_w, absmax, out, n, d, qmax, gamma, damped,
                (cudaStream_t)stream);
}
