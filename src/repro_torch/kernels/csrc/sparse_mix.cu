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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_GRID_Y = 65535;

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
