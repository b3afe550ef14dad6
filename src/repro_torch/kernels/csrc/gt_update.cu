// K1: fused PISCO local step (paper eq. 3a + 3c) for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/gt_update.py:69
// `fused_local_step` (pallas_call at :85).  Two forms, one elementwise pass
// each (four reads, two writes, float32 math, output in the input dtype):
//
//   reference form (track = 0):  x' = x - eta*y ;  y' = (y + g_new) - g_old
//                                (both from the OLD y, as the Pallas kernel)
//   track-step     (track = 1):  y' = y + (g_new - g_old) ;  x' = x - eta*y'
//                                step t's (3c) fused with step t+1's (3a),
//                                in PISCO's own grouping (pisco.py:154)
//
// Bound on the H100: bytes.  Three flops per element against 24 bytes moved
// (f32) is far below the card's flop/byte balance, so the kernel is a
// streaming pass: a grid-stride loop with neighbouring threads on
// neighbouring addresses, no shared memory, every operand read once and
// every result written once.  The arithmetic uses the _rn intrinsics (and
// the file is built with -fmad=false) so no multiply-add is contracted and
// results match the plain PyTorch version bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, bool TRACK>
__global__ void local_step_kernel(const T* __restrict__ x, const T* __restrict__ y,
                                  const T* __restrict__ g_new, const T* __restrict__ g_old,
                                  T* __restrict__ x_out, T* __restrict__ y_out,
                                  int64_t n, float eta) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float xv = to_f32(x[i]);
    const float yv = to_f32(y[i]);
    const float gn = to_f32(g_new[i]);
    const float go = to_f32(g_old[i]);
    float xn, yn;
    if (TRACK) {
      yn = __fadd_rn(yv, __fsub_rn(gn, go));
      xn = __fsub_rn(xv, __fmul_rn(eta, yn));
    } else {
      xn = __fsub_rn(xv, __fmul_rn(eta, yv));
      yn = __fsub_rn(__fadd_rn(yv, gn), go);
    }
    x_out[i] = from_f32<T>(xn);
    y_out[i] = from_f32<T>(yn);
  }
}

template <typename T>
void launch(const void* x, const void* y, const void* gn, const void* go, void* xo,
            void* yo, int64_t n, float eta, int track, cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride past 32 blocks per SM
  if (track) {
    local_step_kernel<T, true><<<(unsigned)blocks, threads, 0, stream>>>(
        (const T*)x, (const T*)y, (const T*)gn, (const T*)go, (T*)xo, (T*)yo, n, eta);
  } else {
    local_step_kernel<T, false><<<(unsigned)blocks, threads, 0, stream>>>(
        (const T*)x, (const T*)y, (const T*)gn, (const T*)go, (T*)xo, (T*)yo, n, eta);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the launch.
extern "C" int launch_local_step(const void* x, const void* y, const void* g_new,
                                 const void* g_old, void* x_out, void* y_out,
                                 long long n, float eta, int track, int dtype,
                                 void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    launch<float>(x, y, g_new, g_old, x_out, y_out, n, eta, track, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, y, g_new, g_old, x_out, y_out, n, eta, track, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
