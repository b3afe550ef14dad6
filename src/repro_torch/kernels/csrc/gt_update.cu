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
//
// K8: fused (4a) candidate + ring-gossip combine.  Replaces the Pallas kernel
// src/repro/kernels/gt_update.py:96 `fused_mix_combine` (pallas_call at
// :112):
//
//   u   = (1 - eta_c) * x_k + eta_c * (x_to - eta_l * y_to)
//   out = w_s * u + w_l * left + w_r * right
//
// and, without y_to, the form the port's round runs, whose local phase
// already left x_half = x_to - eta_l * y_to (K1's track step):
//
//   u   = (1 - eta_c) * x_k + eta_c * x_half
//
// left and right are the neighbours' candidates as they came off the wire
// (float32 or the state's dtype); right may be absent (a ring of two has one
// neighbour).  Bound: bytes — 5 reads and 1 write for ~9 flops an element.
// One grid-stride pass, each thread moving 8 elements per step with 16-byte
// loads and stores where every pointer is 16-byte aligned (a scalar tail
// finishes the last n % 8), float32 math in the same grouping as the plain
// version, rounded once into the state's dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec.cuh"

namespace {

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


struct MixCoef {
  float keep, eta_c, eta_l, ws, wl, wr;  // keep = 1 - eta_c
};

template <bool HAS_Y, bool HAS_R>
__device__ __forceinline__ float mix_one(float xk, float xt, float yt, float l, float r,
                                         const MixCoef& c) {
  const float half = HAS_Y ? __fsub_rn(xt, __fmul_rn(c.eta_l, yt)) : xt;
  const float cand = __fadd_rn(__fmul_rn(c.keep, xk), __fmul_rn(c.eta_c, half));
  float out = __fadd_rn(__fmul_rn(c.ws, cand), __fmul_rn(c.wl, l));
  if (HAS_R) out = __fadd_rn(out, __fmul_rn(c.wr, r));
  return out;
}

template <typename T, typename W, bool HAS_Y, bool HAS_R, bool VEC>
__global__ void mix_combine_kernel(const T* __restrict__ xk, const T* __restrict__ xt,
                                   const T* __restrict__ yt, const W* __restrict__ left,
                                   const W* __restrict__ right, T* __restrict__ out,
                                   int64_t n, MixCoef c) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (VEC) {
    const int64_t nv = n / 8;
    for (int64_t v = tid; v < nv; v += stride) {
      const int64_t i = 8 * v;
      float a[8], b[8], y[8] = {0}, l[8], r[8] = {0}, o[8];
      load8(xk, i, a);
      load8(xt, i, b);
      if (HAS_Y) load8(yt, i, y);
      load8(left, i, l);
      if (HAS_R) load8(right, i, r);
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = mix_one<HAS_Y, HAS_R>(a[k], b[k], y[k], l[k], r[k], c);
      store8(out, i, o);
    }
    done = 8 * nv;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    const float y = HAS_Y ? to_f32(yt[i]) : 0.0f;
    const float r = HAS_R ? to_f32(right[i]) : 0.0f;
    out[i] = from_f32<T>(mix_one<HAS_Y, HAS_R>(to_f32(xk[i]), to_f32(xt[i]), y,
                                               to_f32(left[i]), r, c));
  }
}

template <typename T, typename W, bool HAS_Y, bool HAS_R>
void launch_mix3(const void* xk, const void* xt, const void* yt, const void* l, const void* r,
                 void* out, int64_t n, const MixCoef& c, cudaStream_t s) {
  const bool vec = aligned16(xk) && aligned16(xt) && aligned16(yt) && aligned16(l) &&
                   aligned16(r) && aligned16(out);
  const int threads = 256;
  const int64_t units = vec ? (n + 7) / 8 : n;
  int64_t blocks = (units + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (vec) {
    mix_combine_kernel<T, W, HAS_Y, HAS_R, true><<<(unsigned)blocks, threads, 0, s>>>(
        (const T*)xk, (const T*)xt, (const T*)yt, (const W*)l, (const W*)r, (T*)out, n, c);
  } else {
    mix_combine_kernel<T, W, HAS_Y, HAS_R, false><<<(unsigned)blocks, threads, 0, s>>>(
        (const T*)xk, (const T*)xt, (const T*)yt, (const W*)l, (const W*)r, (T*)out, n, c);
  }
}

template <typename T, typename W>
void launch_mix2(const void* xk, const void* xt, const void* yt, const void* l, const void* r,
                 void* out, int64_t n, const MixCoef& c, cudaStream_t s) {
  if (yt && r) launch_mix3<T, W, true, true>(xk, xt, yt, l, r, out, n, c, s);
  else if (yt) launch_mix3<T, W, true, false>(xk, xt, yt, l, r, out, n, c, s);
  else if (r) launch_mix3<T, W, false, true>(xk, xt, yt, l, r, out, n, c, s);
  else launch_mix3<T, W, false, false>(xk, xt, yt, l, r, out, n, c, s);
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

// K8.  y_to and right may be null (the x_half form; a single neighbour).
// dtype / wire_dtype: 0 = float32, 1 = bfloat16 (the state's; the wire's,
// which left and right share).  Returns cudaGetLastError() after the launch.
extern "C" int launch_mix_combine(const void* x_k, const void* x_to, const void* y_to,
                                  const void* left, const void* right, void* out, long long n,
                                  float keep, float eta_c, float eta_l, float w_self,
                                  float w_left, float w_right, int dtype, int wire_dtype,
                                  void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const MixCoef c{keep, eta_c, eta_l, w_self, w_left, w_right};
  if (dtype == 0 && wire_dtype == 0) {
    launch_mix2<float, float>(x_k, x_to, y_to, left, right, out, n, c, s);
  } else if (dtype == 1 && wire_dtype == 1) {
    launch_mix2<__nv_bfloat16, __nv_bfloat16>(x_k, x_to, y_to, left, right, out, n, c, s);
  } else if (dtype == 1 && wire_dtype == 0) {
    launch_mix2<__nv_bfloat16, float>(x_k, x_to, y_to, left, right, out, n, c, s);
  } else if (dtype == 0 && wire_dtype == 1) {
    launch_mix2<float, __nv_bfloat16>(x_k, x_to, y_to, left, right, out, n, c, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
