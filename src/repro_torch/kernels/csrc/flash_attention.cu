// K6: causal / sliding-window GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:86
// `flash_attention` (pallas_call at :117).  q (B, Hq, Sq, D), k and v
// (B, Hkv, Sk, D), read through their strides (the last dimension must be
// contiguous), so the prefill hands over (B, S, H, D) activations as
// transposed views without a copy.  Query head h reads KV head h / group,
// as the Pallas index map does.  Output (B, Hq, Sq, D), contiguous, in the
// input dtype.
//
// Bound on the H100: operations.  At the prefill's shapes (S in the
// hundreds to thousands, D = 128) causal attention does ~2·S·D flops per
// score against a few bytes per score, far above the card's flop/byte
// balance.  This first version computes in float32 FMAs (f32 inputs need
// f32 arithmetic for their 2e-6 tolerance; bf16 inputs are widened on
// load), so it runs against the 67 TFLOP/s f32 rate, not the tensor cores:
// wgmma/mma.sync on bf16 tiles, with TMA, is a later PR's work.
//
// Design.  The TPU grid walks the key blocks in order and carries m, l and
// acc in VMEM across grid steps; Hopper blocks run in no order, so one block
// owns one (batch, query head, 64-query tile) and runs the key loop inside
// itself: nothing carries over between blocks.  Per 64-key tile the block
// stages K transposed and V in shared memory (Q stays there for the whole
// loop, pre-widened to f32), each of 256 threads computes a 4 x 4 block of
// scores (rows ty + 16i, columns tx + 16j: conflict-free shared reads),
// the 16 threads of a row reduce the row max and sum with shuffles, and P
// goes through shared memory into a 4 x (D/16) block of the output.
// Running m, l and acc are f32 registers.  The causal mask, the window
// (k > q - window) and the ragged tail (k >= Sk; q >= Sq is never written)
// are masked inside the kernel, and key tiles wholly outside the causal
// band or the window are skipped.  The fully-masked-row guard of the
// Pallas kernel (flash_attention.py:71-74) is kept: a row whose running max
// is still -1e30 contributes p = 0 and alpha = 1.  Multiply-adds are
// explicit fmaf (the library is built with -fmad=false); exponentials are
// the accurate expf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // queries per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads: 16 x 16
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

struct Strides {
  long long b, h, s;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + D * (BK + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int hq, int group, int sq, int sk, Strides qs, Strides ks,
          Strides vs, float scale, int causal, int window) {
  extern __shared__ float smem[];
  float* sQ = smem;                 // BQ x (D + 1)
  float* sKt = sQ + BQ * (D + 1);   // D x (BK + 1), K transposed
  float* sV = sKt + D * (BK + 1);   // BK x D
  float* sP = sV + BK * D;          // BQ x (BK + 1)

  constexpr int RPT = BQ / 16;  // query rows per thread
  constexpr int CPT = BK / 16;  // key columns per thread
  constexpr int OPT = D / 16;   // output columns per thread

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qb = q + b * qs.b + (long long)h * qs.h;
  const T* kb = k + b * ks.b + (long long)(h / group) * ks.h;
  const T* vb = v + b * vs.b + (long long)(h / group) * vs.h;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D, qi = q0 + r;
    sQ[r * (D + 1) + c] = qi < sq ? ld(qb + (long long)qi * qs.s + c) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < OPT; ++e) acc[i][e] = 0.f;
  }

  // keys any row of this tile can see
  int k_end = sk;
  if (causal) k_end = min(sk, q0 + BQ);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  k_begin = (k_begin / BK) * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's reads of sKt, sV, sP are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D, kj = k0 + r;
      const bool in = kj < sk;
      sKt[c * (BK + 1) + r] = in ? ld(kb + (long long)kj * ks.s + c) : 0.f;
      sV[r * D + c] = in ? ld(vb + (long long)kj * vs.s + c) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sQ[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = sKt[d * (BK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < sk && (!causal || kj <= qi) && (window <= 0 || kj > qi - window);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes of one half-warp share a row
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const bool live = m_new > NEG_INF / 2;  // fully-masked-row guard
      const float alpha = live ? expf(m[i] - m_new) : 1.f;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = live ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = fmaf(l[i], alpha, rs);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < OPT; ++e) acc[i][e] *= alpha;
#pragma unroll
      for (int j = 0; j < CPT; ++j) sP[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RPT], vv[OPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sP[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int e = 0; e < OPT; ++e) vv[e] = sV[kk * D + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int e = 0; e < OPT; ++e) acc[i][e] = fmaf(pv[i], vv[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + (((long long)b * hq + h) * sq + qi) * D;
#pragma unroll
    for (int e = 0; e < OPT; ++e) st(orow + tx + 16 * e, acc[i][e] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, long long b, int hq, int hkv,
           int sq, int sk, Strides qs, Strides ks, Strides vs, float scale, int causal,
           int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((sq + BQ - 1) / BQ), (unsigned)hq, (unsigned)b);
  flash_fwd<T, D><<<grid, NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, hq,
                                              hq / hkv, sq, sk, qs, ks, vs, scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o, long long b, int hq,
             int hkv, int sq, int sk, Strides qs, Strides ks, Strides vs, float scale,
             int causal, int window, cudaStream_t s) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, b, hq, hkv, sq, sk, qs, ks, vs, scale, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, o, b, hq, hkv, sq, sk, qs, ks, vs, scale, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, o, b, hq, hkv, sq, sk, qs, ks, vs, scale, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head dim 32, 64 or 128; window <= 0
// means none.  Strides are in elements.  Returns cudaGetLastError().
extern "C" int launch_flash_attention(const void* q, const void* k, const void* v, void* o,
                                      long long b, int hq, int hkv, int sq, int sk, int d,
                                      long long qsb, long long qsh, long long qss,
                                      long long ksb, long long ksh, long long kss,
                                      long long vsb, long long vsh, long long vss, float scale,
                                      int causal, int window, int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_d<float>(d, q, k, v, o, b, hq, hkv, sq, sk, qs, ks, vs, scale, causal, window, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(d, q, k, v, o, b, hq, hkv, sq, sk, qs, ks, vs, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
