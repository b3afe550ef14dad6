// K7: Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py:86
// `ssd_scan_kernel` (pallas_call at :106).  x (B, L, H, P), dt (B, L, H),
// a (H,) float32 and negative, B and C (B, L, G, N), head h reading group
// h / (H / G).  The inputs are read through their strides (the last
// dimension must be contiguous), so the prefill's split and reshaped views
// cross without a copy.  Returns y (B, L, H, P) in x's dtype and the final
// state (B, H, P, N) float32.
//
// Bound on the H100: operations.  Per step and head the chunked algorithm
// does ~2·chunk·(N + P) flops for the diagonal block and ~4·P·N for the
// state and its read-out, against ~2·(P + 2N) bytes of input: far above
// the card's flop/byte balance.  Everything is computed in float32 FMAs.
//
// Design.  The TPU grid walks the chunks in order and carries the (P, N)
// state in VMEM; here one block owns one (batch, head) and walks the
// chunks in a loop, with the f32 state (P x N, 32 KB at P = 64, N = 128) in
// shared memory.  The block's chunk is 64 steps whatever the model's
// chunk: the SSD recurrence is the same for any chunk length, and 64 keeps
// the chunk's x, C, B-transposed, the decay-weighted C·Bᵀ block and the
// state in 130 KB of shared memory.  Per chunk, as ssd_scan.py:46-83:
//   cum   = cumsum(dt·a)                       (one thread, 64 adds)
//   G_ls  = (C_l·B_s)·exp(cum_l − cum_s)·dt_s   for s <= l
//   y_l   = Σ_s G_ls x_s + exp(cum_l)·(C_l·h)   (diagonal + off-diagonal)
//   h     = exp(cum_last)·h + Σ_s dt_s·exp(cum_last − cum_s)·x_s ⊗ B_s
// Consecutive threads take consecutive output columns, and the padded
// strides (N + 1, 64 + 1) keep every shared read conflict-free.  A ragged
// last chunk (L % 64 != 0) is masked: its missing steps load dt = 0 and
// x = B = C = 0, which are exact no-ops for the state, and their rows of y
// are not written.  32 heads at batch 1 are only 32 blocks on 132 SMs:
// the first thing to fix (split P across blocks, or chunks across blocks
// with a second pass over the chunk states).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 64;    // steps per chunk
constexpr int NT = 256;  // threads

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

struct Strides {
  long long b, l, h;  // batch, step, head (or group)
};

size_t smem_bytes(int p, int n) {
  return sizeof(float) *
         ((size_t)p * (n + 1) + (size_t)T * p + (size_t)T * (n + 1) + (size_t)n * (T + 1) +
          (size_t)T * (T + 1) + 3 * T);
}

template <typename TX, typename TD>
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const TX* __restrict__ x, const TD* __restrict__ dt, const float* __restrict__ a,
                const TX* __restrict__ bm, const TX* __restrict__ cm, TX* __restrict__ y,
                float* __restrict__ hfin, int L, int H, int G, int P, int N, Strides xs,
                Strides ds, Strides bs, Strides cs) {
  extern __shared__ float sm[];
  float* sH = sm;                    // P x (N + 1) carried state
  float* sX = sH + P * (N + 1);      // T x P
  float* sC = sX + T * P;            // T x (N + 1)
  float* sBt = sC + T * (N + 1);     // N x (T + 1), B transposed
  float* sG = sBt + N * (T + 1);     // T x (T + 1)
  float* sCum = sG + T * (T + 1);    // T
  float* sDt = sCum + T;             // T
  float* sW = sDt + T;               // T: dt_s·exp(cum_last − cum_s)

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const float ah = a[h];
  const TX* xb = x + b * xs.b + (long long)h * xs.h;
  const TD* db = dt + b * ds.b + (long long)h * ds.h;
  const TX* bb = bm + b * bs.b + (long long)g * bs.h;
  const TX* cb = cm + b * cs.b + (long long)g * cs.h;
  TX* yb = y + ((long long)b * L * H + h) * P;  // y is contiguous (B, L, H, P)

  for (int i = tid; i < P * N; i += NT) sH[(i / N) * (N + 1) + i % N] = 0.f;

  for (int t0 = 0; t0 < L; t0 += T) {
    const int tl = min(T, L - t0);
    __syncthreads();  // the previous chunk is done with every tile
    for (int i = tid; i < T * P; i += NT) {
      const int r = i / P, c = i % P;
      sX[i] = r < tl ? ld(xb + (long long)(t0 + r) * xs.l + c) : 0.f;
    }
    for (int i = tid; i < T * N; i += NT) {
      const int r = i / N, c = i % N;
      const bool in = r < tl;
      sC[r * (N + 1) + c] = in ? ld(cb + (long long)(t0 + r) * cs.l + c) : 0.f;
      sBt[c * (T + 1) + r] = in ? ld(bb + (long long)(t0 + r) * bs.l + c) : 0.f;
    }
    if (tid < T) sDt[tid] = tid < tl ? ld(db + (long long)(t0 + tid) * ds.l) : 0.f;
    __syncthreads();
    if (tid == 0) {
      float c = 0.f;
      for (int r = 0; r < T; ++r) {
        c += sDt[r] * ah;
        sCum[r] = c;
      }
    }
    __syncthreads();
    const float cum_last = sCum[T - 1];
    if (tid < T) sW[tid] = sDt[tid] * expf(cum_last - sCum[tid]);
    // decay-weighted C·Bᵀ, lower triangle
    for (int i = tid; i < T * T; i += NT) {
      const int l = i / T, s = i % T;
      float val = 0.f;
      if (s <= l) {
        float dot = 0.f;
        for (int n = 0; n < N; ++n) dot = fmaf(sC[l * (N + 1) + n], sBt[n * (T + 1) + s], dot);
        val = dot * expf(sCum[l] - sCum[s]) * sDt[s];
      }
      sG[l * (T + 1) + s] = val;
    }
    __syncthreads();
    // y: diagonal block plus the incoming state's contribution
    for (int i = tid; i < T * P; i += NT) {
      const int l = i / P, p = i % P;
      if (l >= tl) continue;
      float yd = 0.f;
      for (int s = 0; s <= l; ++s) yd = fmaf(sG[l * (T + 1) + s], sX[s * P + p], yd);
      float yo = 0.f;
      for (int n = 0; n < N; ++n) yo = fmaf(sC[l * (N + 1) + n], sH[p * (N + 1) + n], yo);
      st(yb + (long long)(t0 + l) * H * P + p, yd + expf(sCum[l]) * yo);
    }
    __syncthreads();  // every read of the incoming state is done
    const float dec = expf(cum_last);
    for (int i = tid; i < P * N; i += NT) {
      const int p = i / N, n = i % N;
      float acc = 0.f;
      for (int s = 0; s < T; ++s) acc = fmaf(sW[s] * sX[s * P + p], sBt[n * (T + 1) + s], acc);
      float* hp = sH + p * (N + 1) + n;
      *hp = fmaf(dec, *hp, acc);
    }
  }
  __syncthreads();
  float* hb = hfin + ((long long)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += NT) hb[i] = sH[(i / N) * (N + 1) + i % N];
}

template <typename TX, typename TD>
int launch(const void* x, const void* dt, const float* a, const void* bm, const void* cm,
           void* y, float* hfin, int bsz, int L, int H, int G, int P, int N, Strides xs,
           Strides ds, Strides bs, Strides cs, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<TX, TD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)H, (unsigned)bsz);
  ssd_scan_kernel<TX, TD><<<grid, NT, smem, stream>>>(
      (const TX*)x, (const TD*)dt, a, (const TX*)bm, (const TX*)cm, (TX*)y, hfin, L, H, G, P, N,
      xs, ds, bs, cs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long ssd_scan_smem_bytes(int p, int n) { return (long long)smem_bytes(p, n); }

// x_dtype (x, B, C, y) and dt_dtype: 0 = float32, 1 = bfloat16.  Strides in
// elements, (batch, step, head-or-group) of x, dt, B, C.  Returns
// cudaGetLastError().
extern "C" int launch_ssd_scan(const void* x, const void* dt, const void* a, const void* bm,
                               const void* cm, void* y, void* hfin, int bsz, int L, int H, int G,
                               int P, int N, long long xsb, long long xsl, long long xsh,
                               long long dsb, long long dsl, long long dsh, long long bsb,
                               long long bsl, long long bsg, long long csb, long long csl,
                               long long csg, int x_dtype, int dt_dtype, void* stream) {
  if (bsz <= 0 || H <= 0) return 0;
  if (G <= 0 || H % G != 0 || P <= 0 || N <= 0 || L < 0) return (int)cudaErrorInvalidValue;
  const Strides xs{xsb, xsl, xsh}, ds{dsb, dsl, dsh}, bs{bsb, bsl, bsg}, cs{csb, csl, csg};
  cudaStream_t s = (cudaStream_t)stream;
  const float* af = (const float*)a;
  float* hf = (float*)hfin;
  if (x_dtype == 0 && dt_dtype == 0)
    return launch<float, float>(x, dt, af, bm, cm, y, hf, bsz, L, H, G, P, N, xs, ds, bs, cs, s);
  if (x_dtype == 1 && dt_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, dt, af, bm, cm, y, hf, bsz, L, H, G, P, N, xs, ds, bs, cs, s);
  if (x_dtype == 1 && dt_dtype == 0)
    return launch<__nv_bfloat16, float>(x, dt, af, bm, cm, y, hf, bsz, L, H, G, P, N, xs, ds, bs, cs, s);
  if (x_dtype == 0 && dt_dtype == 1)
    return launch<float, __nv_bfloat16>(x, dt, af, bm, cm, y, hf, bsz, L, H, G, P, N, xs, ds, bs, cs, s);
  return (int)cudaErrorInvalidValue;
}
