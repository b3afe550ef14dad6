// K6: GQA flash attention for Hopper (sm_90a), causal (with or without a
// sliding window) or bidirectional (`causal` = 0: an encoder's
// self-attention, or Sq queries against Sk keys of another sequence).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:86
// `flash_attention` (pallas_call at :117).  q (B, Hq, Sq, D), k and v
// (B, Hkv, Sk, D), read through their strides (the last dimension must be
// contiguous), so the prefill hands over (B, S, H, D) activations as
// transposed views without a copy.  Query head h reads KV head h / group,
// as the Pallas index map does.  Output (B, Hq, Sq, D), contiguous, in the
// input dtype.  Without the causal mask every key tile up to Sk is live for
// every query tile, all items are of one length, and only the ragged Sk
// tail (and a window, if one is given) is masked.  Two kernels behind one
// entry point, chosen by dtype:
//
// bfloat16: flash_fwd_tc, on the tensor cores.  Bound on the H100:
// operations at the prefill's long prompts (causal S = 2048, Hq 32, D 128:
// 34.4 GFLOP against 41.9 MB, 0.0348 ms at 989 TFLOP/s against 0.0125 ms
// at 3.35 TB/s), close to bytes at the served S = 500 (2.05 GFLOP, 10.2 MB:
// 2.1 us of operations, 3.1 us of bytes, and 4 query tiles x 32 heads =
// 128 work items on 132 SMs, one wave).  Against the operations the design
// feeds the tensor cores and hides the softmax and the loads behind them;
// at S = 500 the one wave's ramp (first loads, first tile) is what is left.
//   - Work items: (batch, query head, 128-query tile), numbered longest
//     first; the grid is persistent (one block per SM, no second one fits)
//     and deals the items in a snake, so the causal imbalance leaves no
//     tail and one item's epilogue overlaps the next one's loads.
//   - Warp specialisation: warpgroup 2 is the producer (setmaxnreg down to
//     24 registers): one thread issues TMA loads of each item's Q (once it
//     is free) and of K and V into a ring of stages (3 at D = 128 and 192), each
//     with a full and an empty mbarrier.  Warpgroups 0 and 1 (setmaxnreg up
//     to 240) each own 64 query rows; warpgroup 1 starts each item after
//     warpgroup 0's first Q K^T (one named barrier), so their softmaxes
//     fall between each other's products.
//   - TMA tensor maps over the views as handed in: (D, S, H, B) with the
//     strides in bytes, 128-byte swizzle with the inner box at 64 bf16
//     (D = 128 is two boxes per row, D = 192 three; D = 32 uses the 64-byte
//     swizzle over its 64-byte rows).  TMA zero-fills past Sq and Sk; the k >= Sk mask
//     stays in the softmax and rows q >= Sq are never stored.  The maps are
//     encoded on the host by cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint (no -lcuda), and passed as __grid_constant__.
//   - S = Q K^T on wgmma m64n128k16 (BK = 128 keys; at D = 192, m64n64k16
//     over BK = 64 keys, so that three K + V stages fit beside the 48 KB Q
//     tile and the accumulators of S (32) and O (96) a thread stay within
//     D = 128's budget) with Q and K from shared memory.  While it runs, the previous tile's O += P V runs too,
//     so the exponentials of one tile overlap the other's product.
//   - Online softmax in registers, f32: row max and sum across the four
//     lanes that share an accumulator row (shuffles), exponentials as
//     ex2.approx.ftz of fma(s, scale log2(e), -m log2(e)) on the SFU (a
//     probability below 2^-126 flushes to 0), alpha rescales O in
//     registers.  The -1e30 fully-masked-row guard of the Pallas kernel
//     (flash_attention.py:71-74) is kept per row: a row still fully masked
//     subtracts +inf, so its p are 0 and its alpha 1.  Only tiles that
//     cross the causal diagonal, the window's edge or Sk pay for the mask;
//     tiles wholly outside the band are never loaded.
//   - O += P V on wgmma m64nDk16 (m64n192k16 at D = 192) with P as the
//     register A operand, rounded
//     to bf16 in place (the reference's _sdpa rounds its probabilities to
//     bf16 as well, src/repro/models/attention.py:129-132; the row sum l
//     stays f32), and V from shared memory as stored (BK x D, MN-major B).
//
// The attention logit softcap (Gemma-2's; `softcap` > 0, 0 meaning none)
// caps each scaled score to cap tanh(s / cap) before the masks and the
// running max, as the reference's _sdpa does (src/repro/models/attention.py:
// 113-133).  It is a template parameter of both kernels, so the capless
// instantiations compile to the code they were without it.  The f32 kernel
// calls the accurate tanhf (its 2e-6 tolerance needs it); the tensor-core
// kernel one tanh.approx.f32 on the SFU (relative error ~2^-11, below the
// 2^-9 of the bf16 P it feeds), and folds only log2(e) into its
// exponentials (the scale went into the tanh's argument).  The accurate form
// there, cap - 2 cap / (2^x + 1) from an ex2.approx and an IEEE division,
// costs two SFU operations a score beside the softmax's one and took 0.182
// ms at Qwen3-8B's S = 2048 against tanh.approx's 0.099 (the capless kernel
// 0.073: tools/k6_ablation.py, on an H100), at the same max |err| against
// the plain version.
//
// float32: flash_fwd, SIMT.  f32 inputs need f32 arithmetic for their
// 2e-6 tolerance (neither bf16 nor TF32 tensor cores keep it), so this
// kernel runs against the 67 TFLOP/s f32 rate.  The TPU grid walks the key
// blocks in order and carries m, l and acc in VMEM across grid steps;
// Hopper blocks run in no order, so one block owns one (batch, query head,
// 64-query tile) and runs the key loop inside itself.  Per 64-key tile the
// block stages K transposed and V in shared memory (Q stays there for the
// whole loop), each of 256 threads computes a 4 x 4 block of scores (rows
// ty + 16i, columns tx + 16j: conflict-free shared reads), the 16 threads
// of a row reduce the row max and sum with shuffles, and P goes through
// shared memory into a 4 x (D/16) block of the output.  Running m, l and
// acc are f32 registers.  The causal mask, the window (k > q - window) and
// the ragged tail (k >= Sk; q >= Sq is never written) are masked inside the
// kernel, and key tiles wholly outside the causal band or the window are
// skipped.  The fully-masked-row guard is kept: a row whose running max is
// still -1e30 contributes p = 0 and alpha = 1.  Multiply-adds are explicit
// fmaf (the library is built with -fmad=false); exponentials are the
// accurate expf.
#include <cuda.h>  // CUtensorMap and the driver's enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int BQ = 64;   // queries per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads: 16 x 16
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }

struct Strides {
  long long b, h, s;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + D * (BK + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D, bool CAP>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int hq, int group, int sq, int sk, Strides qs, Strides ks,
          Strides vs, float scale, int causal, int window, float cap) {
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
        if constexpr (CAP) {
          s[i][j] = ok ? cap * tanhf(s[i][j] * scale / cap) : NEG_INF;
        } else {
          s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        }
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

template <typename T, int D, bool CAP>
int launch(const void* q, const void* k, const void* v, void* o, long long b, int hq, int hkv,
           int sq, int sk, Strides qs, Strides ks, Strides vs, float scale, int causal,
           int window, float cap, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, D, CAP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((sq + BQ - 1) / BQ), (unsigned)hq, (unsigned)b);
  flash_fwd<T, D, CAP><<<grid, NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o,
                                                   hq, hq / hkv, sq, sk, qs, ks, vs, scale,
                                                   causal, window, cap);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_cap(const void* q, const void* k, const void* v, void* o, long long b, int hq,
               int hkv, int sq, int sk, Strides qs, Strides ks, Strides vs, float scale,
               int causal, int window, float cap, cudaStream_t s) {
  if (cap > 0.f)
    return launch<T, D, true>(q, k, v, o, b, hq, hkv, sq, sk, qs, ks, vs, scale, causal, window, cap, s);
  return launch<T, D, false>(q, k, v, o, b, hq, hkv, sq, sk, qs, ks, vs, scale, causal, window, cap, s);
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o, long long b, int hq,
             int hkv, int sq, int sk, Strides qs, Strides ks, Strides vs, float scale,
             int causal, int window, float cap, cudaStream_t s) {
  switch (d) {
    case 16: return launch_cap<T, 16>(q, k, v, o, b, hq, hkv, sq, sk, qs, ks, vs, scale, causal, window, cap, s);
    case 32: return launch_cap<T, 32>(q, k, v, o, b, hq, hkv, sq, sk, qs, ks, vs, scale, causal, window, cap, s);
    case 48: return launch_cap<T, 48>(q, k, v, o, b, hq, hkv, sq, sk, qs, ks, vs, scale, causal, window, cap, s);
    case 64: return launch_cap<T, 64>(q, k, v, o, b, hq, hkv, sq, sk, qs, ks, vs, scale, causal, window, cap, s);
    case 128: return launch_cap<T, 128>(q, k, v, o, b, hq, hkv, sq, sk, qs, ks, vs, scale, causal, window, cap, s);
    case 192: return launch_cap<T, 192>(q, k, v, o, b, hq, hkv, sq, sk, qs, ks, vs, scale, causal, window, cap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel (wgmma fed by TMA, warp-specialised)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BQ = 128;       // queries per work item: two consumer warpgroups of 64 rows
constexpr int NTHREADS = 384; // warpgroups 0, 1: consumers; 2: producer
constexpr int NCONSUMER = 256;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  // keys per tile: 128 (64 measured slower at D = 128: tools/k6_ablation.py);
  // 64 at D = 192, where a 128-key stage would leave room for one stage only
  static constexpr int BK = D == 192 ? 64 : 128;
  static constexpr int SWZ = D >= 64 ? 128 : 64;     // swizzle span = bytes per smem row
  static constexpr int CW = SWZ / 2;                 // bf16 columns per box (chunk)
  static constexpr int NCH = D / CW;                 // chunks per row
  static constexpr int LAYOUT = SWZ == 128 ? 1 : 2;  // descriptor layout: 128B / 64B swizzle
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;        // one K or one V tile
  // K/V ring depth: as many stages as fit beside Q (at most 4)
  static constexpr int NSTAGE_FIT = (232448 - 1024 - 64 - Q_BYTES) / (2 * KV_BYTES);
  static constexpr int NSTAGE = NSTAGE_FIT < 4 ? NSTAGE_FIT : 4;
  // 1024 bytes of slack to align the tiles to the swizzle atom, then Q, the
  // ring (K then V per stage) and the barriers (q_full, q_empty, full[], empty[])
  static constexpr int SMEM = 1024 + Q_BYTES + NSTAGE * 2 * KV_BYTES + 8 * (2 + 2 * NSTAGE);
  static_assert(D % CW == 0 && BK % 16 == 0 && NSTAGE >= 2, "tile shape");
  static_assert(D / 2 + BK / 2 <= 128, "accumulators of O and S a thread");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of the given parity has completed; a wait of more
// than 2^34 cycles (~9 s) means a lost transaction and traps, so a fault
// ends the launch with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), layout (swizzle) type in bits 62-63
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void mma_ss(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n192(d, a, db);
}

// 2^x on the special-function unit; subnormal results flush to 0 and
// 2^-inf = 0 (a probability below 2^-126 adds nothing to an f32 row sum)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the softcap of a score, cap tanh(s scale / cap), with k = scale / cap
__device__ __forceinline__ float capped(float s, float k, float cap) {
  float t;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(s * k));
  return cap * t;
}

// named barrier `id` over the 256 consumer threads
template <int id>
__device__ __forceinline__ void bar_sync() {
  asm volatile("bar.sync %0, 256;\n" ::"n"(id) : "memory");
}
template <int id>
__device__ __forceinline__ void bar_arrive() {
  asm volatile("bar.arrive %0, 256;\n" ::"n"(id) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q K^T for one key tile: D / 16 steps of k16, Q and K K-major in
// shared memory; issued, not waited for
template <int D>
__device__ __forceinline__ void issue_qk(float* sc, uint32_t s_qw, uint32_t s_k) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk * 16 / C::CW) * C::SWZ, in = (kk * 16 % C::CW) * 2;
    mma_ss<C::BK>(sc, smem_desc(s_qw + off * BQ + in, 16, 8 * C::SWZ, C::LAYOUT),
                  smem_desc(s_k + off * C::BK + in, 16, 8 * C::SWZ, C::LAYOUT), kk > 0);
  }
  wg_commit();
}

// O += P V: BK / 16 steps of k16, P from registers, V MN-major in shared
// memory (the leading byte offset steps from one D-chunk to the next)
template <int D>
__device__ __forceinline__ void issue_pv(float* acc, const uint32_t (*pa)[4], uint32_t s_v) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk)
    mma_rs<D>(acc, pa[kk],
              smem_desc(s_v + kk * 16 * C::SWZ, C::BK * C::SWZ, 8 * C::SWZ, C::LAYOUT));
  wg_commit();
}

// Cap the scores (CAP; `cap_k` = scale / cap), mask them where
// key tile k0 crosses Sk, the causal diagonal or the window's edge (rows
// r0 .. r0 + 63 of the warpgroup; this thread's rows `row`, `row + 8`,
// columns 8j + col, 8j + col + 1), then turn them into unnormalised
// probabilities against the updated running max m (`scale_log2` is
// scale log2(e), or log2(e) once capped).  Returns the rescale factors alpha
// of the two rows; adds the rows' partial sums into rs.
template <int BK, bool CAP>
__device__ __forceinline__ void softmax_tile(float* sc, float* m, float* alpha, float* rs, int k0,
                                             int r0, int row, int col, int sk, int causal,
                                             int window, float scale_log2, float cap_k,
                                             float cap) {
  if constexpr (CAP) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = capped(sc[i], cap_k, cap);
  }
  const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > r0) ||
                    (window > 0 && k0 < r0 + 64 - window);
  if (edge) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int qi = row + 8 * ((i >> 1) & 1);
      const int kj = k0 + 8 * (i >> 2) + col + (i & 1);
      const bool ok = kj < sk && (!causal || kj <= qi) && (window <= 0 || kj > qi - window);
      if (!ok) sc[i] = NEG_INF;
    }
  }
  // row maxima: four independent chains per row, then the four lanes of a
  // quad (which share a row) by shuffles
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) mx[r][c] = NEG_INF;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float& x = mx[(i >> 1) & 1][((i >> 2) + (i & 1) * 2) & 3];
    x = fmaxf(x, sc[i]);
  }
  float msc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    const float m_new = fmaxf(m[r], v);
    // alpha = 1 while the row is still fully masked (m stays -1e30), 0 once
    // it comes alive; the fully-masked-row guard of p subtracts +inf from
    // the scores of a row that is still masked, so its p are 0
    alpha[r] = ex2((m[r] - m_new) * scale_log2);
    msc[r] = m_new > NEG_INF / 2 ? m_new * scale_log2 : __int_as_float(0x7f800000);
    m[r] = m_new;
  }
  float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    const float p = ex2(fmaf(sc[i], scale_log2, -msc[r]));
    sc[i] = p;
    part[r][((i >> 2) + (i & 1) * 2) & 3] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) rs[r] = (part[r][0] + part[r][1]) + (part[r][2] + part[r][3]);
}

// P in bf16 as the register A operand: keys 16kk .. 16kk + 15 are the
// accumulator's 8-wide blocks 2kk and 2kk + 1
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (*pa)[4], const float* sc) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
  }
}

// One work item: query tile `q0` of head (b, h), the key tiles its rows can
// see from `k_begin` on, `n_tiles` of them.  Items are numbered longest
// first: item w is query tile nq - 1 - w / (B Hq) of head w % (B Hq).
struct Item {
  int q0, h, b, k_begin, n_tiles;
};

template <int BK>
__device__ __forceinline__ Item work_item(int w, int bh, int nq, int hq, int sk, int causal,
                                          int window) {
  Item it;
  it.q0 = (nq - 1 - w / bh) * BQ;
  it.h = (w % bh) % hq;
  it.b = (w % bh) / hq;
  const int k_end = causal ? min(sk, it.q0 + BQ) : sk;
  it.k_begin = (window > 0 ? max(0, it.q0 - window + 1) : 0) / BK * BK;
  it.n_tiles = k_end > it.k_begin ? (k_end - it.k_begin + BK - 1) / BK : 0;
  return it;
}

// The block's item of round r, or -1: rounds of gridDim.x items, dealt in a
// snake (forward in even rounds, backward in odd ones) so that every block's
// sum of lengths comes out near the mean.
__device__ __forceinline__ int work_index(int r, int n_items) {
  const int w = r * gridDim.x + ((r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  return w < n_items ? w : -1;
}

template <int D, bool CAP>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o, int hq,
             int group, int sq, int sk, int nq, int n_items, float scale_log2, int causal,
             int window, float cap_k, float cap) {
  using C = Cfg<D>;
  constexpr int NS = C::NSTAGE;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_ring = s_q + C::Q_BYTES;  // stage s: K at s_ring + 2s KV_BYTES, V after it
  const uint32_t q_full = s_ring + NS * 2 * C::KV_BYTES, q_empty = q_full + 8;
  const uint32_t full0 = q_empty + 8, empty0 = full0 + 8 * NS;
  const int bh = n_items / nq;  // B * Hq

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, NCONSUMER);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NCONSUMER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every load.  Q waits for the consumers'
    // last Q K^T of the previous item; the K/V ring runs on across items.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int kt = 0;  // K/V tiles loaded so far
      for (int r = 0, n = 0;; ++r, ++n) {
        const int w = work_index(r, n_items);
        if (w < 0) break;
        const Item it = work_item<BK>(w, bh, nq, hq, sk, causal, window);
        const int hk = it.h / group;
        mbar_wait(q_empty, (n & 1) ^ 1);
        mbar_expect_tx(q_full, C::Q_BYTES);
        for (int c = 0; c < C::NCH; ++c)
          tma_load(s_q + c * BQ * C::SWZ, &tm_q, q_full, c * C::CW, it.q0, it.h, it.b);
        for (int t = 0; t < it.n_tiles; ++t, ++kt) {
          const int s = kt % NS;
          const uint32_t full = full0 + 8 * s;
          mbar_wait(empty0 + 8 * s, ((kt / NS) & 1) ^ 1);
          mbar_expect_tx(full, 2 * C::KV_BYTES);
          const uint32_t s_k = s_ring + s * 2 * C::KV_BYTES, s_v = s_k + C::KV_BYTES;
          const int k0 = it.k_begin + t * BK;
          for (int c = 0; c < C::NCH; ++c) {
            tma_load(s_k + c * BK * C::SWZ, &tm_k, full, c * C::CW, k0, hk, it.b);
            tma_load(s_v + c * BK * C::SWZ, &tm_v, full, c * C::CW, k0, hk, it.b);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int col = 2 * (lane % 4);  // this thread's first column in each 8-wide block
    const uint32_t s_qw = s_q + wg * 64 * C::SWZ;
    auto stage_k = [&](int kt) { return s_ring + (kt % NS) * 2 * C::KV_BYTES; };
    auto wait_full = [&](int kt) { mbar_wait(full0 + 8 * (kt % NS), (kt / NS) & 1); };
    auto release = [&](int kt) { mbar_arrive(empty0 + 8 * (kt % NS)); };

    // Both warpgroups run every tile of an item (a tile wholly masked for
    // one of them is correct, p = 0: at BK = 64 (D = 192) warpgroup 0's
    // last tile under the causal mask, or a window's leading tile).  Warpgroup 1 starts each item only
    // once warpgroup 0 has issued its first Q K^T (named barrier 1), so
    // that one's softmax runs while the other's products hold the tensor
    // cores; after that the two run free.

    float acc[D / 2], sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    uint32_t pa[BK / 16][4];
    int kt = 0;  // K/V tiles consumed so far
    for (int r = 0, n = 0;; ++r, ++n) {
      const int w = work_index(r, n_items);
      if (w < 0) break;
      const Item it = work_item<BK>(w, bh, nq, hq, sk, causal, window);
      const int r0 = it.q0 + wg * 64;             // first query row of this warpgroup
      const int row = r0 + warp * 16 + lane / 4;  // this thread's rows: row and row + 8
      const int nt = it.n_tiles;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2], rs[2];

      mbar_wait(q_full, n & 1);
      if (nt == 0) mbar_arrive(q_empty);
      if (nt > 0) {
        // first tile: S, softmax, P
        wait_full(kt);
        if (wg == 1) bar_sync<1>();
        wg_fence();
        fence_regs<BK / 2>(sc);
        issue_qk<D>(sc, s_qw, stage_k(kt));
        if (wg == 0) bar_arrive<1>();
        wg_wait<0>();
        fence_regs<BK / 2>(sc);
        if (nt == 1) mbar_arrive(q_empty);  // this item's last read of Q
        softmax_tile<BK, CAP>(sc, m, alpha, rs, it.k_begin, r0, row, col, sk, causal, window,
                              scale_log2, cap_k, cap);
#pragma unroll
        for (int q = 0; q < 2; ++q) l[q] = rs[q];
        pack_p<BK>(pa, sc);
        // steady state: S of tile t and P V of tile t - 1 in flight together;
        // the exponentials of tile t overlap the P V product
        for (int t = 1; t < nt; ++t) {
          ++kt;
          wait_full(kt);
          wg_fence();
          fence_regs<BK / 2>(sc);
          fence_regs<D / 2>(acc);
          issue_qk<D>(sc, s_qw, stage_k(kt));
          issue_pv<D>(acc, pa, stage_k(kt - 1) + C::KV_BYTES);
          wg_wait<1>();
          fence_regs<BK / 2>(sc);
          if (t == nt - 1) mbar_arrive(q_empty);
          softmax_tile<BK, CAP>(sc, m, alpha, rs, it.k_begin + t * BK, r0, row, col, sk,
                                causal, window, scale_log2, cap_k, cap);
          wg_wait<0>();
          fence_regs<D / 2>(acc);
          release(kt - 1);
#pragma unroll
          for (int q = 0; q < 2; ++q) l[q] = fmaf(l[q], alpha[q], rs[q]);
#pragma unroll
          for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
          pack_p<BK>(pa, sc);
        }
        wg_fence();
        fence_regs<D / 2>(acc);
        issue_pv<D>(acc, pa, stage_k(kt) + C::KV_BYTES);
        wg_wait<0>();
        fence_regs<D / 2>(acc);
        release(kt);
        ++kt;
      }

      // epilogue: the quad's partial row sums, then O / l in bf16, rows < Sq
      // only; the producer is already loading the next item
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        l[q] += __shfl_xor_sync(0xffffffffu, l[q], 1);
        l[q] += __shfl_xor_sync(0xffffffffu, l[q], 2);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int qi = row + 8 * q;
        if (qi >= sq) continue;
        const float denom = fmaxf(l[q], 1e-30f);
        __nv_bfloat16* orow = o + (((long long)it.b * hq + it.h) * sq + qi) * D + col;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * q] / denom, acc[4 * j + 2 * q + 1] / denom);
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// a (D, S, H, B) map over a bf16 (B, H, S, D) view with element strides
// (sb, sh, ss), boxes of `rows` x one chunk
int make_map(CUtensorMap* map, const void* ptr, int d, int s, int h, long long b, long long sb,
             long long sh, long long ss, int chunk, int rows, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)chunk, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D, bool CAP>
int launch(const void* q, const void* k, const void* v, void* o, long long b, int hq, int hkv,
           int sq, int sk, Strides qs, Strides ks, Strides vs, float scale, int causal,
           int window, float cap, cudaStream_t stream) {
  using C = Cfg<D>;
  const CUtensorMapSwizzle swz =
      C::SWZ == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap mq, mk, mv;
  int e = make_map(&mq, q, D, sq, hq, b, qs.b, qs.h, qs.s, C::CW, BQ, swz);
  if (e == 0) e = make_map(&mk, k, D, sk, hkv, b, ks.b, ks.h, ks.s, C::CW, C::BK, swz);
  if (e == 0) e = make_map(&mv, v, D, sk, hkv, b, vs.b, vs.h, vs.s, C::CW, C::BK, swz);
  if (e != 0) return e;
  // the smem attribute and the SM count, once per instantiation and device
  // (each host call costs microseconds)
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64) return (int)cudaErrorInvalidDevice;
  static unsigned long long smem_set = 0;
  static int sms[64] = {0};
  if (!((smem_set >> device) & 1ull)) {
    err = cudaFuncSetAttribute(flash_fwd_tc<D, CAP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set |= 1ull << device;
  }
  if (sms[device] == 0) {
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
  }
  // persistent: one block per SM (no second one fits), each walking its items
  const int nq = (sq + BQ - 1) / BQ;
  const long long n_items = (long long)nq * hq * b;
  if (n_items > (1ll << 30)) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(n_items < sms[device] ? n_items : sms[device]);
  // capped, the scale goes into the tanh's argument and the exponentials
  // fold log2(e) alone
  flash_fwd_tc<D, CAP><<<blocks, NTHREADS, C::SMEM, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, hq, hq / hkv, sq, sk, nq, (int)n_items,
      CAP ? LOG2E : scale * LOG2E, causal, window, CAP ? scale / cap : 0.f, cap);
  return (int)cudaGetLastError();
}

template <int D>
int launch_cap(const void* q, const void* k, const void* v, void* o, long long b, int hq,
               int hkv, int sq, int sk, Strides qs, Strides ks, Strides vs, float scale,
               int causal, int window, float cap, cudaStream_t s) {
  if (cap > 0.f)
    return launch<D, true>(q, k, v, o, b, hq, hkv, sq, sk, qs, ks, vs, scale, causal, window, cap, s);
  return launch<D, false>(q, k, v, o, b, hq, hkv, sq, sk, qs, ks, vs, scale, causal, window, cap, s);
}

int launch_d(int d, const void* q, const void* k, const void* v, void* o, long long b, int hq,
             int hkv, int sq, int sk, Strides qs, Strides ks, Strides vs, float scale,
             int causal, int window, float cap, cudaStream_t s) {
  switch (d) {
    case 32: return launch_cap<32>(q, k, v, o, b, hq, hkv, sq, sk, qs, ks, vs, scale, causal, window, cap, s);
    case 64: return launch_cap<64>(q, k, v, o, b, hq, hkv, sq, sk, qs, ks, vs, scale, causal, window, cap, s);
    case 128: return launch_cap<128>(q, k, v, o, b, hq, hkv, sq, sk, qs, ks, vs, scale, causal, window, cap, s);
    case 192: return launch_cap<192>(q, k, v, o, b, hq, hkv, sq, sk, qs, ks, vs, scale, causal, window, cap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (SIMT kernel, head dim 16, 32, 48, 64, 128 or 192),
// 1 = bfloat16 (tensor-core kernel, head dim 32, 64, 128 or 192: its TMA
// boxes and swizzles need rows of at least 64 bytes in whole boxes); window
// <= 0 means none, and so does softcap <= 0.  Strides are in elements; for
// bfloat16 the base addresses and every stride times 2 bytes must be
// multiples of 16 (TMA).  Returns cudaGetLastError() (or the error met
// encoding the tensor maps).
extern "C" int launch_flash_attention(const void* q, const void* k, const void* v, void* o,
                                      long long b, int hq, int hkv, int sq, int sk, int d,
                                      long long qsb, long long qsh, long long qss,
                                      long long ksb, long long ksh, long long kss,
                                      long long vsb, long long vsh, long long vss, float scale,
                                      int causal, int window, float softcap, int dtype,
                                      void* stream) {
  if (b <= 0 || sq <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(d, q, k, v, o, b, hq, hkv, sq, sk, qs, ks, vs, scale, causal, window,
                           softcap, s);
  if (dtype == 1)
    return tc::launch_d(d, q, k, v, o, b, hq, hkv, sq, sk, qs, ks, vs, scale, causal, window,
                        softcap, s);
  return (int)cudaErrorInvalidValue;
}
