// K7: Mamba-2 SSD chunked scan for Hopper (sm_90a), parallel over chunks.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py:86
// `ssd_scan_kernel` (pallas_call at :106).  x (B, L, H, P), dt (B, L, H),
// a (H,) float32 and negative, B and C (B, L, G, N), head h reading group
// h / (H / G).  The inputs are read through their strides (the last
// dimension must be contiguous), so the prefill's split and reshaped views
// cross without a copy.  Returns y (B, L, H, P) in x's dtype and the final
// state (B, H, P, N) float32.  Any L: the ragged last chunk loads dt = 0 and
// x = B = C = 0 for its missing steps (exact no-ops for the state), and its
// rows of y are not written.
//
// The TPU grid walks the chunks of one (batch, head) in order and carries
// the (P, N) state in VMEM.  Here the chunk's work is split as the chunked
// SSD splits it (kernels/ref.py, ssd_chunk_states_ref / ssd_state_scan_ref
// / ssd_chunk_output_ref), into three launches:
//   (a) ssd_chunk_state_kernel, one block per (chunk, head, batch):
//       cum = cumsum(dt·a) (a warp scan), w_s = dt_s·exp(cum_last − cum_s),
//       the chunk-local state S = (w∘X)ᵀ·B (P × N) and exp(cum_last);
//   (b) ssd_state_scan_kernel, one thread per (batch, head, p, n), walking
//       the chunks in order: h_in(z) = h, h = exp(cum_last(z))·h + S(z),
//       written over S(z) in place; the last h is the final state;
//   (c) ssd_chunk_output_kernel, one block per (chunk, head, batch):
//       G = (C·Bᵀ) ∘ exp(cum_l − cum_s)·dt_s on s <= l, and
//       y = G·X + exp(cum_l)·(C·h_inᵀ).
// The chunk is 64 steps whatever the model's chunk (the recurrence is the
// same for every chunk length): 16 × 32 = 512 blocks a pass at L = 1000 and
// Mamba2-370m's 32 heads, against one block per (batch, head) before.
// Every exponent is a difference inside one chunk or a cum itself, so all
// are <= 0: exp(cum_l − cum_s) is never formed as exp(cum_l)·exp(−cum_s),
// which overflows once a chunk's decay passes e^88 (dt 0.1, A −16: e^102).
//
// Products.  Every product is a warp tile of m16n8k16 shapes (warp_mma):
// for bf16 inputs on the tensor cores (mma.sync, bf16 operands), for f32
// inputs on FMAs at the same fragment positions.  C·Bᵀ multiplies two
// bf16 inputs.  G, w∘X and h_in are f32, so each is split into three bf16
// terms, each the rounding of what the ones before leave (the f32 value
// exactly, as a rule), and multiplied once per term.
//
// Precision.  bf16 y must round as the f32 plain version's does wherever
// |y| nears max |y|: the check is 2^-8·(1 + max |y|), one bf16 ulp there,
// and Mamba2-370m's prefill inputs hold an element 1.4e-7 (relative) above
// a bf16 rounding midpoint.  So the kernel is held to better than f32
// accuracy, counted on the card as bf16 outputs that round otherwise than
// an f64 oracle's (tools/k7_accuracy.py): per 2.05 M outputs at L = 1000,
// 109-145 against 540-616 for the f32-FMA kernel this replaces and
// 1,654-2,085 for the plain version.  What it takes:
//   - cum in f64: exponents are differences of cums (|cum| reaches ~100);
//   - three bf16 terms per f32 operand (two leave G carrying most of the
//     error);
//   - the tensor cores truncate the f32 sums they form, so a product sums
//     each k-step in fresh f32 partials, one for the leading bf16 term and
//     one for the small terms, joined by a rounded f32 add and added in f64
//     (add_partials);
//   - G's scale (C·Bᵀ)·exp(cum_l − cum_s)·dt_s, exp(cum_l), y's final
//     combine and the scan's carried state in f64.
//
// Staging.  A block copies its chunk's x, B and C rows (and in pass (c)
// its f32 h_in) into shared memory as they lie in memory, rows padded by
// 16 bytes, with 16-byte cp.async copies all in flight at once while the
// block computes its cumsum (where every row is 16-byte aligned and a
// multiple of 16 bytes long; else one element an access through
// registers).  Fragments whose contraction index runs along a row (C, B in
// C·Bᵀ, G, h_in) are 32-bit (64-bit for f32 h_in) loads; those whose
// contraction index runs down the rows (x, and B in the chunk-local state)
// come through ldmatrix.trans.  w∘X and h_in are scaled and split in
// registers as their fragments are loaded; G is split as it is stored.
// P and N are padded to multiples of 32 with zeros.
//
// Bound on the H100: bytes (x, dt, B, C read once, y and the final state
// written once: 5.7 µs at Mamba2-370m's prefill of 2,048 steps); the
// model-chunk operations at the bf16 tensor rate take 2.6 µs.  The passes
// also move the chunk states (B·H·nc·P·N floats: 34 MB at L = 2048)
// through L2 three times.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int T = 64;           // steps per chunk
constexpr int NT = 256;         // threads of a chunk block (8 warps)
constexpr int NW = NT / 32;
constexpr int CB = 32;          // output columns of one warp item (4 n-tiles)
constexpr int NJ = CB / 8;
constexpr int STAGE_U = 4;      // global loads in flight per thread while staging
constexpr int SCAN_NT = 256;    // threads of a scan block
constexpr int SCAN_BATCH = 8;   // chunk states loaded ahead in the scan
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, double v) { *p = (float)v; }
__device__ __forceinline__ void st(bf16* p, double v) { *p = __double2bfloat16(v); }

struct Strides {
  long long b, l, h;  // batch, step, head (or group)
};

__host__ __device__ constexpr int round32(int v) { return (v + 31) & ~31; }

// Operand element in shared memory: bf16 (tensor cores) for bf16 inputs,
// float (FMAs) for float32 inputs; SPLIT arrays hold G (hi, mid and lo).
template <typename TX> struct Op {
  using E = float;
  static constexpr int SPLIT = 1;
};
template <> struct Op<bf16> {
  using E = bf16;
  static constexpr int SPLIT = 3;
};

// Row pitch (elements) of an operand tile with k (a multiple of 32) elements
// a row: 16 bytes of padding, so the 8 rows of an ldmatrix phase and the
// 8 rows x 4 words of a 32-bit fragment load fall in distinct banks.
template <typename E> __host__ __device__ constexpr int ldk(int k) {
  return k + 16 / (int)sizeof(E);
}

// -- global -> shared -----------------------------------------------------

__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Copies rows [0, rows) x columns [0, cols) of a global matrix (row stride
// rs) into shared memory (row pitch ld) as they lie, with zeros where
// row >= rows_valid or col >= cols_valid (the padding).  VEC: 16-byte
// cp.async copies, in flight until cp_wait_all (every row 16-byte aligned,
// cols_valid a multiple of 16 bytes); else one element an access through
// registers, STAGE_U in flight per thread.
template <bool VEC, typename E>
__device__ __forceinline__ void copy_tile(E* dst, int ld, const E* __restrict__ g, long long rs,
                                          int rows_valid, int rows, int cols_valid, int cols) {
  if constexpr (VEC) {
    constexpr int VE = 16 / sizeof(E);
    const int vr = cols / VE;
    for (int i = threadIdx.x; i < rows * vr; i += NT) {
      const int r = i / vr, c = (i - r * vr) * VE;
      const bool in = r < rows_valid && c < cols_valid;
      cp16(dst + r * ld + c, in ? g + r * rs + c : g, in);
    }
  } else {
    for (int i0 = threadIdx.x; i0 < rows * cols; i0 += STAGE_U * NT) {
      E v[STAGE_U];
#pragma unroll
      for (int u = 0; u < STAGE_U; ++u) {
        const int i = i0 + u * NT, r = i / cols, c = i - r * cols;
        v[u] = i < rows * cols && r < rows_valid && c < cols_valid ? g[r * rs + c] : E(0.f);
      }
#pragma unroll
      for (int u = 0; u < STAGE_U; ++u) {
        const int i = i0 + u * NT, r = i / cols;
        if (i < rows * cols) dst[r * ld + (i - r * cols)] = v[u];
      }
    }
  }
}

// -- warp products -------------------------------------------------------

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The tensor cores truncate the f32 sums they form.  So each product sums a
// k-step's 16 terms in fresh f32 partials, one for an operand's leading
// bf16 term and one for its small terms (which a sum at the leading term's
// scale would truncate), joins them with a rounded f32 add, and adds that
// to acc in double.
__device__ __forceinline__ void add_partials(double (&acc)[NJ][4], const float (&hi)[NJ][4],
                                             const float (&lo)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] += hi[j][q] + lo[j][q];
}

// An f32 pair as three bf16 pairs t[0] + t[1] + t[2], each the rounding
// of what the ones before leave (the f32 value exactly, as a rule).
__device__ __forceinline__ void split3(float x, float y, uint32_t (&t)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 f = __bfloat1622float2(h);
    t[i] = *reinterpret_cast<const uint32_t*>(&h);
    x -= f.x;
    y -= f.y;
  }
}

// G as three bf16 terms (each the rounding of what the ones before leave),
// in arrays `stride` apart; a float tile keeps G itself.
__device__ __forceinline__ void put_g(bf16* g, int stride, float v) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const bf16 r = __float2bfloat16_rn(v);
    g[i * stride] = r;
    v -= __bfloat162float(r);
  }
}
__device__ __forceinline__ void put_g(float* g, int, float v) { *g = v; }

// The B fragments of n-tiles n0 + 8j, j < NJ, at k0: from Bm stored [n][k]
// (32-bit loads) or, BT, [k][n] (ldmatrix.trans).
template <bool BT>
__device__ __forceinline__ void b_frags(uint32_t (&b)[NJ][2], const bf16* Bm, int ldb, int n0,
                                        int k0, int lane) {
  const int g = lane >> 2, t = lane & 3, q = lane >> 3, r = lane & 7;
#pragma unroll
  for (int j = 0; j < NJ; j += 2) {
    if (BT) {
      uint32_t f[4];
      ldsm_x4_t(f, Bm + (k0 + r + 8 * (q & 1)) * ldb + n0 + 8 * j + 8 * (q >> 1));
      b[j][0] = f[0];
      b[j][1] = f[1];
      b[j + 1][0] = f[2];
      b[j + 1][1] = f[3];
    } else {
#pragma unroll
      for (int jj = j; jj < j + 2; ++jj) {
        const bf16* bp = Bm + (n0 + 8 * jj + g) * ldb + k0 + 2 * t;
        b[jj][0] = ld32(bp);
        b[jj][1] = ld32(bp + 8);
      }
    }
  }
}

// acc[j] += Σ_e A_e(m0 + [0, 16), [0, K)) · B(n0 + 8j + [0, 8), [0, K))ᵀ
// over the `terms` arrays A_e, a_stride elements apart (an operand split
// into bf16 terms); K a multiple of 16.  A is stored [m][k] (pitch lda), B
// [n][k] or, BT, [k][n] (pitch ldb).  Lane (g = lane/4, t = lane%4) holds
// acc[j] at rows m0 + g, m0 + g + 8 and columns n0 + 8j + 2t, n0 + 8j + 2t + 1
// (the m16n8 accumulator layout).
template <bool BT>
__device__ __forceinline__ void warp_mma(double (&acc)[NJ][4], const bf16* A, int lda,
                                         int a_stride, int terms, const bf16* Bm, int ldb,
                                         int m0, int n0, int K, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t b[NJ][2];
    b_frags<BT>(b, Bm, ldb, n0, k0, lane);
    float hi[NJ][4] = {}, lo[NJ][4] = {};
    for (int e = 0; e < terms; ++e) {
      const bf16* ap = A + e * a_stride + (m0 + g) * lda + k0 + 2 * t;
      const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * lda), ld32(ap + 8), ld32(ap + 8 * lda + 8)};
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma16816(e ? lo[j] : hi[j], a, b[j]);
    }
    add_partials(acc, hi, lo);
  }
}

// The chunk-local state's product, (w∘X)ᵀ·B: X stored [k][m] (k the step,
// m the head's column p), its fragments through ldmatrix.trans, scaled by
// w_k and split into three bf16 terms in registers; B stored [k][n].
__device__ __forceinline__ void warp_mma_wx(double (&acc)[NJ][4], const bf16* X, int ldx,
                                            const float* w, const bf16* Bm, int ldb, int m0,
                                            int n0, int K, int lane) {
  const int t = lane & 3, q = lane >> 3, r = lane & 7;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t xr[4], at[3][4];
    ldsm_x4_t(xr, X + (k0 + r + 8 * (q >> 1)) * ldx + m0 + 8 * (q & 1));
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // registers 0, 1 hold steps k0 + 2t (+1), 2, 3 eight on
      const int k = k0 + 2 * t + 8 * (i >> 1);
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr[i]));
      uint32_t s3[3];
      split3(f.x * w[k], f.y * w[k + 1], s3);
#pragma unroll
      for (int e = 0; e < 3; ++e) at[e][i] = s3[e];
    }
    uint32_t b[NJ][2];
    b_frags<true>(b, Bm, ldb, n0, k0, lane);
    float hi[NJ][4] = {}, lo[NJ][4] = {};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mma16816(hi[j], at[0], b[j]);
      mma16816(lo[j], at[1], b[j]);
      mma16816(lo[j], at[2], b[j]);
    }
    add_partials(acc, hi, lo);
  }
}

// C·h_inᵀ with h_in f32 in shared memory ([n][k], pitch ldh): its
// fragments are read as f32 pairs and split into three bf16 terms in
// registers.
__device__ __forceinline__ void warp_mma_hf(double (&acc)[NJ][4], const bf16* A, int lda,
                                            const float* Hf, int ldh, int m0, int n0, int K,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 16) {
    const bf16* ap = A + (m0 + g) * lda + k0 + 2 * t;
    const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * lda), ld32(ap + 8), ld32(ap + 8 * lda + 8)};
    float hi[NJ][4] = {}, lo[NJ][4] = {};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* hp = Hf + (n0 + 8 * j + g) * ldh + k0 + 2 * t;
      const float2 f0 = *reinterpret_cast<const float2*>(hp);
      const float2 f1 = *reinterpret_cast<const float2*>(hp + 8);
      uint32_t s0[3], s1[3];
      split3(f0.x, f0.y, s0);
      split3(f1.x, f1.y, s1);
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const uint32_t bt[2] = {s0[e], s1[e]};
        mma16816(e ? lo[j] : hi[j], a, bt);
      }
    }
    add_partials(acc, hi, lo);
  }
}

// The same three products on f32 FMAs for float32 inputs, at the same
// fragment positions: A(m, k)·B(n, k) with B [n][k] or, BT, [k][n];
// the state's product with A(m, k) = w_k X[k][m]; C·h_inᵀ from float h_in.
template <bool BT>
__device__ __forceinline__ void warp_mma(double (&acc)[NJ][4], const float* A, int lda,
                                         int a_stride, int terms, const float* Bm, int ldb,
                                         int m0, int n0, int K, int lane) {
  const int m = m0 + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    for (int i = 0; i < terms * K; ++i) {
      const int k = i % K;
      const float* ae = A + (i / K) * a_stride;
      const float a0 = ae[m * lda + k], a1 = ae[(m + 8) * lda + k];
      const float b0 = BT ? Bm[k * ldb + n] : Bm[n * ldb + k];
      const float b1 = BT ? Bm[k * ldb + n + 1] : Bm[(n + 1) * ldb + k];
      acc[j][0] = fma((double)a0, (double)b0, acc[j][0]);
      acc[j][1] = fma((double)a0, (double)b1, acc[j][1]);
      acc[j][2] = fma((double)a1, (double)b0, acc[j][2]);
      acc[j][3] = fma((double)a1, (double)b1, acc[j][3]);
    }
  }
}

__device__ __forceinline__ void warp_mma_wx(double (&acc)[NJ][4], const float* X, int ldx,
                                            const float* w, const float* Bm, int ldb, int m0,
                                            int n0, int K, int lane) {
  const int m = m0 + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    for (int k = 0; k < K; ++k) {
      const double a0 = w[k] * X[k * ldx + m], a1 = w[k] * X[k * ldx + m + 8];
      acc[j][0] = fma(a0, (double)Bm[k * ldb + n], acc[j][0]);
      acc[j][1] = fma(a0, (double)Bm[k * ldb + n + 1], acc[j][1]);
      acc[j][2] = fma(a1, (double)Bm[k * ldb + n], acc[j][2]);
      acc[j][3] = fma(a1, (double)Bm[k * ldb + n + 1], acc[j][3]);
    }
  }
}

__device__ __forceinline__ void warp_mma_hf(double (&acc)[NJ][4], const float* A, int lda,
                                            const float* Hf, int ldh, int m0, int n0, int K,
                                            int lane) {
  warp_mma<false>(acc, A, lda, 0, 1, Hf, ldh, m0, n0, K, lane);
}

__device__ __forceinline__ void zero(double (&acc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0;
}

// dt of the chunk (0 past L) and cum = cumsum(dt·a) by one warp, two steps
// a lane, in float64: every exponent is a difference of two cums or a cum,
// and f32 prefix sums would carry ~2^-24·|cum| of error into each
// difference (|cum| reaches ~100 in a chunk).  Every block of a chunk
// computes the same values.
template <typename TD>
__device__ __forceinline__ void chunk_cumsum(const TD* __restrict__ db, long long dsl, int tl,
                                             float ah, float* sDt, double* sCum) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < T) sDt[tid] = tid < tl ? ld(db + (long long)tid * dsl) : 0.f;
  __syncthreads();
  if (tid < 32) {
    const double a0 = (double)sDt[2 * lane] * ah, a1 = (double)sDt[2 * lane + 1] * ah;
    double s = a0 + a1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double o = __shfl_up_sync(FULL, s, off);
      if (lane >= off) s += o;
    }
    double excl = __shfl_up_sync(FULL, s, 1);
    if (lane == 0) excl = 0.0;
    sCum[2 * lane] = excl + a0;
    sCum[2 * lane + 1] = excl + a0 + a1;
  }
  __syncthreads();
}

// Shared memory of the two chunk kernels: T doubles (the cumsum, and in
// pass (c) exp(cum)) and T or 2 x T floats, then the tiles.
template <typename TX> size_t state_smem(int p, int n) {
  using E = typename Op<TX>::E;
  const int lp = ldk<E>(round32(p)), ln = ldk<E>(round32(n));
  return T * (sizeof(double) + 2 * sizeof(float)) +
         sizeof(E) * ((size_t)T * lp + (size_t)T * ln);
}

template <typename TX> size_t output_smem(int p, int n) {
  using E = typename Op<TX>::E;
  const int pp = round32(p), np = round32(n);
  const int lp = ldk<E>(pp), ln = ldk<E>(np), lt = ldk<E>(T);
  return T * (2 * sizeof(double) + sizeof(float)) +
         sizeof(E) * (2 * (size_t)T * ln + (size_t)T * lp + (size_t)Op<TX>::SPLIT * T * lt) +
         sizeof(float) * (size_t)pp * (np + 8);
}

// (a) the chunk-local state S[p][n] = Σ_s w_s x[s][p] B[s][n] and the
// chunk's decay exp(cum_last), into states[b][h][z] and decay[b][h][z].
template <typename TX, typename TD, bool VEC>
__global__ void __launch_bounds__(NT)
ssd_chunk_state_kernel(const TX* __restrict__ x, const TD* __restrict__ dt,
                       const float* __restrict__ a, const TX* __restrict__ bm,
                       float* __restrict__ states, float* __restrict__ decay, int L, int H,
                       int G, int P, int N, Strides xs, Strides ds, Strides bs) {
  using E = typename Op<TX>::E;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pp = round32(P), np = round32(N), lp = ldk<E>(pp), ln = ldk<E>(np);
  double* sCum = reinterpret_cast<double*>(smem);
  float* sW = reinterpret_cast<float*>(sCum + T);  // w_s = dt_s·exp(cum_last − cum_s)
  float* sDt = sW + T;
  E* sX = reinterpret_cast<E*>(sDt + T);  // [T][lp]: x
  E* sB = sX + T * lp;                    // [T][ln]: B

  const int z = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = z * T, tl = min(T, L - t0);
  copy_tile<VEC>(sX, lp, reinterpret_cast<const E*>(x) + b * xs.b + (long long)h * xs.h +
                 (long long)t0 * xs.l, xs.l, tl, T, P, pp);
  copy_tile<VEC>(sB, ln, reinterpret_cast<const E*>(bm) + b * bs.b + (long long)g * bs.h +
                 (long long)t0 * bs.l, bs.l, tl, T, N, np);
  chunk_cumsum(dt + b * ds.b + (long long)h * ds.h + (long long)t0 * ds.l, ds.l, tl, a[h], sDt,
               sCum);
  const double cum_last = sCum[T - 1];
  if (tid < T) sW[tid] = (float)(sDt[tid] * exp(cum_last - sCum[tid]));
  if (tid == 0) decay[((long long)b * H + h) * nc + z] = (float)exp(cum_last);
  if (VEC) cp_wait_all();
  __syncthreads();

  float* out = states + (((long long)b * H + h) * nc + z) * P * N;
  const int g8 = lane >> 2, t2 = 2 * (lane & 3);
  for (int item = warp; item < (pp / 16) * (np / CB); item += NW) {
    const int m0 = (item % (pp / 16)) * 16, n0 = (item / (pp / 16)) * CB;
    double acc[NJ][4];
    zero(acc);
    warp_mma_wx(acc, sX, lp, sW, sB, ln, m0, n0, T, lane);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = m0 + g8 + 8 * (q >> 1), n = n0 + 8 * j + t2 + (q & 1);
        if (p < P && n < N) out[p * N + n] = (float)acc[j][q];
      }
  }
}

// (b) h_in(z) over S(z) in place, in chunk order, and the final state; V
// consecutive elements a thread (4 when P·N % 4 == 0).
template <int V>
__global__ void __launch_bounds__(SCAN_NT)
ssd_state_scan_kernel(float* __restrict__ states, const float* __restrict__ decay,
                      float* __restrict__ hfin, int nc, long long pn, long long total) {
  using F = typename std::conditional<V == 4, float4, float>::type;
  const long long i = ((long long)blockIdx.x * SCAN_NT + threadIdx.x) * V;
  if (i >= total) return;
  const long long bh = i / pn;
  F* s = reinterpret_cast<F*>(states + bh * nc * pn + (i - bh * pn));
  const long long step = pn / V;
  const float* dz = decay + bh * nc;
  double h[V];  // the carried state in double, rounded once as each h_in is stored
#pragma unroll
  for (int e = 0; e < V; ++e) h[e] = 0.0;
  for (int z0 = 0; z0 < nc; z0 += SCAN_BATCH) {
    F v[SCAN_BATCH];
#pragma unroll
    for (int u = 0; u < SCAN_BATCH; ++u)
      if (z0 + u < nc) v[u] = s[(z0 + u) * step];
#pragma unroll
    for (int u = 0; u < SCAN_BATCH; ++u)
      if (z0 + u < nc) {
        const float* vf = reinterpret_cast<const float*>(&v[u]);
        F out;
        float* of = reinterpret_cast<float*>(&out);
        const float d = dz[z0 + u];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          of[e] = (float)h[e];
          h[e] = h[e] * d + vf[e];
        }
        s[(z0 + u) * step] = out;
      }
  }
  F fin;
#pragma unroll
  for (int e = 0; e < V; ++e) reinterpret_cast<float*>(&fin)[e] = (float)h[e];
  *reinterpret_cast<F*>(hfin + i) = fin;
}

// (c) y of the chunk from its inputs and h_in(z) (states[b][h][z]).
template <typename TX, typename TD, bool VEC>
__global__ void __launch_bounds__(NT)
ssd_chunk_output_kernel(const TX* __restrict__ x, const TD* __restrict__ dt,
                        const float* __restrict__ a, const TX* __restrict__ bm,
                        const TX* __restrict__ cm, const float* __restrict__ states,
                        TX* __restrict__ y, int L, int H, int G, int P, int N, Strides xs,
                        Strides ds, Strides bs, Strides cs) {
  using E = typename Op<TX>::E;
  constexpr int S = Op<TX>::SPLIT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pp = round32(P), np = round32(N);
  const int lp = ldk<E>(pp), ln = ldk<E>(np), lt = ldk<E>(T), lh = np + 8;
  double* sCum = reinterpret_cast<double*>(smem);
  double* sEc = sCum + T;                  // exp(cum_l)
  float* sDt = reinterpret_cast<float*>(sEc + T);
  E* sC = reinterpret_cast<E*>(sDt + T);   // [T][ln]: C
  E* sB = sC + T * ln;                     // [T][ln]: B
  E* sX = sB + T * ln;                     // [T][lp]: x
  E* sG = sX + T * lp;                     // S x [T][lt]: G (hi, mid, lo)
  float* sH = reinterpret_cast<float*>(sG + S * T * lt);  // [pp][lh]: h_in

  const int z = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = z * T, tl = min(T, L - t0);
  const E* xe = reinterpret_cast<const E*>(x);
  const E* be = reinterpret_cast<const E*>(bm);
  const E* ce = reinterpret_cast<const E*>(cm);
  copy_tile<VEC>(sC, ln, ce + b * cs.b + (long long)g * cs.h + (long long)t0 * cs.l, cs.l, tl, T,
                 N, np);
  copy_tile<VEC>(sB, ln, be + b * bs.b + (long long)g * bs.h + (long long)t0 * bs.l, bs.l, tl, T,
                 N, np);
  copy_tile<VEC>(sX, lp, xe + b * xs.b + (long long)h * xs.h + (long long)t0 * xs.l, xs.l, tl, T,
                 P, pp);
  const bool has_state = z > 0;  // h_in(0) = 0
  if (has_state)
    copy_tile<VEC>(sH, lh, states + (((long long)b * H + h) * nc + z) * P * N, N, P, pp, N, np);
  chunk_cumsum(dt + b * ds.b + (long long)h * ds.h + (long long)t0 * ds.l, ds.l, tl, a[h], sDt,
               sCum);
  if (tid < T) sEc[tid] = exp(sCum[tid]);
  if (VEC) cp_wait_all();
  __syncthreads();

  const int g8 = lane >> 2, t2 = 2 * (lane & 3);
  // G = (C·Bᵀ) ∘ exp(cum_l − cum_s)·dt_s on s <= l: (T/16) x (T/CB) = 8 items
  for (int item = warp; item < (T / 16) * (T / CB); item += NW) {
    const int m0 = (item % (T / 16)) * 16, n0 = (item / (T / 16)) * CB;
    double acc[NJ][4];
    zero(acc);
    if (n0 <= m0 + 15) warp_mma<false>(acc, sC, ln, 0, 1, sB, ln, m0, n0, np, lane);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int l = m0 + g8 + 8 * (q >> 1), s = n0 + 8 * j + t2 + (q & 1);
        const float v = s <= l ? (float)(acc[j][q] * expf((float)(sCum[l] - sCum[s])) * sDt[s])
                               : 0.f;
        put_g(sG + l * lt + s, T * lt, v);
      }
  }
  __syncthreads();

  // y = G·X + exp(cum_l)·(C·h_inᵀ): (T/16) x (pp/CB) items
  TX* yb = y + ((long long)b * L + t0) * H * P + (long long)h * P;  // y contiguous (B, L, H, P)
  for (int item = warp; item < (T / 16) * (pp / CB); item += NW) {
    const int m0 = (item % (T / 16)) * 16, n0 = (item / (T / 16)) * CB;
    double acc[NJ][4];
    zero(acc);
    if (has_state) {  // exp(cum_l)·(C·h_inᵀ) first, then G·X added to it
      warp_mma_hf(acc, sC, ln, sH, lh, m0, n0, np, lane);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] *= sEc[m0 + g8 + 8 * (q >> 1)];
    }
    // G is zero past the diagonal: rows m0..m0+15 need s < m0 + 16 only
    warp_mma<true>(acc, sG, lt, T * lt, S, sX, lp, m0, n0, m0 + 16, lane);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int l = m0 + g8 + 8 * (q >> 1), p = n0 + 8 * j + t2 + (q & 1);
        if (l < tl && p < P) st(yb + (long long)l * H * P + p, acc[j][q]);
      }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename TX, typename TD, bool VEC>
int launch_passes(const void* x, const void* dt, const float* a, const void* bm, const void* cm,
                  void* y, float* hfin, float* states, float* decay, int bsz, int L, int H,
                  int G, int P, int N, Strides xs, Strides ds, Strides bs, Strides cs,
                  cudaStream_t stream) {
  const long long pn = (long long)P * N, total = (long long)bsz * H * pn;
  const int nc = (L + T - 1) / T;
  const size_t sm_a = state_smem<TX>(P, N), sm_c = output_smem<TX>(P, N);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_state_kernel<TX, TD, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm_a);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_chunk_output_kernel<TX, TD, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm_c);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)nc, (unsigned)H, (unsigned)bsz);
  ssd_chunk_state_kernel<TX, TD, VEC><<<grid, NT, sm_a, stream>>>(
      (const TX*)x, (const TD*)dt, a, (const TX*)bm, states, decay, L, H, G, P, N, xs, ds, bs);
  if (pn % 4 == 0)
    ssd_state_scan_kernel<4><<<(unsigned)((total / 4 + SCAN_NT - 1) / SCAN_NT), SCAN_NT, 0,
                               stream>>>(states, decay, hfin, nc, pn, total);
  else
    ssd_state_scan_kernel<1><<<(unsigned)((total + SCAN_NT - 1) / SCAN_NT), SCAN_NT, 0,
                               stream>>>(states, decay, hfin, nc, pn, total);
  ssd_chunk_output_kernel<TX, TD, VEC><<<grid, NT, sm_c, stream>>>(
      (const TX*)x, (const TD*)dt, a, (const TX*)bm, (const TX*)cm, states, (TX*)y, L, H, G, P,
      N, xs, ds, bs, cs);
  return (int)cudaGetLastError();
}

// cp.async staging where every row read (x, B, C and the chunk states)
// starts 16-byte aligned and holds a multiple of 16 bytes; else one element
// an access.
template <typename TX, typename TD>
int launch(const void* x, const void* dt, const float* a, const void* bm, const void* cm,
           void* y, float* hfin, float* states, float* decay, int bsz, int L, int H, int G,
           int P, int N, Strides xs, Strides ds, Strides bs, Strides cs, cudaStream_t stream) {
  if (L == 0)
    return (int)cudaMemsetAsync(hfin, 0, sizeof(float) * bsz * H * P * N, stream);
  constexpr int VE = 16 / sizeof(TX);
  bool vec = P % VE == 0 && N % VE == 0 && aligned16(x) && aligned16(bm) && aligned16(cm);
  const long long strides[] = {xs.b, xs.l, xs.h, bs.b, bs.l, bs.h, cs.b, cs.l, cs.h};
  for (long long v : strides) vec = vec && v % VE == 0;
  return vec ? launch_passes<TX, TD, true>(x, dt, a, bm, cm, y, hfin, states, decay, bsz, L, H,
                                           G, P, N, xs, ds, bs, cs, stream)
             : launch_passes<TX, TD, false>(x, dt, a, bm, cm, y, hfin, states, decay, bsz, L, H,
                                            G, P, N, xs, ds, bs, cs, stream);
}

}  // namespace

// Shared memory of the larger of the two chunk kernels, for x_dtype
// 0 = float32, 1 = bfloat16.
extern "C" long long ssd_scan_smem_bytes(int p, int n, int x_dtype) {
  const size_t a = x_dtype ? state_smem<bf16>(p, n) : state_smem<float>(p, n);
  const size_t c = x_dtype ? output_smem<bf16>(p, n) : output_smem<float>(p, n);
  return (long long)(a > c ? a : c);
}

// x_dtype (x, B, C, y) and dt_dtype: 0 = float32, 1 = bfloat16.  Strides in
// elements, (batch, step, head-or-group) of x, dt, B, C.  states is scratch
// of B·H·ceil(L/64)·P·N floats, decay of B·H·ceil(L/64).  Returns the first
// error of the three launches (cudaGetLastError()).
extern "C" int launch_ssd_scan(const void* x, const void* dt, const void* a, const void* bm,
                               const void* cm, void* y, void* hfin, void* states, void* decay,
                               int bsz, int L, int H, int G, int P, int N, long long xsb,
                               long long xsl, long long xsh, long long dsb, long long dsl,
                               long long dsh, long long bsb, long long bsl, long long bsg,
                               long long csb, long long csl, long long csg, int x_dtype,
                               int dt_dtype, void* stream) {
  if (bsz <= 0 || H <= 0) return 0;
  if (G <= 0 || H % G != 0 || P <= 0 || N <= 0 || L < 0 || bsz > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides xs{xsb, xsl, xsh}, ds{dsb, dsl, dsh}, bs{bsb, bsl, bsg}, cs{csb, csl, csg};
  cudaStream_t s = (cudaStream_t)stream;
  const float* af = (const float*)a;
  float *hf = (float*)hfin, *sts = (float*)states, *dec = (float*)decay;
  if (x_dtype == 0 && dt_dtype == 0)
    return launch<float, float>(x, dt, af, bm, cm, y, hf, sts, dec, bsz, L, H, G, P, N, xs, ds,
                                bs, cs, s);
  if (x_dtype == 1 && dt_dtype == 1)
    return launch<bf16, bf16>(x, dt, af, bm, cm, y, hf, sts, dec, bsz, L, H, G, P, N, xs, ds,
                              bs, cs, s);
  if (x_dtype == 1 && dt_dtype == 0)
    return launch<bf16, float>(x, dt, af, bm, cm, y, hf, sts, dec, bsz, L, H, G, P, N, xs, ds,
                               bs, cs, s);
  if (x_dtype == 0 && dt_dtype == 1)
    return launch<float, bf16>(x, dt, af, bm, cm, y, hf, sts, dec, bsz, L, H, G, P, N, xs, ds,
                               bs, cs, s);
  return (int)cudaErrorInvalidValue;
}
