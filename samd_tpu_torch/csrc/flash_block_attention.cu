// Verify-block attention for Hopper (sm_90a): batch 1 over a dense cache,
// or batched straight over a shared page pool.
//
// Dense mode replaces the two Pallas TPU kernels behind
// samd_tpu/ops/pallas_attention.py:flash_block_attention:
//   K1  _kernel         (pallas_attention.py:49), used when KH < 8;
//   K2  _kernel_foldkv  (pallas_attention.py:171), used when KH >= 8.
// Both compute the same function, which this one kernel computes for every
// KH: T draft rows attend the live prefix [0, kv_limit) of a [KH, S, D]
// cache, with an online softmax in f32.
//
// Paged mode replaces the Pallas TPU kernel behind
// samd_tpu/ops/paged_attention.py:paged_block_attention:
//   K4  _paged_kernel   (paged_attention.py:40).
// The same function per slot b of a batch: logical column c of slot b lives
// in physical page max(table[b][c / page], 0) of a pool [n, KH, page, D], at
// row c % page; its mask comes from the slot's boundary window [T, Wp],
// which starts at logical column floor((kv_limit[b] - T) / page) * page.
//
// Contract (the reference kernels', pallas_attention.py:67-69, 125-129,
// paged_attention.py:80-84, 140-146):
//   * columns below kv_limit - T are the committed prefix and are attended
//     without reading the mask;
//   * columns in [kv_limit - T, kv_limit) follow mask[t, col] (dense) or
//     window[t, col - window origin] (paged);
//   * columns at or past kv_limit are never read;
//   * scores are q.k * D^-0.5 in f32, masked scores are exactly -1e30, the
//     output is acc / max(l, 1e-30) rounded to q's type.
// kv_limit is read from device memory, so the caller never syncs the host.
//
// int8-KV mode (the reference kernels' `scales_hbm` mode,
// pallas_attention.py:59-61, 87-90, 118-121, 209-212, 240-243, and the
// paged kernel's int8 pool, paged_attention.py:69-74, 121-124): k and v
// are int8 with one f32 scale per (KV head, column) each; a value stands
// for (float)q * scale, the reference's dequant, and the function is
// otherwise the same.  Columns past kv_limit load neither values nor
// scales.  The mode is picked by the type of k/v.
//
// What bounds it on an H100 (3.35 TB/s; 989 TFLOP/s bf16 on the tensor
// cores): per slot a call must read q and the live K/V and write the
// output, and do 4 * NH * T * D * kv_limit operations.  The G = NH / KH
// query heads of a KV head share its K/V, so it does 2 * G * T / itemsize
// operations per byte of live K/V (itemsize 1 in int8 mode, whose 8 bytes
// of scales per column and head add 6 % at D = 128), against the card's
// ~295 operations per byte:
//   * llama_1b decode (T 60, G 8, bf16): 480, so the tensor cores bound;
//   * llama_7b decode (T 16, G 1, int8) and the paged B = 12 step over int8
//     pages: 32, so the bytes bound;
//   * the llama_7b T = 128 prefill (G 1, bf16) and the llama_1b paged
//     B = 4 step (T 16, G 8, bf16): 128, the bytes again.
// Each bound is 0.2-11 microseconds at these shapes (PERF.md), the order of
// a launch and of a CTA's first tile loads: latency, not a rate, is what
// the design has to hide.
//
// Design of the bf16-q body (every call on the model's paths):
//   * one CTA of four warps per (row tile, KV head, slot), packed query rows
//     r = g * T + t, so each K/V tile is loaded once per CTA for all G
//     query heads;
//   * a loop over KV tiles of 64 columns at absolute multiples of 64, up to
//     cdiv(min(kv_limit, S), 64), S the cache length (dense) or the slot's
//     table capacity P * page (paged).  The tile's raw K and V bytes (bf16,
//     or int8 and the two f32 scale vectors) are copied to shared memory
//     with cp.async, 16 bytes a thread (the scales 4), into a ring of
//     kStages = 3 tiles, so two tiles load while one computes; columns past
//     kv_limit are zero-filled, not loaded.  In paged mode the wrapper
//     requires page % 64 == 0, so a tile never straddles two pages: one
//     table read per tile, then 64 rows of that page as the dense mode
//     reads 64 rows of the cache;
//   * Q.K^T and P.V run on the tensor cores, mma.sync m16n8k16 with bf16
//     inputs and f32 accumulators.  Q's fragments are loaded once per CTA
//     into registers; K's come from the staged tile (int8 converted to bf16
//     in registers, exactly: |x| <= 128).  Scores are kept in base 2,
//     s * (log2(e) * D^-0.5), so that every exponential is one exp2f (the
//     same softmax: exp2(x log2 e) = exp(x)); in int8 mode a score is
//     (q.k8 * kscale) * log2(e) D^-0.5, and V's scale is folded into the
//     probability, p * vscale, before P.V.  P keeps f32 precision through
//     a split into bf16 P_hi = bf16(p) and P_lo = bf16(p - P_hi), two mmas
//     on the same V fragment (ldmatrix.trans for bf16 V).  The score
//     accumulator's fragment layout is the A fragment's, so P never goes
//     through shared memory;
//   * the softmax runs in registers: each lane holds two rows' scores, and
//     a row's max and sum are the lane's own values in ascending column
//     order, then two quad shuffles (xor 1, then xor 2).
//
// Row layout, chosen from (T, G) alone, never from kv_limit, S, the page
// table, the slot or the data:
//   * R = G * T > 16: row tiles of 64; warp w owns rows 16w .. 16w + 15 of
//     its tile and computes all 64 columns of every KV tile, as in
//     FlashAttention-2.  Rows past R are zero and never written.
//   * R <= 16 (llama_7b decode: G 1, T 16): one row tile of 16; warp w
//     takes columns 16w .. 16w + 15 of every KV tile and runs its own
//     online softmax over them; at the end the four (m, l, acc) are
//     combined in warp order 0..3: m = max_w m_w, acc = sum_w acc_w *
//     exp2(m_w - m), l likewise.
//
// Reduction order, and why the greedy oracles hold bit for bit: each
// score is one chain of D / 16 mmas over d in ascending order from zero;
// each 16-column chunk of P.V is one mma of P_hi from zero, then one of
// P_lo accumulating onto it, and that chunk's sum is added to the f32
// accumulator (after its rescale by alpha) in ascending column order.  No
// atomics, no split over KV.  A masked score gives p = 0 exactly, so a tile
// with no live column for a row leaves its m, l and acc bitwise unchanged
// (alpha = exp2(0) = 1; acc + 0 = acc): a row's bits depend neither on S
// (the single-stream engine's cache buckets) nor on its slot.  Both modes
// run this body over the same absolute tiles in the same order, so a slot's
// paged result equals the dense result on its gathered KV bit for bit.
// ops/flash_attention.py:tiled_order_attention models this order on the
// CPU; ops/flash_attention.py:kernel_tolerance says why its bound covers
// the mma's truncation, the P split and the int8 reassociation.
//
// The f32-q body keeps the CUDA-core design (64-row tiles, f32 FMA chains,
// f32 staging): no card path passes f32 q.
//
// Left for the next redesign: a split of long slots over CTAs at fixed
// absolute column boundaries, combined in a fixed order (the grid is
// KH * B CTAs at R <= 16: 32 at llama_7b single stream on 132 SMs); wgmma
// with TMA page loads (wgmma takes 64-row tiles, more than R at decode).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRows = 64;      // packed query rows per CTA (f32 q; bf16 q
                               // at R > 16)
constexpr int kCols = 64;      // KV columns per tile
constexpr int kThreads = 128;  // 4 warps
constexpr float kNegInf = -1e30f;

// Arguments of one launch.  Dense: k/v [KH, S, D] (scales [KH, S]), mask
// [T, S], kv_limits [1], B = 1, tables unused.  Paged: k/v pools
// [n, KH, page, D] (scales [n, KH, page]), mask = windows [B, T, Wp],
// kv_limits [B], tables [B, P], S = P * page.  q [B, T, NH, D], out
// [B, T, NH * D].
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const uint8_t* mask;
  const int32_t* kv_limits;
  const int32_t* tables;
  void* out;
  int Tq, NH, KH, S, P, page, Wp;
  float scale;       // D^-0.5 (f32 q)
  float scale_log2;  // log2(e) * D^-0.5: the bf16-q body's base-2 scores
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// The first row of KV tile `tile` in the cache (dense) or the pool (paged),
// counted in rows of D values: a tile lies in one page.
template <bool kPaged>
__device__ __forceinline__ size_t tile_base(const Args& a, int b, int h,
                                            int tile) {
  const int j0 = tile * kCols;
  if (kPaged) {
    const int pj = j0 / a.page;
    const int pg = max(a.tables[(size_t)b * a.P + pj], 0);
    return ((size_t)pg * a.KH + h) * a.page + (j0 - pj * a.page);
  }
  return (size_t)h * a.S + j0;
}

// ---------------------------------------------------------------------------
// f32 q: CUDA cores.

// one K or V value as f32: upcast, or int8 times its column's scale
template <typename KV>
__device__ __forceinline__ float kv_value(const KV* p, size_t i,
                                          const float* /*scale*/, int /*col*/) {
  return to_float(p[i]);
}
__device__ __forceinline__ float kv_value(const int8_t* p, size_t i,
                                          const float* scale, int col) {
  return (float)p[i] * scale[col];
}

template <int D>
constexpr size_t smem_floats() {
  return kRows * (D + 1)      // sQ
         + kCols * (D + 1)    // sK
         + kCols * D          // sV
         + kRows * (kCols + 1)  // sP: scores, then probabilities
         + 3 * kRows;         // running max, running sum, rescale factor
}

template <typename T, typename KV, int D, bool kPaged>
__device__ __forceinline__ void attention_body_fma(const Args& a) {
  static_assert(D % 16 == 0 && D <= 128, "head_dim must be 16..128, /16");
  constexpr int kDj = D / 16;  // output columns per thread in P.V
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kRows * (D + 1);
  float* sV = sK + kCols * (D + 1);
  float* sP = sV + kCols * D;
  float* sM = sP + kRows * (kCols + 1);
  float* sL = sM + kRows;
  float* sA = sL + kRows;

  const int Tq = a.Tq, NH = a.NH, KH = a.KH, S = a.S;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ty = tid >> 4;   // 0..7: rows ty*8 .. ty*8+7
  const int tx = tid & 15;   // 0..15: columns tx + 16*j
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = NH / KH;
  const int R = G * Tq;
  const int row_base = blockIdx.x * kRows;

  const T* q = static_cast<const T*>(a.q) + (size_t)b * Tq * NH * D;
  T* out = static_cast<T*>(a.out) + (size_t)b * Tq * NH * D;
  const KV* k = static_cast<const KV*>(a.k);
  const KV* v = static_cast<const KV*>(a.v);

  const int kv_limit = a.kv_limits[b];
  const int kv_lim = min(kv_limit, S);
  const int committed = kv_limit - Tq;
  const int n_tiles = kv_lim > 0 ? (kv_lim + kCols - 1) / kCols : 0;
  // mask row stride and the logical column of its first entry
  const int mstride = kPaged ? a.Wp : S;
  const int mcol0 = kPaged ? floor_div(committed, a.page) * a.page : 0;
  const uint8_t* mask = a.mask + (size_t)b * Tq * mstride;

  // Q rows of this CTA (zero for rows past R)
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int rg = row_base + r;
    float x = 0.f;
    if (rg < R) {
      const int g = rg / Tq, t = rg - g * Tq;
      x = to_float(q[((size_t)t * NH + h * G + g) * D + d]);
    }
    sQ[r * (D + 1) + d] = x;
  }
  if (tid < kRows) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  float o[8][kDj];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kDj; ++j) o[i][j] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int j0 = tile * kCols;
    const size_t base = tile_base<kPaged>(a, b, h, tile);
    const KV* kt = k + base * D;
    const KV* vt = v + base * D;
    const float* kst = a.k_scale ? a.k_scale + base : nullptr;
    const float* vst = a.v_scale ? a.v_scale + base : nullptr;
    __syncthreads();  // the previous tile's P.V is done with sV and sP
    for (int idx = tid; idx < kCols * D; idx += kThreads) {
      const int c = idx / D, d = idx - c * D;
      float kx = 0.f, vx = 0.f;
      if (j0 + c < kv_lim) {
        kx = kv_value(kt, (size_t)c * D + d, kst, c);
        vx = kv_value(vt, (size_t)c * D + d, vst, c);
      }
      sK[c * (D + 1) + d] = kx;
      sV[c * D + d] = vx;
    }
    __syncthreads();

    // scores: 8 rows x 4 columns per thread, one FMA chain over d each
    {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[8], kv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) qv[i] = sQ[(ty * 8 + i) * (D + 1) + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = ty * 8 + i;
        const int rg = row_base + r;
        const int t = rg < R ? rg % Tq : 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const int col = j0 + c;
          bool ok;
          if (rg >= R || col >= kv_lim) {
            ok = false;
          } else if (col < committed) {
            ok = true;
          } else {
            ok = mask[(size_t)t * mstride + (col - mcol0)] != 0;
          }
          sP[r * (kCols + 1) + c] = ok ? acc[i][j] * a.scale : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax: each warp owns 16 rows, each lane two columns
    for (int rr = 0; rr < kRows / 4; ++rr) {
      const int r = warp * (kRows / 4) + rr;
      float* row = sP + r * (kCols + 1);
      const float x0 = row[lane], x1 = row[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      row[lane] = p0;
      row[lane + 32] = p1;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
        sA[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P.V, one FMA chain over the tile's columns
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float al = sA[ty * 8 + i];
#pragma unroll
      for (int j = 0; j < kDj; ++j) o[i][j] *= al;
    }
#pragma unroll 4
    for (int c = 0; c < kCols; ++c) {
      float pv[8], vv[kDj];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = sP[(ty * 8 + i) * (kCols + 1) + c];
#pragma unroll
      for (int j = 0; j < kDj; ++j) vv[j] = sV[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < kDj; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
    const int rg = row_base + r;
    if (rg >= R) continue;
    const int g = rg / Tq, t = rg - g * Tq;
    const float l = fmaxf(sL[r], 1e-30f);
    T* dst = out + ((size_t)t * NH + h * G + g) * D;
#pragma unroll
    for (int j = 0; j < kDj; ++j) dst[tx + 16 * j] = from_float<T>(o[i][j] / l);
  }
}

// ---------------------------------------------------------------------------
// bf16 q: tensor cores.

constexpr int kStages = 3;  // KV tiles in the cp.async ring

// Shared memory of the bf16-q body: a ring of kStages KV tiles, each the
// K rows, the V rows and (int8) the two scale vectors.  A row is padded by
// 16 bytes so that the fragment loads of an mma's eight row groups, and
// ldmatrix's eight row addresses, fall in distinct banks.
template <typename KV, int D>
struct MmaSmem {
  static constexpr bool kInt8 = sizeof(KV) == 1;
  static constexpr int kRowBytes = D * (int)sizeof(KV) + 16;
  static constexpr int kSideBytes = kCols * kRowBytes;
  static constexpr int kStageBytes = 2 * kSideBytes + (kInt8 ? 2 * kCols * 4 : 0);
  static constexpr int kRingBytes = kStages * kStageBytes;
  // after the loop at R <= 16: each warp's m and l of 16 rows, then acc
  static constexpr int kCombineBytes = 4 * 16 * (2 + D) * 4;
  static constexpr int kBytes =
      kRingBytes > kCombineBytes ? kRingBytes : kCombineBytes;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// d += A (16x16 bf16, row) * B (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices, transposed: the B fragments of two n8 tiles
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// (lo, hi) as bf16x2, lo in the low half (the lower k or column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// p = P_hi + P_lo to about 2^-17 relative: two bf16x2 A-fragment words
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

template <typename KV, int D, bool kPaged, bool kQuarter>
__device__ __forceinline__ void attention_body_mma(const Args& a) {
  static_assert(D % 16 == 0 && D <= 128, "head_dim must be 16..128, /16");
  using Smem = MmaSmem<KV, D>;
  constexpr bool kInt8 = Smem::kInt8;
  constexpr int kRowBytes = Smem::kRowBytes;
  constexpr int kRowsCta = kQuarter ? 16 : kRows;   // rows per CTA
  constexpr int kWarpCols = kQuarter ? kCols / 4 : kCols;  // per KV tile
  constexpr int kNT = kWarpCols / 8;   // n8 score tiles of a warp
  constexpr int kKS = D / 16;          // k16 steps of Q.K^T
  constexpr int kDT = D / 8;           // n8 tiles of the output
  extern __shared__ __align__(16) uint8_t smem_bytes[];

  const int Tq = a.Tq, NH = a.NH, KH = a.KH, S = a.S;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // mma group: A/C row, B column
  const int qd = lane & 3;   // k pair within the group
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = NH / KH;
  const int R = G * Tq;
  const int row0 = blockIdx.x * kRowsCta + (kQuarter ? 0 : 16 * warp);
  const int col0 = kQuarter ? kWarpCols * warp : 0;  // in every KV tile
  const bool busy = row0 < R;  // a warp of padding rows only computes nothing

  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(a.q) + (size_t)b * Tq * NH * D;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) +
                       (size_t)b * Tq * NH * D;
  const uint8_t* kbytes = static_cast<const uint8_t*>(a.k);
  const uint8_t* vbytes = static_cast<const uint8_t*>(a.v);

  const int kv_limit = a.kv_limits[b];
  const int kv_lim = min(kv_limit, S);
  const int committed = kv_limit - Tq;
  const int n_tiles = kv_lim > 0 ? (kv_lim + kCols - 1) / kCols : 0;
  const int mstride = kPaged ? a.Wp : S;
  const int mcol0 = kPaged ? floor_div(committed, a.page) * a.page : 0;
  const uint8_t* mask = a.mask + (size_t)b * Tq * mstride;

  // this lane's two rows, g and g + 8 of the warp's 16: valid, t, output
  bool rv[2];
  int rt[2];
  size_t rout[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rg = row0 + g + 8 * i;
    rv[i] = rg < R;
    const int gg = rv[i] ? rg / Tq : 0;
    rt[i] = rv[i] ? rg - gg * Tq : 0;
    rout[i] = ((size_t)rt[i] * NH + h * G + gg) * D;
  }

  // Q's A fragments, loaded once: [k16 step][row g lo, row g+8 lo, row g
  // hi, row g+8 hi], zeros for rows past R
  uint32_t qf[kKS][4];
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t* qr =
          reinterpret_cast<const uint32_t*>(q + rout[i] + kk * 16) + qd;
      qf[kk][i] = rv[i] ? qr[0] : 0u;
      qf[kk][2 + i] = rv[i] ? qr[4] : 0u;
    }

  auto load_tile = [&](int tile) {
    uint8_t* st = smem_bytes + (tile % kStages) * Smem::kStageBytes;
    const int j0 = tile * kCols;
    const size_t base = tile_base<kPaged>(a, b, h, tile);
    const uint8_t* kt = kbytes + base * D * sizeof(KV);
    const uint8_t* vt = vbytes + base * D * sizeof(KV);
    constexpr int kChunks = D * (int)sizeof(KV) / 16;  // 16-byte chunks a row
    for (int c = tid; c < kCols * kChunks; c += kThreads) {
      const int r = c / kChunks, part = c - r * kChunks;
      const bool ok = j0 + r < kv_lim;
      const size_t off = (size_t)r * D * sizeof(KV) + 16 * part;
      cp_async16(st + r * kRowBytes + 16 * part, ok ? kt + off : kt, ok);
      cp_async16(st + Smem::kSideBytes + r * kRowBytes + 16 * part,
                 ok ? vt + off : vt, ok);
    }
    if constexpr (kInt8) {
      float* ss = reinterpret_cast<float*>(st + 2 * Smem::kSideBytes);
      const int c = tid & (kCols - 1);
      const bool ok = j0 + c < kv_lim;
      const float* src = tid < kCols ? a.k_scale : a.v_scale;
      cp_async4(ss + tid, ok ? src + base + c : src, ok);
    }
  };

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this tile has landed; the previous one is consumed
    if (tile + kStages - 1 < n_tiles) load_tile(tile + kStages - 1);
    cp_async_commit();
    if (!busy) continue;

    const uint8_t* sK = smem_bytes + (tile % kStages) * Smem::kStageBytes;
    const uint8_t* sV = sK + Smem::kSideBytes;
    const float* sKs = reinterpret_cast<const float*>(sK + 2 * Smem::kSideBytes);
    const float* sVs = sKs + kCols;
    const int j0 = tile * kCols;

    // scores: one chain of kKS mmas over d per n8 tile
    float sc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
      const uint8_t* krow = sK + (col0 + 8 * n + g) * kRowBytes;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        uint32_t b0, b1;
        if constexpr (kInt8) {
          const int8_t* p =
              reinterpret_cast<const int8_t*>(krow) + kk * 16 + 2 * qd;
          b0 = pack_bf16((float)p[0], (float)p[1]);
          b1 = pack_bf16((float)p[8], (float)p[9]);
        } else {
          const uint32_t* p = reinterpret_cast<const uint32_t*>(krow) +
                              kk * 8 + qd;
          b0 = p[0];
          b1 = p[4];
        }
        mma_bf16(sc[n], qf[kk], b0, b1);
      }
    }

    // scale and mask; the lane's max of each row
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int c = col0 + 8 * n + 2 * qd + (e & 1);
        const int col = j0 + c;
        float s = sc[n][e];
        if constexpr (kInt8) {
          s = (s * sKs[c]) * a.scale_log2;
        } else {
          s = s * a.scale_log2;
        }
        const bool ok =
            rv[i] && col < kv_lim &&
            (col < committed ||
             mask[(size_t)rt[i] * mstride + (col - mcol0)] != 0);
        sc[n][e] = ok ? s : kNegInf;
        mx[i] = fmaxf(mx[i], sc[n][e]);
      }

    // online softmax in registers: quad shuffles, xor 1 then xor 2
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float s = sc[n][e];
        const float p = s > kNegInf ? exp2f(s - m[i]) : 0.f;
        rs[i] += p;
        sc[n][e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * alpha[i] + rs[i];
    }
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // P.V, one 16-column chunk at a time: P_hi then P_lo onto it, added
    // to acc in ascending column order
#pragma unroll
    for (int j = 0; j < kNT / 2; ++j) {
      float p[8];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[2 * j + u][e];
          if constexpr (kInt8)
            x = x * sVs[col0 + 16 * j + 8 * u + 2 * qd + (e & 1)];
          p[4 * u + e] = x;
        }
      // A fragment: rows g / g + 8, columns 2qd (+1) then 8 + 2qd (+1)
      uint32_t hi[4], lo[4];
      split_pair(p[0], p[1], hi[0], lo[0]);
      split_pair(p[2], p[3], hi[1], lo[1]);
      split_pair(p[4], p[5], hi[2], lo[2]);
      split_pair(p[6], p[7], hi[3], lo[3]);
      const int cb = col0 + 16 * j;  // the chunk's first column in the tile
#pragma unroll
      for (int dt = 0; dt < kDT; dt += 2) {
        uint32_t bv[4];  // B fragments of output tiles dt and dt + 1
        if constexpr (kInt8) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int8_t* vp = reinterpret_cast<const int8_t*>(sV) +
                               (cb + 2 * qd) * kRowBytes + (dt + u) * 8 + g;
            bv[2 * u] = pack_bf16((float)vp[0], (float)vp[kRowBytes]);
            bv[2 * u + 1] =
                pack_bf16((float)vp[8 * kRowBytes], (float)vp[9 * kRowBytes]);
          }
        } else {
          const int r = cb + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int d = dt * 8 + (lane >> 4) * 8;
          ldmatrix_x4_trans(bv, sV + r * kRowBytes + d * 2);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float d4[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(d4, hi, bv[2 * u], bv[2 * u + 1]);
          mma_bf16(d4, lo, bv[2 * u], bv[2 * u + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[dt + u][e] += d4[e];
        }
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (!kQuarter) {
    if (!busy) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!rv[i]) continue;
      const float li = fmaxf(l[i], 1e-30f);
      uint32_t* dst = reinterpret_cast<uint32_t*>(out + rout[i]) + qd;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        dst[4 * dt] = pack_bf16(acc[dt][2 * i] / li, acc[dt][2 * i + 1] / li);
    }
  } else {
    // combine the four warps' column quarters in warp order 0..3
    __syncthreads();  // every warp is done with the ring
    float* cm = reinterpret_cast<float*>(smem_bytes);  // [4][16] m
    float* cl = cm + 4 * 16;                           // [4][16] l
    float* ca = cl + 4 * 16;                           // [4][16][D] acc
    if (qd == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        cm[warp * 16 + g + 8 * i] = m[i];
        cl[warp * 16 + g + 8 * i] = l[i];
      }
    }
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ca[(warp * 16 + g + 8 * (e >> 1)) * D + dt * 8 + 2 * qd + (e & 1)] =
            acc[dt][e];
    __syncthreads();
    for (int idx = tid; idx < 16 * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      const int rg = blockIdx.x * 16 + r;
      if (rg >= R) continue;
      float mm = cm[r];
#pragma unroll
      for (int w = 1; w < 4; ++w) mm = fmaxf(mm, cm[w * 16 + r]);
      float o = 0.f, ll = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float f = exp2f(cm[w * 16 + r] - mm);
        o = o + ca[(w * 16 + r) * D + d] * f;
        ll = ll + cl[w * 16 + r] * f;
      }
      const int gg = rg / Tq, t = rg - gg * Tq;
      out[((size_t)t * NH + h * G + gg) * D + d] =
          __float2bfloat16(o / fmaxf(ll, 1e-30f));
    }
  }
}

// ---------------------------------------------------------------------------
// Entry points and launch.

template <typename T, typename KV, int D, bool kPaged, bool kQuarter>
__device__ __forceinline__ void attention_body(const Args& a) {
  if constexpr (std::is_same<T, float>::value)
    attention_body_fma<T, KV, D, kPaged>(a);
  else
    attention_body_mma<KV, D, kPaged, kQuarter>(a);
}

// Two entry points with their own names, so a profile tells K1/K2 from K4.
template <typename T, typename KV, int D, bool kQuarter>
__global__ void __launch_bounds__(kThreads)
flash_block_attention_kernel(const Args a) {
  attention_body<T, KV, D, false, kQuarter>(a);
}

template <typename T, typename KV, int D, bool kQuarter>
__global__ void __launch_bounds__(kThreads)
paged_block_attention_kernel(const Args a) {
  attention_body<T, KV, D, true, kQuarter>(a);
}

template <typename T, typename KV, int D>
constexpr int smem_bytes_of() {
  return std::is_same<T, float>::value ? (int)(smem_floats<D>() * sizeof(float))
                                       : MmaSmem<KV, D>::kBytes;
}

template <typename T, typename KV, int D, bool kPaged, bool kQuarter>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = smem_bytes_of<T, KV, D>();
  auto kernel = kPaged ? paged_block_attention_kernel<T, KV, D, kQuarter>
                       : flash_block_attention_kernel<T, KV, D, kQuarter>;
  // once per instantiation, not per launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int R = (a.NH / a.KH) * a.Tq;
  const int rows = kQuarter ? 16 : kRows;
  dim3 grid((R + rows - 1) / rows, a.KH, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The row layout (bf16 q): column quarters at R <= 16, 64-row tiles above.
template <typename T, typename KV, int D, bool kPaged>
int launch_layout(const Args& a, int B, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value) {
    return launch<T, KV, D, kPaged, false>(a, B, st);
  } else {
    if ((a.NH / a.KH) * a.Tq <= 16)
      return launch<T, KV, D, kPaged, true>(a, B, st);
    return launch<T, KV, D, kPaged, false>(a, B, st);
  }
}

template <typename T, typename KV, bool kPaged>
int launch_d(int D, const Args& a, int B, cudaStream_t st) {
  switch (D) {
    case 16: return launch_layout<T, KV, 16, kPaged>(a, B, st);
    case 32: return launch_layout<T, KV, 32, kPaged>(a, B, st);
    case 64: return launch_layout<T, KV, 64, kPaged>(a, B, st);
    case 128: return launch_layout<T, KV, 128, kPaged>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kPaged>
int dispatch(int D, int is_bf16, int kv_int8, const Args& a, int B,
             cudaStream_t st) {
  if (is_bf16 && kv_int8)
    return launch_d<__nv_bfloat16, int8_t, kPaged>(D, a, B, st);
  if (is_bf16) return launch_d<__nv_bfloat16, __nv_bfloat16, kPaged>(D, a, B, st);
  if (kv_int8) return launch_d<float, int8_t, kPaged>(D, a, B, st);
  return launch_d<float, float, kPaged>(D, a, B, st);
}

Args make_args(const void* q, const void* k, const void* v,
               const void* k_scale, const void* v_scale, const void* mask,
               const void* kv_limits, const void* tables, void* out, int Tq,
               int NH, int KH, int S, int P, int page, int Wp, int D,
               int kv_int8) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_scale = kv_int8 ? static_cast<const float*>(k_scale) : nullptr;
  a.v_scale = kv_int8 ? static_cast<const float*>(v_scale) : nullptr;
  a.mask = static_cast<const uint8_t*>(mask);
  a.kv_limits = static_cast<const int32_t*>(kv_limits);
  a.tables = static_cast<const int32_t*>(tables);
  a.out = out;
  a.Tq = Tq;
  a.NH = NH;
  a.KH = KH;
  a.S = S;
  a.P = P;
  a.page = page;
  a.Wp = Wp;
  a.scale = (float)(1.0 / sqrt((double)D));
  a.scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  return a;
}

// The bf16-q body copies K and V rows 16 bytes at a time and reads q and
// writes out 4 bytes at a time.
bool aligned(int is_bf16, const void* q, const void* k, const void* v,
             const void* out) {
  auto at = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  return !is_bf16 || (at(q, 4) && at(out, 4) && at(k, 16) && at(v, 16));
}

}  // namespace

extern "C" {

// Dense mode, batch 1.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).  is_bf16: 1 for bfloat16 q/out, 0 for
// float32.  kv_int8: 1 for int8 k/v with f32 k_scale/v_scale [KH, S]; 0 for
// k/v of q's type (the scales are then ignored).  bf16 q needs k and v
// 16-byte aligned.
int samd_flash_block_attention(const void* q, const void* k, const void* v,
                               const void* k_scale, const void* v_scale,
                               const void* mask, const void* kv_limit,
                               void* out, int Tq, int NH, int KH, int S,
                               int D, int is_bf16, int kv_int8,
                               void* stream) {
  if (Tq <= 0 || KH <= 0 || NH % KH != 0 || S <= 0 ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr)) ||
      !aligned(is_bf16, q, k, v, out))
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, k_scale, v_scale, mask, kv_limit,
                           nullptr, out, Tq, NH, KH, S, 0, 0, 0, D, kv_int8);
  return dispatch<false>(D, is_bf16, kv_int8, a, 1,
                         static_cast<cudaStream_t>(stream));
}

// Paged mode over B slots.  k_pool/v_pool [n, KH, page, D] (int8 with f32
// scales [n, KH, page] when kv_int8), window [B, Tq, Wp] bool bytes,
// kv_limits [B] int32, tables [B, P] int32 (-1 entries read page 0), out
// [B, Tq, NH * D].  page must be a multiple of 64.  Returns as above.
int samd_paged_block_attention(const void* q, const void* k_pool,
                               const void* v_pool, const void* k_scale,
                               const void* v_scale, const void* window,
                               const void* kv_limits, const void* tables,
                               void* out, int B, int Tq, int NH, int KH,
                               int P, int page, int Wp, int D, int is_bf16,
                               int kv_int8, void* stream) {
  if (B <= 0 || Tq <= 0 || KH <= 0 || NH % KH != 0 || P <= 0 ||
      page <= 0 || page % kCols != 0 || Wp < Tq + page ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr)) ||
      !aligned(is_bf16, q, k_pool, v_pool, out))
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k_pool, v_pool, k_scale, v_scale, window,
                           kv_limits, tables, out, Tq, NH, KH, P * page, P,
                           page, Wp, D, kv_int8);
  return dispatch<true>(D, is_bf16, kv_int8, a, B,
                        static_cast<cudaStream_t>(stream));
}

const char* samd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
