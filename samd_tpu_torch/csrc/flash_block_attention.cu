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
// are int8 with one f32 scale per (KV head, column) each; a loaded value is
// (float)q * scale, the reference's dequant, and the function is otherwise
// the same.  Columns past kv_limit load neither values nor scales.  The
// mode is picked by the type of k/v.
//
// What bounds it on an H100: per call it must move q and the output
// (2 * T * NH * D * itemsize bytes per slot) and the live K/V
// (2 * kv_limit * KH * D * itemsize bytes per slot) against 3.35 TB/s, and
// do 4 * NH * T * D * kv_limit operations per slot against 989 TFLOP/s in
// bf16.  At llama_1b decode in bf16 (T = 60, NH = 32, KH = 4, D = 64) that
// is 0.49 MB + 1 KB per live column and 0.49 MFLOP per live column: the
// bytes bound up to kv_limit ~ 765, the tensor-core rate beyond (the G
// query heads of a KV head share its K/V).  At T = 1 the bytes bound.  In
// int8-KV mode the live K/V bytes halve (1 byte per value, plus 8 bytes of
// scales per column and head): at llama_7b decode (T = 16, NH = KH = 32,
// D = 128) 8.2 KB per live column and slot, so the bytes bound.  Either
// bound is well under a millisecond per layer at these shapes, so the
// design below aims at being right and deterministic, not at either.
//
// Design (simple and exact first; wgmma and TMA are later work):
//   * one CTA per (tile of 64 packed query rows r = g*T + t, KV head,
//     slot), so each K/V tile is loaded once per CTA for all G query heads;
//   * a loop over KV tiles of 64 columns at absolute multiples of 64, up to
//     cdiv(min(kv_limit, S), 64), S the cache length (dense) or the slot's
//     table capacity P * page (paged); K and V tiles are staged in shared
//     memory as f32 (int8 values dequantized on the way), columns past
//     kv_limit are zero-filled, not loaded.  The wrapper requires
//     page % 64 == 0 in paged mode, so a tile never straddles two pages:
//     the page lookup is one table read per tile, and the tile then reads
//     its 64 rows of that page as the dense mode reads 64 rows of the cache;
//   * Q.K^T and P.V are f32 FMA chains in a fixed order, and the row
//     reductions are fixed butterfly shuffles: no atomics, no split over
//     KV.  A row's result therefore depends only on its own inputs, not on
//     its index in the block, its slot, or on how many fully masked tiles
//     follow its last column (such a tile leaves m, l and acc bitwise
//     unchanged) — the invariant the greedy equality oracle needs.  Both
//     modes run the same body on the same columns in the same order, so a
//     slot's paged result equals the dense result on its gathered KV bit
//     for bit: paged serving stays on the single-stream path's numbers.
//   * Known limits: at llama_1b decode (R = 480 rows per KV head, KH = 4)
//     the dense grid is 32 CTAs on 132 SMs; at llama_7b decode (R = 16)
//     three quarters of each 64-row tile are padding; the FMA products run
//     far below the tensor cores' rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // packed query rows per CTA
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
  float scale;
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

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

template <typename T, typename KV, int D, bool kPaged>
__device__ __forceinline__ void attention_body(const Args& a) {
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
    // the tile's first row in the cache or pool (a tile lies in one page)
    size_t base;
    if (kPaged) {
      const int pj = j0 / a.page;
      const int pg = max(a.tables[(size_t)b * a.P + pj], 0);
      base = ((size_t)pg * KH + h) * a.page + (j0 - pj * a.page);
    } else {
      base = (size_t)h * S + j0;
    }
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

// Two entry points with their own names, so a profile tells K1/K2 from K4.
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kThreads)
flash_block_attention_kernel(const Args a) {
  attention_body<T, KV, D, false>(a);
}

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kThreads)
paged_block_attention_kernel(const Args a) {
  attention_body<T, KV, D, true>(a);
}

template <typename T, typename KV, int D, bool kPaged>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kernel = kPaged ? paged_block_attention_kernel<T, KV, D>
                       : flash_block_attention_kernel<T, KV, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int R = (a.NH / a.KH) * a.Tq;
  dim3 grid((R + kRows - 1) / kRows, a.KH, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename KV, bool kPaged>
int launch_d(int D, const Args& a, int B, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, KV, 16, kPaged>(a, B, st);
    case 32: return launch<T, KV, 32, kPaged>(a, B, st);
    case 64: return launch<T, KV, 64, kPaged>(a, B, st);
    case 128: return launch<T, KV, 128, kPaged>(a, B, st);
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
  return a;
}

}  // namespace

extern "C" {

// Dense mode, batch 1.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).  is_bf16: 1 for bfloat16 q/out, 0 for
// float32.  kv_int8: 1 for int8 k/v with f32 k_scale/v_scale [KH, S]; 0 for
// k/v of q's type (the scales are then ignored).
int samd_flash_block_attention(const void* q, const void* k, const void* v,
                               const void* k_scale, const void* v_scale,
                               const void* mask, const void* kv_limit,
                               void* out, int Tq, int NH, int KH, int S,
                               int D, int is_bf16, int kv_int8,
                               void* stream) {
  if (Tq <= 0 || KH <= 0 || NH % KH != 0 || S <= 0 ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr)))
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
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr)))
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
