// Int4 weight-streaming matmul for Hopper (sm_90a): y = x @ dequant(W).
//
// Replaces the Pallas TPU kernel behind
// samd_tpu/ops/int4_matmul.py:int4_matmul, K3 _int4_matmul_stacked
// (int4_matmul.py:165-223) with its default body _kernel_sum (:88-106).
// It computes the same function, not the TPU kernel's block structure:
//
//   y[r, c] = scale[l, c] * sum_k x[r, k] * (nibble(W[l, k, c]) - 8)
//
// W is halves-packed uint8 [L, in, out/2]: byte [l, k, j] holds column j in
// its low nibble and column j + out/2 in its high nibble, each unsigned
// with zero point 8.  Scales are f32 [L, out].  The layer is a pointer
// offset into the stacked array: no per-layer copy.  Products are f32 FMAs
// of the exactly upcast x and the exact small integers nibble - 8; the
// scale is applied once after the sum; the result is rounded once to the
// output type.  (The TPU body's rank-1 -8*sum(x) correction and its
// (dot(x, p) - dot(x, lo)) / 16 high-nibble recovery are vector-unit
// devices of the TPU and are not used: the kernel rounds differently from
// the reference's "v2-sum", within the bound of ops/int4_matmul.py.)
//
// Determinism and row invariance (the greedy equality oracle needs both:
// the fused engine puts a token at row i where the oracle puts it at row 0,
// and prefills at another R): each output's sum runs over k in one order
// that depends only on `in`, never on R, the row's index or its tile.  The
// k range is cut into kSlices fixed slices; warp s sums slice s in
// ascending k with one FMA chain; the slices' partial sums are then added
// in ascending s.  No atomics, no choice of tile or order by R.
//
// What bounds it on an H100: per call it must move the packed layer
// (in * out / 2 bytes), its scales, x and y against 3.35 TB/s, and do
// 2 * R * in * out operations.  At llama_7b decode (R = 16) that is 0.5
// bytes and 32 operations per weight: the bytes bound on the tensor cores'
// rate (a 7B forward streams 3.3 GB, ~1 ms), but this kernel multiplies
// with f32 FMAs on the CUDA cores (67 TFLOP/s), whose 32 operations per
// weight take longer than the weight's half byte of streaming.  A simple
// kernel that is right and deterministic comes first; mma/wgmma with
// in-register unpacking into the tensor cores, TMA and a deeper load
// pipeline are later work.
//
// Design: one CTA per tile of kCols packed columns (2 * kCols outputs) x
// kRows rows, kSlices warps.  Each lane owns kBytes consecutive packed
// columns and loads them as one 32-bit word per k (a warp reads 128
// contiguous bytes per k).  x is staged per warp in shared memory, kChunk
// k values at a time, as f32 float4s of the tile's four rows.  A nibble
// becomes a float without a conversion instruction: the bits
// 0x4B000000 | n are the float 2^23 + n, and subtracting 2^23 + 8 leaves
// n - 8 exactly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlices = 16;               // warps per CTA, one k slice each
constexpr int kThreads = 32 * kSlices;
constexpr int kRows = 4;                  // rows of x per CTA
constexpr int kBytes = 4;                 // packed columns per lane
constexpr int kCols = 32 * kBytes;        // packed columns per CTA
constexpr int kOuts = 2 * kCols;          // output columns per CTA
constexpr int kChunk = 32;                // k values staged per warp
static_assert(kRows == 4, "x is staged as one float4 per k");

constexpr size_t kStageBytes = sizeof(float4) * kSlices * kChunk;
constexpr size_t kPartBytes = sizeof(float) * kSlices * kRows * kOuts;
constexpr size_t kSmemBytes = kStageBytes > kPartBytes ? kStageBytes
                                                       : kPartBytes;

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

// (nibble of w at `shift`) - 8, exactly, as a float
__device__ __forceinline__ float nibble(uint32_t w, int shift) {
  return __uint_as_float(0x4B000000u | ((w >> shift) & 0xFu)) - 8388616.0f;
}

// x [R, IN]; w: the layer's packed bytes [IN, OUTH] read as 32-bit words;
// scale: the layer's [2 * OUTH]; y [R, 2 * OUTH].
template <typename TX, typename TO>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const TX* __restrict__ x, const uint32_t* __restrict__ w,
                   const float* __restrict__ scale, TO* __restrict__ y,
                   int R, int IN, int OUTH) {
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.y * kRows;
  const int col = blockIdx.x * kCols + lane * kBytes;  // first packed column
  const bool col_ok = col < OUTH;   // OUTH % kBytes == 0: all four in range
  const int words = OUTH / kBytes;  // 32-bit words per k row
  const int slice = (IN + kSlices - 1) / kSlices;
  const int kbeg = min(IN, warp * slice);
  const int kend = min(IN, kbeg + slice);

  float acc[kRows][2 * kBytes];  // [r][i]: column col+i; [r][kBytes+i]: +OUTH
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < 2 * kBytes; ++i) acc[r][i] = 0.f;

  float4* sx = smem + warp * kChunk;
  const uint32_t* wcol = w + col / kBytes;
  for (int k0 = kbeg; k0 < kend; k0 += kChunk) {
    const int k = k0 + lane;
    float xv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      xv[r] = (k < kend && row0 + r < R)
                  ? to_float(x[(size_t)(row0 + r) * IN + k]) : 0.f;
    __syncwarp();  // the previous chunk's reads of sx are done
    sx[lane] = make_float4(xv[0], xv[1], xv[2], xv[3]);
    __syncwarp();
    const int n = min(kChunk, kend - k0);
    if (col_ok) {
      const uint32_t* wk = wcol + (size_t)k0 * words;
#pragma unroll 4
      for (int kk = 0; kk < n; ++kk) {
        const uint32_t wv = __ldg(wk + (size_t)kk * words);
        const float4 xr = sx[kk];
#pragma unroll
        for (int i = 0; i < kBytes; ++i) {
          const float lo = nibble(wv, 8 * i);
          const float hi = nibble(wv, 8 * i + 4);
          acc[0][i] = fmaf(xr.x, lo, acc[0][i]);
          acc[1][i] = fmaf(xr.y, lo, acc[1][i]);
          acc[2][i] = fmaf(xr.z, lo, acc[2][i]);
          acc[3][i] = fmaf(xr.w, lo, acc[3][i]);
          acc[0][kBytes + i] = fmaf(xr.x, hi, acc[0][kBytes + i]);
          acc[1][kBytes + i] = fmaf(xr.y, hi, acc[1][kBytes + i]);
          acc[2][kBytes + i] = fmaf(xr.z, hi, acc[2][kBytes + i]);
          acc[3][kBytes + i] = fmaf(xr.w, hi, acc[3][kBytes + i]);
        }
      }
    }
  }

  // partial sums [slice][row][output], reusing the staging memory
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < kBytes; ++i) {
      float* dst = part + (size_t)(warp * kRows + r) * kOuts + lane * kBytes;
      dst[i] = acc[r][i];
      dst[kCols + i] = acc[r][kBytes + i];
    }
  __syncthreads();

  for (int o = threadIdx.x; o < kRows * kOuts; o += kThreads) {
    const int r = o / kOuts;
    const int c = o - r * kOuts;
    const int half = c >= kCols;
    const int j = blockIdx.x * kCols + c - half * kCols;
    if (row0 + r >= R || j >= OUTH) continue;
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < kSlices; ++p) s += part[(p * kRows + r) * kOuts + c];
    const int oc = j + half * OUTH;
    y[(size_t)(row0 + r) * 2 * OUTH + oc] = from_float<TO>(s * scale[oc]);
  }
}

template <typename TX, typename TO>
int launch(const void* x, const uint8_t* w, const float* scale, void* y,
           int R, int IN, int OUTH, cudaStream_t stream) {
  auto kernel = int4_matmul_kernel<TX, TO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((OUTH + kCols - 1) / kCols, (R + kRows - 1) / kRows);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const TX*>(x), reinterpret_cast<const uint32_t*>(w), scale,
      static_cast<TO*>(y), R, IN, OUTH);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y [R, 2*OUTH] = x [R, IN] @ dequant(layer `layer` of packed [L, IN, OUTH],
// scale [L, 2*OUTH]).  Launches on `stream` and returns cudaGetLastError()
// (0 on success).  x_bf16 / out_bf16: 1 for bfloat16, 0 for float32.
// Needs OUTH % 4 == 0 and a 4-byte aligned `packed`.
int samd_int4_matmul(const void* x, const void* packed, const void* scale,
                     void* y, int R, int IN, int OUTH, int layer, int x_bf16,
                     int out_bf16, void* stream) {
  if (R <= 0 || IN <= 0 || OUTH <= 0 || OUTH % kBytes != 0 || layer < 0 ||
      reinterpret_cast<uintptr_t>(packed) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const uint8_t* w =
      static_cast<const uint8_t*>(packed) + (size_t)layer * IN * OUTH;
  const float* s = static_cast<const float*>(scale) + (size_t)layer * 2 * OUTH;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && out_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, s, y, R, IN, OUTH, st);
  if (x_bf16)
    return launch<__nv_bfloat16, float>(x, w, s, y, R, IN, OUTH, st);
  if (out_bf16)
    return launch<float, __nv_bfloat16>(x, w, s, y, R, IN, OUTH, st);
  return launch<float, float>(x, w, s, y, R, IN, OUTH, st);
}

const char* samd_int4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
