// Int4 weight-streaming matmul for Hopper (sm_90a): y = x @ dequant(W).
//
// Replaces the Pallas TPU kernel behind
// samd_tpu/ops/int4_matmul.py:int4_matmul, K3 _int4_matmul_stacked
// (int4_matmul.py:168, pallas_call :212) with its default body _kernel_sum
// (:88).  It computes the same function, not the TPU kernel's block
// structure:
//
//   y[r, c] = scale[l, c] * sum_k x[r, k] * (nibble(W[l, k, c]) - 8)
//
// W is halves-packed uint8 [L, in, out/2]: byte [l, k, j] holds column j in
// its low nibble and column j + out/2 in its high nibble, each unsigned
// with zero point 8.  Scales are f32 [L, out].  The layer is a pointer
// offset into the stacked array: no per-layer copy, no re-layout.  The
// scale is applied once after the sum, in f32; the result is rounded once
// to the output type.  (The TPU body's rank-1 -8*sum(x) correction and its
// (dot(x, p) - dot(x, lo)) / 16 high-nibble recovery are vector-unit
// devices of the TPU and are not used: the kernel rounds differently from
// the reference's "v2-sum", within the bound of ops/int4_matmul.py.)
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16): per call it
// must read the packed layer (in * out / 2 bytes), its scales and x, and
// write y, against 2 * R * in * out operations.  At w_gate (4096 -> 11008)
// and R = 16 that is 22.7 MB, 0.00689 ms: the bytes bound, and the kernel
// has to keep enough of the weight stream in flight on every SM.  At R =
// 192 it is 17.3 GFLOP, 0.01751 ms: the operations bound, which only the
// tensor cores come near (the f32 CUDA cores' 67 TFLOP/s would take 0.26
// ms).
//
// Design of the bf16-x body (every call on the model's paths):
// - Tensor cores through mma.sync.m16n8k16 (bf16 in, f32 out), "swapped":
//   the weights are the A operand (16 output columns by 16 k) and x's rows
//   the N = 8 side.  Decode has 16 rows, so x as A would waste nothing
//   either, but the swap lets one int4 unpack feed every n8 row tile of the
//   CTA, and it lets a lane's A fragment come from whole packed bytes: the
//   tile's m rows 0-7 are the low nibbles of 8 packed columns and m rows
//   8-15 their high nibbles, so every nibble a lane reads is used.
// - The int4 unpacks in registers into the A fragment: a prmt gathers a
//   byte of two k rows into the two 16-bit halves, a lop3 makes each
//   nibble n into the bf16 bits 0x4300 | n, the value 128 + n, and one
//   bf16x2 subtract of 136 leaves n - 8 exactly.
// - Bytes: a CTA owns 32 packed columns (64 outputs; 32 contiguous bytes
//   per k row, one DRAM sector) and kSlices warps, each streaming one
//   fixed k slice through its own kStages-deep cp.async ring of 16-byte
//   copies (neighbouring lanes on neighbouring addresses), with x's tile
//   staged beside the weights: eight warps per CTA, each with three stages
//   of weights in flight.  A strip of 32 bytes gives 64 CTAs at 4096
//   outputs, half of the card's 132 SMs, so `splits` CTAs share each
//   strip's k range (grid z): the wrapper picks it from (in, out) alone
//   (ops/int4_matmul.py:k_splits), the most that keep R <= 16 within one
//   CTA per SM (two at 4096 outputs: 128 CTAs; one at w_gate and the
//   head).  Each writes its slices' sum to an f32 scratch row and a second
//   pass adds the CTAs' sums in ascending order; with one split the CTA
//   writes y itself.  (On the H100 two splits cut 4096 -> 4096 at R = 16
//   from 0.0146 to 0.0116 ms and 11008 -> 4096 from 0.0327 to 0.0215;
//   four splits and deeper rings did worse: PERF.md, time_int4.py.)
// - Operations: a row tile of 8 * kNT rows (kNT = 2 for R <= 16, else 8)
//   reuses each unpacked fragment kNT times; column tiles are the grid's
//   slow axis, so the row tiles of one column tile run together and read
//   its weights from L2.
//
// Determinism and row invariance (the greedy equality oracle needs both:
// the fused engine puts a token at row i where the oracle puts it at row 0,
// and prefills at another R): each output's sum runs through one order that
// depends only on (in, out), never on R, the row's index or its tile.  Each
// mma.sync sums one k16 step's 16 products from a zero accumulator; its
// result is added to an f32 register accumulator with an ordinary
// round-to-nearest add, ascending in k within the warp's slice; a CTA adds
// its kSlices slice sums in ascending slice order, and the second pass the
// CTAs' sums in ascending split order.  (Tensor cores align the products
// to the largest one's exponent and truncate the bits shifted out -- Fasi,
// Higham, Mantovani and Mary, 2021 -- so that error stays inside each
// step, a few u of its largest product; ops/int4_matmul.py:
// kernel_tolerance says why the bound covers it.)  Padded rows are zeros;
// no atomics; the row tile size changes nothing of an output's order.
//
// The f32-x body keeps the CUDA-core design: one CTA per 128 packed columns
// x 4 rows, 16 warps with one k slice each, f32 FMAs of the exactly upcast
// nibbles (the bits 0x4B000000 | n are the float 2^23 + n).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// ---------------------------------------------------------------------------
// bf16 x: tensor cores.

constexpr int kSlices = 8;                 // warps per CTA, one k slice each
constexpr int kThreadsMma = 32 * kSlices;
constexpr int kColBytes = 32;              // packed columns per CTA
constexpr int kOutsMma = 2 * kColBytes;    // output columns per CTA
constexpr int kStepK = 16;                 // k per mma
constexpr int kStageK = 32;                // k per ring stage (two steps)
constexpr int kStages = 4;                 // ring depth per warp
constexpr int kXRow = kStageK + 8;         // staged x row, bf16, padded
constexpr int kWStageBytes = kStageK * kColBytes;

// one ring stage of a warp: the weights, then x's kStageK columns of the
// CTA's 8 * kNT rows
template <int kNT>
__host__ __device__ constexpr int stage_bytes() {
  return kWStageBytes + 8 * kNT * kXRow * 2;
}
// the rings, and after the main loop the f32 slice partials in their place
template <int kNT>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int rings = kSlices * kStages * stage_bytes<kNT>();
  constexpr int parts = kSlices * 8 * kNT * kOutsMma * 4;
  return rings > parts ? rings : parts;
}

// Word offset of packed row r (0..31) of a weight stage.  Rows are rotated
// within each block of four so that the rows 2q, 2q+1, 2q+8, 2q+9 that the
// four lane groups read at once fall in different banks.
__device__ __forceinline__ int wrow(int r) {
  return ((r & ~3) + ((r + (r >> 2)) & 3)) * (kColBytes / 4);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// d = A (16x16 bf16) * B (16x8 bf16), from a zero accumulator
__device__ __forceinline__ void mma_zero(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// The bf16x2 (lo, hi) nibble values - 8 of byte t of words w0 (low half,
// the lower k) and w1 (high half).
__device__ __forceinline__ void unpack_pair(uint32_t w0, uint32_t w1, int t,
                                            uint32_t& lo, uint32_t& hi) {
  const uint32_t sel = t | (t << 4) | ((4 + t) << 8) | ((4 + t) << 12);
  const uint32_t p = __byte_perm(w0, w1, sel);
  const uint32_t l = (p & 0x000F000Fu) | 0x43004300u;         // 128 + n
  const uint32_t h = ((p >> 4) & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
  const __nv_bfloat162 lv =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&l), off);
  const __nv_bfloat162 hv =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&h), off);
  lo = *reinterpret_cast<const uint32_t*>(&lv);
  hi = *reinterpret_cast<const uint32_t*>(&hv);
}

// x [R, IN] bf16; w: the layer's packed bytes [IN, OUTH]; scale: the
// layer's [2 * OUTH]; y [R, 2 * OUTH]; partial [splits, R, 2 * OUTH] f32
// when splits > 1.  Grid: (row tiles, column tiles, splits).
template <int kNT, typename TO>
__global__ void __launch_bounds__(kThreadsMma)
int4_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const uint8_t* __restrict__ w,
                       const float* __restrict__ scale, TO* __restrict__ y,
                       float* __restrict__ partial, int R, int IN, int OUTH,
                       int splits) {
  constexpr int kRT = 8 * kNT;  // rows per CTA
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;      // mma group: A/C row, B column
  const int q = lane & 3;       // k pair within the group
  const int row0 = blockIdx.x * kRT;
  const int j0 = blockIdx.y * kColBytes;

  // this warp's slice of the k16 steps: fixed by IN and splits alone
  const int steps = IN / kStepK;
  const int per = (steps + kSlices * splits - 1) / (kSlices * splits);
  const int sbeg = min(steps, (blockIdx.z * kSlices + warp) * per);
  const int send = min(steps, sbeg + per);
  const int kbeg = sbeg * kStepK, kend = send * kStepK;
  const int nstage = (kend - kbeg + kStageK - 1) / kStageK;

  uint8_t* ring = smem + warp * kStages * stage_bytes<kNT>();

  auto load_stage = [&](int s) {
    uint8_t* st = ring + (s % kStages) * stage_bytes<kNT>();
    const int k0 = kbeg + s * kStageK;
    // weights: kStageK rows x 32 bytes, two 16-byte chunks a row
#pragma unroll
    for (int i = 0; i < kStageK * 2 / 32; ++i) {
      const int c = lane + 32 * i;
      const int r = c >> 1, half = c & 1;
      const int k = k0 + r, j = j0 + 16 * half;
      const bool ok = k < kend && j < OUTH;
      cp_async16(st + wrow(r) * 4 + 16 * half,
                 ok ? w + (size_t)k * OUTH + j : w, ok);
    }
    // x: kRT rows x kStageK bf16, four 16-byte chunks a row
    uint8_t* sx = st + kWStageBytes;
#pragma unroll
    for (int i = 0; i < kRT * 4 / 32; ++i) {
      const int c = lane + 32 * i;
      const int r = c >> 2, part = c & 3;
      const int k = k0 + 8 * part;
      const bool ok = row0 + r < R && k < kend;
      cp_async16(sx + (r * kXRow + 8 * part) * 2,
                 ok ? x + (size_t)(row0 + r) * IN + k : x, ok);
    }
  };

  float acc[4][kNT][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][n][i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nstage) load_stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < nstage; ++s) {
    cp_async_wait<kStages - 2>();
    __syncwarp();  // stage s has landed for all lanes; s - 1 is consumed
    if (s + kStages - 1 < nstage) load_stage(s + kStages - 1);
    cp_async_commit();
    const uint8_t* st = ring + (s % kStages) * stage_bytes<kNT>();
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(st);
    const uint32_t* sx = reinterpret_cast<const uint32_t*>(st + kWStageBytes);
#pragma unroll
    for (int kk = 0; kk < kStageK / kStepK; ++kk) {
      if (kbeg + s * kStageK + kk * kStepK >= kend) break;
      const int r = kk * kStepK + 2 * q;
      const uint32_t w0 = sw[wrow(r) + g], w1 = sw[wrow(r + 1) + g];
      const uint32_t w8 = sw[wrow(r + 8) + g], w9 = sw[wrow(r + 9) + g];
      uint32_t b[kNT][2];
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const uint32_t* xr = sx + (n * 8 + g) * (kXRow / 2) + kk * 8 + q;
        b[n][0] = xr[0];
        b[n][1] = xr[4];
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        uint32_t a[4];  // rows g / g + 8: low / high nibble of column 4g + t
        unpack_pair(w0, w1, t, a[0], a[1]);
        unpack_pair(w8, w9, t, a[2], a[3]);
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          float d[4];
          mma_zero(d, a, b[n][0], b[n][1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[t][n][i] += d[i];
        }
      }
    }
  }
  cp_async_wait<0>();

  // slice partials [slice][row][output of the CTA], reusing the ring:
  // output o < 32 is packed column j0 + o's low nibble, o >= 32 its high
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = n * 8 + 2 * q + (i & 1);
        const int o = 4 * g + t + (i >> 1) * kColBytes;
        part[(warp * kRT + r) * kOutsMma + o] = acc[t][n][i];
      }
  __syncthreads();

  for (int e = threadIdx.x; e < kRT * kOutsMma; e += kThreadsMma) {
    const int r = e / kOutsMma, o = e - r * kOutsMma;
    const int half = o >= kColBytes;
    const int j = j0 + o - half * kColBytes;
    if (row0 + r >= R || j >= OUTH) continue;
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < kSlices; ++p) s += part[(p * kRT + r) * kOutsMma + o];
    const int oc = j + half * OUTH;
    const size_t at = (size_t)(row0 + r) * 2 * OUTH + oc;
    if (splits == 1)
      y[at] = from_float<TO>(s * scale[oc]);
    else
      partial[(size_t)blockIdx.z * R * 2 * OUTH + at] = s;
  }
}

// y = (sum of the splits' partials, ascending) * scale, rounded once.
template <typename TO>
__global__ void int4_matmul_sum_kernel(const float* __restrict__ partial,
                                       const float* __restrict__ scale,
                                       TO* __restrict__ y, int R, int OUT,
                                       int splits) {
  const size_t n = (size_t)R * OUT;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[z * n + e];
  y[e] = from_float<TO>(s * scale[e % OUT]);
}

template <int kNT, typename TO>
int launch_mma(const void* x, const uint8_t* w, const float* scale, void* y,
               float* partial, int R, int IN, int OUTH, int splits,
               cudaStream_t stream) {
  auto kernel = int4_matmul_mma_kernel<kNT, TO>;
  constexpr int bytes = smem_bytes<kNT>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((R + 8 * kNT - 1) / (8 * kNT),
            (OUTH + kColBytes - 1) / kColBytes, splits);
  kernel<<<grid, kThreadsMma, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), w, scale, static_cast<TO*>(y),
      partial, R, IN, OUTH, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t n = (size_t)R * 2 * OUTH;
  int4_matmul_sum_kernel<TO><<<(unsigned)((n + 255) / 256), 256, 0,
                               stream>>>(partial, scale, static_cast<TO*>(y),
                                         R, 2 * OUTH, splits);
  return (int)cudaGetLastError();
}

template <typename TO>
int launch_bf16(const void* x, const uint8_t* w, const float* scale, void* y,
                float* partial, int R, int IN, int OUTH, int splits,
                cudaStream_t stream) {
  if (R <= 16)
    return launch_mma<2, TO>(x, w, scale, y, partial, R, IN, OUTH, splits,
                             stream);
  return launch_mma<8, TO>(x, w, scale, y, partial, R, IN, OUTH, splits,
                           stream);
}

// ---------------------------------------------------------------------------
// f32 x: CUDA cores.

constexpr int kFmaSlices = 16;            // warps per CTA, one k slice each
constexpr int kFmaThreads = 32 * kFmaSlices;
constexpr int kRows = 4;                  // rows of x per CTA
constexpr int kBytes = 4;                 // packed columns per lane
constexpr int kCols = 32 * kBytes;        // packed columns per CTA
constexpr int kOuts = 2 * kCols;          // output columns per CTA
constexpr int kChunk = 32;                // k values staged per warp
static_assert(kRows == 4, "x is staged as one float4 per k");

constexpr size_t kFmaStageBytes = sizeof(float4) * kFmaSlices * kChunk;
constexpr size_t kFmaPartBytes = sizeof(float) * kFmaSlices * kRows * kOuts;
constexpr size_t kFmaSmemBytes =
    kFmaStageBytes > kFmaPartBytes ? kFmaStageBytes : kFmaPartBytes;

// (nibble of w at `shift`) - 8, exactly, as a float
__device__ __forceinline__ float nibble(uint32_t w, int shift) {
  return __uint_as_float(0x4B000000u | ((w >> shift) & 0xFu)) - 8388616.0f;
}

// x [R, IN]; w: the layer's packed bytes [IN, OUTH] read as 32-bit words;
// scale: the layer's [2 * OUTH]; y [R, 2 * OUTH].
template <typename TO>
__global__ void __launch_bounds__(kFmaThreads)
int4_matmul_fma_kernel(const float* __restrict__ x,
                       const uint32_t* __restrict__ w,
                       const float* __restrict__ scale, TO* __restrict__ y,
                       int R, int IN, int OUTH) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.y * kRows;
  const int col = blockIdx.x * kCols + lane * kBytes;  // first packed column
  const bool col_ok = col < OUTH;   // OUTH % kBytes == 0: all four in range
  const int words = OUTH / kBytes;  // 32-bit words per k row
  const int slice = (IN + kFmaSlices - 1) / kFmaSlices;
  const int kbeg = min(IN, warp * slice);
  const int kend = min(IN, kbeg + slice);

  float acc[kRows][2 * kBytes];  // [r][i]: column col+i; [r][kBytes+i]: +OUTH
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < 2 * kBytes; ++i) acc[r][i] = 0.f;

  float4* sx = smem4 + warp * kChunk;
  const uint32_t* wcol = w + col / kBytes;
  for (int k0 = kbeg; k0 < kend; k0 += kChunk) {
    const int k = k0 + lane;
    float xv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      xv[r] = (k < kend && row0 + r < R) ? x[(size_t)(row0 + r) * IN + k]
                                         : 0.f;
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
  float* part = reinterpret_cast<float*>(smem4);
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < kBytes; ++i) {
      float* dst = part + (size_t)(warp * kRows + r) * kOuts + lane * kBytes;
      dst[i] = acc[r][i];
      dst[kCols + i] = acc[r][kBytes + i];
    }
  __syncthreads();

  for (int o = threadIdx.x; o < kRows * kOuts; o += kFmaThreads) {
    const int r = o / kOuts;
    const int c = o - r * kOuts;
    const int half = c >= kCols;
    const int j = blockIdx.x * kCols + c - half * kCols;
    if (row0 + r >= R || j >= OUTH) continue;
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < kFmaSlices; ++p)
      s += part[(p * kRows + r) * kOuts + c];
    const int oc = j + half * OUTH;
    y[(size_t)(row0 + r) * 2 * OUTH + oc] = from_float<TO>(s * scale[oc]);
  }
}

template <typename TO>
int launch_f32(const void* x, const uint8_t* w, const float* scale, void* y,
               int R, int IN, int OUTH, cudaStream_t stream) {
  auto kernel = int4_matmul_fma_kernel<TO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kFmaSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((OUTH + kCols - 1) / kCols, (R + kRows - 1) / kRows);
  kernel<<<grid, kFmaThreads, kFmaSmemBytes, stream>>>(
      static_cast<const float*>(x), reinterpret_cast<const uint32_t*>(w),
      scale, static_cast<TO*>(y), R, IN, OUTH);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y [R, 2*OUTH] = x [R, IN] @ dequant(layer `layer` of packed [L, IN, OUTH],
// scale [L, 2*OUTH]).  Launches on `stream` and returns cudaGetLastError()
// (0 on success).  x_bf16 / out_bf16: 1 for bfloat16, 0 for float32.
// f32 x needs OUTH % 4 == 0, a 4-byte aligned `packed` and splits == 1;
// bf16 x needs IN % 16 == 0, OUTH % 16 == 0, 16-byte aligned `x` and
// `packed`, and for splits > 1 an f32 scratch `partial` of
// splits * R * 2 * OUTH.
int samd_int4_matmul(const void* x, const void* packed, const void* scale,
                     void* y, void* partial, int R, int IN, int OUTH,
                     int layer, int splits, int x_bf16, int out_bf16,
                     void* stream) {
  const int align = x_bf16 ? 16 : 4;
  if (R <= 0 || IN <= 0 || OUTH <= 0 || OUTH % align != 0 || layer < 0 ||
      splits < 1 || (splits > 1 && (!x_bf16 || partial == nullptr)) ||
      reinterpret_cast<uintptr_t>(packed) % align != 0 ||
      (x_bf16 && (IN % kStepK != 0 ||
                  reinterpret_cast<uintptr_t>(x) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const uint8_t* w =
      static_cast<const uint8_t*>(packed) + (size_t)layer * IN * OUTH;
  const float* s = static_cast<const float*>(scale) + (size_t)layer * 2 * OUTH;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  if (x_bf16 && out_bf16)
    return launch_bf16<__nv_bfloat16>(x, w, s, y, p, R, IN, OUTH, splits, st);
  if (x_bf16)
    return launch_bf16<float>(x, w, s, y, p, R, IN, OUTH, splits, st);
  if (out_bf16) return launch_f32<__nv_bfloat16>(x, w, s, y, R, IN, OUTH, st);
  return launch_f32<float>(x, w, s, y, R, IN, OUTH, st);
}

const char* samd_int4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
