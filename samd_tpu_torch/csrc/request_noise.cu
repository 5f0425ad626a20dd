// Per-request uniform noise for Hopper (sm_90a): a counter-based Philox
// stream per request, computed on the device.
//
// Replaces no Pallas kernel.  The reference carries each request's
// jax.random key through its device loop and splits it every step inside
// XLA (samd_tpu/fused_sam.py:682-688, seeded at :806-813; one stream at
// :338, :399-423).  Here a request's noise is a pure function of its seed,
// its draw index and the element, so every slot of a batch can draw in
// every step of a captured CUDA graph, and a slot's stream still advances
// only on its own live sampled steps (the engines keep the draw counters
// on the device and advance them there).
//
// The stream, which ops/request_noise.py's plain version computes bit for
// bit: for slot b with seed s (uint64) and draw index d, element j is word
// (j & 3) of Philox4x32-10(counter = (j >> 2, d, 0, 0),
// key = (s & 0xffffffff, s >> 32)) (Salmon et al., "Parallel random
// numbers: as easy as 1, 2, 3", SC 2011; Random123's constants), and the
// uniform is (w >> 8) * 2^-24, in [0, 1).  A slot whose mask byte is 0
// gets zeros.
//
// What bounds it on an H100 (3.35 TB/s): it reads 13 bytes a slot and
// writes 4 bytes an element, and does ten rounds of two 32-bit multiplies
// for every four elements.  At the batched server's rejection signature
// (B 12, n = 16 + 32000) that is 1.54 MB, 0.46 us; at the hybrid's nucleus
// signature (B 12, n = 24 * 24 + 25 * 32000) 38.4 MB, 11.5 us: the bytes
// bound.  Design: one thread per Philox block of four elements, its four
// words written as one 16-byte store when n is a multiple of 4 (neighbour
// threads write neighbour 16-byte chunks), masked at the ragged end of a
// row otherwise.  The seeds, draws and mask are read from device memory,
// so a replayed graph sees their current values.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kMul0 = 0xD2511F53u;
constexpr uint32_t kMul1 = 0xCD9E8D57u;
constexpr uint32_t kWeyl0 = 0x9E3779B9u;
constexpr uint32_t kWeyl1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round) {
      k0 += kWeyl0;
      k1 += kWeyl1;
    }
    const uint32_t hi0 = __umulhi(kMul0, c.x), lo0 = kMul0 * c.x;
    const uint32_t hi1 = __umulhi(kMul1, c.z), lo1 = kMul1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float to_uniform(uint32_t w) {
  return (float)(w >> 8) * 0x1p-24f;
}

__global__ void request_uniforms_kernel(const int64_t* __restrict__ seeds,
                                        const int32_t* __restrict__ draws,
                                        const uint8_t* __restrict__ mask,
                                        float* __restrict__ out, int64_t n,
                                        int64_t blocks, int vec4) {
  const int b = blockIdx.y;
  const int64_t blk = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (blk >= blocks) return;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (mask == nullptr || mask[b]) {
    const uint64_t s = (uint64_t)seeds[b];
    const uint4 w = philox4x32_10(
        make_uint4((uint32_t)blk, (uint32_t)draws[b], 0u, 0u),
        (uint32_t)s, (uint32_t)(s >> 32));
    v = make_float4(to_uniform(w.x), to_uniform(w.y), to_uniform(w.z),
                    to_uniform(w.w));
  }
  float* row = out + (int64_t)b * n;
  const int64_t j = blk * 4;
  if (vec4) {
    *reinterpret_cast<float4*>(row + j) = v;
    return;
  }
  const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (j + i < n) row[j + i] = vals[i];
}

}  // namespace

extern "C" {

// out [B, n] f32 = the uniforms of each slot's (seed, draw) stream;
// seeds [B] int64, draws [B] int32, mask [B] bytes or null (every slot
// draws).  n >= 1, B >= 1.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).  With vec4 = 1, n must be a multiple
// of 4 and out 16-byte aligned.
int samd_request_uniforms(const void* seeds, const void* draws,
                          const void* mask, void* out, int B, long long n,
                          int vec4, cudaStream_t stream) {
  const int64_t blocks = (n + 3) / 4;
  const int threads = 256;
  const dim3 grid((unsigned)((blocks + threads - 1) / threads), (unsigned)B);
  request_uniforms_kernel<<<grid, threads, 0, stream>>>(
      static_cast<const int64_t*>(seeds), static_cast<const int32_t*>(draws),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out),
      (int64_t)n, blocks, vec4);
  return (int)cudaGetLastError();
}

const char* samd_request_noise_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
