// Shared helpers for the tpu_llm_torch CUDA kernels (plain C interface,
// no PyTorch headers: each file compiles with nvcc in seconds).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TLT_API extern "C" __attribute__((visibility("default")))

namespace tlt {

// the masked-score value of the reference kernels: -0.7 * f32 max. Finite,
// so exp(NEG_INF - m) is exactly 0 for any finite running max m and a
// fully masked row never produces inf - inf.
constexpr float NEG_INF = -0.7f * 3.402823466e+38f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round an f32 to the nearest bf16 and back (what a cast to bf16 and an
// f32 product with it computes)
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 4 consecutive bytes of row `row` of a row-major (rows, N) byte plane,
// columns n0..n0+3, as one little-endian word (zero past N); `vec`: N % 4
// == 0 and a 4-byte-aligned plane, so one 32-bit load
__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ base, int64_t row,
                                          int n0, int N, bool vec) {
  if (n0 >= N) return 0;
  const uint8_t* p = base + row * N + n0;
  if (vec) return __ldg(reinterpret_cast<const uint32_t*>(p));
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (n0 + c < N) v |= uint32_t(__ldg(p + c)) << (8 * c);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace tlt
