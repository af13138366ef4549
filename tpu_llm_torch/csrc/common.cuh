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

// -- cp.async, ldmatrix, mma.sync (K1-K6) -------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared (through L1); zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one bf16x2 word, round to nearest; `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two f32 as three bf16x2 words, x = hi + mid + lo to f32's 24 bits (each
// residual is exact in f32)
__device__ __forceinline__ void split3_bf16(float a, float b, uint32_t& hi, uint32_t& mid,
                                            uint32_t& lo) {
  const float ah = round_bf16(a), bh = round_bf16(b);
  const float ar = a - ah, br = b - bh;
  const float am = round_bf16(ar), bm = round_bf16(br);
  hi = pack_bf16(ah, bh);
  mid = pack_bf16(am, bm);
  lo = pack_bf16(ar - am, br - bm);
}

}  // namespace tlt
