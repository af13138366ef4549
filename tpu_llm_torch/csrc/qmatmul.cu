// Fused dequant-matmul for packed q4_0 / q8_0 weights on Hopper.
//
// Replaces: tpu_llm/quant/pallas_matmul.py::_qmm_kernel (wrapper
// qmatmul_pallas) for kinds q4_0 and q8_0 with f32 scale planes.
//
// Computes out (rows, N) = x (rows, K) @ W (K, N), W packed as in
// tpu_llm_torch/quant/qtensor.py: q4_0 byte (16b + j, n) holds W[32b + j, n]
// in its low nibble and W[32b + 16 + j, n] in its high nibble, value
// (nibble - 8) * scale[b, n]; q8_0 value q[k, n] * scale[k / 32, n].
// Accumulation is f32 for f32 and bf16 activations alike.
//
// What bounds it on the H100: at decode (rows 1-8) the weight bytes, 0.5625
// (q4_0) or 1.125 (q8_0) bytes a weight with the f32 scales, over the
// 3.35 TB/s of HBM; nothing of the weight is reused. At prefill rows the
// f32 FMAs on the CUDA cores.
//
// Design against that bound:
// - every weight byte is read once per 8-row tile, 4 columns per 32-bit
//   load, a warp reading 128 contiguous bytes of a packed row (coalesced);
//   the nibble unpack happens in registers and the per-block scale is
//   applied once per 32-row block, not per weight;
// - decode has few columns per matrix (2048 columns = 16 blocks of 128),
//   so K is split: 8 warps of a block take interleaved 32-row blocks and
//   reduce through shared memory, and the grid's y dimension splits K
//   further until the grid covers the 132 SMs about twice; the y partials
//   go to an f32 workspace summed by a second, small kernel (fixed order:
//   the result does not depend on scheduling);
// - ragged N is masked per thread (32000 = 250 x 128; 2560 = 20 x 128).
// Not yet: tensor cores (wgmma) for prefill rows, cp.async/TMA pipelining.

#include "common.cuh"

namespace {

using tlt::to_f32;

constexpr int kWarps = 8;                 // K slices of one block
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 128;                // 32 lanes x 4 columns

// 4 consecutive bytes of packed row `row`, columns n0..n0+3 (zero past N)
__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ base,
                                          int64_t row, int n0, int N, bool vec) {
  const uint8_t* p = base + row * N + n0;
  if (vec) return __ldg(reinterpret_cast<const uint32_t*>(p));
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (n0 + c < N) v |= uint32_t(__ldg(p + c)) << (8 * c);
  return v;
}

template <typename XT, int KIND, int ROWS>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ q,
           const float* __restrict__ scales, void* __restrict__ out, int out_bf16,
           float* __restrict__ partial, int rows, int K, int N, int kb_per_split) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = (blockIdx.x * 32 + lane) * 4;
  const int split = blockIdx.y;
  const int r0 = blockIdx.z * ROWS;
  const int nrows = min(ROWS, rows - r0);
  const int nkb = K / 32;
  const int kb_begin = split * kb_per_split;
  const int kb_end = min(nkb, kb_begin + kb_per_split);
  const bool vec = (N & 3) == 0;
  const XT* xr = x + (int64_t)r0 * K;

  float acc[ROWS][4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  if (n0 < N) {
    for (int kb = kb_begin + warp; kb < kb_end; kb += kWarps) {
      float blk[ROWS][4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) blk[r][c] = 0.f;
      const int k0 = kb * 32;
      if (KIND == 0) {
        // q4_0: byte row 16kb + j -> weights k0 + j (lo) and k0 + 16 + j (hi)
#pragma unroll 4
        for (int j = 0; j < 16; ++j) {
          const uint32_t b = load4(q, (int64_t)kb * 16 + j, n0, N, vec);
          float xlo[ROWS], xhi[ROWS];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            xlo[r] = r < nrows ? to_f32(xr[(int64_t)r * K + k0 + j]) : 0.f;
            xhi[r] = r < nrows ? to_f32(xr[(int64_t)r * K + k0 + 16 + j]) : 0.f;
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const uint32_t byte = (b >> (8 * c)) & 0xFFu;
            const float lo = float(int(byte & 0xFu) - 8);
            const float hi = float(int(byte >> 4) - 8);
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
              blk[r][c] = fmaf(xhi[r], hi, fmaf(xlo[r], lo, blk[r][c]));
          }
        }
      } else {
        // q8_0: one int8 per weight, row k of the plane
#pragma unroll 4
        for (int j = 0; j < 32; ++j) {
          const uint32_t b = load4(q, (int64_t)k0 + j, n0, N, vec);
          float xv[ROWS];
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            xv[r] = r < nrows ? to_f32(xr[(int64_t)r * K + k0 + j]) : 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float w = float(int8_t((b >> (8 * c)) & 0xFFu));
#pragma unroll
            for (int r = 0; r < ROWS; ++r) blk[r][c] = fmaf(xv[r], w, blk[r][c]);
          }
        }
      }
      float s[4];
      const float* srow = scales + (int64_t)kb * N + n0;
      if (vec) {
        const float4 s4 = __ldg(reinterpret_cast<const float4*>(srow));
        s[0] = s4.x; s[1] = s4.y; s[2] = s4.z; s[3] = s4.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[c] = n0 + c < N ? __ldg(srow + c) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(blk[r][c], s[c], acc[r][c]);
    }
  }

  // reduce the 8 warps' K slices
  __shared__ float red[kWarps][ROWS][kCols];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][r][lane * 4 + c] = acc[r][c];
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * kCols; i += kThreads) {
    const int r = i / kCols, col = i % kCols;
    const int n = blockIdx.x * kCols + col;
    if (r < nrows && n < N) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[w][r][col];
      const int64_t o = (int64_t)(r0 + r) * N + n;
      if (partial != nullptr)
        partial[(int64_t)split * rows * N + o] = sum;
      else if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(sum);
      else
        static_cast<float*>(out)[o] = sum;
    }
  }
}

// sum the K-split partials in a fixed order and store in the output dtype
__global__ void qmm_reduce(const float* __restrict__ partial, void* __restrict__ out,
                           int out_bf16, int64_t count, int ksplit) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float sum = 0.f;
  for (int y = 0; y < ksplit; ++y) sum += partial[(int64_t)y * count + i];
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(sum);
  else
    static_cast<float*>(out)[i] = sum;
}

template <typename XT, int KIND>
void launch_rows(const void* x, const uint8_t* q, const float* scales, void* out,
                 int out_bf16, float* partial, int rows, int K, int N, int ksplit,
                 int kb_per_split, cudaStream_t st) {
  const int rt = rows >= 8 ? 8 : rows >= 4 ? 4 : rows >= 2 ? 2 : 1;
  dim3 grid((N + kCols - 1) / kCols, ksplit, (rows + rt - 1) / rt);
  const XT* xp = static_cast<const XT*>(x);
  float* part = ksplit > 1 ? partial : nullptr;
  switch (rt) {
    case 8: qmm_kernel<XT, KIND, 8><<<grid, kThreads, 0, st>>>(xp, q, scales, out, out_bf16, part, rows, K, N, kb_per_split); break;
    case 4: qmm_kernel<XT, KIND, 4><<<grid, kThreads, 0, st>>>(xp, q, scales, out, out_bf16, part, rows, K, N, kb_per_split); break;
    case 2: qmm_kernel<XT, KIND, 2><<<grid, kThreads, 0, st>>>(xp, q, scales, out, out_bf16, part, rows, K, N, kb_per_split); break;
    default: qmm_kernel<XT, KIND, 1><<<grid, kThreads, 0, st>>>(xp, q, scales, out, out_bf16, part, rows, K, N, kb_per_split); break;
  }
}

}  // namespace

// kind: 0 = q4_0, 1 = q8_0. partial: (ksplit, rows, N) f32 workspace when
// ksplit > 1, else unused. Returns cudaGetLastError() after the launches.
TLT_API int tlt_qmatmul(const void* x, int x_bf16, const void* q, const void* scales,
                        int kind, void* out, int out_bf16, void* partial, int rows,
                        int K, int N, int ksplit, int kb_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  const float* sp = static_cast<const float*>(scales);
  float* pp = static_cast<float*>(partial);
  if (x_bf16) {
    if (kind == 0) launch_rows<__nv_bfloat16, 0>(x, qp, sp, out, out_bf16, pp, rows, K, N, ksplit, kb_per_split, st);
    else launch_rows<__nv_bfloat16, 1>(x, qp, sp, out, out_bf16, pp, rows, K, N, ksplit, kb_per_split, st);
  } else {
    if (kind == 0) launch_rows<float, 0>(x, qp, sp, out, out_bf16, pp, rows, K, N, ksplit, kb_per_split, st);
    else launch_rows<float, 1>(x, qp, sp, out, out_bf16, pp, rows, K, N, ksplit, kb_per_split, st);
  }
  if (ksplit > 1) {
    const int64_t count = (int64_t)rows * N;
    const int threads = 256;
    qmm_reduce<<<(unsigned)((count + threads - 1) / threads), threads, 0, st>>>(
        pp, out, out_bf16, count, ksplit);
  }
  return (int)cudaGetLastError();
}
