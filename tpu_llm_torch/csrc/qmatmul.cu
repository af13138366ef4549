// Fused dequant-matmul for packed block-quantized weights on Hopper.
//
// Replaces: tpu_llm/quant/pallas_matmul.py::_qmm_kernel (wrapper
// qmatmul_pallas) for every kind it takes, the int4-plane q4_0i4 of the
// --scan program included, with f32, bf16 or f16-bit (int16) scale and mins
// planes (_scale_f32), the affine mins plane and the row_scale operand.
//
// Computes out (rows, N) = (x * row_scale) (rows, K) @ W (K, N), with W as
// packed in tpu_llm_torch/quant/qtensor.py: value v[k, n] times the scale of
// its block (16 or 32 rows), plus the block's min for the affine kinds:
//   out[r, n] = sum_k x'[r, k] v[k, n] s[k / B, n] + sum_b xs[r, b] m[b, n]
// where x' = x * row_scale (f32, not rounded) and xs[r, b] the sum of x' over
// block b. Value planes:
// - nibble-packed (q4_0, q4_0i4, q4_1, q2_kp, q3_kp): byte (16b + j, n) holds
//   v[32b + j, n] (low nibble) and v[32b + 16 + j, n] (high nibble), minus a
//   per-kind offset (8, 8, 0, 0, 4); q4_0i4 stores its signed int4 values in
//   offset binary, so it is q4_0's layout in blocks of 32 or 16 rows;
// - q6_kp: the same nibbles, plus 2 high bits from the (K/4, N) qh plane
//   (byte (8b + i, n) bits 2*(r/8).. for row 32b + r, i = r % 8), minus 32;
// - int8 (q8_0, q5_0, q5_1, q2_k, q3_k, q6_k): v[k, n] = q[k, n].
// Accumulation is f32 for f32 and bf16 activations alike; bf16 scale and min
// planes are widened in registers (exact), f16 bits through __half2float
// (exact, subnormal scales included).
//
// What bounds it on the H100: at decode (rows 1-8) the weight bytes, from
// 0.5625 (q4_0 / q4_0i4 with 2-byte planes) to 1.125 (q8_0; q6_k with bf16
// per-16 scales) bytes a weight, over the 3.35 TB/s of HBM; nothing of the
// weight is reused. At prefill rows the f32 FMAs on the CUDA cores.
//
// Design against that bound:
// - every weight byte is read once per 8-row tile, 4 columns per 32-bit
//   load, a warp reading 128 contiguous bytes of a packed row (coalesced);
//   the unpack happens in registers and the scales are applied once per
//   16-row half block (two partial sums a thread), not per weight;
// - the mins need the block sums of x', which every column shares: the warp
//   that owns a 32-row block sums its x' once (one row element a lane, a
//   16-lane shuffle reduction), not once per column;
// - decode has few columns per matrix (2048 columns = 16 blocks of 128),
//   so K is split: 8 warps of a block take interleaved 32-row blocks and
//   reduce through shared memory, and the grid's y dimension splits K
//   further until the grid covers the card's SMs about twice; the y
//   partials go to an f32 workspace summed by a second, small kernel (fixed
//   order: the result does not depend on scheduling);
// - ragged N is masked per thread (32000 = 250 x 128; 2560 = 20 x 128).
// Not yet: tensor cores (wgmma) for prefill rows, cp.async/TMA pipelining.
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

using tlt::load4;
using tlt::to_f32;

constexpr int kWarps = 8;                 // K slices of one block
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 128;                // 32 lanes x 4 columns

// value planes: int8 values, nibble-packed, nibble-packed + qh plane
enum Pack { kInt8 = 0, kNibble = 1, kNibbleQh = 2 };
// scale / mins plane element types
enum Plane { kF32 = 0, kBF16 = 1, kF16Bits = 2 };

// one 16-bit plane element as f32: bf16 widens by a shift, f16 bits through
// the hardware conversion (both exact)
__device__ __forceinline__ float half_bits_to_f32(uint32_t h, int dtype) {
  return dtype == kBF16 ? __uint_as_float(h << 16)
                        : __half2float(__ushort_as_half((unsigned short)h));
}

// 4 scale (or min) values of plane row `row`, columns n0..n0+3, as f32
// (zero past N)
__device__ __forceinline__ void load_plane4(const void* __restrict__ plane, int dtype,
                                            int64_t row, int n0, int N, bool vec,
                                            float out[4]) {
  if (n0 >= N) {
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c] = 0.f;
    return;
  }
  const int64_t o = row * N + n0;
  if (dtype != kF32) {
    const uint16_t* p = static_cast<const uint16_t*>(plane) + o;
    if (vec) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      out[0] = half_bits_to_f32(v.x & 0xFFFFu, dtype);
      out[1] = half_bits_to_f32(v.x >> 16, dtype);
      out[2] = half_bits_to_f32(v.y & 0xFFFFu, dtype);
      out[3] = half_bits_to_f32(v.y >> 16, dtype);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        out[c] = n0 + c < N ? half_bits_to_f32(__ldg(p + c), dtype) : 0.f;
    }
  } else {
    const float* p = static_cast<const float*>(plane) + o;
    if (vec) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p));
      out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) out[c] = n0 + c < N ? __ldg(p + c) : 0.f;
    }
  }
}

template <int ROWS>
__device__ __forceinline__ void fma_cols(float (&b)[ROWS][4], const float (&xv)[ROWS],
                                         const float (&w)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) b[r][c] = fmaf(xv[r], w[c], b[r][c]);
}

// x'[r, k] for the tile's rows (zero past the last row)
template <typename XT, int ROWS>
__device__ __forceinline__ void load_x(const XT* __restrict__ xr, const float* __restrict__ rs,
                                       int nrows, int K, int k, float (&xv)[ROWS]) {
  const float s = rs != nullptr ? __ldg(rs + k) : 1.f;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    xv[r] = r < nrows ? to_f32(xr[(int64_t)r * K + k]) * s : 0.f;
}

template <typename XT, int PACK, bool B16, int ROWS>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const XT* __restrict__ x, const float* __restrict__ rs,
           const uint8_t* __restrict__ q, const uint8_t* __restrict__ qh,
           const void* __restrict__ scales, const void* __restrict__ mins, int s_dtype,
           int voff, void* __restrict__ out, int out_bf16, float* __restrict__ partial,
           int rows, int K, int N, int kb_per_split) {
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

  // every lane runs the loop (columns past N load zeros): the block sums
  // below shuffle across the whole warp
  for (int kb = kb_begin + warp; kb < kb_end; kb += kWarps) {
    // partial sums of the first and the second 16 rows of the block
    float blo[ROWS][4], bhi[ROWS][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) blo[r][c] = bhi[r][c] = 0.f;
    const int k0 = kb * 32;
    if (PACK != kInt8) {
#pragma unroll 4
      for (int j = 0; j < 16; ++j) {
        const uint32_t b = load4(q, (int64_t)kb * 16 + j, n0, N, vec);
        uint32_t h = 0;
        if (PACK == kNibbleQh) h = load4(qh, (int64_t)kb * 8 + (j & 7), n0, N, vec);
        const int sh = 2 * (j >> 3);          // rows j (low) and j + 16 (high)
        float xlo[ROWS], xhi[ROWS];
        load_x<XT, ROWS>(xr, rs, nrows, K, k0 + j, xlo);
        load_x<XT, ROWS>(xr, rs, nrows, K, k0 + 16 + j, xhi);
        float wlo[4], whi[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t byte = (b >> (8 * c)) & 0xFFu;
          uint32_t lo = byte & 0xFu, hi = byte >> 4;
          if (PACK == kNibbleQh) {
            const uint32_t hb = (h >> (8 * c)) & 0xFFu;
            lo |= ((hb >> sh) & 3u) << 4;
            hi |= ((hb >> (sh + 4)) & 3u) << 4;
          }
          wlo[c] = float(int(lo) - voff);
          whi[c] = float(int(hi) - voff);
        }
        fma_cols<ROWS>(blo, xlo, wlo);
        if (B16) fma_cols<ROWS>(bhi, xhi, whi);
        else fma_cols<ROWS>(blo, xhi, whi);
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < 16; ++j) {
        const uint32_t blw = load4(q, (int64_t)k0 + j, n0, N, vec);
        const uint32_t bhw = load4(q, (int64_t)k0 + 16 + j, n0, N, vec);
        float xlo[ROWS], xhi[ROWS];
        load_x<XT, ROWS>(xr, rs, nrows, K, k0 + j, xlo);
        load_x<XT, ROWS>(xr, rs, nrows, K, k0 + 16 + j, xhi);
        float wlo[4], whi[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          wlo[c] = float(int8_t((blw >> (8 * c)) & 0xFFu));
          whi[c] = float(int8_t((bhw >> (8 * c)) & 0xFFu));
        }
        fma_cols<ROWS>(blo, xlo, wlo);
        if (B16) fma_cols<ROWS>(bhi, xhi, whi);
        else fma_cols<ROWS>(blo, xhi, whi);
      }
    }
    // scales: per-16 blocks take plane rows 2kb (first half) and 2kb + 1
    float slo[4], shi[4];
    load_plane4(scales, s_dtype, B16 ? 2 * (int64_t)kb : kb, n0, N, vec, slo);
    if (B16) load_plane4(scales, s_dtype, 2 * (int64_t)kb + 1, n0, N, vec, shi);
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[r][c] = fmaf(blo[r][c], slo[c], acc[r][c]);
        if (B16) acc[r][c] = fmaf(bhi[r][c], shi[c], acc[r][c]);
      }
    if (mins != nullptr) {
      // block sums of x': lane l holds row element k0 + l; lanes 0-15 and
      // 16-31 reduce separately, giving the two 16-row halves
      float xs_lo[ROWS], xs_hi[ROWS];
      float xl[ROWS];
      load_x<XT, ROWS>(xr, rs, nrows, K, k0 + lane, xl);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float v = xl[r];
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        xs_lo[r] = __shfl_sync(0xffffffffu, v, 0);
        xs_hi[r] = __shfl_sync(0xffffffffu, v, 16);
      }
      float mlo[4], mhi[4];
      load_plane4(mins, s_dtype, B16 ? 2 * (int64_t)kb : kb, n0, N, vec, mlo);
      if (B16) load_plane4(mins, s_dtype, 2 * (int64_t)kb + 1, n0, N, vec, mhi);
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (B16)
            acc[r][c] = fmaf(xs_hi[r], mhi[c], fmaf(xs_lo[r], mlo[c], acc[r][c]));
          else
            acc[r][c] = fmaf(xs_lo[r] + xs_hi[r], mlo[c], acc[r][c]);
        }
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

struct Args {
  const void* x; const float* rs; const uint8_t* q; const uint8_t* qh;
  const void* scales; const void* mins; int s_dtype; int voff;
  void* out; int out_bf16; float* partial; int rows, K, N, ksplit, kb_per_split;
};

template <typename XT, int PACK, bool B16, int RT>
void launch_tile(const Args& a, cudaStream_t st) {
  dim3 grid((a.N + kCols - 1) / kCols, a.ksplit, (a.rows + RT - 1) / RT);
  qmm_kernel<XT, PACK, B16, RT><<<grid, kThreads, 0, st>>>(
      static_cast<const XT*>(a.x), a.rs, a.q, a.qh, a.scales, a.mins, a.s_dtype, a.voff,
      a.out, a.out_bf16, a.ksplit > 1 ? a.partial : nullptr, a.rows, a.K, a.N,
      a.kb_per_split);
}

template <typename XT, int PACK, bool B16>
void launch_rows(const Args& a, cudaStream_t st) {
  const int rt = a.rows >= 8 ? 8 : a.rows >= 4 ? 4 : a.rows >= 2 ? 2 : 1;
  switch (rt) {
    case 8: launch_tile<XT, PACK, B16, 8>(a, st); break;
    case 4: launch_tile<XT, PACK, B16, 4>(a, st); break;
    case 2: launch_tile<XT, PACK, B16, 2>(a, st); break;
    default: launch_tile<XT, PACK, B16, 1>(a, st); break;
  }
}

template <typename XT>
int launch_kind(const Args& a, int pack, int block, cudaStream_t st) {
  if (pack == kNibble && block == 32) launch_rows<XT, kNibble, false>(a, st);
  else if (pack == kNibble && block == 16) launch_rows<XT, kNibble, true>(a, st);
  else if (pack == kNibbleQh && block == 16) launch_rows<XT, kNibbleQh, true>(a, st);
  else if (pack == kInt8 && block == 32) launch_rows<XT, kInt8, false>(a, st);
  else if (pack == kInt8 && block == 16) launch_rows<XT, kInt8, true>(a, st);
  else return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// pack: 0 int8 values, 1 nibble-packed, 2 nibble-packed + qh plane (qh, K/4
// rows); voff: subtracted from each unpacked value; block: 32 or 16 rows a
// scale; scales / mins: f32 (s_dtype 0), bf16 (1) or f16-bit (2) planes of
// one dtype, mins may be null;
// row_scale: (K,) f32 or null. partial: (ksplit, rows, N) f32 workspace when
// ksplit > 1, else unused. Returns cudaGetLastError() after the launches.
TLT_API int tlt_qmatmul(const void* x, int x_bf16, const void* row_scale, const void* q,
                        const void* qh, const void* scales, const void* mins, int s_dtype,
                        int pack, int voff, int block, void* out, int out_bf16,
                        void* partial, int rows, int K, int N, int ksplit,
                        int kb_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{x, static_cast<const float*>(row_scale), static_cast<const uint8_t*>(q),
               static_cast<const uint8_t*>(qh), scales, mins, s_dtype, voff, out, out_bf16,
               static_cast<float*>(partial), rows, K, N, ksplit, kb_per_split};
  const int bad = x_bf16 ? launch_kind<__nv_bfloat16>(a, pack, block, st)
                         : launch_kind<float>(a, pack, block, st);
  if (bad) return bad;
  if (ksplit > 1) {
    const int64_t count = (int64_t)rows * N;
    const int threads = 256;
    qmm_reduce<<<(unsigned)((count + threads - 1) / threads), threads, 0, st>>>(
        static_cast<float*>(partial), out, out_bf16, count, ksplit);
  }
  return (int)cudaGetLastError();
}
