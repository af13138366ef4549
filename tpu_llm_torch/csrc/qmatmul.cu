// Fused dequant-matmul for packed block-quantized weights on Hopper (K1).
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
//
// What bounds it on the H100. At 1-8 rows (decode, a verify window): the
// weight bytes, from 0.5625 (q4_0 / q4_0i4 with 2-byte planes) to 1.125
// (q8_0; q6_k with bf16 per-16 scales) bytes a weight, over 3.35 TB/s;
// nothing of the weight is reused, and at that rate the SMs have ~5
// instructions a weight per thread-lane to spend, so the unpack and the
// multiply-adds must stay well below that. At prefill rows (512 x w13):
// 2 * rows * K * N operations over the bf16 tensor-core rate (989 TFLOP/s).
//
// Design, one body for every row count:
// - every kind's value is a small integer (-128..127), exact in bf16, so
//   the products run on the tensor cores: mma.sync m16n8k16, bf16 in, f32
//   accumulate, x as the A operand (rows 1-16 pad one m16 tile: the tensor
//   cores take the multiply-adds off the CUDA cores), the unpacked values as
//   B. A CTA of 4 warps owns 128 columns, each warp 32 (4 n8 tiles); a B
//   fragment's column g of tile t is physical column 4g + t, so one 32-bit
//   shared load of a packed row gives a thread its byte of all four tiles;
//   the k order inside a block is the natural one, so x needs no permute;
// - unpacking is integer work in registers: a byte permute pairs the two
//   rows of a B register, a mask-or puts each nibble under the exponent of
//   128.0 in bf16 (0x4300 | n = 128 + n), one bf16x2 subtract removes 128
//   plus the kind's offset; int8 values go through the same trick in f32
//   (2^23 + u) and one pack to bf16x2;
// - the weight, qh, scale and mins rows of one 32-row block and the x
//   tile of its 32 k form a stage; the stages stream through a ring in
//   shared memory (8 deep at 1-16 rows, 6 for int8 values; 4 at prefill
//   rows) with 16-byte cp.async copies (weight rows padded to 144
//   bytes, x rows by 16: the fragment reads are free of bank conflicts);
// - scales go on the accumulators, not on the weights: a k16 step (per-16
//   kinds) or two (per-32) sum x . v into a fresh fragment, which is then
//   multiplied by its column's scale and added to the running f32
//   accumulator; the mins term adds xs * m there too. The weight is never
//   rounded with its scale;
// - bf16 x without row_scale is exact in bf16: ldmatrix reads the A
//   fragments straight from the stage (each used by the 4 n tiles). f32 x'
//   (f32 x, or any row_scale) is never rounded: once a block it is split
//   into hi + mid + lo, three bf16 parts holding all 24 bits, three
//   products a step. The block sums of x' for the mins are one more
//   product of the same A fragments with a B of ones (f32 sums);
// - prefill rows take 64-row tiles (4 m16 tiles a warp: each B fragment is
//   used 4 times); rows are tiled rounding up (5 rows are one tile);
// - the grid's y dimension splits K until the card holds about 4 CTAs an
//   SM; each split stores an f32 partial, and the last CTA of each output
//   tile (an int32 counter, atomicAdd after a __threadfence) sums them in
//   split order, so the result does not depend on scheduling, and resets
//   its counter: one launch a call, graph replays need no memset;
// - ragged N or planes not on 16-byte boundaries take plain loads into the
//   same stages, zero past N.
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

using tlt::cp_async16;
using tlt::cp_async_commit;
using tlt::cp_async_wait;
using tlt::ldsm_x4;
using tlt::mma_bf16;
using tlt::pack_bf16;
using tlt::round_bf16;
using tlt::to_f32;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;             // 4 warps
constexpr int kCols = 128;                // columns a CTA, 32 a warp
constexpr int kRowB = kCols + 16;         // a staged byte row, padded
// value planes: int8 values, nibble-packed, nibble-packed + qh plane
enum Pack { kInt8 = 0, kNibble = 1, kNibbleQh = 2 };
// scale / mins plane element types
enum Plane { kF32 = 0, kBF16 = 1, kF16Bits = 2 };

// one stage, a 32-row block of K: its value rows, qh rows, scale rows and
// mins rows (a plane row holds 128 elements of up to 4 bytes), and the x
// tile (RT rows x 32 k of raw XT, rows padded by 16 bytes)
template <typename XT, int PACK, bool B16, int MT>
struct Stage {
  static constexpr int RT = 16 * MT;
  static constexpr int WROWS = PACK == kInt8 ? 32 : 16;
  static constexpr int QROWS = PACK == kNibbleQh ? 8 : 0;
  static constexpr int SROWS = B16 ? 2 : 1;
  static constexpr int XROWB = 32 * (int)sizeof(XT) + 16;
  static constexpr int Q_OFF = WROWS * kRowB;
  static constexpr int S_OFF = Q_OFF + QROWS * kRowB;
  static constexpr int M_OFF = S_OFF + SROWS * kCols * 4;
  static constexpr int X_OFF = M_OFF + SROWS * kCols * 4;
  static constexpr int BYTES = X_OFF + RT * XROWB;
  // stages in the ring: 7 blocks in flight at 1-16 rows (5 for int8
  // values, so 4 CTAs fit an SM), 3 at prefill rows
  static constexpr int N = MT == 1 ? (PACK == kInt8 ? 6 : 8) : 4;
};

constexpr int kPartLD = 40;   // a converted x part's row: 32 bf16, padded by 16 bytes

template <typename XT, int PARTS, int PACK, bool B16, int MT>
constexpr size_t smem_bytes() {
  using SG = Stage<XT, PACK, B16, MT>;
  return (size_t)SG::N * SG::BYTES + sizeof(bf16) * (PARTS == 3 ? 3 : 0) * SG::RT * kPartLD;
}

// d = a (16x16 bf16, row) * b (16x8 bf16, col), f32, from zero
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// one 16-bit plane element as f32: bf16 widens by a shift, f16 bits through
// the hardware conversion (both exact)
__device__ __forceinline__ float half_bits_to_f32(uint32_t h, int dtype) {
  return dtype == kBF16 ? __uint_as_float(h << 16)
                        : __half2float(__ushort_as_half((unsigned short)h));
}

// 8 consecutive elements of a staged scale / mins row as f32
__device__ __forceinline__ void plane8(const unsigned char* row, int dtype, int col,
                                       float (&v)[8]) {
  if (dtype == kF32) {
    const float4 a = *reinterpret_cast<const float4*>(row + col * 4);
    const float4 b = *reinterpret_cast<const float4*>(row + col * 4 + 16);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(row + col * 2);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = half_bits_to_f32(w[i] & 0xFFFFu, dtype);
      v[2 * i + 1] = half_bits_to_f32(w[i] >> 16, dtype);
    }
  }
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// byte t of a (low half) and byte t of b (high half): bits 0-7 and 16-23
__device__ __forceinline__ uint32_t pair_bytes(uint32_t a, uint32_t b, int t) {
  return __byte_perm(a, b, t | ((4 + t) << 8));
}

// signed byte t of a word as an exact f32 (u = v + 128 under 2^23)
__device__ __forceinline__ float s8_to_f32(uint32_t w_xor80, int t) {
  return __int_as_float(__byte_perm(w_xor80, 0x4B000000u, 0x7540 | t)) - 8388736.f;
}

template <typename XT, int PARTS, int PACK, bool B16, int MT>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 4 : 3)
qmm_tc_kernel(const XT* __restrict__ x, const float* __restrict__ rs,
              const uint8_t* __restrict__ q, const uint8_t* __restrict__ qh,
              const void* __restrict__ scales, const void* __restrict__ mins, int s_dtype,
              int voff, void* __restrict__ out, int out_bf16, float* __restrict__ partial,
              int* __restrict__ counters, int rows, int K, int N, int kb_per_split,
              int vec) {
  using SG = Stage<XT, PACK, B16, MT>;
  constexpr int RT = SG::RT, NST = SG::N;
  constexpr int SPB = B16 ? 2 : 1;          // scale rows a block
  // bf16 x without row_scale: the A operand straight from the stage; else
  // x' in three bf16 parts, converted once a block. The block sums of x'
  // for the mins are one more product, with a B of ones
  constexpr bool RAW_A = PARTS == 1;
  constexpr uint32_t kOnes = 0x3F803F80u;    // bf16x2 (1, 1)
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  unsigned char* ring = smem;
  bf16* xp = reinterpret_cast<bf16*>(smem + NST * SG::BYTES);              // [3][RT][kPartLD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, tig = lane & 3;
  const int n_base = blockIdx.x * kCols;
  const int split = blockIdx.y, ksplit = gridDim.y;
  const int r0 = blockIdx.z * RT;
  const int nrows = min(RT, rows - r0);
  const int kb_begin = split * kb_per_split;
  const int kb_end = min(K / 32, kb_begin + kb_per_split);
  const int nblk = kb_end - kb_begin;       // >= 1: k_split makes no empty split
  const int es = s_dtype == kF32 ? 4 : 2;
  const int nplanes = mins != nullptr ? 2 : 1;

  // rows past nrows of the x parts stay zero
  if constexpr (!RAW_A) {
    uint4* z = reinterpret_cast<uint4*>(xp);
    constexpr int n16 = (int)(sizeof(bf16) * 3 * RT * kPartLD / 16);
    for (int i = tid; i < n16; i += kThreads) z[i] = make_uint4(0, 0, 0, 0);
  }

  auto load_stage = [&](int kb, int slot) {
    unsigned char* st = ring + slot * SG::BYTES;
    const int64_t wrow0 = (int64_t)kb * SG::WROWS;
    const int64_t qrow0 = (int64_t)kb * 8;
    const int64_t srow0 = (int64_t)kb * SPB;
    // the x tile (rows past nrows zero-filled): x rows start on 16 bytes
    constexpr int XCH = 32 * (int)sizeof(XT) / 16;
    for (int c = tid; c < RT * XCH; c += kThreads) {
      const int r = c / XCH, ch = c - r * XCH;
      const bool ok = r < nrows;
      cp_async16(st + SG::X_OFF + r * SG::XROWB + ch * 16,
                 x + (int64_t)(r0 + (ok ? r : 0)) * K + kb * 32 + ch * (16 / (int)sizeof(XT)),
                 ok);
    }
    if (vec) {
      for (int c = tid; c < (SG::WROWS + SG::QROWS) * 8; c += kThreads) {
        const int r = c >> 3, col = (c & 7) * 16;
        const bool ok = n_base + col < N;
        const int n = ok ? n_base + col : 0;
        const uint8_t* src = r < SG::WROWS ? q + (wrow0 + r) * N + n
                                           : qh + (qrow0 + r - SG::WROWS) * N + n;
        cp_async16(st + r * kRowB + col, src, ok);
      }
      const int cpr = kCols * es / 16;      // 16-byte chunks a plane row
      for (int c = tid; c < nplanes * SPB * cpr; c += kThreads) {
        const int pl = c / (SPB * cpr), rem = c - pl * SPB * cpr;
        const int i = rem / cpr, ch = rem - i * cpr;
        const int col = ch * 16 / es;
        const bool ok = n_base + col < N;
        const unsigned char* src = static_cast<const unsigned char*>(pl ? mins : scales) +
                                   ((srow0 + i) * N + (ok ? n_base + col : 0)) * es;
        cp_async16(st + (pl ? SG::M_OFF : SG::S_OFF) + i * kCols * 4 + ch * 16, src, ok);
      }
    } else {
      // ragged N or unaligned planes: plain loads, zero past N (visible to
      // every thread after the barrier that precedes the stage's use)
      for (int c = tid; c < (SG::WROWS + SG::QROWS) * kCols; c += kThreads) {
        const int r = c / kCols, col = c - r * kCols, n = n_base + col;
        const uint8_t* src = r < SG::WROWS ? q + (wrow0 + r) * N + n
                                           : qh + (qrow0 + r - SG::WROWS) * N + n;
        st[r * kRowB + col] = n < N ? __ldg(src) : 0;
      }
      for (int c = tid; c < nplanes * SPB * kCols; c += kThreads) {
        const int pl = c / (SPB * kCols), rem = c - pl * SPB * kCols;
        const int i = rem / kCols, col = rem - i * kCols, n = n_base + col;
        unsigned char* dst = st + (pl ? SG::M_OFF : SG::S_OFF) + i * kCols * 4;
        const void* p = pl ? mins : scales;
        const int64_t o = (srow0 + i) * N + n;
        if (es == 4)
          reinterpret_cast<float*>(dst)[col] = n < N ? __ldg(static_cast<const float*>(p) + o) : 0.f;
        else
          reinterpret_cast<uint16_t*>(dst)[col] =
              n < N ? __ldg(static_cast<const unsigned short*>(p) + o) : (unsigned short)0;
      }
    }
  };

  // f32 x' of block kb from the stage into its three parts (never rounded)
  auto convert_x = [&](int slot, int kb) {
    const unsigned char* xs = ring + slot * SG::BYTES + SG::X_OFF;
    for (int i = tid; i < nrows * 32; i += kThreads) {
      const int r = i >> 5, k = i & 31;
      float v = to_f32(reinterpret_cast<const XT*>(xs + r * SG::XROWB)[k]);
      if (rs != nullptr) v *= __ldg(rs + kb * 32 + k);
      const float h = round_bf16(v), r1 = v - h, m = round_bf16(r1);
      bf16* dst = xp + r * kPartLD + k;
      dst[0] = __float2bfloat16_rn(h);
      dst[RT * kPartLD] = __float2bfloat16_rn(m);
      dst[2 * RT * kPartLD] = __float2bfloat16_rn(r1 - m);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[m][t][0] = acc[m][t][1] = acc[m][t][2] = acc[m][t][3] = 0.f;

  // bf16x2 of 128 + the kind's offset: what the 0x4300 trick adds
  const uint32_t bias = pack_bf16(128.f + voff, 128.f + voff);
  const int wcol = warp * 32 + 4 * g8;       // this thread's 4 B columns (bytes of a row)
  const int ccol = warp * 32 + 8 * tig;      // its 8 accumulator columns

  auto compute = [&](int slot) {
    const unsigned char* st = ring + slot * SG::BYTES;
    auto word = [&](int r) { return *reinterpret_cast<const uint32_t*>(st + r * kRowB + wcol); };
    uint32_t w[PACK == kInt8 ? 8 : 4];
    w[0] = word(2 * tig);
    w[1] = word(2 * tig + 1);
    w[2] = word(2 * tig + 8);
    w[3] = word(2 * tig + 9);
    if constexpr (PACK == kInt8) {
#pragma unroll
      for (int i = 0; i < 4; ++i) w[4 + i] = word(2 * tig + (i >> 1) * 8 + (i & 1) + 16);
#pragma unroll
      for (int i = 0; i < 8; ++i) w[i] ^= 0x80808080u;
    }
    uint32_t qw0 = 0, qw1 = 0;
    if constexpr (PACK == kNibbleQh) {
      qw0 = *reinterpret_cast<const uint32_t*>(st + SG::Q_OFF + (2 * tig) * kRowB + wcol);
      qw1 = *reinterpret_cast<const uint32_t*>(st + SG::Q_OFF + (2 * tig + 1) * kRowB + wcol);
    }
    // B fragments of both k16 steps and the 4 n tiles: [step][tile][0] =
    // rows (2tig, 2tig+1), [1] = rows (2tig+8, 2tig+9) of the step
    uint32_t b[2][4][2];
#pragma unroll
    for (int step = 0; step < 2; ++step)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if constexpr (PACK == kInt8) {
            const uint32_t wa = w[4 * step + 2 * h], wb = w[4 * step + 2 * h + 1];
            b[step][t][h] = pack_bf16(s8_to_f32(wa, t), s8_to_f32(wb, t));
          } else {
            const uint32_t p = pair_bytes(w[2 * h], w[2 * h + 1], t) >> (4 * step);
            uint32_t u = (p & 0x000F000Fu) | 0x43004300u;
            if constexpr (PACK == kNibbleQh) {
              const uint32_t hb = pair_bytes(qw0, qw1, t) >> (2 * h + 4 * step);
              u |= (hb & 0x00030003u) << 4;
            }
            b[step][t][h] = bf16x2_sub(u, bias);
          }
        }
    float sc[SPB][8], mn[SPB][8];
#pragma unroll
    for (int si = 0; si < SPB; ++si) {
      plane8(st + SG::S_OFF + si * kCols * 4, s_dtype, ccol, sc[si]);
      if (mins != nullptr) plane8(st + SG::M_OFF + si * kCols * 4, s_dtype, ccol, mn[si]);
    }
    const bf16* abase = RAW_A ? reinterpret_cast<const bf16*>(st + SG::X_OFF) : xp;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const bf16* arow = abase + (m * 16 + (lane & 15)) * kPartLD + (lane >> 4) * 8;
#pragma unroll
      for (int si = 0; si < SPB; ++si) {
        // the sum of one scale group: steps si (per-16) or 0 and 1 (per-32);
        // with mins also the group's x' sums (xs[0] row g8, xs[2] row g8 + 8)
        float tmp[4][4], xs[4];
        bool first = true;
#pragma unroll
        for (int step = 0; step < 2; ++step) {
          if (B16 && step != si) continue;
#pragma unroll
          for (int p = 0; p < PARTS; ++p) {
            uint32_t a[4];
            ldsm_x4(a, arow + p * RT * kPartLD + step * 16);
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              if (first) mma_bf16_zero(tmp[t], a, b[step][t][0], b[step][t][1]);
              else mma_bf16(tmp[t], a, b[step][t][0], b[step][t][1]);
            }
            if (mins != nullptr) {
              if (first) mma_bf16_zero(xs, a, kOnes, kOnes);
              else mma_bf16(xs, a, kOnes, kOnes);
            }
            first = false;
          }
        }
        const float xlo = mins != nullptr ? xs[0] : 0.f;
        const float xhi = mins != nullptr ? xs[2] : 0.f;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          float* c = acc[m][t];
          c[0] = fmaf(tmp[t][0], sc[si][t], c[0]);       // row g8, column 8tig + t
          c[1] = fmaf(tmp[t][1], sc[si][4 + t], c[1]);   // row g8, column 8tig + 4 + t
          c[2] = fmaf(tmp[t][2], sc[si][t], c[2]);       // row g8 + 8
          c[3] = fmaf(tmp[t][3], sc[si][4 + t], c[3]);
          if (mins != nullptr) {
            c[0] = fmaf(xlo, mn[si][t], c[0]);
            c[1] = fmaf(xlo, mn[si][4 + t], c[1]);
            c[2] = fmaf(xhi, mn[si][t], c[2]);
            c[3] = fmaf(xhi, mn[si][4 + t], c[3]);
          }
        }
      }
    }
  };

#pragma unroll 1
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nblk) load_stage(kb_begin + s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int i = 0; i < nblk; ++i) {
    cp_async_wait<NST - 2>();
    __syncthreads();            // stage i is in; every warp is done with block i - 1
    if (i + NST - 1 < nblk) load_stage(kb_begin + i + NST - 1, (i + NST - 1) % NST);
    cp_async_commit();
    if constexpr (!RAW_A) {
      convert_x(i % NST, kb_begin + i);
      __syncthreads();
    }
    compute(i % NST);
  }

  // this thread's outputs: rows m*16 + g8 (+ 8), columns ccol + 0..7, where
  // column ccol + c is acc[.][c & 3][c < 4 ? 0 : 1] (row g8) or [.. 2 : 3]
  auto store_row = [&](int r, const float (&v)[8], bool to_out, int64_t prow0) {
    if (r >= nrows) return;
    const int n0 = n_base + ccol;
    if (!to_out) {
      float* dst = partial + (prow0 + r) * N + n0;
      if (vec && n0 + 7 < N) {
        reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        for (int c = 0; c < 8; ++c)
          if (n0 + c < N) dst[c] = v[c];
      }
      return;
    }
    const int64_t o = (int64_t)(r0 + r) * N + n0;
    if (out_bf16) {
      bf16* dst = static_cast<bf16*>(out) + o;
      if (vec && n0 + 7 < N) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                                    pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
      } else {
        for (int c = 0; c < 8; ++c)
          if (n0 + c < N) dst[c] = __float2bfloat16_rn(v[c]);
      }
    } else {
      float* dst = static_cast<float*>(out) + o;
      if (vec && n0 + 7 < N) {
        reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        for (int c = 0; c < 8; ++c)
          if (n0 + c < N) dst[c] = v[c];
      }
    }
  };
  const bool direct = ksplit == 1;
  const int64_t prow0 = (int64_t)split * rows + r0;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float lo[8], hi[8];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      lo[c] = acc[m][c][0], lo[4 + c] = acc[m][c][1];
      hi[c] = acc[m][c][2], hi[4 + c] = acc[m][c][3];
    }
    store_row(m * 16 + g8, lo, direct, prow0);
    store_row(m * 16 + g8 + 8, hi, direct, prow0);
  }
  if (direct) return;

  // the last split of this output tile to finish sums the partials in
  // split order and resets the tile's counter for the next launch
  int* counter = counters + (int64_t)blockIdx.z * gridDim.x + blockIdx.x;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counter, 1) == ksplit - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = tid; i < nrows * kCols; i += kThreads) {
    const int r = i / kCols, n = n_base + (i - r * kCols);
    if (n >= N) continue;
    float sum = 0.f;
    for (int y = 0; y < ksplit; ++y)
      sum += __ldcg(partial + ((int64_t)y * rows + r0 + r) * N + n);
    const int64_t o = (int64_t)(r0 + r) * N + n;
    if (out_bf16)
      static_cast<bf16*>(out)[o] = __float2bfloat16_rn(sum);
    else
      static_cast<float*>(out)[o] = sum;
  }
  if (tid == 0) *counter = 0;
}

struct Args {
  const void* x; const float* rs; const uint8_t* q; const uint8_t* qh;
  const void* scales; const void* mins; int s_dtype; int voff;
  void* out; int out_bf16; float* partial; int* counters;
  int rows, K, N, ksplit, kb_per_split, vec;
};

template <typename XT, int PARTS, int PACK, bool B16, int MT>
void launch_tile(const Args& a, cudaStream_t st) {
  auto kernel = qmm_tc_kernel<XT, PARTS, PACK, B16, MT>;
  constexpr size_t smem = smem_bytes<XT, PARTS, PACK, B16, MT>();
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int rt = 16 * MT;
  dim3 grid((a.N + kCols - 1) / kCols, a.ksplit, (a.rows + rt - 1) / rt);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const XT*>(a.x), a.rs, a.q, a.qh, a.scales, a.mins, a.s_dtype, a.voff,
      a.out, a.out_bf16, a.partial, a.counters, a.rows, a.K, a.N, a.kb_per_split, a.vec);
}

// rows 1-16: one m16 tile; more: 64-row tiles
template <typename XT, int PARTS, int PACK, bool B16>
void launch_rows(const Args& a, cudaStream_t st) {
  if (a.rows <= 16) launch_tile<XT, PARTS, PACK, B16, 1>(a, st);
  else launch_tile<XT, PARTS, PACK, B16, 4>(a, st);
}

template <typename XT, int PARTS>
int launch_kind(const Args& a, int pack, int block, cudaStream_t st) {
  if (pack == kNibble && block == 32) launch_rows<XT, PARTS, kNibble, false>(a, st);
  else if (pack == kNibble && block == 16) launch_rows<XT, PARTS, kNibble, true>(a, st);
  else if (pack == kNibbleQh && block == 16) launch_rows<XT, PARTS, kNibbleQh, true>(a, st);
  else if (pack == kInt8 && block == 32) launch_rows<XT, PARTS, kInt8, false>(a, st);
  else if (pack == kInt8 && block == 16) launch_rows<XT, PARTS, kInt8, true>(a, st);
  else return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// pack: 0 int8 values, 1 nibble-packed, 2 nibble-packed + qh plane (qh, K/4
// rows); voff: subtracted from each unpacked value; block: 32 or 16 rows a
// scale; scales / mins: f32 (s_dtype 0), bf16 (1) or f16-bit (2) planes of
// one dtype, mins may be null; row_scale: (K,) f32 or null. ksplit > 1:
// partial is a (ksplit, rows, N) f32 workspace and counters one int32 per
// output tile (ceil(N / 128) x row tiles), 0 on entry and 0 again on exit.
// vec: N % 16 == 0 and every plane on a 16-byte boundary. Returns
// cudaGetLastError() after the launch.
TLT_API int tlt_qmatmul(const void* x, int x_bf16, const void* row_scale, const void* q,
                        const void* qh, const void* scales, const void* mins, int s_dtype,
                        int pack, int voff, int block, void* out, int out_bf16,
                        void* partial, void* counters, int rows, int K, int N, int ksplit,
                        int kb_per_split, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{x, static_cast<const float*>(row_scale), static_cast<const uint8_t*>(q),
               static_cast<const uint8_t*>(qh), scales, mins, s_dtype, voff, out, out_bf16,
               static_cast<float*>(partial), static_cast<int*>(counters), rows, K, N, ksplit,
               kb_per_split, vec};
  // f32 x' (f32 x, or any row_scale) in three bf16 parts; bf16 x in one
  const int bad = !x_bf16 ? launch_kind<float, 3>(a, pack, block, st)
                  : row_scale != nullptr ? launch_kind<bf16, 3>(a, pack, block, st)
                                         : launch_kind<bf16, 1>(a, pack, block, st);
  if (bad) return bad;
  return (int)cudaGetLastError();
}
