// The quantized-weight tensor-core tile that K1 (qmm_tc_kernel,
// qmatmul.cu) and K7 (ffn_tc_kernel, ffn.cu) share: the stage of one
// 32-row block of K, its copy into a ring in shared memory, the unpacking
// of its values into exact bf16 B fragments, the ring's loop, and the
// in-launch merge of a K split on a counter. The design is K1's
// (qmatmul.cu); the two kernels differ in where the scale goes: K1 puts it
// on the f32 accumulators of each k16 / k32 group, K7 on the weight (one
// __hmul2 by the column's bf16 scale, the Pallas FFN's rounded weight).
//
// - A CTA of 4 warps owns 128 staged columns, each warp 32 (4 n8 tiles);
//   a B fragment's column g of tile t is staged column 4g + t, so one
//   32-bit shared load of a packed row gives a thread its byte of all four
//   tiles (its columns wcol .. wcol + 3, wcol = warp * 32 + 4 * g8), and
//   its accumulators hold columns ccol + c (ccol = warp * 32 + 8 * tig) in
//   acc[.][c & 3][c < 4 ? 0 : 1] (row g8) and [.][c & 3][c < 4 ? 2 : 3]
//   (row g8 + 8). The k order inside a block is the natural one, so x
//   needs no permute.
// - Which weight column a staged column is, is the caller's: LinearCols
//   (columns n0 .. n0 + 127), or K7's gate / up halves (ffn.cu).
// - Every kind's value is a small integer (-128..127), exact in bf16:
//   a byte permute pairs the two rows of a B register, a mask-or puts each
//   nibble under the exponent of 128.0 in bf16 (0x4300 | n = 128 + n), one
//   bf16x2 subtract removes 128 plus the kind's offset; int8 values go
//   through the same trick in f32 (2^23 + u) and one pack to bf16x2.
// - A stage: the weight, qh, scale and mins rows of one 32-row block and
//   the x tile of its 32 k, copied with 16-byte cp.async (weight rows
//   padded to 144 bytes, x rows by 16: the fragment reads are free of bank
//   conflicts); zero past the weight's columns and past the x rows.
#pragma once

#include <cuda_fp16.h>

#include "common.cuh"

namespace tlt {
namespace qmm {

constexpr int kThreads = 128;             // 4 warps
constexpr int kCols = 128;                // columns a CTA, 32 a warp
constexpr int kRowB = kCols + 16;         // a staged byte row, padded
constexpr int kPartLD = 40;               // an x row of the stage: 32 bf16, padded by 16 bytes
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

// staged column c is weight column n0 + c, a real one below N
struct LinearCols {
  int n0, N;
  __device__ __forceinline__ int col(int c) const { return n0 + c; }
  __device__ __forceinline__ bool ok(int c) const { return n0 + c < N; }
};

// Copy 32-row block kb into stage st: x rows r0 .. r0 + nrows - 1 of a
// (rows, K) XT matrix (rows past nrows zero-filled; x rows start on 16
// bytes), the value rows of a (K or K/2, N) byte plane q (and the qh rows,
// K/4 of them), the scale rows (and mins, if not null) of (K/B, N) planes
// of es-byte elements; staged column c is cols.col(c), zero where
// !cols.ok(c). vec: N % 16 == 0 and every plane on a 16-byte boundary
// (16-byte cp.async); else plain loads into the same stage (visible to
// every thread after the barrier that precedes the stage's use).
template <typename XT, int PACK, bool B16, int MT, typename Cols>
__device__ __forceinline__ void load_stage(unsigned char* st, const XT* __restrict__ x,
                                           int r0, int nrows, int K,
                                           const uint8_t* __restrict__ q,
                                           const uint8_t* __restrict__ qh,
                                           const void* __restrict__ scales,
                                           const void* __restrict__ mins, int es, int N,
                                           Cols cols, int kb, bool vec) {
  using SG = Stage<XT, PACK, B16, MT>;
  constexpr int RT = SG::RT, SPB = B16 ? 2 : 1;
  const int tid = threadIdx.x;
  const int nplanes = mins != nullptr ? 2 : 1;
  const int64_t wrow0 = (int64_t)kb * SG::WROWS;
  const int64_t qrow0 = (int64_t)kb * 8;
  const int64_t srow0 = (int64_t)kb * SPB;
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
      const bool ok = cols.ok(col);
      const int n = ok ? cols.col(col) : 0;
      const uint8_t* src = r < SG::WROWS ? q + (wrow0 + r) * N + n
                                         : qh + (qrow0 + r - SG::WROWS) * N + n;
      cp_async16(st + r * kRowB + col, src, ok);
    }
    const int cpr = kCols * es / 16;      // 16-byte chunks a plane row
    for (int c = tid; c < nplanes * SPB * cpr; c += kThreads) {
      const int pl = c / (SPB * cpr), rem = c - pl * SPB * cpr;
      const int i = rem / cpr, ch = rem - i * cpr;
      const int col = ch * 16 / es;
      const bool ok = cols.ok(col);
      const unsigned char* src = static_cast<const unsigned char*>(pl ? mins : scales) +
                                 ((srow0 + i) * N + (ok ? cols.col(col) : 0)) * es;
      cp_async16(st + (pl ? SG::M_OFF : SG::S_OFF) + i * kCols * 4 + ch * 16, src, ok);
    }
  } else {
    for (int c = tid; c < (SG::WROWS + SG::QROWS) * kCols; c += kThreads) {
      const int r = c / kCols, col = c - r * kCols, n = cols.col(col);
      const uint8_t* src = r < SG::WROWS ? q + (wrow0 + r) * N + n
                                         : qh + (qrow0 + r - SG::WROWS) * N + n;
      st[r * kRowB + col] = cols.ok(col) ? __ldg(src) : 0;
    }
    for (int c = tid; c < nplanes * SPB * kCols; c += kThreads) {
      const int pl = c / (SPB * kCols), rem = c - pl * SPB * kCols;
      const int i = rem / kCols, col = rem - i * kCols, n = cols.col(col);
      unsigned char* dst = st + (pl ? SG::M_OFF : SG::S_OFF) + i * kCols * 4;
      const void* p = pl ? mins : scales;
      const int64_t o = (srow0 + i) * N + n;
      const bool ok = cols.ok(col);
      if (es == 4)
        reinterpret_cast<float*>(dst)[col] = ok ? __ldg(static_cast<const float*>(p) + o) : 0.f;
      else
        reinterpret_cast<uint16_t*>(dst)[col] =
            ok ? __ldg(static_cast<const unsigned short*>(p) + o) : (unsigned short)0;
    }
  }
}

// The B fragments of a staged block's values, exact in bf16, for both k16
// steps and the 4 n tiles: b[step][tile][0] = rows (2tig, 2tig+1), [1] =
// rows (2tig+8, 2tig+9) of the step, at staged column wcol + tile. bias:
// bf16x2 of 128 + the kind's offset (what the 0x4300 trick adds).
template <int PACK, typename SG>
__device__ __forceinline__ void unpack_values(const unsigned char* st, int wcol, int tig,
                                              uint32_t bias, uint32_t (&b)[2][4][2]) {
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
}

// The ring: blocks 0 .. nblk - 1 stream through NST stages, NST - 1 in
// flight; load(i, slot) starts block i's copies into stage slot, body(i,
// slot) runs once block i is in and every warp is done with block i - 1.
template <int NST, typename Load, typename Body>
__device__ __forceinline__ void run_ring(int nblk, Load load, Body body) {
#pragma unroll 1
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nblk) load(s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int i = 0; i < nblk; ++i) {
    cp_async_wait<NST - 2>();
    __syncthreads();            // stage i is in; every warp is done with block i - 1
    if (i + NST - 1 < nblk) load(i + NST - 1, (i + NST - 1) % NST);
    cp_async_commit();
    body(i, i % NST);
  }
}

// The merge of a K split: once this CTA's split stored its partial, true
// for the last of the n splits of an output tile to arrive (an int32
// counter, atomicAdd after a __threadfence; `flag` a __shared__ int). The
// last sums the partials in split order, so the result does not depend on
// scheduling, and sets the counter back to 0 for the next launch.
__device__ __forceinline__ bool last_to_arrive(int* counter, int n, int& flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) flag = atomicAdd(counter, 1) == n - 1;
  __syncthreads();
  const bool last = flag;
  if (last) __threadfence();
  return last;
}

}  // namespace qmm
}  // namespace tlt
