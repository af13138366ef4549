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
// Two bodies, chosen by the wrapper from shapes (quant/qmatmul.py
// takes_decode): the decode body (qmm_tc_kernel_decode, below) for rows 1
// .. DECODE_ROWS of a nibble-packed kind (instantiated for 1 and 2), the tensor-core body
// (qmm_tc_kernel) for every other call. Both names hold "qmm_tc_kernel",
// which a profile's K1 time is summed by.
//
// The decode body, built for the byte bound (one thread's view):
// - it streams its weight bytes once, from device memory into registers:
//   8-byte loads, neighbouring lanes on neighbouring columns of a packed
//   row (16 lanes on a 128-column tile's 128 bytes), the 16 packed rows of
//   a 32-row block all in flight at once, and the next block's loads out
//   before this one is used. 8 bytes and not 16: the second block's
//   registers fit the 128 a thread has at two CTAs an SM. No shared memory
//   for the weight, and no barrier a block;
// - x' = x * row_scale is copied once a CTA into shared memory (cp.async,
//   landing before any weight load goes out) for the blocks its range
//   reads, f32, and read as a broadcast (a float4 for 4 k);
// - it multiplies in f32 on the CUDA cores: f32 x' times the exact value,
//   one FFMA a weight and row. A nibble is masked in place under the
//   exponent of 2^23 (one LOP3, 2^23's bits in a register) and 2^23 plus
//   the kind's offset subtracted (one FADD): the value times its place
//   value in the word (1, 16, 256 or 4096), exact. A scale group's f32
//   sum, over that power of 2, times the column's scale goes on the f32
//   accumulator; the mins add as block sums of x' times m. The weight is
//   never rounded with its scale, x' never rounded. ~3.25 instructions a
//   weight at one row (LOP3, FADD, FFMA, a shift per 4), which leaves the
//   body instruction-bound on the H100 at Qwen2-7B's widths (with every
//   load an L1 hit it still takes 85% of its time);
// - the work: U = ceil(N / 128) * K / 32 units (128-column tile, 32-row
//   block), tile-major, split into G equal contiguous ranges, one a CTA
//   (quant/qmatmul.py decode_grid: G from shapes alone, a whole number a
//   tile where the tiles cannot fill the card). A CTA's 16 k groups (8
//   warps of two 16-lane groups) take a tile segment's blocks in turn,
//   then sum it: a butterfly in each warp, the warps in order in shared
//   memory. A tile a CTA holds whole goes out; one split across CTAs is
//   merged by the last of them to arrive (a tile counter, as below), in
//   CTA order: one launch a call, no memset, results independent of
//   scheduling.
//
// The tensor-core body, for every other call (its tile, stage, unpacking,
// ring and split merge in qmm_tile.cuh, shared with K7):
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
#include "common.cuh"
#include "qmm_tile.cuh"

namespace {

using namespace tlt::qmm;
using tlt::ldsm_x4;
using tlt::mma_bf16;
using tlt::pack_bf16;
using tlt::round_bf16;
using tlt::to_f32;
using bf16 = __nv_bfloat16;

template <typename XT, int PARTS, int PACK, bool B16, int MT>
constexpr size_t smem_bytes() {
  using SG = Stage<XT, PACK, B16, MT>;
  return (size_t)SG::N * SG::BYTES + sizeof(bf16) * (PARTS == 3 ? 3 : 0) * SG::RT * kPartLD;
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

  // rows past nrows of the x parts stay zero
  if constexpr (!RAW_A) {
    uint4* z = reinterpret_cast<uint4*>(xp);
    constexpr int n16 = (int)(sizeof(bf16) * 3 * RT * kPartLD / 16);
    for (int i = tid; i < n16; i += kThreads) z[i] = make_uint4(0, 0, 0, 0);
  }

  const LinearCols cols{n_base, N};
  auto load = [&](int i, int slot) {
    load_stage<XT, PACK, B16, MT>(ring + slot * SG::BYTES, x, r0, nrows, K, q, qh, scales,
                                  mins, es, N, cols, kb_begin + i, vec);
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
    uint32_t b[2][4][2];
    unpack_values<PACK, SG>(st, wcol, tig, bias, b);
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

  run_ring<NST>(nblk, load, [&](int i, int slot) {
    if constexpr (!RAW_A) {
      convert_x(slot, kb_begin + i);
      __syncthreads();
    }
    compute(slot);
  });

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
  if (!last_to_arrive(counter, ksplit, is_last)) return;
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

// ---- the decode body: rows 1 and 2 of a nibble-packed kind ----
// (the design is in the note at the top)

constexpr int kDecThreads = 256;           // 8 warps
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kSlotLD = 36;                // floats a staged x' block (32, padded: no bank conflicts)

template <int RB, bool B16>
struct Dec {
  static constexpr int NW = 2;               // 32-bit words a lane loads from a packed row
  static constexpr int LC = 4 * NW;          // the lane's columns
  static constexpr int LPR = kCols / LC;     // lanes on one packed row of a tile
  static constexpr int GPW = 32 / LPR;       // k groups a warp
  static constexpr int KG = kDecWarps * GPW; // k groups a CTA
  // CTAs an SM (quant/qmatmul.py decode_ctas_per_sm): two at one row, one
  // above (the accumulators of more rows take a second CTA's registers)
  static constexpr int MINB = RB == 1 ? 2 : 1;
  static constexpr int SPB = B16 ? 2 : 1;    // scale rows a block
};

// one 8-byte load: the NW = 2 words of a packed row
__device__ __forceinline__ void load_words(uint32_t (&w)[2], const uint8_t* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  w[0] = v.x, w[1] = v.y;
}

// LC consecutive elements of row `row` of a (rows, N) scale or mins plane
// as f32, columns n0 .. n0 + LC - 1, zero past N
template <int LC>
__device__ __forceinline__ void plane_cols(const void* __restrict__ p, int dtype, int64_t row,
                                           int n0, int N, bool vec, float (&v)[LC]) {
  if (vec) {
    if (n0 >= N) {
#pragma unroll
      for (int c = 0; c < LC; ++c) v[c] = 0.f;
      return;
    }
    if (dtype == kF32) {
      const float4* s = reinterpret_cast<const float4*>(static_cast<const float*>(p) + row * N + n0);
#pragma unroll
      for (int i = 0; i < LC / 4; ++i) {
        const float4 f = __ldg(s + i);
        v[4 * i] = f.x, v[4 * i + 1] = f.y, v[4 * i + 2] = f.z, v[4 * i + 3] = f.w;
      }
    } else {
      const uint4* s = reinterpret_cast<const uint4*>(static_cast<const uint16_t*>(p) + row * N + n0);
#pragma unroll
      for (int i = 0; i < LC / 8; ++i) {
        const uint4 u = __ldg(s + i);
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[8 * i + 2 * e] = half_bits_to_f32(w[e] & 0xFFFFu, dtype);
          v[8 * i + 2 * e + 1] = half_bits_to_f32(w[e] >> 16, dtype);
        }
      }
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < LC; ++c) {
    const int n = n0 + c;
    v[c] = n >= N ? 0.f
           : dtype == kF32 ? __ldg(static_cast<const float*>(p) + row * N + n)
                           : half_bits_to_f32(__ldg(static_cast<const unsigned short*>(p) + row * N + n),
                                              dtype);
  }
}

// one 32-row block of a lane's columns n0 .. n0 + LC - 1: its 16 packed
// rows (zero past N) and its scale rows
template <int NW, int LC, int SPB>
struct Block {
  uint32_t w[16][NW];
  float sc[SPB][LC];

  __device__ __forceinline__ void load(const uint8_t* __restrict__ q,
                                       const void* __restrict__ scales, int s_dtype, int kb,
                                       int n0, int N, bool vec) {
    if (vec) {
      const uint8_t* qp = q + (int64_t)kb * 16 * N + n0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (n0 < N) {
          load_words(w[j], qp + (int64_t)j * N);
        } else {
#pragma unroll
          for (int i = 0; i < NW; ++i) w[j][i] = 0;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int i = 0; i < NW; ++i)
          w[j][i] = tlt::load4(q, (int64_t)kb * 16 + j, n0 + 4 * i, N, false);
    }
#pragma unroll
    for (int h = 0; h < SPB; ++h)
      plane_cols<LC>(scales, s_dtype, (int64_t)kb * SPB + h, n0, N, vec, sc[h]);
  }
};

// out (RB, N) = (x * row_scale) (RB, K) @ W (K, N) for a nibble-packed W,
// rows RB = 1 or 2. The grid (G CTAs, quant/qmatmul.py
// decode_grid) splits the tile-major units (128-column tile t, 32-row block
// kb), U = ceil(N / 128) * K / 32 of them, into G equal contiguous ranges;
// a CTA walks its range one tile segment at a time (see the note at the top)
template <int RB, bool B16>
__global__ void __launch_bounds__(kDecThreads, Dec<RB, B16>::MINB)
qmm_tc_kernel_decode(const void* __restrict__ x, int x_bf16, const float* __restrict__ rs,
                     const uint8_t* __restrict__ q, const void* __restrict__ scales,
                     const void* __restrict__ mins, int s_dtype, int voff,
                     void* __restrict__ out, int out_bf16, float* __restrict__ partial,
                     int* __restrict__ counters, int K, int N, int nslot, int vec) {
  using D = Dec<RB, B16>;
  constexpr int NW = D::NW, LC = D::LC, LPR = D::LPR, KG = D::KG, SPB = D::SPB;
  extern __shared__ __align__(16) float dsm[];
  __shared__ int is_last;
  float* red = dsm;                                  // [kDecWarps][RB][kCols] warp sums
  float* xs = red + kDecWarps * RB * kCols;          // [RB][nslot][kSlotLD] x'
  float* bsum = xs + RB * nslot * kSlotLD;           // [RB][nslot][2] x' sums of scale groups

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kgrp = warp * D::GPW + lane / LPR;       // this thread's k group
  const int cl = (lane % LPR) * LC;                  // its first column in a tile
  const int nkb = K / 32;
  const int64_t G = gridDim.x;
  const int64_t U = (int64_t)((N + kCols - 1) / kCols) * nkb;
  const int64_t u0 = blockIdx.x * U / G, u1 = (blockIdx.x + 1) * U / G;
  // x' slot s holds block (base + s) % nkb: the blocks of [u0, u1) are
  // either every block (a range of nkb units or more) or a run that may
  // wrap from the end of one tile to the start of the next
  const int base = u1 - u0 >= nkb ? 0 : (int)(u0 % nkb);
  const int ns = u1 - u0 >= nkb ? nkb : (int)(u1 - u0);

  // the range's tiles t0 .. tl: blocks [a0, nkb) of t0 (or [a0, bl) if
  // t0 == tl), every block of those between, [0, bl) of tl
  const int t0 = (int)(u0 / nkb), a0 = (int)(u0 - (int64_t)t0 * nkb);
  const int tl = (int)((u1 - 1) / nkb), bl = (int)(u1 - (int64_t)tl * nkb);
  // this k group's blocks, in order: block a + kgrp, + KG, ... of each
  // segment [a, b) of a tile; (gt, gkb) is the next, gt > tl when none is
  // left. No 64-bit division past this point but at a tile's merge.
  auto settle = [&](int& gt, int& gkb) {
    while (gt <= tl && gkb >= (gt == tl ? bl : nkb)) {
      ++gt;
      gkb = kgrp;
    }
  };
  auto load = [&](Block<NW, LC, SPB>& blk, int gt, int gkb) {
    blk.load(q, scales, s_dtype, gkb, gt * kCols + cl, N, vec);
  };

  // x's blocks for this CTA go to their slots by cp.async, and land before
  // any weight load goes out (behind those, under every SM's loads, x'
  // would hold back the first block's compute); a thread takes whole slots
  const int xbytes = x_bf16 ? 2 : 4;
  for (int i = tid; i < RB * ns; i += kDecThreads) {
    const int r = i / ns, sl = i - r * ns;
    const int kb = base + sl < nkb ? base + sl : base + sl - nkb;
    const unsigned char* src = static_cast<const unsigned char*>(x) +
                               ((int64_t)r * K + (int64_t)kb * 32) * xbytes;
    unsigned char* dst = reinterpret_cast<unsigned char*>(xs + (r * nslot + sl) * kSlotLD);
    for (int c = 0; c < 2 * xbytes; ++c) tlt::cp_async16(dst + 16 * c, src + 16 * c, true);
  }
  tlt::cp_async_commit();

  // x' = x * row_scale in f32, each thread over the slots it copied
  tlt::cp_async_wait<0>();
  if (x_bf16 || rs != nullptr) {
    for (int i = tid; i < RB * ns; i += kDecThreads) {
      const int r = i / ns, sl = i - r * ns;
      const int kb = base + sl < nkb ? base + sl : base + sl - nkb;
      float* p = xs + (r * nslot + sl) * kSlotLD;
      float v[32];
      if (x_bf16) {
        uint32_t raw[16];
#pragma unroll
        for (int c = 0; c < 16; ++c) raw[c] = reinterpret_cast<const uint32_t*>(p)[c];
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          v[2 * c] = __uint_as_float(raw[c] << 16);
          v[2 * c + 1] = __uint_as_float(raw[c] & 0xFFFF0000u);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) v[e] = p[e];
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) p[e] = rs != nullptr ? v[e] * __ldg(rs + kb * 32 + e) : v[e];
    }
  }
  __syncthreads();
  if (mins != nullptr) {
    // each scale group's sum of x', in k order
    constexpr int GB = 32 / SPB;
    for (int i = tid; i < RB * ns * SPB; i += kDecThreads) {
      const int r = i / (ns * SPB), rem = i - r * ns * SPB, sl = rem / SPB, h = rem - sl * SPB;
      const float* p = xs + (r * nslot + sl) * kSlotLD + h * GB;
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < GB; ++e) sum += p[e];
      bsum[(r * nslot + sl) * 2 + h] = sum;
    }
    __syncthreads();
  }

  // the first block's loads: (gt, gkb) is the block to compute, (lt, lkb)
  // the next to load
  Block<NW, LC, SPB> cur, nxt;
  int gt = t0, gkb = a0 + kgrp;
  settle(gt, gkb);
  if (gt <= tl) load(cur, gt, gkb);
  int lt = gt, lkb = gkb + KG;
  settle(lt, lkb);

  // 2^23 plus the kind's offset, at a nibble's place value (1, 16, 256 or
  // 4096); 2^23's bits in a register, so a nibble's masking and placing is
  // one LOP3 with one immediate
  const float c1 = 8388608.f + (float)voff, c16 = 8388608.f + 16.f * (float)voff;
  const float c256 = 8388608.f + 256.f * (float)voff, c4096 = 8388608.f + 4096.f * (float)voff;
  uint32_t magic;
  asm("mov.b32 %0, 0x4B000000;" : "=r"(magic));
  auto put = [&](int64_t o, float val) {
    if (out_bf16) static_cast<bf16*>(out)[o] = __float2bfloat16_rn(val);
    else static_cast<float*>(out)[o] = val;
  };

#pragma unroll 1
  for (int t = t0; t <= tl; ++t) {
    // the segment: tile t, blocks [a, b)
    const int a = t == t0 ? a0 : 0, b = t == tl ? bl : nkb;
    float acc[RB][LC];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int c = 0; c < LC; ++c) acc[r][c] = 0.f;

#pragma unroll 1
    while (gt == t) {
      // the next block's loads go out before this one is used
      if (lt <= tl) load(nxt, lt, lkb);
      lkb += KG;
      settle(lt, lkb);
      const Block<NW, LC, SPB>& use = cur;
      const int kb = gkb;
      const int s = kb - base >= 0 ? kb - base : kb - base + nkb;
      float gs[RB][LC];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // pass h: the low nibbles (k = 32 kb + j, bits 0-3 of a byte) or
        // the high (32 kb + 16 + j, bits 4-7)
        if (h == 0 || B16) {
#pragma unroll
          for (int r = 0; r < RB; ++r)
#pragma unroll
            for (int c = 0; c < LC; ++c) gs[r][c] = 0.f;
        } else {
          // bytes 0 and 1 give their high nibbles at 16 times the low ones'
          // place value: so the low ones' sums, exactly
#pragma unroll
          for (int r = 0; r < RB; ++r)
#pragma unroll
            for (int c = 0; c < LC; ++c)
              if (c % 4 < 2) gs[r][c] *= 16.f;
        }
#pragma unroll
        for (int j4 = 0; j4 < 16; j4 += 4) {
          float xv[RB][4];
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float4 f =
                *reinterpret_cast<const float4*>(xs + (r * nslot + s) * kSlotLD + 16 * h + j4);
            xv[r][0] = f.x, xv[r][1] = f.y, xv[r][2] = f.z, xv[r][3] = f.w;
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int i = 0; i < NW; ++i) {
              // column 4i + t is byte t of the word. The nibble is masked in
              // place under the exponent of 2^23 (one LOP3: the magic is in a
              // register): bytes 0 and 1 from the word (low nibbles at place
              // value 1 and 256, high at 16 and 4096), bytes 2 and 3 from it
              // shifted down by 16 (low) or 20 (high), at 1 and 256. Less 2^23
              // and the kind's offset at that place: the value times its
              // place value, exact
              const uint32_t w = use.w[j4 + jj][i], ws = w >> (h ? 20 : 16);
              const float v0 = __uint_as_float((w & (h ? 0xF0u : 0xFu)) | magic) - (h ? c16 : c1);
              const float v1 =
                  __uint_as_float((w & (h ? 0xF000u : 0xF00u)) | magic) - (h ? c4096 : c256);
              const float v2 = __uint_as_float((ws & 0xFu) | magic) - c1;
              const float v3 = __uint_as_float((ws & 0xF00u) | magic) - c256;
#pragma unroll
              for (int r = 0; r < RB; ++r) {
                const float xr = xv[r][jj];
                gs[r][4 * i] = fmaf(xr, v0, gs[r][4 * i]);
                gs[r][4 * i + 1] = fmaf(xr, v1, gs[r][4 * i + 1]);
                gs[r][4 * i + 2] = fmaf(xr, v2, gs[r][4 * i + 2]);
                gs[r][4 * i + 3] = fmaf(xr, v3, gs[r][4 * i + 3]);
              }
            }
        }
        if (h == 1 || B16) {
          // a scale group is summed: times its column's scale, over the
          // place value it was summed at (a power of 2: exact), on the
          // accumulator
          const int sh = B16 ? h : 0;
#pragma unroll
          for (int c = 0; c < LC; ++c) {
            const float place = c % 4 == 0 ? (h ? 16.f : 1.f) : c % 4 == 1 ? (h ? 4096.f : 256.f)
                                : c % 4 == 2 ? 1.f : 256.f;
            const float scv = use.sc[sh][c] * (1.f / place);
#pragma unroll
            for (int r = 0; r < RB; ++r) acc[r][c] = fmaf(gs[r][c], scv, acc[r][c]);
          }
          if (mins != nullptr) {
            float mv[LC];
            plane_cols<LC>(mins, s_dtype, (int64_t)kb * SPB + sh, t * kCols + cl, N, vec, mv);
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              const float xsum = bsum[(r * nslot + s) * 2 + sh];
#pragma unroll
              for (int c = 0; c < LC; ++c) acc[r][c] = fmaf(xsum, mv[c], acc[r][c]);
            }
          }
        }
      }
      cur = nxt;
      gkb += KG;
      settle(gt, gkb);
    }

    // the k groups of a warp hold the same columns: a butterfly sum (every
    // lane gets the same value), then the warps' sums in warp order
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int c = 0; c < LC; ++c) acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);
    if (lane < LPR) {
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int c = 0; c < LC; c += 4)
          *reinterpret_cast<float4*>(red + (warp * RB + r) * kCols + cl + c) =
              make_float4(acc[r][c], acc[r][c + 1], acc[r][c + 2], acc[r][c + 3]);
    }
    __syncthreads();
    // a whole tile goes out; a part of one is this CTA's partial: slot 0 if
    // the segment starts inside the tile (the range's first), else slot 1
    const bool whole = a == 0 && b == nkb;
    const int64_t slot_row = ((int64_t)blockIdx.x * 2 + (a > 0 ? 0 : 1)) * RB;
    for (int i = tid; i < RB * kCols; i += kDecThreads) {
      const int r = i / kCols, c = i - r * kCols;
      float sum = 0.f;
#pragma unroll
      for (int wp = 0; wp < kDecWarps; ++wp) sum += red[(wp * RB + r) * kCols + c];
      if (!whole) partial[(slot_row + r) * kCols + c] = sum;
      else if (t * kCols + c < N) put((int64_t)r * N + t * kCols + c, sum);
    }
    if (!whole) {
      // the CTAs whose ranges hold tile t's units: the last to arrive sums
      // their partials in CTA order and resets the tile's counter
      const int64_t tu0 = (int64_t)t * nkb;
      const int64_t first = ((tu0 + 1) * G - 1) / U, last = ((tu0 + nkb) * G - 1) / U;
      if (last_to_arrive(counters + t, (int)(last - first + 1), is_last)) {
        for (int i = tid; i < RB * kCols; i += kDecThreads) {
          const int r = i / kCols, c = i - r * kCols;
          if (t * kCols + c >= N) continue;
          float sum = 0.f;
          // the first CTA's part of the tile is its range's last segment
          // (slot 1), every later one's its first (slot 0)
          for (int64_t ci = first; ci <= last; ++ci)
            sum += __ldcg(partial + ((ci * 2 + (ci == first)) * RB + r) * kCols + c);
          put((int64_t)r * N + t * kCols + c, sum);
        }
        if (tid == 0) counters[t] = 0;
      }
    }
    __syncthreads();            // red is the next segment's
  }
}

struct DecArgs {
  const void* x; int x_bf16; const float* rs; const uint8_t* q;
  const void* scales; const void* mins; int s_dtype; int voff;
  void* out; int out_bf16; float* partial; int* counters;
  int K, N, ctas, nslot, vec;
};

template <int RB, bool B16>
void launch_decode(const DecArgs& a, cudaStream_t st) {
  auto kernel = qmm_tc_kernel_decode<RB, B16>;
  // quant/qmatmul.py decode_smem
  const size_t smem = sizeof(float) * RB * ((size_t)kDecWarps * kCols + (kSlotLD + 2) * a.nslot);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kernel<<<a.ctas, kDecThreads, smem, st>>>(a.x, a.x_bf16, a.rs, a.q, a.scales, a.mins,
                                            a.s_dtype, a.voff, a.out, a.out_bf16, a.partial,
                                            a.counters, a.K, a.N, a.nslot, a.vec);
}

template <bool B16>
int launch_decode_rows(const DecArgs& a, int rows, cudaStream_t st) {
  switch (rows) {
    case 1: launch_decode<1, B16>(a, st); break;
    case 2: launch_decode<2, B16>(a, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
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

// The decode body (rows 1-2 of a nibble-packed kind: pack 1 of
// tlt_qmatmul), the same arguments but: ctas and nslot from
// quant/qmatmul.py decode_grid; partial a (ctas, 2, rows, 128) f32
// workspace; counters one int32 per 128-column tile, 0 on entry and 0 again
// on exit. Returns cudaGetLastError() after the launch.
TLT_API int tlt_qmatmul_decode(const void* x, int x_bf16, const void* row_scale, const void* q,
                               const void* scales, const void* mins, int s_dtype, int voff,
                               int block, void* out, int out_bf16, void* partial,
                               void* counters, int rows, int K, int N, int ctas, int nslot,
                               int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DecArgs a{x, x_bf16, static_cast<const float*>(row_scale),
                  static_cast<const uint8_t*>(q), scales, mins, s_dtype, voff, out, out_bf16,
                  static_cast<float*>(partial), static_cast<int*>(counters), K, N, ctas,
                  nslot, vec};
  const int bad = block == 32 ? launch_decode_rows<false>(a, rows, st)
                  : block == 16 ? launch_decode_rows<true>(a, rows, st)
                                : (int)cudaErrorInvalidValue;
  if (bad) return bad;
  return (int)cudaGetLastError();
}
