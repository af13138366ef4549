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
// Design, one body for every row count (its tile, stage, unpacking, ring
// and split merge in qmm_tile.cuh, shared with K7):
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
