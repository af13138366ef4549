// The SwiGLU FFN megakernel on Hopper: one launch for a decode step's FFN.
//
// Replaces: tpu_llm/quant/pallas_ffn.py::_ffn_kernel (wrapper
// ffn_fused_pallas). For at most 8 bf16 rows x (rows, E) and q4_0 / q8_0
// weights w13 (E, 2F, gate | up) and w2 (F, E):
//   h13 = x @ W13;  g = bf16(silu(h13[:, :F]) * h13[:, F:]);  out = g @ W2
// accumulated in f32, out in bf16. Numerics are the Pallas kernel's bf16
// ones, not K1's: each scale is rounded to bf16 and each dequantized weight
// round_bf16(v * s_bf16) is rounded to bf16 before the f32 multiply-add
// (_dequant_q4_bf16 / _dequant_q8_bf16); the gate is computed in f32.
//
// What bounds it on the H100: the bytes of w13 and w2 (at TinyLlama width,
// q4_0 with f32 scales 21.6 MB, q8_0 38.9 MB) over the 3.35 TB/s of HBM.
//
// Design: K1's tensor-core tile (qmm_tile.cuh: 4 warps, 128 staged
// columns, 32-row blocks of K through a cp.async ring, values unpacked
// exactly into bf16 by integer tricks) with the scale on the weight, in
// one cooperative launch of two phases and one grid barrier:
// - the products run on the tensor cores (mma.sync m16n8k16, f32
//   accumulate), x (or g) as the A operand, its rows padded into one m16
//   tile; the B operand is the Pallas weight bit for bit: the exact bf16
//   value times the column's bf16 scale by one __hmul2, whose single
//   rounding to nearest even is round_bf16(v * s_bf16);
// - A: h13 over a 64-column tile of F and a K split of E. A tile stages
//   the gate columns f0 .. f0 + 63 beside the up columns F + f0 .. F + f0
//   + 63, so the last CTA of the tile to finish (K1's merge: each split
//   stores an f32 partial, the last to arrive on the tile's counter sums
//   them in split order and resets the counter) holds the gate and the up
//   of those f and writes g = bf16(silu(gate) * up) itself, the gate in
//   f32: no gate pass and no reduction pass;
// - one grid barrier (a counter and a generation word in device memory;
//   the last CTA to arrive resets the counter and bumps the generation):
//   B reads all of g;
// - B: out over 128 columns of E and a K split of F, x = g read through L2
//   (cp.async.cg); the last CTA of each tile sums the partials in split
//   order and stores out in bf16;
// - a merge reads its partials as float4, 16 splits a round trip to L2
//   (read one by one, each split cost a round trip);
// - the grid is what fits on the card at once (cudaLaunchCooperativeKernel
//   checks it); the wrapper's K splits give each phase about one item a
//   CTA, and a CTA loops over its items. The sums are added in a fixed
//   order, so the result does not depend on scheduling.
// The TPU kernel's phase-pinned block indices and its VMEM tile gate do
// not carry over.

#include "common.cuh"
#include "qmm_tile.cuh"

namespace {

using namespace tlt::qmm;
using tlt::ldsm_x4;
using tlt::mma_bf16;
using tlt::pack_bf16;
using bf16 = __nv_bfloat16;

constexpr int kGate = kCols / 2;   // gate (and up) columns of a phase-A tile
constexpr int kCtasPerSm = 4;      // __launch_bounds__ of the kernel

struct FfnArgs {
  const bf16* x;                          // (rows, E)
  const uint8_t* q13; const void* s13;    // w13 planes (E, 2F)
  const uint8_t* q2; const void* s2;      // w2 planes (F, E)
  int s13_dtype, s2_dtype;                // Plane: kF32 or kBF16
  float* part_a;                          // (ks_a, rows, tiles_a * 128): [gate | up] a tile
  bf16* g;                                // (rows, F)
  float* part_b;                          // (ks_b, rows, E)
  bf16* out;                              // (rows, E)
  int* counters;                          // barrier {count, generation}, tiles_a, tiles_b
  int rows, E, F, ks_a, kbps_a, ks_b, kbps_b;
};

// staged columns [0, 64): gate columns f0 + c; [64, 128): the up columns
// F + f0 + c - 64 of the same f; real while f < F
struct GateUpCols {
  int f0, F;
  __device__ __forceinline__ int col(int c) const {
    return c < kGate ? f0 + c : F + f0 + c - kGate;
  }
  __device__ __forceinline__ bool ok(int c) const { return f0 + (c & (kGate - 1)) < F; }
};

__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g0 = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g0) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// the scales of staged columns wcol .. wcol + 3, each rounded to bf16 and
// doubled into a bf16x2 word (both rows of a B register share a column)
__device__ __forceinline__ void scales_bf16x2(const unsigned char* row, int dtype, int wcol,
                                              uint32_t (&s)[4]) {
  if (dtype == kF32) {
    const float4 v = *reinterpret_cast<const float4*>(row + wcol * 4);
    s[0] = pack_bf16(v.x, v.x), s[1] = pack_bf16(v.y, v.y);
    s[2] = pack_bf16(v.z, v.z), s[3] = pack_bf16(v.w, v.w);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(row + wcol * 2);
    s[0] = (u.x & 0xFFFFu) * 0x10001u, s[1] = (u.x >> 16) * 0x10001u;
    s[2] = (u.y & 0xFFFFu) * 0x10001u, s[3] = (u.y >> 16) * 0x10001u;
  }
}

// One item: X (rows, K) bf16 @ the weight's staged columns `cols` over the
// 32-row blocks [kb0, kb1), into this thread's accumulators (rows g8 and
// g8 + 8, staged columns ccol + c in acc[c & 3][c < 4 ? 0 : 1] for row g8)
template <int PACK, typename Cols>
__device__ __forceinline__ void gemm_item(unsigned char* ring_s, const bf16* X, int K,
                                          int nrows, const uint8_t* __restrict__ q,
                                          const void* __restrict__ s, int s_dtype, int N,
                                          Cols cols, int kb0, int kb1, float (&acc)[4][4]) {
  using SG = Stage<bf16, PACK, false, 1>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, tig = lane & 3;
  const int wcol = warp * 32 + 4 * g8;   // this thread's 4 B columns
  const int es = s_dtype == kF32 ? 4 : 2;
  const uint32_t bias = pack_bf16(136.f, 136.f);   // 128 + q4_0's offset 8
#pragma unroll
  for (int t = 0; t < 4; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  run_ring<SG::N>(
      kb1 - kb0,
      [&](int i, int slot) {
        load_stage<bf16, PACK, false, 1>(ring_s + slot * SG::BYTES, X, 0, nrows, K, q,
                                         nullptr, s, nullptr, es, N, cols, kb0 + i, true);
      },
      [&](int, int slot) {
        const unsigned char* st = ring_s + slot * SG::BYTES;
        uint32_t b[2][4][2], sc[4];
        unpack_values<PACK, SG>(st, wcol, tig, bias, b);
        scales_bf16x2(st + SG::S_OFF, s_dtype, wcol, sc);
        const bf16* arow = reinterpret_cast<const bf16*>(st + SG::X_OFF) +
                           (lane & 15) * kPartLD + (lane >> 4) * 8;
#pragma unroll
        for (int step = 0; step < 2; ++step) {
          uint32_t a[4];
          ldsm_x4(a, arow + step * 16);
#pragma unroll
          for (int t = 0; t < 4; ++t)
            mma_bf16(acc[t], a, bf16x2_mul(b[step][t][0], sc[t]),
                     bf16x2_mul(b[step][t][1], sc[t]));
        }
      });
  __syncthreads();   // the ring is reused by the next item
}

// s[j] = the sum over the n splits y, in split order, of the float4 at p +
// j * jstride + y * stride, read through L2 (written by other CTAs). The
// loads go out 16 at a time (past n a +0 that changes no sum), so a merge
// waits for a round trip to L2 every 16 / NP splits, not every split
template <int NP>
__device__ __forceinline__ void sum_splits4(const float* p, int jstride, int64_t stride,
                                            int n, float4 (&s)[NP]) {
  constexpr int kBatch = 16 / NP;
#pragma unroll
  for (int j = 0; j < NP; ++j) s[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int y = 0; y < n; y += kBatch) {
    float4 v[kBatch][NP];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int j = 0; j < NP; ++j)
        v[u][j] = y + u < n ? __ldcg(reinterpret_cast<const float4*>(
                                  p + j * jstride + (y + u) * stride))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        s[j].x += v[u][j].x;
        s[j].y += v[u][j].y;
        s[j].z += v[u][j].z;
        s[j].w += v[u][j].w;
      }
  }
}

// 4 bf16 of (a0, a1, a2, a3) at p (8-byte aligned)
__device__ __forceinline__ void store4_bf16(bf16* p, float a0, float a1, float a2, float a3) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(a0, a1), pack_bf16(a2, a3));
}

// silu(gate) * up, the gate in f32
__device__ __forceinline__ float silu_mul(float gate, float up) {
  return gate * (1.f / (1.f + expf(-gate))) * up;
}

// row g8's 8 accumulator columns ccol .. ccol + 7 into dst (f32, 16-byte aligned)
__device__ __forceinline__ void store_partial(float* dst, const float (&acc)[4][4]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(acc[0][0], acc[1][0], acc[2][0], acc[3][0]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(acc[0][1], acc[1][1], acc[2][1], acc[3][1]);
}

template <int PACK>
__global__ void __launch_bounds__(kThreads, kCtasPerSm) ffn_tc_kernel(FfnArgs a) {
  extern __shared__ __align__(16) unsigned char ring_s[];
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, tig = lane & 3;
  const int ccol = warp * 32 + 8 * tig;   // this thread's 8 accumulator columns
  const int nrows = a.rows;
  const int tiles_a = (a.F + kGate - 1) / kGate, tiles_b = (a.E + kCols - 1) / kCols;
  const int na = tiles_a * kCols;          // a phase-A partial's row
  unsigned* bar = reinterpret_cast<unsigned*>(a.counters);
  int* ctr_a = a.counters + 2;
  int* ctr_b = ctr_a + tiles_a;
  float acc[4][4];

  // A: h13 partials of (gate | up) tiles; the last split of a tile writes g
  for (int it = blockIdx.x; it < tiles_a * a.ks_a; it += gridDim.x) {
    const int tile = it % tiles_a, split = it / tiles_a;
    const int kb0 = split * a.kbps_a, kb1 = min(a.E / 32, kb0 + a.kbps_a);
    gemm_item<PACK>(ring_s, a.x, a.E, nrows, a.q13, a.s13, a.s13_dtype, 2 * a.F,
                    GateUpCols{tile * kGate, a.F}, kb0, kb1, acc);
    if (g8 < nrows)
      store_partial(a.part_a + ((int64_t)split * nrows + g8) * na + tile * kCols + ccol, acc);
    if (last_to_arrive(ctr_a + tile, a.ks_a, is_last)) {
      // 4 columns a thread: the gate's and the up's f32 sums, then g
      for (int i = tid; i < nrows * (kGate / 4); i += kThreads) {
        const int r = i / (kGate / 4), c = (i - r * (kGate / 4)) * 4, f = tile * kGate + c;
        if (f >= a.F) continue;   // F % 32 == 0: 4 columns are all real or none
        float4 s[2];              // gate, up
        sum_splits4(a.part_a + (int64_t)r * na + tile * kCols + c, kGate,
                    (int64_t)nrows * na, a.ks_a, s);
        store4_bf16(a.g + (int64_t)r * a.F + f, silu_mul(s[0].x, s[1].x),
                    silu_mul(s[0].y, s[1].y), silu_mul(s[0].z, s[1].z),
                    silu_mul(s[0].w, s[1].w));
      }
      if (tid == 0) ctr_a[tile] = 0;
    }
  }
  grid_sync(bar);
  // B: out partials; the last split of a tile stores out
  for (int it = blockIdx.x; it < tiles_b * a.ks_b; it += gridDim.x) {
    const int tile = it % tiles_b, split = it / tiles_b;
    const int kb0 = split * a.kbps_b, kb1 = min(a.F / 32, kb0 + a.kbps_b);
    const int n0 = tile * kCols;
    gemm_item<PACK>(ring_s, a.g, a.F, nrows, a.q2, a.s2, a.s2_dtype, a.E,
                    LinearCols{n0, a.E}, kb0, kb1, acc);
    if (g8 < nrows && n0 + ccol < a.E)
      store_partial(a.part_b + ((int64_t)split * nrows + g8) * a.E + n0 + ccol, acc);
    if (last_to_arrive(ctr_b + tile, a.ks_b, is_last)) {
      for (int i = tid; i < nrows * (kCols / 4); i += kThreads) {
        const int r = i / (kCols / 4), n = n0 + (i - r * (kCols / 4)) * 4;
        if (n >= a.E) continue;   // E % 32 == 0
        float4 s[1];
        sum_splits4(a.part_b + (int64_t)r * a.E + n, 0, (int64_t)nrows * a.E, a.ks_b, s);
        store4_bf16(a.out + (int64_t)r * a.E + n, s[0].x, s[0].y, s[0].z, s[0].w);
      }
      if (tid == 0) ctr_b[tile] = 0;
    }
  }
}

const void* kernel_for(int kind) {
  return kind == 0 ? reinterpret_cast<const void*>(&ffn_tc_kernel<kNibble>)
                   : reinterpret_cast<const void*>(&ffn_tc_kernel<kInt8>);
}

template <int PACK>
constexpr size_t ring_bytes() {
  return (size_t)Stage<bf16, PACK, false, 1>::N * Stage<bf16, PACK, false, 1>::BYTES;
}

size_t smem_for(int kind) { return kind == 0 ? ring_bytes<kNibble>() : ring_bytes<kInt8>(); }

}  // namespace

// The CTAs of kind's cooperative launch that fit on the card at once (SMs
// x occupancy); 0 if the card takes no cooperative launch.
TLT_API int tlt_ffn_grid(int kind) {
  int dev = 0, sms = 0, coop = 0, occ = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel_for(kind), kThreads,
                                                    smem_for(kind)) != cudaSuccess)
    return 0;
  return sms * occ;
}

// kind: 0 = q4_0, 1 = q8_0 (both weights). s*_dtype: scale planes in f32
// (0) or bf16 (1), blocks of 32 rows. Every plane, x and the workspaces on
// 16-byte boundaries; E and F multiples of 32. Workspaces sized as in
// FfnArgs; counters: 2 + ceil(F / 64) + ceil(E / 128) int32, zero at the
// first launch and left zero by each. Returns the launch's error code.
TLT_API int tlt_ffn(const void* x, const void* q13, const void* s13, int s13_dtype,
                    const void* q2, const void* s2, int s2_dtype, int kind, void* part_a,
                    void* g, void* part_b, void* out, void* counters, int rows, int E, int F,
                    int ks_a, int kbps_a, int ks_b, int kbps_b, int grid, void* stream) {
  FfnArgs a{static_cast<const bf16*>(x), static_cast<const uint8_t*>(q13), s13,
            static_cast<const uint8_t*>(q2), s2, s13_dtype, s2_dtype,
            static_cast<float*>(part_a), static_cast<bf16*>(g), static_cast<float*>(part_b),
            static_cast<bf16*>(out), static_cast<int*>(counters), rows, E, F, ks_a, kbps_a,
            ks_b, kbps_b};
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel_for(kind), dim3(grid),
                                                    dim3(kThreads), args, smem_for(kind),
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
