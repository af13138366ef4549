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
// Design: phase B needs all of phase A, across CTAs. The launch is
// cooperative (cudaLaunchCooperativeKernel checks that every CTA of the
// grid is resident at once), with as many CTAs as fit, and three grid-wide
// barriers split four phases, each a loop of the grid over its tiles:
//   A: (128 columns of h13) x (a K split of E): 8 warps take interleaved
//      32-row blocks, reduce through shared memory, and store an f32
//      partial into a global workspace (ksA, rows, 2F);
//   G: the gate, elementwise: sum the ksA partials in order, silu * up,
//      round to bf16 into a (rows, F) workspace;
//   B: as A over g and W2, partials (ksB, rows, E);
//   R: sum the ksB partials in order and store out in bf16.
// The K splits are chosen so each phase has about one tile per CTA; the
// partial sums are added in a fixed order, so the result does not depend on
// scheduling. The barrier is a counter and a generation word in global
// memory (the last CTA to arrive resets the counter and bumps the
// generation); workspaces written by other CTAs are read with ld.cg (L2), never
// through the SM's L1. The TPU kernel's phase-pinned block indices and its
// VMEM tile gate do not carry over.

#include "common.cuh"

namespace {

using tlt::load4;
using tlt::round_bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 128;                // 32 lanes x 4 columns

struct FfnArgs {
  const __nv_bfloat16* x;                 // (rows, E)
  const uint8_t* q13; const void* s13;    // w13 planes
  const uint8_t* q2; const void* s2;      // w2 planes
  int s13_bf16, s2_bf16;
  float* part_a;                          // (ksA, rows, 2F)
  __nv_bfloat16* g;                       // (rows, F)
  float* part_b;                          // (ksB, rows, E)
  __nv_bfloat16* out;                     // (rows, E)
  unsigned* bar;                          // {count, generation}, zero at first use
  int rows, E, F, ks_a, kbps_a, ks_b, kbps_b;
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

// the 4 scales of row `row`, columns n0.., rounded to bf16 (zero past N)
__device__ __forceinline__ void scales_bf16(const void* __restrict__ plane, int bf16,
                                            int64_t row, int n0, int N, float s[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int n = n0 + c;
    if (n >= N) { s[c] = 0.f; continue; }
    s[c] = bf16 ? __uint_as_float(uint32_t(__ldg(static_cast<const uint16_t*>(plane)
                                                  + row * N + n)) << 16)
                : round_bf16(__ldg(static_cast<const float*>(plane) + row * N + n));
  }
}

// one tile: columns [tile * 128, +128) of X (rows, K) bf16 @ W (K, N) over
// the 32-row blocks [kb_begin, kb_end), stored as f32 into dst (rows, N)
template <int KIND, int ROWS>
__device__ void ffn_tile(const __nv_bfloat16* X, int K, const uint8_t* __restrict__ q,
                         const void* s, int s_bf16, int N, int tile, int kb_begin,
                         int kb_end, int nrows, float* dst,
                         float (&red)[kWarps][ROWS][kCols]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = (tile * 32 + lane) * 4;
  const bool vec = (N & 3) == 0;
  float acc[ROWS][4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  auto xval = [&](int r, int k) -> float {
    if (r >= nrows) return 0.f;
    const unsigned short b = __ldcg(reinterpret_cast<const unsigned short*>(X)
                                    + (int64_t)r * K + k);
    return __uint_as_float(uint32_t(b) << 16);
  };

  for (int kb = kb_begin + warp; kb < kb_end; kb += kWarps) {
    const int k0 = kb * 32;
    float sb[4];
    scales_bf16(s, s_bf16, kb, n0, N, sb);
    if (KIND == 0) {
      // q4_0: byte row 16kb + j -> rows k0 + j (low nibble), k0 + 16 + j
#pragma unroll 4
      for (int j = 0; j < 16; ++j) {
        const uint32_t b = load4(q, (int64_t)kb * 16 + j, n0, N, vec);
        float xlo[ROWS], xhi[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) { xlo[r] = xval(r, k0 + j); xhi[r] = xval(r, k0 + 16 + j); }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t byte = (b >> (8 * c)) & 0xFFu;
          const float wlo = round_bf16(float(int(byte & 0xFu) - 8) * sb[c]);
          const float whi = round_bf16(float(int(byte >> 4) - 8) * sb[c]);
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            acc[r][c] = fmaf(xhi[r], whi, fmaf(xlo[r], wlo, acc[r][c]));
        }
      }
    } else {
      // q8_0: one int8 a weight
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        const uint32_t b = load4(q, (int64_t)k0 + j, n0, N, vec);
        float xv[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) xv[r] = xval(r, k0 + j);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float w = round_bf16(float(int8_t((b >> (8 * c)) & 0xFFu)) * sb[c]);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) acc[r][c] = fmaf(xv[r], w, acc[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][r][lane * 4 + c] = acc[r][c];
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * kCols; i += kThreads) {
    const int r = i / kCols, col = i % kCols;
    const int n = tile * kCols + col;
    if (r < nrows && n < N) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[w][r][col];
      dst[(int64_t)r * N + n] = sum;
    }
  }
  __syncthreads();   // red is reused by the next tile
}

template <int KIND, int ROWS>
__global__ void __launch_bounds__(kThreads) ffn_kernel(FfnArgs a) {
  __shared__ float red[kWarps][ROWS][kCols];
  const int F2 = 2 * a.F;
  const int nrows = a.rows;

  // A: h13 partials
  {
    const int cols = (F2 + kCols - 1) / kCols;
    const int nkb = a.E / 32;
    for (int t = blockIdx.x; t < cols * a.ks_a; t += gridDim.x) {
      const int tile = t % cols, split = t / cols;
      const int kb0 = split * a.kbps_a;
      ffn_tile<KIND, ROWS>(a.x, a.E, a.q13, a.s13, a.s13_bf16, F2, tile, kb0,
                           min(nkb, kb0 + a.kbps_a), nrows,
                           a.part_a + (int64_t)split * nrows * F2, red);
    }
  }
  grid_sync(a.bar);
  // G: g = bf16(silu(gate) * up), the gate in f32
  {
    const int64_t count = (int64_t)nrows * a.F;
    const int64_t plane = (int64_t)nrows * F2;
    for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < count;
         i += (int64_t)gridDim.x * kThreads) {
      const int64_t r = i / a.F, f = i % a.F;
      float gate = 0.f, up = 0.f;
      for (int sp = 0; sp < a.ks_a; ++sp) {
        gate += __ldcg(a.part_a + sp * plane + r * F2 + f);
        up += __ldcg(a.part_a + sp * plane + r * F2 + a.F + f);
      }
      const float sig = 1.f / (1.f + expf(-gate));
      a.g[i] = __float2bfloat16_rn(gate * sig * up);
    }
  }
  grid_sync(a.bar);
  // B: out partials
  {
    const int cols = (a.E + kCols - 1) / kCols;
    const int nkb = a.F / 32;
    for (int t = blockIdx.x; t < cols * a.ks_b; t += gridDim.x) {
      const int tile = t % cols, split = t / cols;
      const int kb0 = split * a.kbps_b;
      ffn_tile<KIND, ROWS>(a.g, a.F, a.q2, a.s2, a.s2_bf16, a.E, tile, kb0,
                           min(nkb, kb0 + a.kbps_b), nrows,
                           a.part_b + (int64_t)split * nrows * a.E, red);
    }
  }
  grid_sync(a.bar);
  // R: sum the partials in split order
  {
    const int64_t count = (int64_t)nrows * a.E;
    for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < count;
         i += (int64_t)gridDim.x * kThreads) {
      float sum = 0.f;
      for (int sp = 0; sp < a.ks_b; ++sp) sum += __ldcg(a.part_b + sp * count + i);
      a.out[i] = __float2bfloat16_rn(sum);
    }
  }
}

template <int KIND>
const void* kernel_for(int rows) {
  const int rt = rows >= 5 ? 8 : rows >= 3 ? 4 : rows >= 2 ? 2 : 1;
  switch (rt) {
    case 8: return reinterpret_cast<const void*>(&ffn_kernel<KIND, 8>);
    case 4: return reinterpret_cast<const void*>(&ffn_kernel<KIND, 4>);
    case 2: return reinterpret_cast<const void*>(&ffn_kernel<KIND, 2>);
    default: return reinterpret_cast<const void*>(&ffn_kernel<KIND, 1>);
  }
}

const void* kernel_for(int kind, int rows) {
  return kind == 0 ? kernel_for<0>(rows) : kernel_for<1>(rows);
}

}  // namespace

// The grid of the cooperative launch for (kind, rows): CTAs that fit on the
// card at once, at most 2 an SM; 0 if cooperative launch is not supported.
TLT_API int tlt_ffn_grid(int kind, int rows) {
  int dev = 0, sms = 0, coop = 0, occ = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel_for(kind, rows), kThreads, 0)
      != cudaSuccess)
    return 0;
  return sms * (occ < 2 ? occ : 2);
}

// kind: 0 = q4_0, 1 = q8_0 (both weights). s*_bf16: scale planes in bf16 (else
// f32). Workspaces sized as in FfnArgs; bar: 2 zeroed words kept across
// launches. Returns the launch's error code.
TLT_API int tlt_ffn(const void* x, const void* q13, const void* s13, int s13_bf16,
                    const void* q2, const void* s2, int s2_bf16, int kind, void* part_a,
                    void* g, void* part_b, void* out, void* bar, int rows, int E, int F,
                    int ks_a, int kbps_a, int ks_b, int kbps_b, int grid, void* stream) {
  FfnArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q13), s13,
            static_cast<const uint8_t*>(q2), s2, s13_bf16, s2_bf16,
            static_cast<float*>(part_a), static_cast<__nv_bfloat16*>(g),
            static_cast<float*>(part_b), static_cast<__nv_bfloat16*>(out),
            static_cast<unsigned*>(bar), rows, E, F, ks_a, kbps_a, ks_b, kbps_b};
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel_for(kind, rows), dim3(grid),
                                                    dim3(kThreads), args, 0,
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
