// Flash (online-softmax) GQA attention kernels on Hopper.
//
// Replaces, in tpu_llm/ops/flash_attention.py:
// - _decode_kernel (wrapper flash_decode_attention, K2): one-query GQA
//   decode over a flat (B, S, Hkv*D) cache, keys s <= pos[b];
// - _decode_fused_kernel (wrapper flash_decode_fused, K3): the same
//   attention against a STALE cache (s < pos) plus this step's k_cur/v_cur
//   for s == pos, which it also stores at row pos (K2's body, APPEND);
// - _flash_kernel (wrapper flash_gqa_attention, K4): causal prefill, query
//   t sees s <= offset + t, kv head h / G.
//
// What they compute (not how the TPU tiles it): scores q . k in f32 times
// sm_scale; online softmax in f32 with NEG_INF = -0.7 * f32max for masked
// scores; a row with l == 0 stores 0; ROUND_P (q and cache both bf16)
// rounds the softmax weights to bf16 before the AV product, which is what
// the reference's einsum path computes for bf16 inputs; output in q's
// dtype.
//
// What bounds them on the H100. Decode: the cache bytes of rows <= pos,
// 2 * (pos + 1) * Hkv * D * itemsize a batch row, over 3.35 TB/s; 4 flops
// a cache element. Prefill: 4 * T * S_visible * D flops a head, over the
// bf16 tensor-core rate (989 TFLOP/s); its bytes (q, out, K/V rows once)
// are a few MB.
//
// K2, flash_decode_split_kernel: split over the sequence (flash-decoding).
// The grid is (kv head, batch row, split); the wrapper picks the split
// count from (B, Hkv, S) alone (decode_splits in ops/flash_attention.py,
// about two CTAs an SM), never from the positions, so a CUDA graph
// captures it with the position in a device tensor. A CTA of 128 threads
// holds all G = H / Hkv query heads of its kv head (q as f32 in shared
// memory, read as warp-wide broadcasts: G and D are runtime values), so
// each cache row is read from device memory once and used G times. Its
// rows come in 64-row tiles, 16-byte cp.async copies into two shared
// stages (rows padded by 16 bytes: conflict-free 16-byte reads), the next
// tile's copy in flight while this one is computed; the math is f32 on
// CUDA cores. A split stores its unnormalised partial (acc, m, l); one
// whose rows all lie past pos reads and stores nothing. The merge is in
// the same launch: each split counts itself done on an int32 counter of
// its (b, kv head) (atomicAdd after a __threadfence), and the last one
// merges the partials of the splits that hold rows, in split order, so
// the result does not depend on which split finishes last; it resets the
// counter to 0, so the counters (kept by the wrapper, zero-filled once)
// are 0 again for the next launch or graph replay. One launch a call: at
// batch 1 a second, merging launch cost as much as the split kernel. With
// one split the kernel writes the output itself.
//
// K3 runs the same body with APPEND set. What bounds it is what bounds
// K2: the cache bytes of rows < pos plus the one row it stores, over
// 3.35 TB/s (its old body, one CTA of 256 threads per (b, kv head) over
// f32 tiles padded to D + 1, ran 4 CTAs at batch 1 and stayed well
// under 1% of that). The split that holds pos copies key pos from k_cur / v_cur (in
// the cache dtype) into its tile in place of the stale row, and stores
// them at row pos; every other split ends before pos or lies past it and
// exits, so no CTA reads the row being written. The merge, its counters
// and the n_split == 1 path are K2's.
//
// K4, flash_prefill_kernel (bf16 q): tensor cores. One CTA of 4 warps per
// (64-query tile, query head, b); each warp owns 16 query rows, its Q
// fragments in registers for the whole CTA. GQA: one CTA per query head,
// not one per kv head: the G CTAs of a kv head read the same K/V tiles,
// which L2 serves (a kv head's K and V of 1024 rows are 256 KB), and the
// grid stays H * T / 64 CTAs with 16 query rows a warp. K and V come in
// 64-key tiles through shared memory with rows padded by 16 bytes, so
// the ldmatrix fragment loads are free of bank conflicts. S = Q K^T and
// O += P V are mma.sync m16n8k16 bf16 products with f32 accumulators; the
// online softmax runs on the accumulator fragments in registers (row max
// and row sum over the quad of threads that share a row, by shuffles).
// P is packed to bf16 as the A operand of the PV product: with a bf16
// cache that is ROUND_P's rounding. A bf16 cache is copied with cp.async
// into two stages (the next tile's copy overlaps this tile's math). An f32
// cache is never rounded to bf16: its tile is copied raw (cp.async, one
// f32 stage, the next copy overlapping this tile's math) and split, on
// its way to the bf16 tiles, into x = hi + mid + lo, three bf16 parts that
// hold all 24 bits; S = Q Kh + Q Km + Q Kl (q is bf16, exact), and the
// unrounded P, split the same way, gives O += every product down to 2^-16
// of the leading one (Ph Vh, Pm Vh, Pl Vh, Ph Vm, Pm Vm, Ph Vl), so the
// products keep f32's precision and only the order of the f32 sums
// differs from the f32 twin's. Tiles wholly above the causal
// diagonal are neither copied nor computed (a CTA stops at its deepest
// query; a warp skips tiles above its own rows); only diagonal tiles are
// masked elementwise; rows past the deepest visible key are zero-filled,
// never read. CTAs run deepest tile first.
//
// K4, flash_prefill_simt_kernel (f32 q: --dtype f32, the K-quant logits
// checks): CUDA cores in f32, so the f32 tolerance holds. One CTA of 256
// threads per (b, h, 64-query tile); 64-row K/V tiles converted to f32 in
// shared memory, rows padded to D + 1 floats; scalar dot products.

#include <type_traits>

#include "common.cuh"

namespace {

using tlt::NEG_INF;
using tlt::cp_async16;
using tlt::cp_async_commit;
using tlt::cp_async_wait;
using tlt::from_f32;
using tlt::ldsm_x4;
using tlt::ldsm_x4_t;
using tlt::mma_bf16;
using tlt::pack_bf16;
using tlt::split3_bf16;
using tlt::round_bf16;
using tlt::to_f32;
using tlt::warp_max;
using tlt::warp_sum;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int KT = 64;   // keys per tile
constexpr int BQ = 64;   // queries per prefill tile

template <typename K>
void allow_smem(K kernel, size_t bytes) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// -- K2: decode split over the sequence ---------------------------------------

constexpr int kSplitThreads = 128;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int PKT = KT + 4;   // p_s row: heads g and g + 1 on other banks

// 8 consecutive cache elements as f32 (16 bytes of bf16, 32 of f32)
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h2 = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    x[2 * i] = __low2float(h2);
    x[2 * i + 1] = __high2float(h2);
  }
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

__device__ __forceinline__ void load4(const bf16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  x[0] = __low2float(a), x[1] = __high2float(a), x[2] = __low2float(b), x[3] = __high2float(b);
}

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
}

// padded cache row in shared memory, in elements: 16 bytes past the row,
// so 16-byte reads of one column by consecutive rows hit distinct banks
template <typename CT>
__host__ __device__ constexpr int split_row(int D) {
  return D + 16 / (int)sizeof(CT);
}

template <typename CT>
size_t split_smem(int G, int D, int n_split) {
  return sizeof(CT) * 4 * KT * split_row<CT>(D) +
         sizeof(float) * (2 * G * D + G * PKT + 3 * G + 2 * G * n_split + G);
}

template <typename QT, typename CT, bool ROUND_P, bool SPLIT, bool APPEND>
__global__ void __launch_bounds__(kSplitThreads)
flash_decode_split_kernel(const QT* __restrict__ q, CT* __restrict__ kc,
                          CT* __restrict__ vc, const CT* __restrict__ k_cur,
                          const CT* __restrict__ v_cur, const int* __restrict__ pos_arr,
                          QT* __restrict__ out, float* __restrict__ part_acc,
                          float* __restrict__ part_ml, int* __restrict__ counters, int H,
                          int Hkv, int D, int S, int rows_per_split, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int is_last;
  const int G = H / Hkv;
  const int h = blockIdx.x;            // kv head
  const int b = blockIdx.y;
  const int split = blockIdx.z, n_split = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int HkvD = Hkv * D;
  const int RW = split_row<CT>(D);
  CT* kv_s = reinterpret_cast<CT*>(smem_raw);        // [stage][K|V][KT][RW]
  float* q_s = reinterpret_cast<float*>(kv_s + 4 * KT * RW);   // G x D
  float* p_s = q_s + G * D;            // G x PKT
  float* acc_s = p_s + G * PKT;        // G x D
  float* m_s = acc_s + G * D;          // G
  float* l_s = m_s + G;                // G
  float* alpha_s = l_s + G;            // G
  float* wm_s = alpha_s + G;           // merge: G x n_split maxima, then weights
  float* wl_s = wm_s + G * n_split;    // G x n_split sums
  float* inv_s = wl_s + G * n_split;   // G

  const int pos = min(pos_arr[b], S - 1);
  const int s_begin = split * rows_per_split;
  const int s_end = min(pos + 1, s_begin + rows_per_split);   // exclusive
  const int n_tiles = s_end > s_begin ? (s_end - s_begin + KT - 1) / KT : 0;
  const int64_t head0 = (int64_t)b * H + (int64_t)h * G;       // first query head

  if (n_tiles > 0) {   // a split past pos reads and stores nothing
    CT* kb = kc + (int64_t)b * S * HkvD + (int64_t)h * D;
    CT* vb = vc + (int64_t)b * S * HkvD + (int64_t)h * D;
    constexpr int EPC = 16 / sizeof(CT);     // elements a 16-byte chunk
    const int cpr = D / EPC;                 // chunks a row
    // K3: key pos is this step's k_cur / v_cur (never the stale row), and
    // the split that holds pos (the only one whose rows reach it) stores
    // it at row pos of its kv head; no split reads row pos of the cache
    const CT* kcur = APPEND ? k_cur + (int64_t)b * HkvD + (int64_t)h * D : nullptr;
    const CT* vcur = APPEND ? v_cur + (int64_t)b * HkvD + (int64_t)h * D : nullptr;
    if (APPEND && pos < s_end) {
      for (int c = tid; c < cpr; c += kSplitThreads) {
        const int64_t off = (int64_t)pos * HkvD + c * EPC;
        *reinterpret_cast<uint4*>(kb + off) = *reinterpret_cast<const uint4*>(kcur + c * EPC);
        *reinterpret_cast<uint4*>(vb + off) = *reinterpret_cast<const uint4*>(vcur + c * EPC);
      }
    }
    auto load_tile = [&](int j) {
      const int s0 = s_begin + j * KT;
      CT* ks = kv_s + (j & 1) * 2 * KT * RW;
      CT* vs = ks + KT * RW;
      for (int c = tid; c < KT * cpr; c += kSplitThreads) {
        const int r = c / cpr, col = (c - r * cpr) * EPC;
        const bool ok = s0 + r < s_end;
        const int64_t off = (int64_t)(ok ? s0 + r : s_begin) * HkvD + col;
        const bool cur = APPEND && s0 + r == pos;
        cp_async16(ks + r * RW + col, cur ? kcur + col : kb + off, ok);
        cp_async16(vs + r * RW + col, cur ? vcur + col : vb + off, ok);
      }
    };
    load_tile(0);
    cp_async_commit();
    // q and the softmax state while the first tile is in flight
    const QT* qb = q + head0 * D;
    for (int i = tid; i < G * D; i += kSplitThreads) {
      q_s[i] = to_f32(qb[i]);
      acc_s[i] = 0.f;
    }
    for (int g = tid; g < G; g += kSplitThreads) {
      m_s[g] = NEG_INF;
      l_s[g] = 0.f;
    }

    for (int j = 0; j < n_tiles; ++j) {
      if (j + 1 < n_tiles) load_tile(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const int s0 = s_begin + j * KT;
      const int nk = min(KT, s_end - s0);
      const CT* ks = kv_s + (j & 1) * 2 * KT * RW;
      const CT* vs = ks + KT * RW;

      // scores: thread -> key s, heads hg, hg + 2, ... (a warp shares hg,
      // so its q reads are broadcasts); rows past nk are zeros in shared memory
      {
        const int s = tid & (KT - 1), hg = tid / KT;
        constexpr int GC = 4;
        for (int g0 = hg; g0 < G; g0 += 2 * GC) {
          float dot[GC] = {0.f, 0.f, 0.f, 0.f};
          for (int c = 0; c < D; c += 8) {
            float kx[8];
            load8(ks + s * RW + c, kx);
#pragma unroll
            for (int u = 0; u < GC; ++u) {
              const int g = g0 + 2 * u;
              if (g < G) {
                const float4 qa = *reinterpret_cast<const float4*>(q_s + g * D + c);
                const float4 qc = *reinterpret_cast<const float4*>(q_s + g * D + c + 4);
                float d = dot[u];
                d = fmaf(qa.x, kx[0], d); d = fmaf(qa.y, kx[1], d);
                d = fmaf(qa.z, kx[2], d); d = fmaf(qa.w, kx[3], d);
                d = fmaf(qc.x, kx[4], d); d = fmaf(qc.y, kx[5], d);
                d = fmaf(qc.z, kx[6], d); d = fmaf(qc.w, kx[7], d);
                dot[u] = d;
              }
            }
          }
#pragma unroll
          for (int u = 0; u < GC; ++u) {
            const int g = g0 + 2 * u;
            if (g < G) p_s[g * PKT + s] = s < nk ? dot[u] * sm_scale : NEG_INF;
          }
        }
      }
      __syncthreads();
      for (int g = warp; g < G; g += kSplitWarps) {
        float mx = NEG_INF;
        for (int s = lane; s < KT; s += 32) mx = fmaxf(mx, p_s[g * PKT + s]);
        mx = warp_max(mx);
        const float m_prev = m_s[g];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int s = lane; s < KT; s += 32) {
          const float p = s < nk ? expf(p_s[g * PKT + s] - m_new) : 0.f;
          sum += p;
          p_s[g * PKT + s] = ROUND_P ? round_bf16(p) : p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          m_s[g] = m_new;
          l_s[g] = alpha * l_s[g] + sum;
          alpha_s[g] = alpha;
        }
      }
      __syncthreads();
      // AV: thread -> (head g, 4 columns); p past nk is 0 and V rows past nk
      // are zeros, so the key loop runs in whole steps of 4
      const int nk4 = (nk + 3) & ~3;
      for (int it = tid; it < G * (D / 4); it += kSplitThreads) {
        const int g = it / (D / 4), d0 = (it - g * (D / 4)) * 4;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        for (int s = 0; s < nk4; s += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(p_s + g * PKT + s);
          const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float vx[4];
            load4(vs + (s + u) * RW + d0, vx);
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] = fmaf(pv[u], vx[e], a[e]);
          }
        }
        const float alpha = alpha_s[g];
        float* acc = acc_s + g * D + d0;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] = acc[e] * alpha + a[e];
      }
      __syncthreads();
    }

    if (!SPLIT) {
      QT* ob = out + head0 * D;
      for (int i = tid; i < G * D; i += kSplitThreads) {
        const float l = l_s[i / D];
        const float inv = l == 0.f ? 1.f : 1.f / l;
        ob[i] = from_f32<QT>(acc_s[i] * inv);
      }
      return;
    }
    for (int i = tid; i < G * D; i += kSplitThreads) {
      const int g = i / D, d = i - g * D;
      part_acc[((head0 + g) * n_split + split) * D + d] = acc_s[i];
    }
    for (int g = tid; g < G; g += kSplitThreads) {
      part_ml[((head0 + g) * n_split + split) * 2] = m_s[g];
      part_ml[((head0 + g) * n_split + split) * 2 + 1] = l_s[g];
    }
  }
  if (!SPLIT) return;

  // The last split of (b, kv head) to finish merges the partials of the
  // splits that hold rows (i <= pos / rows_per_split; the others add
  // nothing), in split order, so the result does not depend on which
  // split is last: out = sum_i e^(m_i - m) acc_i / sum_i e^(m_i - m) l_i.
  // It then resets the counter to 0 for the next launch.
  int* counter = counters + (int64_t)b * Hkv + h;
  __threadfence();                     // this split's partial, device-wide
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counter, 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int n_used = min(n_split, pos / rows_per_split + 1);
  for (int gi = tid; gi < G * n_used; gi += kSplitThreads) {
    const int g = gi / n_used, i = gi - g * n_used;
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(
        part_ml + ((head0 + g) * n_split + i) * 2));
    wm_s[g * n_used + i] = ml.x;
    wl_s[g * n_used + i] = ml.y;
  }
  __syncthreads();
  for (int g = tid; g < G; g += kSplitThreads) {
    float m = NEG_INF;
    for (int i = 0; i < n_used; ++i) m = fmaxf(m, wm_s[g * n_used + i]);
    float l = 0.f;
    for (int i = 0; i < n_used; ++i) {
      const float w = expf(wm_s[g * n_used + i] - m);
      l = fmaf(w, wl_s[g * n_used + i], l);
      wm_s[g * n_used + i] = w;
    }
    inv_s[g] = l == 0.f ? 1.f : 1.f / l;
  }
  __syncthreads();
  for (int it = tid; it < G * (D / 4); it += kSplitThreads) {
    const int g = it / (D / 4), d0 = (it - g * (D / 4)) * 4;
    const float* pa = part_acc + (head0 + g) * n_split * D + d0;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int i = 0; i < n_used; ++i) {
      const float w = wm_s[g * n_used + i];
      const float4 x = __ldcg(reinterpret_cast<const float4*>(pa + (int64_t)i * D));
      a.x = fmaf(w, x.x, a.x);
      a.y = fmaf(w, x.y, a.y);
      a.z = fmaf(w, x.z, a.z);
      a.w = fmaf(w, x.w, a.w);
    }
    const float inv = inv_s[g];
    QT* o = out + (head0 + g) * D + d0;
    o[0] = from_f32<QT>(a.x * inv);
    o[1] = from_f32<QT>(a.y * inv);
    o[2] = from_f32<QT>(a.z * inv);
    o[3] = from_f32<QT>(a.w * inv);
  }
  if (tid == 0) *counter = 0;
}

// -- K4, bf16 q: causal prefill on tensor cores -------------------------------

constexpr int kPfThreads = 128;   // 4 warps x 16 query rows = BQ

template <typename CT, int D>
struct PrefillSmem {
  static constexpr bool F32C = std::is_same<CT, float>::value;
  static constexpr int LD = D + 8;             // bf16 row, padded by 16 bytes
  static constexpr int TILE = KT * LD;         // one bf16 K or V tile
  // bf16 cache: [stage][K|V] tiles; f32 cache: [K|V][hi|mid|lo] tiles
  static constexpr int TILES = F32C ? 6 : 4;
  // q tile, the bf16 tiles and, for an f32 cache, one raw f32 [K|V] stage
  static constexpr size_t BYTES =
      sizeof(bf16) * (BQ * LD + TILES * TILE) + (F32C ? sizeof(float) * 2 * KT * D : 0);
};

template <typename CT, int D>
__global__ void __launch_bounds__(kPfThreads)
flash_prefill_kernel(const bf16* __restrict__ q, const CT* __restrict__ kc,
                     const CT* __restrict__ vc, bf16* __restrict__ out, int T, int H,
                     int Hkv, int S, int offset, float sm_scale) {
  using SM = PrefillSmem<CT, D>;
  constexpr bool F32C = SM::F32C;
  constexpr int LD = SM::LD, TILE = SM::TILE;
  constexpr int NK = D / 16;   // k-steps of S = Q K^T
  constexpr int ND = D / 8;    // n-tiles of O
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* t_s = q_s + BQ * LD;                                // SM::TILES tiles
  float* raw_s = reinterpret_cast<float*>(t_s + SM::TILES * TILE);   // f32 cache: K, V

  const int t0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // deepest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, tig = lane & 3;   // mma fragment row / column pair
  const int q_last = offset + min(t0 + BQ, T) - 1;   // deepest query position
  const int kv_end = min(S, q_last + 1);             // rows past it are never read
  const int n_tiles = (kv_end + KT - 1) / KT;
  const int wt0 = t0 + warp * 16;                    // this warp's first query
  const bool warp_live = wt0 < T;
  const int warp_last = offset + min(wt0 + 15, T - 1);   // its deepest query position

  // q tile (zero rows past T)
  for (int c = tid; c < BQ * (D / 8); c += kPfThreads) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    const bool ok = t0 + r < T;
    const int t = ok ? t0 + r : 0;
    cp_async16(q_s + r * LD + col, q + (((int64_t)b * T + t) * H + h) * D + col, ok);
  }
  const int64_t row0 = (int64_t)b * S;
  // bf16 cache: tile j into stage j & 1; f32: into the raw stage
  auto load_tile = [&](int j) {
    const int s0 = j * KT;
    constexpr int EPC = 16 / sizeof(CT);
    constexpr int CPR = D / EPC;
    for (int c = tid; c < KT * CPR; c += kPfThreads) {
      const int r = c / CPR, col = (c % CPR) * EPC;
      const bool ok = s0 + r < kv_end;
      const int64_t off = ((row0 + (ok ? s0 + r : 0)) * Hkv + hk) * D + col;
      if constexpr (F32C) {
        cp_async16(raw_s + r * D + col, kc + off, ok);
        cp_async16(raw_s + KT * D + r * D + col, vc + off, ok);
      } else {
        bf16* ks = t_s + (j & 1) * 2 * TILE;
        cp_async16(ks + r * LD + col, kc + off, ok);
        cp_async16(ks + TILE + r * LD + col, vc + off, ok);
      }
    }
  };
  // f32 cache: the raw stage -> hi / mid / lo bf16 tiles
  auto split_tile = [&]() {
    for (int c = tid; c < 2 * KT * (D / 4); c += kPfThreads) {
      const int kv = c / (KT * (D / 4));
      const int rc = c - kv * KT * (D / 4);
      const int r = rc / (D / 4), col = (rc % (D / 4)) * 4;
      const float4 x = *reinterpret_cast<const float4*>(raw_s + kv * KT * D + r * D + col);
      bf16* hi = t_s + kv * 3 * TILE + r * LD + col;
      uint2 h, m, l;
      split3_bf16(x.x, x.y, h.x, m.x, l.x);
      split3_bf16(x.z, x.w, h.y, m.y, l.y);
      *reinterpret_cast<uint2*>(hi) = h;
      *reinterpret_cast<uint2*>(hi + TILE) = m;
      *reinterpret_cast<uint2*>(hi + 2 * TILE) = l;
    }
  };

  load_tile(0);
  cp_async_commit();

  uint32_t qa[NK][4];
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;   // rows g8 and g8 + 8 of this warp
  float l0 = 0.f, l1 = 0.f;           // this thread's part of their sums

  for (int j = 0; j < n_tiles; ++j) {
    const bf16 *kh, *vh;
    if constexpr (F32C) {
      cp_async_wait<0>();
      __syncthreads();
      split_tile();
      __syncthreads();
      if (j + 1 < n_tiles) load_tile(j + 1);
      cp_async_commit();
      kh = t_s;
      vh = t_s + 3 * TILE;
    } else {
      if (j + 1 < n_tiles) load_tile(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      kh = t_s + (j & 1) * 2 * TILE;
      vh = kh + TILE;
    }
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        ldsm_x4(qa[kk], q_s + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
    }
    const int s0 = j * KT;
    if (warp_live && s0 <= warp_last) {
      // S = Q K^T over the tile's 64 keys: 8 n-tiles of 8 keys
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int krow = np * 16 + (lane >> 4) * 8 + (lane & 7);
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          const int kcol = kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t r[4];
          ldsm_x4(r, kh + krow * LD + kcol);
          mma_bf16(s[2 * np], qa[kk], r[0], r[1]);
          mma_bf16(s[2 * np + 1], qa[kk], r[2], r[3]);
          if constexpr (F32C) {
#pragma unroll
            for (int part = 1; part < 3; ++part) {   // K mid, K lo
              ldsm_x4(r, kh + part * TILE + krow * LD + kcol);
              mma_bf16(s[2 * np], qa[kk], r[0], r[1]);
              mma_bf16(s[2 * np + 1], qa[kk], r[2], r[3]);
            }
          }
        }
      }
      // scale; mask the diagonal tile and rows past kv_end
      const bool masked = s0 + KT - 1 > offset + wt0 || s0 + KT > kv_end;
      const int ta = offset + wt0 + g8;   // row g8's position; g8 + 8 is ta + 8
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = s[n][e] * sm_scale;
          if (masked) {
            const int key = s0 + n * 8 + 2 * tig + (e & 1);
            if (key >= kv_end || key > ta + (e >> 1) * 8) v = NEG_INF;
          }
          s[n][e] = v;
        }
      }
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = exp2f((m0 - mn0) * kLog2e), al1 = exp2f((m1 - mn1) * kLog2e);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mn = e < 2 ? mn0 : mn1;
          const float p = s[n][e] == NEG_INF ? 0.f : exp2f((s[n][e] - mn) * kLog2e);
          s[n][e] = p;
          if (e < 2) sum0 += p; else sum1 += p;
        }
      }
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= al0;
        o[n][1] *= al0;
        o[n][2] *= al1;
        o[n][3] *= al1;
      }
      // O += P V: 4 k-steps of 16 keys; P from the S fragments
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // the A operand: p packed to bf16 (ROUND_P's rounding with a bf16
        // cache); with an f32 cache also its mid and lo parts
        uint32_t pa[4], pm[4], pl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = s[2 * kk + (i >> 1)][2 * (i & 1)];
          const float b = s[2 * kk + (i >> 1)][2 * (i & 1) + 1];
          if constexpr (F32C)
            split3_bf16(a, b, pa[i], pm[i], pl[i]);
          else
            pa[i] = pack_bf16(a, b);
        }
        const int vrow = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          const int vcol = dp * 16 + (lane >> 4) * 8;
          uint32_t r[4];
          ldsm_x4_t(r, vh + vrow * LD + vcol);
          mma_bf16(o[2 * dp], pa, r[0], r[1]);
          mma_bf16(o[2 * dp + 1], pa, r[2], r[3]);
          if constexpr (F32C) {
            // every product down to 2^-16 of the leading one:
            // Ph Vh (above) + Pm Vh + Pl Vh + Ph Vm + Pm Vm + Ph Vl
            mma_bf16(o[2 * dp], pm, r[0], r[1]);
            mma_bf16(o[2 * dp + 1], pm, r[2], r[3]);
            mma_bf16(o[2 * dp], pl, r[0], r[1]);
            mma_bf16(o[2 * dp + 1], pl, r[2], r[3]);
            ldsm_x4_t(r, vh + TILE + vrow * LD + vcol);   // V mid
            mma_bf16(o[2 * dp], pa, r[0], r[1]);
            mma_bf16(o[2 * dp + 1], pa, r[2], r[3]);
            mma_bf16(o[2 * dp], pm, r[0], r[1]);
            mma_bf16(o[2 * dp + 1], pm, r[2], r[3]);
            ldsm_x4_t(r, vh + 2 * TILE + vrow * LD + vcol);   // V lo
            mma_bf16(o[2 * dp], pa, r[0], r[1]);
            mma_bf16(o[2 * dp + 1], pa, r[2], r[3]);
          }
        }
      }
    }
    __syncthreads();   // the tiles are overwritten next
  }

  if (!warp_live) return;
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 1.f : 1.f / l1;
  const int ta = wt0 + g8;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = n * 8 + 2 * tig;
    if (ta < T)
      *reinterpret_cast<uint32_t*>(out + (((int64_t)b * T + ta) * H + h) * D + d) =
          pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (ta + 8 < T)
      *reinterpret_cast<uint32_t*>(out + (((int64_t)b * T + ta + 8) * H + h) * D + d) =
          pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}

// -- K4, f32 q: causal prefill on CUDA cores ----------------------------------

size_t prefill_simt_smem(int D) {
  return sizeof(float) * (3 * BQ * (D + 1) + BQ * (KT + 1) + 3 * BQ);
}

template <typename CT>
__global__ void __launch_bounds__(kThreads)
flash_prefill_simt_kernel(const float* __restrict__ q, const CT* __restrict__ kc,
                          const CT* __restrict__ vc, float* __restrict__ out, int T, int H,
                          int Hkv, int D, int S, int offset, float sm_scale) {
  extern __shared__ float smem[];
  const int t0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int DP = D + 1, SP = KT + 1;
  float* q_s = smem;                   // BQ x DP
  float* k_s = q_s + BQ * DP;          // KT x DP
  float* v_s = k_s + KT * DP;          // KT x DP
  float* s_s = v_s + KT * DP;          // BQ x SP
  float* m_s = s_s + BQ * SP;          // BQ
  float* l_s = m_s + BQ;               // BQ
  float* alpha_s = l_s + BQ;           // BQ
  // the f32 accumulator: BQ x D in registers, element i = tid + j * kThreads
  constexpr int kAcc = BQ * 128 / kThreads;
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int t = i / D, d = i - t * D;
    q_s[t * DP + d] = t0 + t < T ? q[(((int64_t)b * T + t0 + t) * H + h) * D + d] : 0.f;
  }
  for (int t = tid; t < BQ; t += kThreads) {
    m_s[t] = NEG_INF;
    l_s[t] = 0.f;
  }
  __syncthreads();

  const int q_last = offset + min(t0 + BQ, T) - 1;   // deepest query position
  const int kv_end = min(S, q_last + 1);             // tiles above it are skipped
  for (int s0 = 0; s0 < kv_end; s0 += KT) {
    const int nk = min(KT, kv_end - s0);
    for (int i = tid; i < KT * D; i += kThreads) {
      const int s = i / D, d = i - s * D;
      float kv = 0.f, vv = 0.f;
      if (s < nk) {
        const int64_t off = (((int64_t)b * S + s0 + s) * Hkv + hk) * D + d;
        kv = to_f32(kc[off]);
        vv = to_f32(vc[off]);
      }
      k_s[s * DP + d] = kv;
      v_s[s * DP + d] = vv;
    }
    __syncthreads();
    for (int i = tid; i < BQ * KT; i += kThreads) {
      const int t = i / KT, s = i - t * KT;
      float sc = NEG_INF;
      if (s < nk && s0 + s <= offset + t0 + t) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(q_s[t * DP + d], k_s[s * DP + d], dot);
        sc = dot * sm_scale;
      }
      s_s[t * SP + s] = sc;
    }
    __syncthreads();
    for (int t = warp; t < BQ; t += kWarps) {
      float mx = NEG_INF;
      for (int s = lane; s < KT; s += 32) mx = fmaxf(mx, s_s[t * SP + s]);
      mx = warp_max(mx);
      const float m_prev = m_s[t];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int s = lane; s < KT; s += 32) {
        const float p = expf(s_s[t * SP + s] - m_new);
        sum += p;
        s_s[t * SP + s] = p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        m_s[t] = m_new;
        l_s[t] = alpha * l_s[t] + sum;
        alpha_s[t] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int i = tid + j * kThreads;
      if (i < BQ * D) {
        const int t = i / D, d = i - t * D;
        float a = 0.f;
        for (int s = 0; s < nk; ++s) a = fmaf(s_s[t * SP + s], v_s[s * DP + d], a);
        acc[j] = acc[j] * alpha_s[t] + a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int i = tid + j * kThreads;
    if (i < BQ * D) {
      const int t = i / D, d = i - t * D;
      if (t0 + t < T) {
        const float l = l_s[t];
        const float inv = l == 0.f ? 1.f : 1.f / l;
        out[(((int64_t)b * T + t0 + t) * H + h) * D + d] = acc[j] * inv;
      }
    }
  }
}

// -- launches -----------------------------------------------------------------

template <typename QT, typename CT, bool ROUND_P, bool SPLIT, bool APPEND>
void launch_split_main(const void* q, void* kc, void* vc, const void* k_cur,
                       const void* v_cur, const int* pos, void* out, float* part_acc,
                       float* part_ml, int* counters, int B, int H, int Hkv, int D, int S,
                       int rows_per_split, int n_split, float sm_scale, cudaStream_t st) {
  auto kernel = flash_decode_split_kernel<QT, CT, ROUND_P, SPLIT, APPEND>;
  const size_t smem = split_smem<CT>(H / Hkv, D, n_split);
  allow_smem(kernel, smem);
  kernel<<<dim3(Hkv, B, n_split), kSplitThreads, smem, st>>>(
      static_cast<const QT*>(q), static_cast<CT*>(kc), static_cast<CT*>(vc),
      static_cast<const CT*>(k_cur), static_cast<const CT*>(v_cur), pos,
      static_cast<QT*>(out), part_acc, part_ml, counters, H, Hkv, D, S, rows_per_split,
      sm_scale);
}

template <typename QT, typename CT, bool ROUND_P>
void launch_split(const void* q, void* kc, void* vc, const void* k_cur, const void* v_cur,
                  const int* pos, void* out, float* part_acc, float* part_ml, int* counters,
                  int B, int H, int Hkv, int D, int S, int rows_per_split, int n_split,
                  float sm_scale, cudaStream_t st) {
#define TLT_SPLIT(SP, AP)                                                                  \
  launch_split_main<QT, CT, ROUND_P, SP, AP>(q, kc, vc, k_cur, v_cur, pos, out, part_acc, \
                                             part_ml, counters, B, H, Hkv, D, S,          \
                                             rows_per_split, n_split, sm_scale, st)
  const bool append = k_cur != nullptr;
  if (n_split == 1 && append) TLT_SPLIT(false, true);
  else if (n_split == 1) TLT_SPLIT(false, false);
  else if (append) TLT_SPLIT(true, true);
  else TLT_SPLIT(true, false);
#undef TLT_SPLIT
}

template <typename CT, int D>
void launch_prefill_tc(const void* q, const void* kc, const void* vc, void* out, int B, int T,
                       int H, int Hkv, int S, int offset, float sm_scale, cudaStream_t st) {
  auto kernel = flash_prefill_kernel<CT, D>;
  const size_t smem = PrefillSmem<CT, D>::BYTES;
  allow_smem(kernel, smem);
  kernel<<<dim3((T + BQ - 1) / BQ, H, B), kPfThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const CT*>(kc), static_cast<const CT*>(vc),
      static_cast<bf16*>(out), T, H, Hkv, S, offset, sm_scale);
}

template <typename CT>
void prefill_tc_dispatch(const void* q, const void* kc, const void* vc, void* out, int B,
                         int T, int H, int Hkv, int D, int S, int offset, float sm_scale,
                         cudaStream_t st) {
#define TLT_PF(DD) \
  case DD:         \
    launch_prefill_tc<CT, DD>(q, kc, vc, out, B, T, H, Hkv, S, offset, sm_scale, st); break
  switch (D) {
    TLT_PF(16); TLT_PF(32); TLT_PF(48); TLT_PF(64);
    TLT_PF(80); TLT_PF(96); TLT_PF(112); TLT_PF(128);
    default: break;   // the wrapper admits only these
  }
#undef TLT_PF
}

template <typename CT>
void launch_prefill_simt(const void* q, const void* kc, const void* vc, void* out, int B,
                         int T, int H, int Hkv, int D, int S, int offset, float sm_scale,
                         cudaStream_t st) {
  auto kernel = flash_prefill_simt_kernel<CT>;
  const size_t smem = prefill_simt_smem(D);
  allow_smem(kernel, smem);
  kernel<<<dim3((T + BQ - 1) / BQ, H, B), kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const CT*>(kc), static_cast<const CT*>(vc),
      static_cast<float*>(out), T, H, Hkv, D, S, offset, sm_scale);
}

}  // namespace

// K2 (k_cur == v_cur == nullptr) or K3 (both given, (B, Hkv*D) in the
// cache dtype). q (B, 1, H, D); caches (B, S, Hkv*D); pos (B,) int32 on
// the device; out (B, 1, H, D) in q's dtype. The rows split into n_split
// runs of rows_per_split; with n_split > 1 the launch takes part_acc
// (B*H, n_split, D) and part_ml (B*H, n_split, 2) f32 scratch and
// counters, B*Hkv int32 that are 0 on entry and 0 again on exit. K3
// attends k_cur/v_cur as key pos and stores them at row pos.
TLT_API int tlt_flash_decode(const void* q, int q_bf16, void* kc, void* vc, int cache_bf16,
                             const void* k_cur, const void* v_cur, const void* pos,
                             void* out, void* part_acc, void* part_ml, void* counters, int B,
                             int H, int Hkv, int D, int S, int rows_per_split, int n_split,
                             float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  int* cn = static_cast<int*>(counters);
#define TLT_DEC(QT, CT, RP)                                                              \
  launch_split<QT, CT, RP>(q, kc, vc, k_cur, v_cur, p, out, pa, pm, cn, B, H, Hkv, D, S, \
                           rows_per_split, n_split, sm_scale, st)
  if (q_bf16 && cache_bf16)
    TLT_DEC(bf16, bf16, true);
  else if (q_bf16)
    TLT_DEC(bf16, float, false);
  else if (cache_bf16)
    TLT_DEC(float, bf16, false);
  else
    TLT_DEC(float, float, false);
#undef TLT_DEC
  return (int)cudaGetLastError();
}

// K4: q (B, T, H, D); caches (B, S, Hkv, D); out (B, T, H, D) in q's dtype.
// bf16 q: tensor cores (D a multiple of 16 up to 128); f32 q: CUDA cores.
TLT_API int tlt_flash_prefill(const void* q, int q_bf16, const void* kc, const void* vc,
                              int cache_bf16, void* out, int B, int T, int H, int Hkv,
                              int D, int S, int offset, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16 && cache_bf16)
    prefill_tc_dispatch<bf16>(q, kc, vc, out, B, T, H, Hkv, D, S, offset, sm_scale, st);
  else if (q_bf16)
    prefill_tc_dispatch<float>(q, kc, vc, out, B, T, H, Hkv, D, S, offset, sm_scale, st);
  else if (cache_bf16)
    launch_prefill_simt<bf16>(q, kc, vc, out, B, T, H, Hkv, D, S, offset, sm_scale, st);
  else
    launch_prefill_simt<float>(q, kc, vc, out, B, T, H, Hkv, D, S, offset, sm_scale, st);
  return (int)cudaGetLastError();
}
