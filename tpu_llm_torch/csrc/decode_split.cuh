// The split decode body of the port's one-query attention kernels on
// Hopper: K2 (flash_decode_attention) and K3 (flash_decode_fused) over flat
// caches, launched from flash_attention.cu; K5 (paged_flash_decode_attention)
// and K6 (paged_flash_decode_q) over paged pools, from paged_attention.cu.
// Each is an instantiation of flash_decode_split_kernel below.
//
// The body takes two policies. The row source (Rows) says where logical
// row s of batch row b lies: FlatRows, row b * S + s of a (B, S, Hkv*D)
// cache; PagedRows, row table[b, s / BS] * BS + s % BS of an (N, BS, Hkv*D)
// pool, resolved through the int32 block table by the thread that starts
// the row's copy. The value type (CT) is f32, bf16, or int8 with per-row scales
// (K6: the scale of (block blk, kv head h, offset o) at (blk * HP + h) * SP
// + o of a 2-D f32 scale pool), each row's k and v scale copied beside the
// row into a per-stage shared array.
//
// What it computes: scores q . k in f32 times sm_scale (int8: q rounded to
// bf16 and the score also times the row's k scale); online softmax in f32
// with NEG_INF = -0.7 * f32max for masked scores; l sums the unrounded
// softmax weights p; the AV weight is p (int8: p times the row's v scale),
// rounded to bf16 when ROUND_P (K2/K3: q and cache both bf16; K5: q bf16;
// K6: always); a row with l == 0 stores 0; output in q's dtype.
//
// What bounds it on the H100: the cache or pool bytes of rows <= pos,
// 2 * (pos + 1) * Hkv * D * itemsize a batch row (paged: plus the table
// entries; int8: plus 8 bytes of scales a row and kv head), over 3.35 TB/s;
// 4 flops a cache element.
//
// Design: split over the sequence (flash-decoding). The grid is (kv head,
// batch row, split); the wrapper picks the split count from shapes alone
// (decode_splits in ops/flash_attention.py, about two CTAs an SM), never
// from the positions, so a CUDA graph captures it with the positions (and
// the block table) in device tensors. A CTA of 128 threads holds all G =
// H / Hkv query heads of its kv head (q as f32 in shared memory, read as
// warp-wide broadcasts: G and D are runtime values), so each row is read
// from device memory once and used G times. Rows come in 64-row tiles,
// 16-byte cp.async copies into two shared stages (rows padded by 16 bytes:
// conflict-free 16-byte reads), the next tile's copies in flight while
// this one is computed; the math is f32 on CUDA cores. A paged tile's rows
// may cross several blocks (BS is 4-64): each copy resolves its own row
// through the table. A row past the split's last visible row copies
// nothing (zero-filled) from the split's first row, so no table entry past
// pos / BS is ever read. A split stores its unnormalised partial (acc, m,
// l); one whose rows all lie past pos reads and stores nothing. The merge
// is in the same launch: each split counts itself done on an int32 counter
// of its (b, kv head) (atomicAdd after a __threadfence), and the last one
// merges the partials of the splits that hold rows, in split order, so the
// result does not depend on which split finishes last; it resets the
// counter to 0, so the counters (kept by the wrapper, zero-filled once)
// are 0 again for the next launch or graph replay. One launch a call. With
// one split the kernel writes the output itself.
//
// K3 (APPEND, flat rows only): the split that holds pos copies key pos
// from k_cur / v_cur (in the cache dtype) into its tile in place of the
// stale row, and stores them at row pos; every other split ends before pos
// or lies past it and exits, so no CTA reads the row being written.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace tlt {

constexpr int kSplitThreads = 128;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSplitKeys = 64;               // keys per tile
constexpr int kSplitPKT = kSplitKeys + 4;    // p_s row: heads g and g + 1 on other banks

// row s of batch row b of a flat (B, S, Hkv*D) cache
struct FlatRows {
  static constexpr bool kPaged = false;
  int S;
  __device__ __forceinline__ int n_rows() const { return S; }
  __device__ __forceinline__ int64_t row(int b, int s, int, int64_t& scale) const {
    scale = 0;
    return (int64_t)b * S + s;
  }
};

// row s of batch row b of an (N, BS, Hkv*D) pool through the (B, MB) int32
// block table; for int8 pools also the index of its scale for kv head h in
// the (N * HP, SP) scale pools
struct PagedRows {
  static constexpr bool kPaged = true;
  const int* table;
  int BS, MB;
  const float* k_scale;
  const float* v_scale;
  int HP, SP;
  __device__ __forceinline__ int n_rows() const { return MB * BS; }
  __device__ __forceinline__ int64_t row(int b, int s, int h, int64_t& scale) const {
    const int j = s / BS, o = s - j * BS;
    const int64_t blk = __ldg(table + (int64_t)b * MB + j);
    scale = (blk * HP + h) * SP + o;
    return blk * BS + o;
  }
};

// elements of one row a score step reads: 16 bytes of bf16 or int8 (an
// int8 row is padded by 16 bytes, so 8-byte reads would meet in banks)
template <typename CT> struct ScoreChunk { static constexpr int N = 8; };
template <> struct ScoreChunk<int8_t> { static constexpr int N = 16; };

__device__ __forceinline__ float int8_at(uint32_t w, int k) {
  return (float)(int8_t)(w >> (8 * k));
}

// N consecutive cache elements as f32
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h2 = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    x[2 * i] = __low2float(h2);
    x[2 * i + 1] = __high2float(h2);
  }
}

__device__ __forceinline__ void load_n(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

__device__ __forceinline__ void load_n(const int8_t* p, float (&x)[16]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) x[4 * i + k] = int8_at(w[i], k);
}

__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  x[0] = __low2float(a), x[1] = __high2float(a), x[2] = __low2float(b), x[3] = __high2float(b);
}

__device__ __forceinline__ void load_n(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
}

__device__ __forceinline__ void load_n(const int8_t* p, float (&x)[4]) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) x[k] = int8_at(w, k);
}

// padded cache row in shared memory, in elements: 16 bytes past the row,
// so 16-byte reads of one column by consecutive rows hit distinct banks
template <typename CT>
__host__ __device__ constexpr int split_row(int D) {
  return D + 16 / (int)sizeof(CT);
}

template <typename CT>
size_t split_smem(int G, int D, int n_split) {
  constexpr bool QUANT = std::is_same<CT, int8_t>::value;
  return sizeof(CT) * 4 * kSplitKeys * split_row<CT>(D) +
         sizeof(float) * ((QUANT ? 4 * kSplitKeys : 0) + 2 * G * D + G * kSplitPKT + 3 * G +
                          2 * G * n_split + G);
}

template <typename Rows, typename QT, typename CT, bool ROUND_P, bool SPLIT, bool APPEND>
__global__ void __launch_bounds__(kSplitThreads)
flash_decode_split_kernel(const QT* __restrict__ q, CT* __restrict__ kc,
                          CT* __restrict__ vc, const CT* __restrict__ k_cur,
                          const CT* __restrict__ v_cur, const int* __restrict__ pos_arr,
                          const Rows rows, QT* __restrict__ out, float* __restrict__ part_acc,
                          float* __restrict__ part_ml, int* __restrict__ counters, int H,
                          int Hkv, int D, int rows_per_split, float sm_scale) {
  constexpr bool QUANT = std::is_same<CT, int8_t>::value;
  static_assert(!(APPEND && Rows::kPaged), "the append (K3) is over flat caches");
  constexpr int KT = kSplitKeys, PKT = kSplitPKT;
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
  float* sc_s = reinterpret_cast<float*>(kv_s + 4 * KT * RW);   // int8: [stage][K|V][KT]
  float* q_s = sc_s + (QUANT ? 4 * KT : 0);          // G x D
  float* p_s = q_s + G * D;            // G x PKT
  float* acc_s = p_s + G * PKT;        // G x D
  float* m_s = acc_s + G * D;          // G
  float* l_s = m_s + G;                // G
  float* alpha_s = l_s + G;            // G
  float* wm_s = alpha_s + G;           // merge: G x n_split maxima, then weights
  float* wl_s = wm_s + G * n_split;    // G x n_split sums
  float* inv_s = wl_s + G * n_split;   // G

  const int pos = min(pos_arr[b], rows.n_rows() - 1);
  const int s_begin = split * rows_per_split;
  const int s_end = min(pos + 1, s_begin + rows_per_split);   // exclusive
  const int n_tiles = s_end > s_begin ? (s_end - s_begin + KT - 1) / KT : 0;
  const int64_t head0 = (int64_t)b * H + (int64_t)h * G;       // first query head

  if (n_tiles > 0) {   // a split past pos reads and stores nothing
    CT* kh = kc + (int64_t)h * D;      // kv head h of row 0
    CT* vh = vc + (int64_t)h * D;
    constexpr int EPC = 16 / sizeof(CT);     // elements a 16-byte chunk
    const int cpr = D / EPC;                 // chunks a row
    // K3: key pos is this step's k_cur / v_cur (never the stale row), and
    // the split that holds pos (the only one whose rows reach it) stores
    // it at row pos of its kv head; no split reads row pos of the cache
    const CT* kcur = APPEND ? k_cur + (int64_t)b * HkvD + (int64_t)h * D : nullptr;
    const CT* vcur = APPEND ? v_cur + (int64_t)b * HkvD + (int64_t)h * D : nullptr;
    if (APPEND && pos < s_end) {
      int64_t unused;
      const int64_t at = rows.row(b, pos, h, unused) * HkvD;
      for (int c = tid; c < cpr; c += kSplitThreads) {
        const int64_t off = at + c * EPC;
        *reinterpret_cast<uint4*>(kh + off) = *reinterpret_cast<const uint4*>(kcur + c * EPC);
        *reinterpret_cast<uint4*>(vh + off) = *reinterpret_cast<const uint4*>(vcur + c * EPC);
      }
    }
    auto load_tile = [&](int j) {
      const int s0 = s_begin + j * KT;
      CT* ks = kv_s + (j & 1) * 2 * KT * RW;
      CT* vs = ks + KT * RW;
      float* sc = sc_s + (j & 1) * 2 * KT;
      for (int c = tid; c < KT * cpr; c += kSplitThreads) {
        const int r = c / cpr, ch = c - r * cpr, col = ch * EPC;
        const bool ok = s0 + r < s_end;
        // a row past s_end copies nothing, from row s_begin (<= pos)
        int64_t si;
        const int64_t off = rows.row(b, ok ? s0 + r : s_begin, h, si) * HkvD + col;
        const bool cur = APPEND && s0 + r == pos;
        cp_async16(ks + r * RW + col, cur ? kcur + col : kh + off, ok);
        cp_async16(vs + r * RW + col, cur ? vcur + col : vh + off, ok);
        if constexpr (QUANT) {
          if (ch == 0) {
            cp_async4(sc + r, rows.k_scale + si, ok);
            cp_async4(sc + KT + r, rows.v_scale + si, ok);
          }
        }
      }
    };
    load_tile(0);
    cp_async_commit();
    // q and the softmax state while the first tile is in flight
    const QT* qb = q + head0 * D;
    for (int i = tid; i < G * D; i += kSplitThreads) {
      const float qv = to_f32(qb[i]);
      q_s[i] = QUANT ? round_bf16(qv) : qv;
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
      const float* ksc = sc_s + (j & 1) * 2 * KT;   // int8: the rows' k, v scales
      const float* vsc = ksc + KT;

      // scores: thread -> key s, heads hg, hg + 2, ... (a warp shares hg,
      // so its q reads are broadcasts); rows past nk are zeros in shared memory
      {
        const int s = tid & (KT - 1), hg = tid / KT;
        constexpr int GC = 4;
        constexpr int CN = ScoreChunk<CT>::N;
        float row_scale = sm_scale;
        if constexpr (QUANT) row_scale = ksc[s];
        for (int g0 = hg; g0 < G; g0 += 2 * GC) {
          float dot[GC] = {0.f, 0.f, 0.f, 0.f};
          for (int c = 0; c < D; c += CN) {
            float kx[CN];
            load_n(ks + s * RW + c, kx);
#pragma unroll
            for (int u = 0; u < GC; ++u) {
              const int g = g0 + 2 * u;
              if (g < G) {
                float d = dot[u];
#pragma unroll
                for (int e = 0; e < CN; e += 4) {
                  const float4 qa = *reinterpret_cast<const float4*>(q_s + g * D + c + e);
                  d = fmaf(qa.x, kx[e], d);
                  d = fmaf(qa.y, kx[e + 1], d);
                  d = fmaf(qa.z, kx[e + 2], d);
                  d = fmaf(qa.w, kx[e + 3], d);
                }
                dot[u] = d;
              }
            }
          }
#pragma unroll
          for (int u = 0; u < GC; ++u) {
            const int g = g0 + 2 * u;
            if (g < G) {
              // int8: (q . k) * sm_scale * ks
              const float sc = QUANT ? dot[u] * sm_scale * row_scale : dot[u] * sm_scale;
              p_s[g * PKT + s] = s < nk ? sc : NEG_INF;
            }
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
          float w = p;
          if constexpr (QUANT) w = p * vsc[s];   // the AV weight p * vs (0 past nk)
          p_s[g * PKT + s] = ROUND_P ? round_bf16(w) : w;
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
            load_n(vs + (s + u) * RW + d0, vx);
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

// One launch of the body. q (B, 1, H, D); out like q; pos (B,) int32 on the
// device; k_cur / v_cur (B, Hkv*D) or null. With n_split > 1: part_acc
// (B*H, n_split, D) and part_ml (B*H, n_split, 2) f32 scratch and counters,
// B*Hkv int32 that are 0 on entry and 0 again on exit.
struct SplitLaunch {
  const void* q;
  void* kc;
  void* vc;
  const void* k_cur;
  const void* v_cur;
  const int* pos;
  void* out;
  float* part_acc;
  float* part_ml;
  int* counters;
  int B, H, Hkv, D, rows_per_split, n_split;
  float sm_scale;
  cudaStream_t stream;
};

template <typename Rows, typename QT, typename CT, bool ROUND_P, bool SPLIT, bool APPEND>
void launch_split_grid(const SplitLaunch& a, const Rows& rows) {
  auto kernel = flash_decode_split_kernel<Rows, QT, CT, ROUND_P, SPLIT, APPEND>;
  const size_t smem = split_smem<CT>(a.H / a.Hkv, a.D, a.n_split);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kernel<<<dim3(a.Hkv, a.B, a.n_split), kSplitThreads, smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<CT*>(a.kc), static_cast<CT*>(a.vc),
      static_cast<const CT*>(a.k_cur), static_cast<const CT*>(a.v_cur), a.pos, rows,
      static_cast<QT*>(a.out), a.part_acc, a.part_ml, a.counters, a.H, a.Hkv, a.D,
      a.rows_per_split, a.sm_scale);
}

template <typename Rows, typename QT, typename CT, bool ROUND_P, bool APPEND = false>
void launch_decode_split(const SplitLaunch& a, const Rows& rows) {
  if (a.n_split == 1)
    launch_split_grid<Rows, QT, CT, ROUND_P, false, APPEND>(a, rows);
  else
    launch_split_grid<Rows, QT, CT, ROUND_P, true, APPEND>(a, rows);
}

}  // namespace tlt
