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
// K2 and K3 are instantiations of the split decode body that K5 and K6
// share (flash_decode_split_kernel, decode_split.cuh: its design and its
// bound), with the flat row source: row s of batch row b at row b * S + s.
// K2 rounds p to bf16 when q and the cache are both bf16; K3 runs the body
// with APPEND set: the split that holds pos takes key pos from k_cur /
// v_cur and stores it at row pos. What bounds K3 is what bounds K2: the
// cache bytes of rows < pos plus the one row it stores, over 3.35 TB/s.
//
// K4, flash_prefill_kernel<QT, CT, D>: tensor cores for every (q, cache)
// dtype pair. One CTA of 4 warps per (64-query tile, query head, b); each
// warp owns 16 query rows, its Q fragments in registers for the whole CTA.
// GQA: one CTA per query head,
// not one per kv head: the G CTAs of a kv head read the same K/V tiles,
// which L2 serves (a kv head's K and V of 1024 rows are 256 KB), and the
// grid stays H * T / 64 CTAs with 16 query rows a warp. K and V come in
// 64-key tiles through shared memory with rows padded by 16 bytes, so
// the ldmatrix fragment loads are free of bank conflicts. S = Q K^T and
// O += P V are mma.sync m16n8k16 bf16 products with f32 accumulators; the
// online softmax runs on the accumulator fragments in registers (row max
// and row sum over the quad of threads that share a row, by shuffles).
// P is packed to bf16 as the A operand of the PV product: with bf16 q and
// cache that is ROUND_P's rounding. A bf16 cache is copied with cp.async
// into two stages (the next tile's copy overlaps this tile's math). An f32
// cache is never rounded to bf16: its tile is copied raw (cp.async, one
// f32 stage, the next copy overlapping this tile's math) and split, on
// its way to the bf16 tiles, into x = hi + mid + lo, three bf16 parts that
// hold all 24 bits. f32 q is split the same way, once a CTA, straight
// from device memory into its A fragments: hi stays in registers, mid and
// lo go to a shared slot each thread owns (16 bytes a fragment, lanes
// adjacent: conflict-free, read back by the same thread, no barrier), so
// the registers a warp holds for Q do not triple. With parts i of one
// operand and j of the other, each product keeps i + j <= 2: every product
// down to 2^-16 of the leading one (S over an f32 cache with f32 q: qh kh,
// qm kh, ql kh, qh km, qm km, qh kl; with bf16 q: q kh, q km, q kl; over a
// bf16 cache with f32 q: qh k, qm k, ql k). P is unrounded unless q and
// cache are both bf16 and is then split too (O over an f32 cache: Ph Vh,
// Pm Vh, Pl Vh, Ph Vm, Pm Vm, Ph Vl; over a bf16 cache: Ph V, Pm V, Pl V),
// so the products keep f32's precision and only the order of the f32 sums
// differs from the f32 twin's; the output is stored in q's dtype. Tiles
// wholly above the causal
// diagonal are neither copied nor computed (a CTA stops at its deepest
// query; a warp skips tiles above its own rows); only diagonal tiles are
// masked elementwise; rows past the deepest visible key are zero-filled,
// never read. CTAs run deepest tile first.

#include <type_traits>

#include "common.cuh"
#include "decode_split.cuh"

namespace {

using tlt::NEG_INF;
using tlt::cp_async16;
using tlt::cp_async_commit;
using tlt::cp_async_wait;
using tlt::ldsm_x4;
using tlt::ldsm_x4_t;
using tlt::mma_bf16;
using tlt::pack_bf16;
using tlt::split3_bf16;
using bf16 = __nv_bfloat16;

constexpr int KT = 64;   // keys per tile
constexpr int BQ = 64;   // queries per prefill tile

template <typename K>
void allow_smem(K kernel, size_t bytes) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// -- K4: causal prefill on tensor cores ---------------------------------------

constexpr int kPfThreads = 128;   // 4 warps x 16 query rows = BQ

template <typename QT, typename CT, int D>
struct PrefillSmem {
  static constexpr bool F32Q = std::is_same<QT, float>::value;
  static constexpr bool F32C = std::is_same<CT, float>::value;
  static constexpr int LD = D + 8;             // bf16 row, padded by 16 bytes
  static constexpr int TILE = KT * LD;         // one bf16 K or V tile
  // bf16 cache: [stage][K|V] tiles; f32 cache: [K|V][hi|mid|lo] tiles
  static constexpr int TILES = F32C ? 6 : 4;
  // bf16 q: the q tile; f32 q: each thread's mid and lo A fragments
  static constexpr size_t Q_BYTES =
      F32Q ? 2 * (D / 16) * kPfThreads * sizeof(uint4) : sizeof(bf16) * BQ * LD;
  // the q region, the bf16 tiles and, for an f32 cache, one raw f32 [K|V] stage
  static constexpr size_t BYTES =
      Q_BYTES + sizeof(bf16) * TILES * TILE + (F32C ? sizeof(float) * 2 * KT * D : 0);
};

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <typename QT, typename CT, int D>
__global__ void __launch_bounds__(kPfThreads)
flash_prefill_kernel(const QT* __restrict__ q, const CT* __restrict__ kc,
                     const CT* __restrict__ vc, QT* __restrict__ out, int T, int H,
                     int Hkv, int S, int offset, float sm_scale) {
  using SM = PrefillSmem<QT, CT, D>;
  constexpr bool F32Q = SM::F32Q, F32C = SM::F32C;
  constexpr int LD = SM::LD, TILE = SM::TILE;
  constexpr int NK = D / 16;   // k-steps of S = Q K^T
  constexpr int ND = D / 8;    // n-tiles of O
  // bf16 parts of q, of the cache rows and of P (P is rounded to one only
  // when q and cache are both bf16)
  constexpr int QP = F32Q ? 3 : 1, CP = F32C ? 3 : 1, PP = F32Q || F32C ? 3 : 1;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);            // bf16 q
  uint4* qp_s = reinterpret_cast<uint4*>(smem_raw);         // f32 q: [mid|lo][kk][thread]
  bf16* t_s = reinterpret_cast<bf16*>(smem_raw + SM::Q_BYTES);       // SM::TILES tiles
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

  // bf16 q: the q tile (zero rows past T)
  if constexpr (!F32Q) {
    for (int c = tid; c < BQ * (D / 8); c += kPfThreads) {
      const int r = c / (D / 8), col = (c % (D / 8)) * 8;
      const bool ok = t0 + r < T;
      const int t = ok ? t0 + r : 0;
      cp_async16(q_s + r * LD + col, q + (((int64_t)b * T + t) * H + h) * D + col, ok);
    }
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
  if constexpr (F32Q) {
    // this thread's A fragments of its warp's 16 rows (zero past T): a[i]
    // holds row g8 (+ 8 if i is odd), columns 2 tig, 2 tig + 1 (+ 8 if
    // i >= 2) of k-step kk, split into hi (registers), mid and lo (slots)
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t m[4], l[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = wt0 + g8 + (i & 1) * 8;
        const int d = kk * 16 + (i >> 1) * 8 + 2 * tig;
        const float2 v = t < T ? __ldg(reinterpret_cast<const float2*>(
                                     q + (((int64_t)b * T + t) * H + h) * D + d))
                               : make_float2(0.f, 0.f);
        split3_bf16(v.x, v.y, qa[kk][i], m[i], l[i]);
      }
      qp_s[kk * kPfThreads + tid] = make_uint4(m[0], m[1], m[2], m[3]);
      qp_s[(NK + kk) * kPfThreads + tid] = make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
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
    if constexpr (!F32Q) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < NK; ++kk)
          ldsm_x4(qa[kk], q_s + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      }
    }
    const int s0 = j * KT;
    if (warp_live && s0 <= warp_last) {
      // S = Q K^T over the tile's 64 keys: 8 n-tiles of 8 keys; the
      // products of q part i and K part j with i + j <= 2
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t qm[4] = {}, ql[4] = {};
        if constexpr (F32Q) {
          const uint4 m = qp_s[kk * kPfThreads + tid], l = qp_s[(NK + kk) * kPfThreads + tid];
          qm[0] = m.x, qm[1] = m.y, qm[2] = m.z, qm[3] = m.w;
          ql[0] = l.x, ql[1] = l.y, ql[2] = l.z, ql[3] = l.w;
        }
        const int kcol = kk * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          const int krow = np * 16 + (lane >> 4) * 8 + (lane & 7);
#pragma unroll
          for (int cp = 0; cp < CP; ++cp) {   // K hi, mid, lo
            uint32_t r[4];
            ldsm_x4(r, kh + cp * TILE + krow * LD + kcol);
            mma_bf16(s[2 * np], qa[kk], r[0], r[1]);
            mma_bf16(s[2 * np + 1], qa[kk], r[2], r[3]);
            if (QP == 3 && cp <= 1) {   // q mid
              mma_bf16(s[2 * np], qm, r[0], r[1]);
              mma_bf16(s[2 * np + 1], qm, r[2], r[3]);
            }
            if (QP == 3 && cp == 0) {   // q lo
              mma_bf16(s[2 * np], ql, r[0], r[1]);
              mma_bf16(s[2 * np + 1], ql, r[2], r[3]);
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
      // O += P V: 4 k-steps of 16 keys; P from the S fragments, the
      // products of P part i and V part j with i + j <= 2
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // the A operand: p packed to bf16 (ROUND_P's rounding with bf16 q
        // and cache), else split into hi, mid and lo
        uint32_t pa[4], pm[4] = {}, pl[4] = {};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = s[2 * kk + (i >> 1)][2 * (i & 1)];
          const float b = s[2 * kk + (i >> 1)][2 * (i & 1) + 1];
          if constexpr (PP == 3)
            split3_bf16(a, b, pa[i], pm[i], pl[i]);
          else
            pa[i] = pack_bf16(a, b);
        }
        const int vrow = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          const int vcol = dp * 16 + (lane >> 4) * 8;
#pragma unroll
          for (int cp = 0; cp < CP; ++cp) {   // V hi, mid, lo
            uint32_t r[4];
            ldsm_x4_t(r, vh + cp * TILE + vrow * LD + vcol);
            mma_bf16(o[2 * dp], pa, r[0], r[1]);
            mma_bf16(o[2 * dp + 1], pa, r[2], r[3]);
            if (PP == 3 && cp <= 1) {   // P mid
              mma_bf16(o[2 * dp], pm, r[0], r[1]);
              mma_bf16(o[2 * dp + 1], pm, r[2], r[3]);
            }
            if (PP == 3 && cp == 0) {   // P lo
              mma_bf16(o[2 * dp], pl, r[0], r[1]);
              mma_bf16(o[2 * dp + 1], pl, r[2], r[3]);
            }
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
      store2(out + (((int64_t)b * T + ta) * H + h) * D + d, o[n][0] * inv0, o[n][1] * inv0);
    if (ta + 8 < T)
      store2(out + (((int64_t)b * T + ta + 8) * H + h) * D + d, o[n][2] * inv1,
             o[n][3] * inv1);
  }
}

// -- launches -----------------------------------------------------------------

template <typename QT, typename CT, int D>
void launch_prefill(const void* q, const void* kc, const void* vc, void* out, int B, int T,
                    int H, int Hkv, int S, int offset, float sm_scale, cudaStream_t st) {
  auto kernel = flash_prefill_kernel<QT, CT, D>;
  const size_t smem = PrefillSmem<QT, CT, D>::BYTES;
  allow_smem(kernel, smem);
  kernel<<<dim3((T + BQ - 1) / BQ, H, B), kPfThreads, smem, st>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(kc), static_cast<const CT*>(vc),
      static_cast<QT*>(out), T, H, Hkv, S, offset, sm_scale);
}

template <typename QT, typename CT>
void prefill_dispatch(const void* q, const void* kc, const void* vc, void* out, int B, int T,
                      int H, int Hkv, int D, int S, int offset, float sm_scale,
                      cudaStream_t st) {
#define TLT_PF(DD) \
  case DD:         \
    launch_prefill<QT, CT, DD>(q, kc, vc, out, B, T, H, Hkv, S, offset, sm_scale, st); break
  switch (D) {
    TLT_PF(16); TLT_PF(32); TLT_PF(48); TLT_PF(64);
    TLT_PF(80); TLT_PF(96); TLT_PF(112); TLT_PF(128);
    default: break;   // the wrapper admits only these
  }
#undef TLT_PF
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
  const tlt::SplitLaunch a{q, kc, vc, k_cur, v_cur, static_cast<const int*>(pos), out,
                           static_cast<float*>(part_acc), static_cast<float*>(part_ml),
                           static_cast<int*>(counters), B, H, Hkv, D, rows_per_split,
                           n_split, sm_scale, static_cast<cudaStream_t>(stream)};
  const tlt::FlatRows rows{S};
  const bool append = k_cur != nullptr;
#define TLT_DEC(QT, CT, RP)                                         \
  (append ? tlt::launch_decode_split<tlt::FlatRows, QT, CT, RP, true>(a, rows) \
          : tlt::launch_decode_split<tlt::FlatRows, QT, CT, RP, false>(a, rows))
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
// Every (q, cache) dtype pair on tensor cores; D a multiple of 16 up to 128.
TLT_API int tlt_flash_prefill(const void* q, int q_bf16, const void* kc, const void* vc,
                              int cache_bf16, void* out, int B, int T, int H, int Hkv,
                              int D, int S, int offset, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TLT_PFD(QT, CT) \
  prefill_dispatch<QT, CT>(q, kc, vc, out, B, T, H, Hkv, D, S, offset, sm_scale, st)
  if (q_bf16 && cache_bf16)
    TLT_PFD(bf16, bf16);
  else if (q_bf16)
    TLT_PFD(bf16, float);
  else if (cache_bf16)
    TLT_PFD(float, bf16);
  else
    TLT_PFD(float, float);
#undef TLT_PFD
  return (int)cudaGetLastError();
}
