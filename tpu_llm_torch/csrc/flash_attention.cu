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
#include "decode_split.cuh"

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
