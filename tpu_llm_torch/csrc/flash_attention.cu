// Flash (online-softmax) GQA attention kernels on Hopper.
//
// Replaces, in tpu_llm/ops/flash_attention.py:
// - _decode_kernel (wrapper flash_decode_attention): one-query GQA decode
//   over a flat (B, S, Hkv*D) cache, keys s <= pos[b];
// - _decode_fused_kernel (wrapper flash_decode_fused): the same attention
//   against a STALE cache (s < pos) plus this step's k_cur/v_cur for
//   s == pos, which it also stores at row pos;
// - _flash_kernel (wrapper flash_gqa_attention): causal prefill, query t
//   sees s <= offset + t, kv head h / G.
//
// What bounds them on the H100. Decode: the cache bytes of rows <= pos,
// 2 * (pos + 1) * Hkv * D * itemsize a batch row, over 3.35 TB/s; the
// arithmetic is 4 flops a cache element. Prefill: the f32 score and AV
// products, 4 * T * S_visible * D flops a head.
//
// Design. One CTA of 256 threads per (b, kv head) for decode, holding all
// G = H / Hkv query heads of that kv head, so every K/V row is read from
// device memory once and used G times; one CTA per (b, h, 64-query tile)
// for prefill. K and V come in 64-row tiles through shared memory, rows
// padded to D + 1 floats so the per-key dot products run without bank
// conflicts. The running max m, sum l and the f32 accumulator stay in
// shared memory across tiles (online softmax); tiles past pos (decode) or
// above the causal diagonal (prefill) are neither read nor computed. Masked
// scores are NEG_INF = -0.7 * f32max, and a row with l == 0 stores 0, as
// the reference kernels do. ROUND_P (q and cache both bf16) rounds the
// softmax weights to bf16 before the AV product, which is what the
// reference's einsum path computes for bf16 inputs.
//
// The TPU fused kernel's tile-aligned row-group read-modify-write has no
// counterpart here: the append is a plain store of row pos by the CTA that
// owns that kv head, which reads only rows < pos of the stale cache.
// Not yet: split-K over the sequence (flash-decoding) for batch-1 decode,
// where B * Hkv CTAs leave most SMs idle; tensor cores for prefill.

#include "common.cuh"

namespace {

using tlt::NEG_INF;
using tlt::from_f32;
using tlt::round_bf16;
using tlt::to_f32;
using tlt::warp_max;
using tlt::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int KT = 64;   // keys per tile
constexpr int BQ = 64;   // queries per prefill tile

// -- decode (K2) and fused decode + append (K3) ------------------------------

size_t decode_smem(int G, int D) {
  return sizeof(float) * (2 * G * D + 2 * KT * (D + 1) + G * KT + 3 * G);
}

template <typename QT, typename CT, bool FUSED, bool ROUND_P>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const QT* __restrict__ q, CT* __restrict__ kc, CT* __restrict__ vc,
                    const CT* __restrict__ k_cur, const CT* __restrict__ v_cur,
                    const int* __restrict__ pos_arr, QT* __restrict__ out,
                    int H, int Hkv, int D, int S, float sm_scale) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  const int h = blockIdx.x;            // kv head
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int HkvD = Hkv * D;
  const int DP = D + 1;
  float* q_s = smem;                   // G x D
  float* k_s = q_s + G * D;            // KT x DP
  float* v_s = k_s + KT * DP;          // KT x DP
  float* p_s = v_s + KT * DP;          // G x KT
  float* acc_s = p_s + G * KT;         // G x D
  float* m_s = acc_s + G * D;          // G
  float* l_s = m_s + G;                // G
  float* alpha_s = l_s + G;            // G

  const int pos = min(pos_arr[b], S - 1);
  const QT* qb = q + ((int64_t)b * H + (int64_t)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f32(qb[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  __syncthreads();

  CT* kb = kc + (int64_t)b * S * HkvD + (int64_t)h * D;
  CT* vb = vc + (int64_t)b * S * HkvD + (int64_t)h * D;
  // visible cache rows: s <= pos (K2); the stale rows s < pos (K3)
  const int n_keys = FUSED ? pos : pos + 1;
  for (int s0 = 0; s0 < n_keys; s0 += KT) {
    const int nk = min(KT, n_keys - s0);
    for (int i = tid; i < KT * D; i += kThreads) {
      const int s = i / D, d = i - s * D;
      float kv = 0.f, vv = 0.f;
      if (s < nk) {
        const int64_t off = (int64_t)(s0 + s) * HkvD + d;
        kv = to_f32(kb[off]);
        vv = to_f32(vb[off]);
      }
      k_s[s * DP + d] = kv;
      v_s[s * DP + d] = vv;
    }
    __syncthreads();
    for (int i = tid; i < G * KT; i += kThreads) {
      const int g = i / KT, s = i - g * KT;
      float sc = NEG_INF;
      if (s < nk) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(q_s[g * D + d], k_s[s * DP + d], dot);
        sc = dot * sm_scale;
      }
      p_s[i] = sc;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      float mx = NEG_INF;
      for (int s = lane; s < KT; s += 32) mx = fmaxf(mx, p_s[g * KT + s]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int s = lane; s < KT; s += 32) {
        const float p = expf(p_s[g * KT + s] - m_new);
        sum += p;
        p_s[g * KT + s] = ROUND_P ? round_bf16(p) : p;
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
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i - g * D;
      float a = 0.f;
      for (int s = 0; s < nk; ++s) a = fmaf(p_s[g * KT + s], v_s[s * DP + d], a);
      acc_s[i] = acc_s[i] * alpha_s[g] + a;
    }
    __syncthreads();
  }

  if (FUSED) {
    // this step's k/v (already in the cache dtype): store row pos of this
    // kv head, and merge it into the softmax as key s == pos
    const CT* kcur = k_cur + (int64_t)b * HkvD + (int64_t)h * D;
    const CT* vcur = v_cur + (int64_t)b * HkvD + (int64_t)h * D;
    for (int d = tid; d < D; d += kThreads) {
      const CT kv = kcur[d], vv = vcur[d];
      kb[(int64_t)pos * HkvD + d] = kv;
      vb[(int64_t)pos * HkvD + d] = vv;
      k_s[d] = to_f32(kv);
      v_s[d] = to_f32(vv);
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot = fmaf(q_s[g * D + d], k_s[d], dot);
      dot = warp_sum(dot);
      if (lane == 0) {
        const float sc = dot * sm_scale;
        const float m_prev = m_s[g];
        const float m_new = fmaxf(m_prev, sc);
        const float alpha = expf(m_prev - m_new);
        const float p = expf(sc - m_new);
        m_s[g] = m_new;
        l_s[g] = alpha * l_s[g] + p;
        alpha_s[g] = alpha;
        p_s[g] = p;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i - g * D;
      acc_s[i] = acc_s[i] * alpha_s[g] + p_s[g] * v_s[d];
    }
    __syncthreads();
  }

  QT* ob = out + ((int64_t)b * H + (int64_t)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const float l = l_s[i / D];
    const float inv = l == 0.f ? 1.f : 1.f / l;
    ob[i] = from_f32<QT>(acc_s[i] * inv);
  }
}

// -- causal prefill (K4) ------------------------------------------------------

size_t prefill_smem(int D) {
  return sizeof(float) * (3 * BQ * (D + 1) + BQ * (KT + 1) + 3 * BQ);
}

template <typename QT, typename CT, bool ROUND_P>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const QT* __restrict__ q, const CT* __restrict__ kc,
                     const CT* __restrict__ vc, QT* __restrict__ out, int T, int H,
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
    q_s[t * DP + d] = t0 + t < T ? to_f32(q[(((int64_t)b * T + t0 + t) * H + h) * D + d]) : 0.f;
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
        s_s[t * SP + s] = ROUND_P ? round_bf16(p) : p;
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
        out[(((int64_t)b * T + t0 + t) * H + h) * D + d] = from_f32<QT>(acc[j] * inv);
      }
    }
  }
}

template <typename K>
void allow_smem(K kernel, size_t bytes) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename QT, typename CT, bool FUSED, bool ROUND_P>
void launch_decode(const void* q, void* kc, void* vc, const void* k_cur, const void* v_cur,
                   const int* pos, void* out, int B, int H, int Hkv, int D, int S,
                   float sm_scale, cudaStream_t st) {
  auto kernel = flash_decode_kernel<QT, CT, FUSED, ROUND_P>;
  const size_t smem = decode_smem(H / Hkv, D);
  allow_smem(kernel, smem);
  kernel<<<dim3(Hkv, B), kThreads, smem, st>>>(
      static_cast<const QT*>(q), static_cast<CT*>(kc), static_cast<CT*>(vc),
      static_cast<const CT*>(k_cur), static_cast<const CT*>(v_cur), pos,
      static_cast<QT*>(out), H, Hkv, D, S, sm_scale);
}

template <bool FUSED>
void decode_dispatch(const void* q, int q_bf16, void* kc, void* vc, int cache_bf16,
                     const void* k_cur, const void* v_cur, const int* pos, void* out,
                     int B, int H, int Hkv, int D, int S, float sm_scale, cudaStream_t st) {
  using bf = __nv_bfloat16;
  if (q_bf16 && cache_bf16)
    launch_decode<bf, bf, FUSED, true>(q, kc, vc, k_cur, v_cur, pos, out, B, H, Hkv, D, S, sm_scale, st);
  else if (q_bf16)
    launch_decode<bf, float, FUSED, false>(q, kc, vc, k_cur, v_cur, pos, out, B, H, Hkv, D, S, sm_scale, st);
  else if (cache_bf16)
    launch_decode<float, bf, FUSED, false>(q, kc, vc, k_cur, v_cur, pos, out, B, H, Hkv, D, S, sm_scale, st);
  else
    launch_decode<float, float, FUSED, false>(q, kc, vc, k_cur, v_cur, pos, out, B, H, Hkv, D, S, sm_scale, st);
}

template <typename QT, typename CT, bool ROUND_P>
void launch_prefill(const void* q, const void* kc, const void* vc, void* out, int B, int T,
                    int H, int Hkv, int D, int S, int offset, float sm_scale,
                    cudaStream_t st) {
  auto kernel = flash_prefill_kernel<QT, CT, ROUND_P>;
  const size_t smem = prefill_smem(D);
  allow_smem(kernel, smem);
  kernel<<<dim3((T + BQ - 1) / BQ, H, B), kThreads, smem, st>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(kc), static_cast<const CT*>(vc),
      static_cast<QT*>(out), T, H, Hkv, D, S, offset, sm_scale);
}

}  // namespace

// K2 (k_cur == v_cur == nullptr) or K3 (both given, in the cache dtype).
// q (B, 1, H, D); caches (B, S, Hkv*D); pos (B,) int32 on the device;
// out (B, 1, H, D) in q's dtype. K3 stores k_cur/v_cur at row pos.
TLT_API int tlt_flash_decode(const void* q, int q_bf16, void* kc, void* vc, int cache_bf16,
                             const void* k_cur, const void* v_cur, const void* pos,
                             void* out, int B, int H, int Hkv, int D, int S,
                             float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  if (k_cur != nullptr)
    decode_dispatch<true>(q, q_bf16, kc, vc, cache_bf16, k_cur, v_cur, p, out, B, H, Hkv, D, S, sm_scale, st);
  else
    decode_dispatch<false>(q, q_bf16, kc, vc, cache_bf16, nullptr, nullptr, p, out, B, H, Hkv, D, S, sm_scale, st);
  return (int)cudaGetLastError();
}

// K4: q (B, T, H, D); caches (B, S, Hkv, D); out (B, T, H, D) in q's dtype.
TLT_API int tlt_flash_prefill(const void* q, int q_bf16, const void* kc, const void* vc,
                              int cache_bf16, void* out, int B, int T, int H, int Hkv,
                              int D, int S, int offset, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (q_bf16 && cache_bf16)
    launch_prefill<bf, bf, true>(q, kc, vc, out, B, T, H, Hkv, D, S, offset, sm_scale, st);
  else if (q_bf16)
    launch_prefill<bf, float, false>(q, kc, vc, out, B, T, H, Hkv, D, S, offset, sm_scale, st);
  else if (cache_bf16)
    launch_prefill<float, bf, false>(q, kc, vc, out, B, T, H, Hkv, D, S, offset, sm_scale, st);
  else
    launch_prefill<float, float, false>(q, kc, vc, out, B, T, H, Hkv, D, S, offset, sm_scale, st);
  return (int)cudaGetLastError();
}
