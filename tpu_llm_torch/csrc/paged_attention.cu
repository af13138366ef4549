// Paged flash-decode GQA attention kernels on Hopper.
//
// Replaces, in tpu_llm/ops/flash_attention.py:
// - _paged_decode_kernel (wrapper paged_flash_decode_attention, K5): one
//   query a batch row over shared f32/bf16 pools (N, BS, Hkv*D) reached
//   through an int32 block table (B, MB): logical row s of row b is
//   pool[table[b, s / BS], s % BS]; keys s <= pos[b];
// - _paged_decode_q_kernel (wrapper paged_flash_decode_q, K6): the same
//   walk over int8 pools with 2-D f32 scale pools (N * HP, SP): the scale
//   of (block blk, kv head h, offset o) is scale[(blk * HP + h) * SP + o].
//
// What they compute (not how the TPU tiles it). K5: scores q . k in f32,
// times sm_scale; online softmax in f32 with NEG_INF = -0.7 * f32max and
// the l == 0 guard; p rounded to q's dtype before the AV product (the
// reference casts p to q.dtype); output in q's dtype. K6: q rounded to
// bf16, int8 k exact, scores (q . k) * sm_scale * ks; pv = p * vs rounded
// to bf16; AV in f32. Table entries past pos / BS are never read, so a
// caller may leave them at the null block or at garbage.
//
// What bounds them on the H100: the pool bytes of rows <= pos,
// 2 * (pos + 1) * Hkv * D * itemsize a batch row (plus 8 bytes of scales a
// row and kv head for K6), over 3.35 TB/s; 4 flops a pool element.
//
// Design. As the port's flat decode kernel (flash_attention.cu): one CTA
// of 256 threads per (b, kv head) holds all G = H / Hkv query heads of
// that kv head, so each pool row is read once and used G times; 64-row
// tiles go through shared memory, rows padded to D + 1 floats. Each tile
// first resolves its rows through the table (one thread a row, pool row
// index and, for K6, the row's two scales into shared memory), then loads
// the rows; a 16-row block is 16 * Hkv * D contiguous elements, so the
// loads of one head's D values stay contiguous. At serving batch the
// (b, kv head) grid alone is 32 CTAs for 132 SMs, so the sequence is also
// split over the grid's z dimension (flash-decoding): each split runs the
// online softmax over its own rows and stores its unnormalised partial
// (acc, m, l); a second small kernel merges the partials of a query head
// in split order (results do not depend on scheduling). Splits past pos
// read nothing. With one split the first kernel writes the output itself.
//
// Left behind from the TPU kernels: the contiguous-run DMA coalescing
// (identical results, a TPU copy-engine fast path) and the VMEM chunk
// budget (_chunk_blocks).

#include <type_traits>

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

__device__ __forceinline__ float pool_f32(float v) { return v; }
__device__ __forceinline__ float pool_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float pool_f32(int8_t v) { return (float)v; }

size_t paged_smem(int G, int D) {
  return sizeof(int64_t) * KT +
         sizeof(float) * (2 * G * D + 2 * KT * (D + 1) + G * KT + 3 * G + 2 * KT);
}

template <typename QT, typename CT, bool QUANT, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const QT* __restrict__ q, const CT* __restrict__ kp,
                    const CT* __restrict__ vp, const float* __restrict__ ksp,
                    const float* __restrict__ vsp, int HP, int SP,
                    const int* __restrict__ table, const int* __restrict__ pos_arr,
                    QT* __restrict__ out, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int H, int Hkv, int D, int BS, int MB,
                    int rows_per_split, float sm_scale) {
  // K5 rounds p to q's dtype; K6 always rounds q and p * vs to bf16
  constexpr bool ROUND_P = QUANT || std::is_same<QT, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / Hkv;
  const int h = blockIdx.x;            // kv head
  const int b = blockIdx.y;
  const int split = blockIdx.z, n_split = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int HkvD = Hkv * D;
  const int DP = D + 1;
  int64_t* row_s = reinterpret_cast<int64_t*>(smem_raw);   // KT pool rows
  float* q_s = reinterpret_cast<float*>(row_s + KT);       // G x D
  float* k_s = q_s + G * D;            // KT x DP
  float* v_s = k_s + KT * DP;          // KT x DP
  float* p_s = v_s + KT * DP;          // G x KT
  float* acc_s = p_s + G * KT;         // G x D
  float* m_s = acc_s + G * D;          // G
  float* l_s = m_s + G;                // G
  float* alpha_s = l_s + G;            // G
  float* ks_s = alpha_s + G;           // KT (K6)
  float* vs_s = ks_s + KT;             // KT (K6)

  const int pos = min(pos_arr[b], MB * BS - 1);
  const int s_begin = split * rows_per_split;
  const int s_end = min(pos + 1, s_begin + rows_per_split);   // exclusive
  const QT* qb = q + ((int64_t)b * H + (int64_t)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const float qv = to_f32(qb[i]);
    q_s[i] = QUANT ? round_bf16(qv) : qv;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int* tb = table + (int64_t)b * MB;
  for (int s0 = s_begin; s0 < s_end; s0 += KT) {
    const int nk = min(KT, s_end - s0);
    if (tid < nk) {
      const int s = s0 + tid;
      const int64_t blk = tb[s / BS];
      const int off = s - (s / BS) * BS;
      row_s[tid] = blk * BS + off;
      if (QUANT) {
        const int64_t si = (blk * HP + h) * SP + off;
        ks_s[tid] = ksp[si];
        vs_s[tid] = vsp[si];
      }
    }
    __syncthreads();
    for (int i = tid; i < KT * D; i += kThreads) {
      const int s = i / D, d = i - s * D;
      float kv = 0.f, vv = 0.f;
      if (s < nk) {
        const int64_t off = row_s[s] * HkvD + (int64_t)h * D + d;
        kv = pool_f32(kp[off]);
        vv = pool_f32(vp[off]);
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
        if (QUANT) sc *= ks_s[s];
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
        const float p = s < nk ? expf(p_s[g * KT + s] - m_new) : 0.f;
        sum += p;
        const float pv = QUANT && s < nk ? p * vs_s[s] : p;
        p_s[g * KT + s] = ROUND_P ? round_bf16(pv) : pv;
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

  const int64_t head0 = (int64_t)b * H + (int64_t)h * G;   // first query head
  if (SPLIT) {
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i - g * D;
      part_acc[((head0 + g) * n_split + split) * D + d] = acc_s[i];
    }
    for (int g = tid; g < G; g += kThreads) {
      part_ml[((head0 + g) * n_split + split) * 2] = m_s[g];
      part_ml[((head0 + g) * n_split + split) * 2 + 1] = l_s[g];
    }
  } else {
    QT* ob = out + head0 * D;
    for (int i = tid; i < G * D; i += kThreads) {
      const float l = l_s[i / D];
      const float inv = l == 0.f ? 1.f : 1.f / l;
      ob[i] = from_f32<QT>(acc_s[i] * inv);
    }
  }
}

// merge the splits of one query head (blockIdx.x = b * H + head), in
// split order: out = sum_i e^(m_i - m) acc_i / sum_i e^(m_i - m) l_i
template <typename QT>
__global__ void paged_combine_kernel(const float* __restrict__ part_acc,
                                     const float* __restrict__ part_ml,
                                     QT* __restrict__ out, int D, int n_split) {
  const int64_t hq = blockIdx.x;
  const float* ml = part_ml + hq * n_split * 2;
  float m = NEG_INF;
  for (int i = 0; i < n_split; ++i) m = fmaxf(m, ml[2 * i]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float l = 0.f, a = 0.f;
    for (int i = 0; i < n_split; ++i) {
      const float w = expf(ml[2 * i] - m);
      l = fmaf(w, ml[2 * i + 1], l);
      a = fmaf(w, part_acc[(hq * n_split + i) * D + d], a);
    }
    const float inv = l == 0.f ? 1.f : 1.f / l;
    out[hq * D + d] = from_f32<QT>(a * inv);
  }
}

template <typename QT, typename CT, bool QUANT, bool SPLIT>
void launch_main(const void* q, const void* kp, const void* vp, const float* ksp,
                 const float* vsp, int HP, int SP, const int* table, const int* pos,
                 void* out, float* part_acc, float* part_ml, int B, int H, int Hkv, int D,
                 int BS, int MB, int rows_per_split, int n_split, float sm_scale,
                 cudaStream_t st) {
  auto kernel = paged_decode_kernel<QT, CT, QUANT, SPLIT>;
  const size_t smem = paged_smem(H / Hkv, D);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kernel<<<dim3(Hkv, B, n_split), kThreads, smem, st>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(kp), static_cast<const CT*>(vp), ksp,
      vsp, HP, SP, table, pos, static_cast<QT*>(out), part_acc, part_ml, H, Hkv, D, BS, MB,
      rows_per_split, sm_scale);
}

template <typename QT, typename CT, bool QUANT>
void launch(const void* q, const void* kp, const void* vp, const float* ksp,
            const float* vsp, int HP, int SP, const int* table, const int* pos,
            void* out, float* part_acc, float* part_ml, int B, int H, int Hkv, int D,
            int BS, int MB, int rows_per_split, int n_split, float sm_scale,
            cudaStream_t st) {
  if (n_split == 1) {
    launch_main<QT, CT, QUANT, false>(q, kp, vp, ksp, vsp, HP, SP, table, pos, out, part_acc,
                                      part_ml, B, H, Hkv, D, BS, MB, rows_per_split,
                                      n_split, sm_scale, st);
    return;
  }
  launch_main<QT, CT, QUANT, true>(q, kp, vp, ksp, vsp, HP, SP, table, pos, out, part_acc,
                                   part_ml, B, H, Hkv, D, BS, MB, rows_per_split, n_split,
                                   sm_scale, st);
  paged_combine_kernel<QT><<<B * H, 128, 0, st>>>(part_acc, part_ml,
                                                  static_cast<QT*>(out), D, n_split);
}

}  // namespace

// K5. q (B, 1, H, D) f32/bf16; pools (N, BS, Hkv*D) f32 or bf16
// (pool_bf16); table (B, MB) int32; pos (B,) int32; out like q. With
// n_split > 1, part_acc (B*H, n_split, D) and part_ml (B*H, n_split, 2)
// f32 scratch; split i covers rows [i * rows_per_split, (i+1) * ...).
TLT_API int tlt_paged_decode(const void* q, int q_bf16, const void* k_pool,
                             const void* v_pool, int pool_bf16, const void* table,
                             const void* pos, void* out, void* part_acc, void* part_ml,
                             int B, int H, int Hkv, int D, int BS, int MB,
                             int rows_per_split, int n_split, float sm_scale,
                             void* stream) {
  using bf = __nv_bfloat16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* p = static_cast<const int*>(pos);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
#define TLT_K5(QT, CT) \
  launch<QT, CT, false>(q, k_pool, v_pool, nullptr, nullptr, 0, 0, tb, p, out, pa, pm, B, H, \
                        Hkv, D, BS, MB, rows_per_split, n_split, sm_scale, st)
  if (q_bf16 && pool_bf16)
    TLT_K5(bf, bf);
  else if (q_bf16)
    TLT_K5(bf, float);
  else if (pool_bf16)
    TLT_K5(float, bf);
  else
    TLT_K5(float, float);
#undef TLT_K5
  return (int)cudaGetLastError();
}

// K6. As K5 over int8 pools, with k_scale / v_scale (N * HP, SP) f32.
TLT_API int tlt_paged_decode_q(const void* q, int q_bf16, const void* k_pool,
                               const void* v_pool, const void* k_scale,
                               const void* v_scale, int HP, int SP, const void* table,
                               const void* pos, void* out, void* part_acc, void* part_ml,
                               int B, int H, int Hkv, int D, int BS, int MB,
                               int rows_per_split, int n_split, float sm_scale,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* p = static_cast<const int*>(pos);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (q_bf16)
    launch<__nv_bfloat16, int8_t, true>(q, k_pool, v_pool, ks, vs, HP, SP, tb, p, out, pa,
                                        pm, B, H, Hkv, D, BS, MB, rows_per_split, n_split,
                                        sm_scale, st);
  else
    launch<float, int8_t, true>(q, k_pool, v_pool, ks, vs, HP, SP, tb, p, out, pa, pm, B,
                                H, Hkv, D, BS, MB, rows_per_split, n_split, sm_scale, st);
  return (int)cudaGetLastError();
}
