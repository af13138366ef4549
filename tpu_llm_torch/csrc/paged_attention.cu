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
// bf16, int8 k exact, scores (q . k) * sm_scale * ks; l sums the unrounded
// p; the AV weight p * vs rounded to bf16; AV in f32. Table entries past
// pos / BS are never read, so a caller may leave them at the null block or
// at garbage.
//
// Both are instantiations of the split decode body that K2 and K3 run
// (flash_decode_split_kernel, decode_split.cuh: design and bound), with
// the paged row source: each row's 16-byte copies resolve it through the
// table when they start, and K6 copies each row's two scales beside it.
// One launch a call: the last split of a (b, kv head) merges the partials.
//
// Left behind from the TPU kernels: the contiguous-run DMA coalescing
// (identical results, a TPU copy-engine fast path) and the VMEM chunk
// budget (_chunk_blocks).

#include "common.cuh"
#include "decode_split.cuh"

namespace {

tlt::SplitLaunch split_launch(const void* q, const void* k_pool, const void* v_pool,
                              const void* pos, void* out, void* part_acc, void* part_ml,
                              void* counters, int B, int H, int Hkv, int D,
                              int rows_per_split, int n_split, float sm_scale,
                              void* stream) {
  return {q, const_cast<void*>(k_pool), const_cast<void*>(v_pool), nullptr, nullptr,
          static_cast<const int*>(pos), out, static_cast<float*>(part_acc),
          static_cast<float*>(part_ml), static_cast<int*>(counters), B, H, Hkv, D,
          rows_per_split, n_split, sm_scale, static_cast<cudaStream_t>(stream)};
}

}  // namespace

// K5. q (B, 1, H, D) f32/bf16; pools (N, BS, Hkv*D) f32 or bf16
// (pool_bf16); table (B, MB) int32; pos (B,) int32; out like q. Split i
// covers rows [i * rows_per_split, (i+1) * ...); with n_split > 1,
// part_acc (B*H, n_split, D) and part_ml (B*H, n_split, 2) f32 scratch and
// counters, B*Hkv int32 that are 0 on entry and 0 again on exit.
TLT_API int tlt_paged_decode(const void* q, int q_bf16, const void* k_pool,
                             const void* v_pool, int pool_bf16, const void* table,
                             const void* pos, void* out, void* part_acc, void* part_ml,
                             void* counters, int B, int H, int Hkv, int D, int BS, int MB,
                             int rows_per_split, int n_split, float sm_scale,
                             void* stream) {
  using bf = __nv_bfloat16;
  using tlt::PagedRows;
  const tlt::SplitLaunch a =
      split_launch(q, k_pool, v_pool, pos, out, part_acc, part_ml, counters, B, H, Hkv, D,
                   rows_per_split, n_split, sm_scale, stream);
  const PagedRows rows{static_cast<const int*>(table), BS, MB, nullptr, nullptr, 0, 0};
  // K5 rounds p whenever q is bf16
  if (q_bf16 && pool_bf16)
    tlt::launch_decode_split<PagedRows, bf, bf, true>(a, rows);
  else if (q_bf16)
    tlt::launch_decode_split<PagedRows, bf, float, true>(a, rows);
  else if (pool_bf16)
    tlt::launch_decode_split<PagedRows, float, bf, false>(a, rows);
  else
    tlt::launch_decode_split<PagedRows, float, float, false>(a, rows);
  return (int)cudaGetLastError();
}

// K6. As K5 over int8 pools, with k_scale / v_scale (N * HP, SP) f32.
TLT_API int tlt_paged_decode_q(const void* q, int q_bf16, const void* k_pool,
                               const void* v_pool, const void* k_scale,
                               const void* v_scale, int HP, int SP, const void* table,
                               const void* pos, void* out, void* part_acc, void* part_ml,
                               void* counters, int B, int H, int Hkv, int D, int BS, int MB,
                               int rows_per_split, int n_split, float sm_scale,
                               void* stream) {
  using tlt::PagedRows;
  const tlt::SplitLaunch a =
      split_launch(q, k_pool, v_pool, pos, out, part_acc, part_ml, counters, B, H, Hkv, D,
                   rows_per_split, n_split, sm_scale, stream);
  const PagedRows rows{static_cast<const int*>(table), BS, MB,
                       static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                       HP, SP};
  // K6 rounds q and the AV weights to bf16 whatever q's dtype
  if (q_bf16)
    tlt::launch_decode_split<PagedRows, __nv_bfloat16, int8_t, true>(a, rows);
  else
    tlt::launch_decode_split<PagedRows, float, int8_t, true>(a, rows);
  return (int)cudaGetLastError();
}
