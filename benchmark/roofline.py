"""The yardstick's arithmetic, frozen: the published peaks of one H100 and
the operations and bytes of each kernel call and of each forward.

A bound time is the larger of operations / peak and bytes / 3.35 TB/s.
Every input byte is counted read once and every output byte written
once, whatever a kernel reads again; scratch a kernel keeps for itself
(split-K partials, merge counters) is not counted.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}
Q4_0_BLOCK = 32                     # weights a q4_0 scale covers

# the port's kernels by the names its CUDA sources give them: K1's every
# body (qmm_tc_kernel, qmm_tc_kernel_decode) and any later one of its family
K1_KERNELS = ("qmm_",)
ATTN_KERNELS = ("flash_decode_split_kernel", "flash_prefill_kernel")


def bound_s(ops: float, nbytes: float, peak: str = "bf16") -> float:
    return max(ops / PEAK_OPS[peak], nbytes / HBM_BYTES_PER_S)


def q4_0_bytes(K: int, N: int, scale_bytes: int = 4) -> int:
    """A (K, N) q4_0 weight: a nibble a value and one scale a 32-row block."""
    return K * N // 2 + (K // Q4_0_BLOCK) * N * scale_bytes


def k1_call(rows: int, K: int, N: int, x_bytes: int, out_bytes: int,
            w_bytes: int) -> Tuple[float, float]:
    """(operations, bytes) of one fused dequant-matmul: (rows, K) x (K, N)
    with a packed weight of ``w_bytes``."""
    return 2.0 * rows * K * N, float(w_bytes + rows * K * x_bytes + rows * N * out_bytes)


def attn_peak(q_bytes: int, kv_bytes: int) -> str:
    """Tensor-core bf16 where q and the cache are both bf16, else f32."""
    return "bf16" if q_bytes == 2 and kv_bytes == 2 else "f32"


def decode_attn_call(positions: Sequence[int], H: int, Hkv: int, D: int, q_bytes: int,
                     kv_bytes: int, table_bytes: int = 0, block: int = 0,
                     appended: bool = False) -> Tuple[float, float]:
    """(operations, bytes) of one decode attention call: one query row a
    batch row at ``positions``, reading cache rows 0..pos of K and V (and,
    paged, the table entries that map them); ``appended``: the call also
    writes the row at pos (K3)."""
    ops = 0.0
    nbytes = 0.0
    for p in positions:
        n = p + 1
        ops += 4.0 * H * D * n
        nbytes += 2.0 * n * Hkv * D * kv_bytes + 2 * H * D * q_bytes
        if block:
            nbytes += (p // block + 1) * table_bytes
        if appended:
            nbytes += 2.0 * Hkv * D * kv_bytes
    return ops, nbytes


def prefill_attn_call(batch: int, T: int, offset: int, H: int, Hkv: int, D: int,
                      q_bytes: int, kv_bytes: int) -> Tuple[float, float]:
    """(operations, bytes) of one causal prefill attention call: T query
    rows at offset.., each over cache rows 0..its position."""
    ctx = T * offset + T * (T + 1) / 2            # sum of (offset + i + 1)
    ops = batch * 4.0 * H * D * ctx
    nbytes = batch * (2.0 * (offset + T) * Hkv * D * kv_bytes + 2.0 * T * H * D * q_bytes)
    return ops, nbytes


def expected_union(n_experts: int, k: int, rows: int) -> float:
    """Experts that ``rows`` routed rows select between them, at uniform
    routing: exact (k) for one row."""
    if rows <= 0 or not n_experts:
        return 0.0
    if rows == 1:
        return float(k)
    return n_experts * (1.0 - (1.0 - k / n_experts) ** rows)


def forward_cost(d: dict, groups: Iterable[Tuple[int, int]], logit_rows: int,
                 kv_bytes: int, act_peak: str = "bf16") -> float:
    """The bound time of one forward that the inputs need: ``groups`` are
    (offset, rows) of each sequence's real rows in it, ``logit_rows`` the
    rows whose logits are taken. It counts the k selected experts' work a
    row and the union of selected experts' planes; the KV rows each
    position reads and the rows it writes; every dense plane once."""
    E, F, L, H, Hkv, D, V = d["E"], d["F"], d["L"], d["H"], d["Hkv"], d["D"], d["V"]
    X, k = d["X"], d["k"]
    qkv = (H + 2 * Hkv) * D
    groups = list(groups)
    rows = sum(n for _, n in groups)
    if rows == 0:
        return 0.0
    ffn_ops = (k * 3 * E * F + E * X) if X else 3 * E * F
    proj_ops = 2.0 * rows * L * (E * qkv + H * D * E + ffn_ops) + 2.0 * logit_rows * E * V
    attn_ops = 0.0
    kv = 0.0
    for off, n in groups:
        attn_ops += 4.0 * H * D * (n * off + n * (n + 1) / 2) * L
        kv += 2.0 * (off + n) * Hkv * D * kv_bytes * L          # read (incl. the new rows)
        kv += 2.0 * n * Hkv * D * kv_bytes * L                  # written
    w = L * (q4_0_bytes(E, qkv) + q4_0_bytes(H * D, E))
    if X:
        w += L * expected_union(X, k, rows) * (2 * q4_0_bytes(E, F) + q4_0_bytes(F, E))
        w += L * E * X * 4
    else:
        w += L * (q4_0_bytes(E, 2 * F) + q4_0_bytes(F, E))
    if logit_rows:
        w += q4_0_bytes(E, V)
    nbytes = w + kv + rows * E * 2 + logit_rows * V * 4
    t_ops = proj_ops / PEAK_OPS["bf16"] + attn_ops / PEAK_OPS[act_peak]
    return max(t_ops, nbytes / HBM_BYTES_PER_S)
