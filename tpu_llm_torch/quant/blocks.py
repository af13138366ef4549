"""Host-side (numpy) GGML block-quant codecs: the kinds this slice reads
and writes (a copy of the q4_0 / q8_0 part of ``tpu_llm/quant/blocks.py``).

- Q4_0: blocks of 32 weights; per block [f16 scale d][16 bytes qs].
  byte j: low nibble = q[j], high nibble = q[j+16]; value = (q - 8) * d.
- Q8_0: [f16 d][32 int8]; value = q * d.

f32 / f16 / bf16 need no codec (io/gguf.py views them directly). Every
other ggml kind raises ``NotImplementedError`` naming the ROADMAP item
that ports it.
"""

from __future__ import annotations

import numpy as np

QK4_0 = 32
QK8_0 = 32
QK_K = 256

# bytes per block
Q4_0_BLOCK_BYTES = 2 + 16
Q8_0_BLOCK_BYTES = 2 + 32

# block sizes of the kinds this slice does not decode — io/gguf.py still
# needs them to walk a file's tensor directory
Q4_1_BLOCK_BYTES = 4 + 16
Q5_0_BLOCK_BYTES = 2 + 4 + 16
Q5_1_BLOCK_BYTES = 4 + 4 + 16
Q2_K_BLOCK_BYTES = 16 + 64 + 2 + 2
Q3_K_BLOCK_BYTES = 32 + 64 + 12 + 2
Q4_K_BLOCK_BYTES = 2 + 2 + 12 + 128
Q5_K_BLOCK_BYTES = 2 + 2 + 12 + 32 + 128
Q6_K_BLOCK_BYTES = 128 + 64 + 16 + 2

LATER_SLICE = ("ported by ROADMAP.md queue 1, 'qmatmul: the remaining "
               "kinds and inputs'")


def not_in_slice(kind: str):
    raise NotImplementedError(f"ggml kind {kind} is not in this slice of "
                              f"tpu_llm_torch; it is {LATER_SLICE}")


def quantize_q4_0(x: np.ndarray) -> bytes:
    """Quantize a flat f32 array (len % 32 == 0) to GGML Q4_0 bytes."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK4_0)
    amax_idx = np.argmax(np.abs(x), axis=1)
    maxv = x[np.arange(x.shape[0]), amax_idx]  # signed value of abs-max (ggml convention)
    d = maxv / -8.0
    inv_d = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.clip((x * inv_d[:, None]) + 8.5, 0.0, 15.0).astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    packed = (lo | (hi << 4)).astype(np.uint8)
    out = np.empty((x.shape[0], Q4_0_BLOCK_BYTES), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:] = packed
    return out.tobytes()


def dequantize_q4_0(buf: bytes | np.ndarray, n: int) -> np.ndarray:
    """Dequantize GGML Q4_0 bytes to a flat f32 array of length n."""
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(-1, Q4_0_BLOCK_BYTES)
    assert raw.shape[0] * QK4_0 == n, (raw.shape, n)
    d = raw[:, :2].copy().view(np.float16).astype(np.float32)  # (nb, 1)
    qs = raw[:, 2:]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)  # (nb, 32)
    return (q * d).reshape(-1)


def quantize_q8_0(x: np.ndarray) -> bytes:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK8_0)
    amax = np.max(np.abs(x), axis=1)
    d = amax / 127.0
    inv_d = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.round(x * inv_d[:, None]).astype(np.int8)
    out = np.empty((x.shape[0], Q8_0_BLOCK_BYTES), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.tobytes()


def dequantize_q8_0(buf: bytes | np.ndarray, n: int) -> np.ndarray:
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(-1, Q8_0_BLOCK_BYTES)
    assert raw.shape[0] * QK8_0 == n
    d = raw[:, :2].copy().view(np.float16).astype(np.float32)
    q = raw[:, 2:].view(np.int8).astype(np.float32)
    return (q * d).reshape(-1)
