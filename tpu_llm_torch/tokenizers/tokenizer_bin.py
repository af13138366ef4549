"""tokenizer.bin side-format (a copy of the reader and the writer in
``tpu_llm/tokenizers/tokenizer_bin.py``).

Format (verified by the reference readers ``llama2.f90:321-356`` /
``ssm/mamba.f90:348-384`` and writer ``load.f90:477-503``):

    [i32 max_len] then per token: [f32 score][i32 len][len raw bytes]

The record count is NOT stored — readers read ``vocab_size`` records (the
Mamba program deliberately stops 3 short of the nominal 50280,
``ssm/mamba.f90:366``). Our reader just reads until EOF.
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

import numpy as np


def read_tokenizer_bin(path: str) -> Tuple[List[bytes], np.ndarray, int]:
    """Returns (token byte strings, scores f32, max_len)."""
    with open(path, "rb") as f:
        data = f.read()
    (max_len,) = struct.unpack_from("<i", data, 0)
    pos = 4
    tokens: List[bytes] = []
    scores: List[float] = []
    while pos + 8 <= len(data):
        score, tok_len = struct.unpack_from("<fi", data, pos)
        pos += 8
        tokens.append(data[pos : pos + tok_len])
        pos += tok_len
        scores.append(score)
    return tokens, np.asarray(scores, dtype=np.float32), max_len


def write_tokenizer_bin(path: str, tokens: Sequence[bytes], scores: Sequence[float]):
    max_len = max((len(t) for t in tokens), default=0)
    with open(path, "wb") as f:
        f.write(struct.pack("<i", max_len))
        for tok, score in zip(tokens, scores):
            s = float(score)
            if s <= -1e30:
                # the UNMERGEABLE sentinel (bpe.UNMERGEABLE) is written as the
                # reference converter's 0.0 for vocab-only tokens
                # (ssm/convert_tokens.py)
                s = 0.0
            f.write(struct.pack("<fi", s, len(tok)))
            f.write(tok)
