"""Legacy "ak" (llama2.c-style) packed checkpoint format (the port of
``tpu_llm/io/ak.py``).

Byte layout per the reference reader (``llama2.f90:159-294``) and writer
(``load.f90:313-421``):

  header: 7 x i32 — dim, hidden_dim, n_layers, n_heads, n_kv_heads,
          vocab_size (NEGATED: llama2.c convention for an unshared
          classifier, load.f90:258,320), seq_len
  then f32 tensors, each group containing all layers consecutively:
    token_embedding (vocab, dim)
    rms_att  (L, dim)
    wq (L, dim, dim)  wk (L, kv_dim, dim)  wv (L, kv_dim, dim)
    wo (L, dim, dim)
    rms_ffn  (L, dim)
    w1 (L, hidden, dim)   w2 (L, dim, hidden)   w3 (L, hidden, dim)
    rms_final (dim,)
    wcls (vocab, dim)

(Matrix shapes given as numpy row-major (out, in): the transpose of the
Fortran column-major declarations, same bytes.)

The reference's `llm --ak` ignores the header and uses compile-time
TinyLlama dims (llama2.f90:100-108); this reader honours the header, as
the JAX package's does.
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np
import torch

from tpu_llm_torch.config import LlamaConfig

# the per-layer matrix groups in file order: (model key, (out, in) of a layer)
_MATRICES = ("wq", "wk", "wv", "wo")
_FFN = ("w1", "w2", "w3")


def load_ak(path: str, dtype_policy: str = "f32", device="cpu") -> Tuple[Dict, LlamaConfig]:
    """-> (params, cfg): the port's per-layer llama parameters on
    ``device`` (q|k|v and gate|up fused, as ``llama.load_gguf`` makes
    them), dense f32, or bf16 weights with f32 norms under
    ``dtype_policy="bf16"``. A positive header vocab means a classifier
    tied to the embedding (``wcls`` None)."""
    from tpu_llm_torch.quant.convert_params import fuse_llama_layers

    with open(path, "rb") as f:
        dim, hidden, n_layers, n_heads, n_kv_heads, vocab, seq_len = struct.unpack(
            "<7i", f.read(28))
        shared = vocab > 0
        vocab = abs(vocab)
        cfg = LlamaConfig(dim=dim, hidden_dim=hidden, n_layers=n_layers, n_heads=n_heads,
                          n_kv_heads=n_kv_heads, vocab_size=vocab, seq_len=seq_len,
                          tie_embeddings=shared)
        kv = cfg.kv_dim

        def rd(*shape):
            n = int(np.prod(shape))
            a = np.fromfile(f, dtype=np.float32, count=n)
            if a.size != n:
                raise EOFError(f"{path}: truncated at {shape}")
            return a.reshape(shape)

        tok_emb = rd(vocab, dim)
        rms_att = rd(n_layers, dim)
        mats = {k: rd(n_layers, *s) for k, s in zip(
            _MATRICES, ((dim, dim), (kv, dim), (kv, dim), (dim, dim)))}
        rms_ffn = rd(n_layers, dim)
        mats.update({k: rd(n_layers, *s) for k, s in zip(
            _FFN, ((hidden, dim), (dim, hidden), (hidden, dim)))})
        rms_final = rd(dim)
        wcls = None if shared else rd(vocab, dim)

    wdt = torch.bfloat16 if dtype_policy == "bf16" else torch.float32
    dense = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    proj = lambda a: dense(a.T).to(wdt)   # (out, in) -> (in, out) for x @ W  # noqa: E731
    layers = [dict({"attn_norm": dense(rms_att[i]), "ffn_norm": dense(rms_ffn[i])},
                   **{k: proj(m[i]) for k, m in mats.items()}) for i in range(n_layers)]
    params = {"tok_emb": dense(tok_emb).to(wdt), "final_norm": dense(rms_final),
              "wcls": None if wcls is None else proj(wcls),
              "layers": fuse_llama_layers(layers)}
    return params, cfg


def write_ak(path: str, gguf, verbose: bool = False):
    """GGUF -> ak converter core (the reference's `load` program,
    load.f90:313-421). Tensors are written dequantized to f32, as the JAX
    package writes them (the reference's dtype-preserving write makes
    files its own f32 reader cannot read back)."""
    from tpu_llm_torch.models.llama import config_from_gguf

    cfg = config_from_gguf(gguf)
    with open(path, "wb") as f:
        f.write(struct.pack("<7i", cfg.dim, cfg.hidden_dim, cfg.n_layers, cfg.n_heads,
                            cfg.n_kv_heads, -cfg.vocab_size, cfg.seq_len))

        def wr(name):
            a = gguf.dequantized(name, np.float32)
            f.write(np.ascontiguousarray(a).tobytes())
            if verbose:
                print(f"wrote {name}: {a.size}")

        wr("token_embd.weight")
        for i in range(cfg.n_layers):
            wr(f"blk.{i}.attn_norm.weight")
        for group in ("attn_q", "attn_k", "attn_v", "attn_output"):
            for i in range(cfg.n_layers):
                wr(f"blk.{i}.{group}.weight")
        for i in range(cfg.n_layers):
            wr(f"blk.{i}.ffn_norm.weight")
        for group in ("ffn_gate", "ffn_down", "ffn_up"):
            for i in range(cfg.n_layers):
                wr(f"blk.{i}.{group}.weight")
        wr("output_norm.weight")
        wr("output.weight")
