"""Perplexity harness of the port (``tpu_llm/runtime/perplexity.py``):
``python -m tpu_llm_torch.runtime.perplexity``.

Teacher-forced NLL of a token stream under any ModelAdapter, in
non-overlapping windows of at most the model's context:
ppl = exp(mean over positions of -log p(token_{t+1} | tokens_<=t)); the
first token of each window is not scored. A short last window is padded
and masked by ``length`` (a recurrent state must not see the padding).

``dtype_table`` round-trips a base GGUF through the writer at each storage
format, reloads each file on the serving path (native policy: packed
QTensors through K1) and scores windowed ppl and the logit deviation from
the f32 model on the first window. Flags: -m -f --dtype --window
--max-tokens --table, and --device (cuda unless told otherwise).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from tpu_llm_torch.io import gguf as gg
from tpu_llm_torch.runtime.engine import ModelAdapter


@dataclasses.dataclass
class PplResult:
    ppl: float
    nll_sum: float
    n_tokens: int

    @property
    def mean_nll(self) -> float:
        return self.nll_sum / max(self.n_tokens, 1)


@torch.inference_mode()
def compute_ppl(params: Any, adapter: ModelAdapter, ids: Sequence[int], window: int = 512,
                add_bos: bool = True, device="cuda") -> PplResult:
    """Windowed (non-overlapping) teacher-forced perplexity; the NLL of a
    window summed in f32 on ``device``, the windows in f64 on the host."""
    ids = list(ids)
    if add_bos and adapter.bos_id >= 0:
        ids = [adapter.bos_id] + ids
    if len(ids) < 2:
        raise ValueError("need at least 2 tokens to score")
    nll_sum, count, pos = 0.0, 0, 0
    while pos + 1 < len(ids):
        chunk = ids[pos:pos + window]
        n_valid = len(chunk)
        tokens = torch.tensor([chunk + [0] * (window - n_valid)], device=device)
        state = adapter.init_state(1, window)
        hidden, _ = adapter.apply(params, tokens, state, 0, length=n_valid)
        logp = torch.log_softmax(adapter.lm_head(params, hidden)[0, :n_valid - 1], dim=-1)
        tok_logp = logp.gather(1, tokens[0, 1:n_valid, None])[:, 0]
        nll_sum += float(-tok_logp.sum())
        count += n_valid - 1
        # windows restart the context: a window's last token is the next
        # one's first (unscored) token, as in llama.cpp's chunked ppl
        pos += n_valid
        if n_valid < window:
            break
    return PplResult(ppl=math.exp(nll_sum / count), nll_sum=nll_sum, n_tokens=count)


_TABLE_FORMATS = ("f32", "f16", "bf16", "q8_0", "q4_1", "q4_0")


def eval_stream(n: int = 1024, vocab: int = 1024, seed: int = 11) -> List[int]:
    """Deterministic token stream with bigram structure (half the tokens
    follow from the previous one), for ppl with no text corpus: pure noise
    would score near-uniform under every model and hide quantization
    error."""
    rng = np.random.default_rng(seed)
    ids = [int(rng.integers(3, vocab))]
    for _ in range(n - 1):
        if rng.random() < 0.5:
            ids.append(3 + (ids[-1] * 7 + 1) % (vocab - 3))
        else:
            ids.append(int(rng.integers(3, vocab)))
    return ids


def model_sampled_stream(params, cfg, n: int = 512, seed: int = 0, temperature: float = 1.0,
                         device="cuda") -> List[int]:
    """A stream sampled FROM the model (temperature 1): the f32 model is
    optimal on its own distribution, so a quantized variant's Δppl on it
    measures divergence even with synthetic weights. The draws come from
    the port's generator, not the JAX package's PRNG: the stream differs
    from the JAX package's for the same seed."""
    from tpu_llm_torch.runtime.engine import Engine

    eng = Engine(params, ModelAdapter.llama(cfg, device=device),
                 max_seq=min(cfg.seq_len, n + 8), device=device)
    return eng.generate([3], n_new=n, temperature=temperature, seed=seed).tokens


_FORMAT_TYPES = {"f32": gg.GGML_F32, "f16": gg.GGML_F16, "bf16": gg.GGML_BF16,
                 "q8_0": gg.GGML_Q8_0, "q5_0": gg.GGML_Q5_0, "q5_1": gg.GGML_Q5_1,
                 "q4_0": gg.GGML_Q4_0, "q4_1": gg.GGML_Q4_1, "q2_k": gg.GGML_Q2_K,
                 "q3_k": gg.GGML_Q3_K, "q4_k": gg.GGML_Q4_K, "q5_k": gg.GGML_Q5_K,
                 "q6_k": gg.GGML_Q6_K}


def _variant(base, fmt: str, out_path: str):
    """``base`` re-written with every 2-D weight in ``fmt`` (norms, and rows
    that do not fill a whole block, stay f32, as llama.cpp does)."""
    ttype = _FORMAT_TYPES[fmt]
    tensors = {}
    for name in base.tensors:
        arr = base.dequantized(name, np.float32)
        block = gg._TYPE_TRAITS[ttype][0]
        quantize = arr.ndim == 2 and "norm" not in name and arr.shape[-1] % block == 0
        tensors[name] = (arr, ttype) if quantize else arr
    gg.write_gguf(out_path, dict(base.metadata), tensors)


@torch.inference_mode()
def dtype_table(base_path: str, ids: Optional[Sequence[int]] = None, window: int = 256,
                formats: Sequence[str] = _TABLE_FORMATS, device="cuda") -> List[dict]:
    """Cross-dtype table: each format's file written by the GGUF writer,
    reloaded on the serving path (f32 dense for "f32", else native), scored
    by windowed ppl over ``ids`` (default: a stream sampled from the f32
    model) and by the logit deviation from the first row on the first
    window. ``formats`` starts with "f32": every delta is against it."""
    import os
    import tempfile

    from tpu_llm_torch.models.llama import load_gguf

    if formats[0] != "f32":
        raise ValueError(f"dtype_table computes every delta against the FIRST row; pass "
                         f"formats starting with 'f32' (got {formats[0]!r})")
    base = gg.GGUFFile(base_path)
    if ids is None:
        params_f32, cfg_f32 = load_gguf(base, dtype_policy="f32", device=device)
        ids = model_sampled_stream(params_f32, cfg_f32, n=min(512, cfg_f32.seq_len - 8),
                                   device=device)
        del params_f32
    rows: List[dict] = []
    ref_logits = None
    with tempfile.TemporaryDirectory() as td:
        for fmt in formats:
            path = base_path
            if fmt != "f32" or base.tensors["output.weight"].ggml_type != gg.GGML_F32:
                path = os.path.join(td, f"{fmt}.gguf")
                _variant(base, fmt, path)
            params, cfg = load_gguf(path, dtype_policy="native" if fmt != "f32" else "f32",
                                    device=device)
            adapter = ModelAdapter.llama(cfg, device=device)
            res = compute_ppl(params, adapter, ids, window=min(window, cfg.seq_len),
                              device=device)
            w = min(window, cfg.seq_len, len(ids))
            hidden, _ = adapter.apply(params, torch.tensor([list(ids[:w])], device=device),
                                      adapter.init_state(1, w), 0, length=w)
            logits = adapter.lm_head(params, hidden).cpu().numpy()
            if ref_logits is None:
                ref_logits = logits
                dmax = dmean = 0.0
            else:
                d = np.abs(logits - ref_logits)
                dmax, dmean = float(d.max()), float(d.mean())
            rows.append({
                "format": fmt, "ppl": res.ppl, "n_tokens": res.n_tokens,
                "ppl_delta_vs_f32": res.ppl - rows[0]["ppl"] if rows else 0.0,
                "logit_max_abs_delta": dmax, "logit_mean_abs_delta": dmean,
            })
            del params
    return rows


def format_table(rows: List[dict]) -> str:
    out = ["| format | ppl | Δppl vs f32 | max|Δlogit| | mean|Δlogit| |",
           "|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['format']} | {r['ppl']:.4f} | {r['ppl_delta_vs_f32']:+.4f} "
            f"| {r['logit_max_abs_delta']:.4g} | {r['logit_mean_abs_delta']:.4g} |")
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import sys

    p = argparse.ArgumentParser(prog="llm-ppl", allow_abbrev=False,
                                description="perplexity of a text file under a GGUF model")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-f", "--file", default=None, help="UTF-8 text file")
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16", "native"])
    p.add_argument("--window", type=int, default=512)
    p.add_argument("--max-tokens", type=int, default=0, help="truncate input")
    p.add_argument("--table", action="store_true",
                   help="cross-dtype ppl / logit-delta table: the model round-tripped "
                        "through the GGUF writer at f32/f16/bf16/q8_0/q4_1/q4_0 and "
                        "scored (-f text, or a stream sampled from the f32 model)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if not args.table and not args.file:
        p.error("-f/--file is required unless --table")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (pass --device cpu to run on the CPU)", file=sys.stderr)
        return 1

    from tpu_llm_torch.tokenizers.bpe import BPETokenizer

    gguf = gg.GGUFFile(args.model)
    ids = None
    if args.file:
        with open(args.file, "rb") as fh:
            ids = BPETokenizer.from_gguf(gguf).encode(fh.read().decode("utf-8",
                                                                       errors="replace"))
        if args.max_tokens:
            ids = ids[:args.max_tokens]
    if args.table:
        print(format_table(dtype_table(args.model, ids, window=args.window,
                                       device=args.device)))
        return 0

    from tpu_llm_torch.models.llama import load_model

    params, cfg = load_model(gguf, dtype_policy=args.dtype, device=args.device)
    bos = BPETokenizer.from_gguf(gguf).bos_id
    res = compute_ppl(params, ModelAdapter.llama(cfg, bos_id=bos, device=args.device), ids,
                      window=min(args.window, cfg.seq_len), device=args.device)
    print(f"ppl = {res.ppl:.4f} over {res.n_tokens} tokens (mean nll {res.mean_nll:.4f})")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
