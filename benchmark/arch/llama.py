"""The llama family (Qwen2, Mixtral): everything of the benchmark that
depends on a model's architecture, behind one contract. A configuration
file names its module by its top-level ``"arch"`` key; the harness loads
``arch/<arch>.py`` (``harness.load_arch``) and calls nothing
architecture-specific except through it. A new architecture is a new file
here with the same names, beside its own weights, reference and cost
functions; no other file of the harness changes for it.

The contract (every name is required unless marked optional):

- ``dims(cfg) -> dict``: the sizes the benchmark uses, from the
  configuration's Hugging Face dict. The harness and the entries read
  ``X`` (routed experts a layer, 0 without), ``k`` (experts a token) and
  ``bias`` (True where q reaches attention in f32, so attention runs
  against the f32 peak); everything else is the module's own.
- ``draw(cfg, seed, device) -> raw``: the benchmark's weights, drawn on
  ``device`` from ``seed``; the reference reads them as they are.
- ``port_params(raw)``: the same tensors as the program's parameters.
- ``port_config(cfg)``: the program's model configuration.
- ``adapter(pcfg, cache_dtype, bos_id, device)``: the program's
  ``ModelAdapter`` (``runtime/engine.py``), which ``Engine`` and
  ``BatchEngine`` drive.
- ``paged_engine(ctx, **kw)``: the program's paged engine over
  ``ctx.params`` / ``ctx.pcfg`` with the mix's engine keywords; an
  architecture without paged KV raises ``NotImplementedError`` naming it.
- ``logits_at(cfg, raw, seqs, spans, act, routes, router_logits)``: the
  plain reference (``check.py`` calls it): for each token sequence the
  f32 logits at the positions of its span; ``act`` rounds each
  projection's input ("f32", "bf16", "fp8"); ``routes`` the program's
  experts and gate weights to follow, or None; ``router_logits`` a list
  that receives the reference's own router logits, or None.
- ``forward_cost(d, groups, logit_rows, kv_bytes, act_peak) -> seconds``:
  the bound time of one forward (``mfu``): ``groups`` the (offset, rows)
  of each sequence in it, ``logit_rows`` the rows whose logits it takes.
- ``attention_sites``: ``(module, name)`` of every attention entry (K2-K6)
  that the model calls, under the name it is imported by there; ``name``
  is the entry's own name in ``tpu_llm_torch/ops/flash_attention.py``
  (``harness.ATTN_ENTRIES``). The ``Recorder`` wraps each of them.
- ``router_site``: ``(module, name)`` of the projection that computes a
  mixture's router logits (``routes.Routes`` keeps its output); None
  for an architecture without experts.
- ``wrap(rec)`` (optional): called once the ``Recorder`` has wrapped K1,
  the attention sites and the graph capture. A module that brings a
  kernel of its own wraps its entry here and notes each call with
  ``rec.note(kind, cost)`` under a kind of its own; ``cost(positions)``
  returns the tuple its metric reads from ``run.trace["calls"][kind]``.

Here every name delegates to the code the benchmark has always run for
this family: ``weights.py``, ``reference/model.py``, ``roofline.py``.
"""

from __future__ import annotations

from benchmark import roofline, weights
from benchmark.reference import model as reference

MODEL = "tpu_llm_torch.models.llama"
PAGED = "tpu_llm_torch.ops.paged_kv"

dims = weights.dims
draw = weights.draw
port_params = weights.port_params
port_config = weights.port_config
logits_at = reference.logits_at
forward_cost = roofline.forward_cost

attention_sites = (
    (MODEL, "flash_decode_attention"),            # K2
    (MODEL, "flash_decode_fused"),                # K3
    (MODEL, "flash_gqa_attention"),               # K4
    (PAGED, "flash_gqa_attention"),               # K4 under the paged engine
    (PAGED, "paged_flash_decode_attention"),      # K5, K6
)
router_site = (MODEL, "matmul")


def adapter(pcfg, cache_dtype, bos_id: int, device):
    from tpu_llm_torch.runtime.engine import ModelAdapter

    return ModelAdapter.llama(pcfg, cache_dtype, bos_id=bos_id, device=device)


def paged_engine(ctx, **kw):
    from tpu_llm_torch.runtime.paged_engine import PagedEngine

    return PagedEngine(ctx.params, ctx.pcfg, **kw)
