"""CUDA graphs over the decode path: the port's counterpart of the JAX
package's all-on-device loops (``lax.scan`` / ``while_loop`` in
``tpu_llm/runtime/engine.py``).

``CapturedStep(fn, device)`` records ``fn()`` once in a
``torch.cuda.CUDAGraph`` and replays it. ``fn`` must read and write only
tensors that outlive the graph (the caller's static buffers, the KV cache,
the weights) and must not read anything on the host: positions, tokens,
counters and seeds live in device tensors that ``fn`` updates itself, so
every replay is the next step. Scratch tensors ``fn`` allocates come from
the graph's private memory pool. On the CPU there is no graph: the step
runs eagerly on each call, so the same step code is tested there.

Warm-up: ``warmup`` eager runs of ``fn`` on a side stream before the
capture (the first launch of a kernel builds the library, the first
cuBLAS call makes its handle; neither may happen while capturing). They
are real steps: the caller counts them as such. A capture that fails
raises (``--scan`` on the card never falls back to the step loop).

Launch counts: each kernel wrapper counts on the host where it launches,
so a capture would count launches that did not happen and a replay none
of those it makes. ``CapturedStep`` takes back what the capture counted
and adds it again on every replay: ``launches`` stays the number of
kernel launches the card ran. ``per_replay`` holds those counts; the
wrappers they belong to are looked up once, at capture.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def counted_kernels() -> Dict[str, Callable]:
    """The kernel wrappers with a ``launches`` count, by name."""
    from tpu_llm_torch.ops import flash_attention as FA
    from tpu_llm_torch.quant import ffn, qmatmul

    return {"qmatmul": qmatmul.qmatmul, "ffn_fused": ffn.ffn_fused,
            "flash_decode_attention": FA.flash_decode_attention,
            "flash_decode_fused": FA.flash_decode_fused,
            "flash_gqa_attention": FA.flash_gqa_attention,
            "paged_flash_decode_attention": FA.paged_flash_decode_attention,
            "paged_flash_decode_q": FA.paged_flash_decode_q}


def _counts() -> Dict[str, int]:
    return {n: f.launches for n, f in counted_kernels().items()}


class CapturedStep:
    """``fn`` captured in a CUDA graph on a CUDA ``device`` (after
    ``warmup`` eager runs), or run eagerly on the CPU."""

    def __init__(self, fn: Callable[[], None], device, warmup: int = 1):
        self.fn = fn
        self.device = torch.device(device)
        self.graph = None
        self.per_replay: Dict[str, int] = {}
        self._counted = []                       # (wrapper, launches a replay)
        self.replays = 0
        if self.device.type != "cuda":
            for _ in range(warmup):
                fn()
            return
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(warmup):
                fn()
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            fn()
        after = _counts()
        torch.cuda.current_stream(self.device).wait_stream(side)
        wrappers = counted_kernels()
        for name, n in before.items():
            wrappers[name].launches = n          # the capture launched nothing
            if after[name] != n:
                self.per_replay[name] = after[name] - n
                self._counted.append((wrappers[name], after[name] - n))
        self.graph = graph

    def __call__(self):
        if self.graph is None:
            self.fn()
            return
        self.graph.replay()
        self.replays += 1
        for wrapper, n in self._counted:
            wrapper.launches += n
