"""Linear-layer dispatch (``tpu_llm/quant/linear.py::matmul``): dense
tensors or packed QTensors.

A QTensor goes to the fused dequant-matmul (quant/qmatmul.py: the CUDA
kernel for CUDA tensors, its plain twin on the CPU). A dense weight goes
to ``torch.matmul`` with f32 accumulation, as the JAX package leaves it to
XLA. Float32 products run in full f32 on the card: TF32 is switched off
below, for matmuls and for cuDNN alike. K-padded QTensors and the folded
norm ``row_scale`` come with the ``--fold-norms`` slice.
"""

from __future__ import annotations

from typing import Union

import torch

from tpu_llm_torch.quant.qmatmul import qmatmul
from tpu_llm_torch.quant.qtensor import QTensor

# reference numerics: f32 products stay f32 (TF32 keeps ~3 decimal digits)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

Weight = Union[torch.Tensor, QTensor]


def matmul(x: torch.Tensor, w: Weight, out_dtype=None) -> torch.Tensor:
    """x (..., K) @ w (K, N) -> (..., N), accumulated in f32.

    ``out_dtype`` defaults to x.dtype; pass torch.float32 to keep the f32
    accumulator unrounded (the classifier's logits)."""
    out_dtype = out_dtype or x.dtype
    if isinstance(w, QTensor):
        return qmatmul(x, w, out_dtype=out_dtype)
    if x.dtype == w.dtype == out_dtype:
        return torch.matmul(x, w)      # f32 accumulate, one rounding at the end
    return torch.matmul(x.float(), w.float()).to(out_dtype)
