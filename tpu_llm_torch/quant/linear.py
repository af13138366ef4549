"""Linear-layer dispatch (``tpu_llm/quant/linear.py::matmul``): dense
tensors or packed QTensors.

A QTensor goes to the fused dequant-matmul (quant/qmatmul.py: the CUDA
kernel for CUDA tensors, its plain twin on the CPU). A dense weight goes
to ``torch.matmul`` with f32 accumulation, as the JAX package leaves it to
XLA. Float32 products run in full f32 on the card: TF32 is switched off
below, for matmuls and for cuDNN alike.

``row_scale`` (K,) is a folded norm weight: the kernel multiplies x by it
in f32; a dense weight gets the plain broadcast multiply, rounded back to
x's dtype as the JAX package's XLA path does. A K-padded QTensor
(``qtensor.pad_k``) gets x, and row_scale, zero-padded to its K.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from tpu_llm_torch.quant.qmatmul import qmatmul
from tpu_llm_torch.quant.qtensor import QTensor

# reference numerics: f32 products stay f32 (TF32 keeps ~3 decimal digits)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

Weight = Union[torch.Tensor, QTensor]


def matmul(x: torch.Tensor, w: Weight, out_dtype=None,
           row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(x * row_scale) (..., K) @ w (K, N) -> (..., N), accumulated in f32.

    ``out_dtype`` defaults to x.dtype; pass torch.float32 to keep the f32
    accumulator unrounded (the classifier's logits)."""
    out_dtype = out_dtype or x.dtype
    if isinstance(w, QTensor):
        Kq, K = w.shape[-2], x.shape[-1]
        if Kq > K:
            x = F.pad(x, (0, Kq - K))
            if row_scale is not None:
                row_scale = F.pad(row_scale, (0, Kq - K))
        return qmatmul(x, w, out_dtype=out_dtype, row_scale=row_scale)
    if row_scale is not None:
        x = (x.float() * row_scale).to(x.dtype)
    if x.dtype == w.dtype == out_dtype:
        return torch.matmul(x, w)      # f32 accumulate, one rounding at the end
    return torch.matmul(x.float(), w.float()).to(out_dtype)
