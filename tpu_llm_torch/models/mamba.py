"""Mamba selective-state-space model (Mamba-130M / 790M; the port of
``tpu_llm/models/mamba.py``, the reference's ``ssm/`` path).

``forward(params, cfg, tokens, state, length)`` runs decode (T = 1) and
prefill (T > 1). The recurrent state is a dict of per-layer lists,
``conv`` (B, d_conv, d_inner) and ``ssm`` (B, d_state, d_inner), f32, and
is written IN PLACE: the engines pass views of their own state (a batch
slot, the static state of a captured decode step) and rely on the model
writing into them. The returned state holds the same tensors.

Numerics pinned to the reference step (``ssm/mamba.f90:511-665``): fused
add-norm residual stream (xb = rmsnorm(h + res); res = h + res), causal
depthwise conv as a shift register, softplus(dt @ dt_proj + bias),
A = -exp(A_log), dA = exp(dt ⊗ A), dB = dt ⊗ B, state = state·dA + x ⊗ dB,
y = Cᵀ·state + D·x, gate y·silu(z).

Prefill is time-parallel, as in the JAX package: every projection is one
full-sequence matmul, the conv a sum of shifted slices, and the
first-order recurrence state_t = dA_t·state_{t-1} + dBx_t a log-depth
doubling scan over T with the combine (a1, b1)∘(a2, b2) = (a2·a1,
a2·b1 + b2) (the JAX package uses ``jax.lax.associative_scan``). The
incoming state is folded into the first element, so the scanned b is the
state at every position; it multiplies factors of dA <= 1 and never
divides, so it does not underflow where exp(cumsum(dt·A)) differences
would. Positions at or past ``length`` take the identity element (dA = 1,
dBx = 0): the last state is the state after exactly ``length`` tokens.
``sequential=True`` runs the exact step recurrence over T instead (the
numerics oracle).

Weights: ``cast_weights`` (serving mode) stores the four projections, the
embedding and the classifier in bf16; the small per-channel leaves (norm,
conv, dt bias, A_log, D) are rounded to bf16 values but kept in f32, so
the elementwise work reads them as they are. A bf16 projection takes its
activation cast down to bf16 (its product rounded to bf16, then widened),
never its weight widened; the state and the residual stream stay f32.
The fused in_proj / x_proj are sliced, not split (the JAX package's
``split_projections`` layout was measured neutral there and is not
ported).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_llm_torch.config import MambaConfig
from tpu_llm_torch.ops.activations import silu, softplus
from tpu_llm_torch.ops.norms import rmsnorm

Params = Dict[str, Any]
State = Dict[str, List[torch.Tensor]]

# the leaves cast_weights stores in bf16 (the rest keep f32 storage)
_MATRICES = ("in_proj", "x_proj", "dt_proj", "out_proj", "tok_emb", "wcls")


def init_state(cfg: MambaConfig, batch: int = 1, device="cpu") -> State:
    """Zeroed per-layer conv and SSM state, f32."""
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    return {"conv": [zeros(batch, cfg.d_conv, cfg.d_inner) for _ in range(cfg.n_layers)],
            "ssm": [zeros(batch, cfg.d_state, cfg.d_inner) for _ in range(cfg.n_layers)]}


def cast_weights(params: Params, dtype=torch.bfloat16) -> Params:
    """Weight-only cast (serving mode): projections, embedding and
    classifier -> ``dtype``; the per-channel leaves take ``dtype``'s
    values in f32 storage (see the module docstring). The state and every
    accumulation stay f32."""
    def cast(k, v):
        return v.to(dtype) if k in _MATRICES else v.to(dtype).float()

    out = {k: cast(k, v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: cast(k, v) for k, v in lp.items()} for lp in params["layers"]]
    return out


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with an f32 result; a bf16 ``w`` takes x cast down."""
    if w.dtype == torch.float32:
        return torch.matmul(x, w)
    return torch.matmul(x.to(w.dtype), w).float()


def _mixer_step(cfg: MambaConfig, lp, xb, conv_state, ssm_state):
    """One token through one mixer. xb: (B, E). Writes the new conv and
    SSM state into ``conv_state`` / ``ssm_state``; returns (B, E)."""
    di, ds, dr = cfg.d_inner, cfg.d_state, cfg.dt_rank_
    xz = _mm(xb, lp["in_proj"])
    x, z = xz[:, :di], xz[:, di:]
    # causal depthwise conv as a shift register (ssm/mamba.f90:616-621)
    conv_state.copy_(torch.cat([conv_state[:, 1:], x[:, None, :]], dim=1))
    x = silu((conv_state * lp["conv_w"]).sum(dim=1) + lp["conv_b"])
    x_db = _mm(x, lp["x_proj"])
    dt = softplus(_mm(x_db[:, :dr], lp["dt_proj"]) + lp["dt_bias"])      # (B, di)
    Bv, Cv = x_db[:, dr:dr + ds], x_db[:, dr + ds:]
    dA = torch.exp(dt[:, None, :] * -torch.exp(lp["A_log"]))             # (B, ds, di)
    ssm_state.mul_(dA).add_((dt * x)[:, None, :] * Bv[:, :, None])
    y = (ssm_state * Cv[:, :, None]).sum(dim=1) + lp["d"] * x
    return _mm(y * silu(z), lp["out_proj"])


def _token_step(params, cfg: MambaConfig, emb, state: State) -> torch.Tensor:
    """All layers for one token: emb (B, E) -> final-normed hidden (B, E)."""
    hidden, residual = emb, torch.zeros_like(emb)
    for i, lp in enumerate(params["layers"]):
        residual = hidden + residual
        xb = rmsnorm(residual, lp["norm"], cfg.norm_eps)
        hidden = _mixer_step(cfg, lp, xb, state["conv"][i], state["ssm"][i])
    return rmsnorm(hidden + residual, params["norm_f"], cfg.norm_eps)


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of (a, b) over dim 1 under (a1, b1)∘(a2, b2) =
    (a2·a1, a2·b1 + b2), doubling the reach each round (Hillis-Steele):
    the b of every prefix. Out of place, so a round reads the previous
    round's values only."""
    T, s = a.shape[1], 1
    while s < T:
        b = torch.cat([b[:, :s], torch.addcmul(b[:, s:], a[:, s:], b[:, :-s])], dim=1)
        if 2 * s < T:
            a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


def _mixer_scan(cfg: MambaConfig, lp, xb, conv_state, ssm_state, length: int):
    """Full-sequence mixer, time-parallel. xb: (B, T, E) -> (B, T, E);
    the state after ``length`` tokens is written into the given tensors."""
    B, T, _ = xb.shape
    di, ds, dr, dc = cfg.d_inner, cfg.d_state, cfg.dt_rank_, cfg.d_conv
    xz = _mm(xb, lp["in_proj"])
    x, z = xz[..., :di], xz[..., di:]
    # the incoming shift register gives the conv its left context
    padded = torch.cat([conv_state[:, 1:], x], dim=1)            # (B, dc-1+T, di)
    conv_w = lp["conv_w"]
    x_conv = padded[:, 0:T] * conv_w[0]
    for j in range(1, dc):
        x_conv = x_conv + padded[:, j:j + T] * conv_w[j]
    x = silu(x_conv + lp["conv_b"])
    x_db = _mm(x, lp["x_proj"])
    dt = softplus(_mm(x_db[..., :dr], lp["dt_proj"]) + lp["dt_bias"])   # (B, T, di)
    Bv, Cv = x_db[..., dr:dr + ds], x_db[..., dr + ds:]
    dA = torch.exp(dt[:, :, None, :] * -torch.exp(lp["A_log"]))         # (B, T, ds, di)
    dBx = (dt * x)[:, :, None, :] * Bv[..., None]
    if length < T:
        dA[:, length:] = 1.0
        dBx[:, length:] = 0.0
    # fold the incoming state into the first element: the scanned b is
    # the state at every position
    dBx[:, 0] = torch.addcmul(dBx[:, 0], dA[:, 0], ssm_state)
    states = _scan(dA, dBx)
    del dA, dBx
    y = torch.einsum("btsd,bts->btd", states, Cv) + lp["d"] * x
    conv_state.copy_(padded[:, length - 1:length - 1 + dc])
    ssm_state.copy_(states[:, -1])
    return _mm(y * silu(z), lp["out_proj"])


def forward(params: Params, cfg: MambaConfig, tokens: torch.Tensor, state: State,
            length: Optional[int] = None, sequential: bool = False
            ) -> Tuple[torch.Tensor, State]:
    """tokens (B, T) -> (hidden (B, T, E) f32, state). ``length`` (an int)
    is the valid prefix of a right-padded prompt: later positions do not
    advance the state (their hidden rows are computed and meaningless).
    ``sequential`` runs the exact step recurrence (the oracle)."""
    B, T = tokens.shape
    emb = params["tok_emb"][tokens].float()                       # (B, T, E)
    if T == 1:
        return _token_step(params, cfg, emb[:, 0], state)[:, None, :], state
    length = T if length is None else int(length)
    if sequential:
        outs = []
        for t in range(T):
            # a padded position steps a copy: the state stays at ``length``
            st = state if t < length else {k: [s.clone() for s in v]
                                           for k, v in state.items()}
            outs.append(_token_step(params, cfg, emb[:, t], st))
        return torch.stack(outs, dim=1), state
    hidden, residual = emb, torch.zeros_like(emb)
    for i, lp in enumerate(params["layers"]):
        residual = hidden + residual
        xb = rmsnorm(residual, lp["norm"], cfg.norm_eps)
        hidden = _mixer_scan(cfg, lp, xb, state["conv"][i], state["ssm"][i], length)
    return rmsnorm(hidden + residual, params["norm_f"], cfg.norm_eps), state


def lm_head(params: Params, cfg: MambaConfig, x: torch.Tensor) -> torch.Tensor:
    return _mm(x.float(), params["wcls"])


# -- loading -----------------------------------------------------------------

def load_packed(path: str, device="cpu") -> Tuple[Params, MambaConfig]:
    """The reference's packed Mamba checkpoint (``io/mamba_ckpt.py``)."""
    from tpu_llm_torch.io.mamba_ckpt import read_packed

    return read_packed(path, device)


def params_from_numpy(tree: Params, device="cpu") -> Params:
    """The JAX package's Mamba parameter pytree, every array as numpy
    (stacked (L, ...) layers or the per-layer list of ``unstack_layers``;
    bf16 as ml_dtypes arrays) -> the port's parameters on ``device``: the
    per-layer list, the per-channel leaves in f32 storage."""
    from tpu_llm_torch.quant.qtensor import plane_from_numpy

    def leaf(k, a):
        t = plane_from_numpy(a, device)
        return t if k in _MATRICES else t.float()

    layers = tree["layers"]
    if isinstance(layers, dict):
        n = len(next(iter(layers.values())))
        layers = [{k: np.asarray(v)[i] for k, v in layers.items()} for i in range(n)]
    out = {k: leaf(k, v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [{k: leaf(k, v) for k, v in lp.items()} for lp in layers]
    return out
