"""Mamba packed checkpoint format (the reference's ssm/ path; a copy of
``tpu_llm/io/mamba_ckpt.py`` that reads into the port's per-layer list).

Layout (pinned by reader ``ssm/mamba.f90:172-325``, writer
``ssm/savemodel.py:44-102``):

  header: 7 x i32 — d_model, 0, n_layer, 0, 0, vocab_size, 0
  then f32 tensors, each group storing all layers consecutively
  (torch row-major bytes == the Fortran column-major reads):
    token_embedding (vocab, d_model)
    D          L x (d_inner,)
    in_proj    L x (2*d_inner, d_model)
    conv1d     L x (d_inner, d_conv)         # torch (d_inner, 1, d_conv)
    conv1d_b   L x (d_inner,)
    x_proj     L x (dt_rank + 2*d_state, d_inner)
    dt_proj    L x (d_inner, dt_rank)
    dt_proj_b  L x (d_inner,)
    A_log      L x (d_inner, d_state)
    out_proj   L x (d_model, d_inner)
    norm       L x (d_model,)
    norm_f     (d_model,)
    lm_head    (vocab, d_model)

Derived dims: d_inner = 2*d_model, dt_rank = ceil(d_model/16); constants
d_conv=4, d_state=16 (ssm/mamba.f90:106-109,177-179).
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np
import torch

from tpu_llm_torch.config import MambaConfig

# the per-layer groups in file order: (file key, model key, transposed)
_GROUPS = (("D", "d", False), ("in_proj", "in_proj", True), ("conv_w", "conv_w", True),
           ("conv_b", "conv_b", False), ("x_proj", "x_proj", True),
           ("dt_proj", "dt_proj", True), ("dt_bias", "dt_bias", False),
           ("A_log", "A_log", True), ("out_proj", "out_proj", True),
           ("norm", "norm", False))


def read_packed(path: str, device="cpu") -> Tuple[Dict, MambaConfig]:
    """-> (params, cfg): the port's parameters on ``device``, projections in
    x @ W orientation, one dict a layer."""
    with open(path, "rb") as f:
        d_model, _, n_layers, _, _, vocab, _ = struct.unpack("<7i", f.read(28))
        cfg = MambaConfig(d_model=d_model, n_layers=n_layers, vocab_size=vocab)
        di, ds, dr, dc = cfg.d_inner, cfg.d_state, cfg.dt_rank_, cfg.d_conv
        shapes = {"D": (di,), "in_proj": (2 * di, d_model), "conv_w": (di, dc),
                  "conv_b": (di,), "x_proj": (dr + 2 * ds, di), "dt_proj": (di, dr),
                  "dt_bias": (di,), "A_log": (di, ds), "out_proj": (d_model, di),
                  "norm": (d_model,)}

        def rd(*shape):
            n = int(np.prod(shape))
            a = np.fromfile(f, dtype=np.float32, count=n)
            if a.size != n:
                raise EOFError(f"{path}: truncated reading {shape}")
            return a.reshape(shape)

        tok_emb = rd(vocab, d_model)
        groups = {key: [rd(*shapes[key]) for _ in range(n_layers)] for key, _, _ in _GROUPS}
        norm_f = rd(d_model)
        wcls = rd(vocab, d_model)
        if f.read(4):
            raise ValueError(f"{path}: did not reach EOF, check weights")

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    layers = [{mk: t(groups[fk][i].T if tr else groups[fk][i]) for fk, mk, tr in _GROUPS}
              for i in range(n_layers)]
    return {"tok_emb": t(tok_emb), "norm_f": t(norm_f), "wcls": t(wcls.T),
            "layers": layers}, cfg


def write_packed(path: str, arrays: Dict[str, np.ndarray], cfg: MambaConfig):
    """Write the packed format from numpy arrays in TORCH orientation
    (the shapes listed in the module docstring)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<7i", cfg.d_model, 0, cfg.n_layers, 0, 0, cfg.vocab_size, 0))

        def wr(a):
            f.write(np.ascontiguousarray(a, dtype=np.float32).tobytes())

        wr(arrays["tok_emb"])
        for key, _, _ in _GROUPS:
            for layer in range(cfg.n_layers):
                wr(arrays[key][layer])
        wr(arrays["norm_f"])
        wr(arrays["wcls"])


def convert_hf_mamba(model_dir: str, out_path: str, verbose: bool = False) -> MambaConfig:
    """HF Mamba (pytorch_model.bin + config.json) -> packed format: the
    reference's ssm/savemodel.py converter."""
    import json
    import os

    with open(os.path.join(model_dir, "config.json")) as fh:
        hf = json.load(fh)
    sd = torch.load(os.path.join(model_dir, "pytorch_model.bin"), map_location="cpu",
                    weights_only=True)
    sd = {k: v.float().numpy() for k, v in sd.items()}
    emb = sd["backbone.embedding.weight"]
    n_layers = hf["n_layer"] if "n_layer" in hf else hf["num_hidden_layers"]
    cfg = MambaConfig(
        d_model=hf["d_model"] if "d_model" in hf else hf["hidden_size"],
        n_layers=n_layers,
        vocab_size=emb.shape[0],  # the real vocab, from the embedding (savemodel.py:43)
    )
    names = {"D": "mixer.D", "in_proj": "mixer.in_proj.weight",
             "conv_w": "mixer.conv1d.weight", "conv_b": "mixer.conv1d.bias",
             "x_proj": "mixer.x_proj.weight", "dt_proj": "mixer.dt_proj.weight",
             "dt_bias": "mixer.dt_proj.bias", "A_log": "mixer.A_log",
             "out_proj": "mixer.out_proj.weight", "norm": "norm.weight"}
    arrays = {key: np.stack([sd[f"backbone.layers.{i}.{name}"] for i in range(n_layers)])
              for key, name in names.items()}
    arrays["conv_w"] = arrays["conv_w"].reshape(n_layers, cfg.d_inner, cfg.d_conv)
    arrays.update(tok_emb=emb, norm_f=sd["backbone.norm_f.weight"],
                  wcls=sd.get("lm_head.weight", emb))    # tied when absent
    write_packed(out_path, arrays, cfg)
    if verbose:
        print(f"wrote {out_path}: {cfg}")
    return cfg
