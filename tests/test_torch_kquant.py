"""The port's legacy-quant and K-quant weights against the JAX package on
the CPU: the numpy codecs byte for byte, GGUF files written by either
package read by the other, ``qtensor_from_ggml`` planes under each layout
switch (TPU_LLM_KQ_F32S, TPU_LLM_Q6K_PACK, TPU_LLM_Q23_INT8), the packing
transforms, and ``dequantize`` within the tolerances of
tests/test_quant.py (f32 planes 2e-5 of the host codec; bf16 planes
rtol 1/64, atol 3e-2)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
torch.set_num_threads(1)  # one intra-op thread a test process (xdist runs 6 on 8 cores)

from tpu_llm.io import gguf as jgg
from tpu_llm.quant import blocks as jblocks
from tpu_llm.quant import qtensor as jq
from tpu_llm_torch.io import gguf as tgg
from tpu_llm_torch.quant import blocks as tblocks
from tpu_llm_torch.quant import qtensor as tq

CODECS = ["q4_0", "q4_1", "q5_0", "q5_1", "q8_0", "q2_k", "q3_k", "q4_k", "q5_k", "q6_k"]
GGML = {c: getattr(jgg, f"GGML_{c.upper()}") for c in CODECS}
SWITCHES = [None, "TPU_LLM_KQ_F32S", "TPU_LLM_Q6K_PACK", "TPU_LLM_Q23_INT8"]


def np_plane(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def j_plane(a) -> np.ndarray:
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def to_torch(jqt) -> tq.QTensor:
    """A JAX QTensor's planes as a port QTensor (bf16 bits carried)."""
    def plane(a):
        if a is None:
            return None
        a = np.array(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)
    return tq.QTensor(plane(jqt.q), plane(jqt.scales), jqt.kind, plane(jqt.mins))


def assert_same_planes(t: tq.QTensor, j):
    assert t.kind == j.kind and t.shape == tuple(j.shape)
    assert t.scales.dtype == (torch.bfloat16 if np.asarray(j.scales).dtype.name == "bfloat16"
                              else torch.float32)
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
    np.testing.assert_array_equal(np_plane(t.scales), j_plane(j.scales))
    assert (t.mins is None) == (j.mins is None)
    if t.mins is not None:
        np.testing.assert_array_equal(np_plane(t.mins), j_plane(j.mins))


@pytest.mark.parametrize("codec", CODECS)
def test_block_codecs_match_jax_bytes(codec):
    x = np.random.default_rng(1).standard_normal(256 * 6).astype(np.float32) * 0.3
    raw = getattr(tblocks, f"quantize_{codec}")(x)
    assert raw == getattr(jblocks, f"quantize_{codec}")(x)
    np.testing.assert_array_equal(getattr(tblocks, f"dequantize_{codec}")(raw, x.size),
                                  getattr(jblocks, f"dequantize_{codec}")(raw, x.size))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_gguf_files_cross_read(tmp_path, writer):
    """A file of every block type written by one package reads back the
    same bytes and the same dequantized values through both readers."""
    rng = np.random.default_rng(2)
    arrs = {c: rng.standard_normal((8, 512)).astype(np.float32) for c in CODECS}
    path = str(tmp_path / "all.gguf")
    gg = tgg if writer == "port" else jgg
    gg.write_gguf(path, {"general.architecture": "llama"},
                  {f"{c}.weight": (a, GGML[c]) for c, a in arrs.items()})
    t, j = tgg.GGUFFile(path), jgg.GGUFFile(path)
    for c, a in arrs.items():
        name = f"{c}.weight"
        assert t.tensors[name].ggml_type == j.tensors[name].ggml_type == GGML[c]
        np.testing.assert_array_equal(np.asarray(t.raw(name)), np.asarray(j.raw(name)))
        got = t.dequantized(name)
        np.testing.assert_array_equal(got, j.dequantized(name))
        assert got.shape == a.shape and np.abs(got - a).mean() < 0.5


@pytest.mark.parametrize("switch", SWITCHES)
@pytest.mark.parametrize("codec", CODECS)
def test_qtensor_from_ggml_planes_match_jax(monkeypatch, codec, switch):
    if switch:
        monkeypatch.setenv(switch, "1")
    rows, row_len = 48, 512
    w = np.random.default_rng(3).standard_normal((rows, row_len)).astype(np.float32)
    raw = np.frombuffer(getattr(jblocks, f"quantize_{codec}")(w.reshape(-1)), np.uint8)
    tqt = tq.qtensor_from_ggml(GGML[codec], raw, rows, row_len)
    assert_same_planes(tqt, jq.qtensor_from_ggml(GGML[codec], raw, rows, row_len))


@pytest.mark.parametrize("switch", [None, "TPU_LLM_KQ_F32S"])
@pytest.mark.parametrize("codec", CODECS)
def test_dequantize_matches_jax_and_host_codec(monkeypatch, codec, switch):
    if switch:
        monkeypatch.setenv(switch, "1")
    K, N = 512, 64
    w = np.random.default_rng(7).normal(size=(K, N)).astype(np.float32)
    tqt, jqt = tq.quantize_tensor(w, codec), jq.quantize_tensor(w, codec)
    assert_same_planes(tqt, jqt)
    got = tq.dequantize(tqt).numpy()
    np.testing.assert_allclose(got, np.asarray(jq.dequantize(jqt, jnp.float32)),
                               rtol=0, atol=2e-5)
    host = getattr(jblocks, f"dequantize_{codec}")(
        getattr(jblocks, f"quantize_{codec}")(np.ascontiguousarray(w.T).reshape(-1)),
        w.size).reshape(N, K).T
    if tqt.scales.dtype == torch.bfloat16:
        np.testing.assert_allclose(got, host, rtol=1 / 64, atol=3e-2)
    else:
        np.testing.assert_allclose(got, host, atol=2e-5)


@pytest.mark.parametrize("kind", ["q2_k", "q3_k", "q6_k"])
def test_pack_transforms_match_jax(monkeypatch, kind):
    """pack_q2_k / pack_q3_k / pack_q6_k and pack_scales_bf16 on the
    int8-plane kinds give the JAX package's planes, and dequantize alike."""
    monkeypatch.setenv("TPU_LLM_Q23_INT8", "1")
    monkeypatch.setenv("TPU_LLM_KQ_F32S", "1")
    w = np.random.default_rng(4).normal(size=(512, 40)).astype(np.float32)
    tqt, jqt = tq.quantize_tensor(w, kind), jq.quantize_tensor(w, kind)
    assert tqt.kind == jqt.kind == kind
    pack = {"q2_k": "pack_q2_k", "q3_k": "pack_q3_k", "q6_k": "pack_q6_k"}[kind]
    tp, jp = getattr(tq, pack)(tqt), getattr(jq, pack)(jqt)
    assert_same_planes(tp, jp)
    np.testing.assert_array_equal(tq.dequantize(tp).numpy(), tq.dequantize(tqt).numpy())
    if kind != "q6_k":      # the JAX transform would cast q6_kp's qh plane too
        assert_same_planes(tq.pack_scales_bf16(tp), jq.pack_scales_bf16(jp))


@pytest.mark.parametrize("codec", ["q4_0", "q4_1", "q5_1", "q2_k", "q6_k"])
def test_pad_k_matches_jax(monkeypatch, codec):
    monkeypatch.setenv("TPU_LLM_Q6K_PACK", "1")      # q6_k pads as q6_kp, qh and all
    w = np.random.default_rng(5).normal(size=(768, 24)).astype(np.float32)
    tp, jp = tq.pad_k(tq.quantize_tensor(w, codec)), jq.pad_k(jq.quantize_tensor(w, codec))
    assert tp.shape == (1024, 24)
    assert_same_planes(tp, jp)
    d = tq.dequantize(tp)
    assert torch.equal(d[768:], torch.zeros_like(d[768:]))


def build_quant_gguf(path: str, ggml_type: int, seed: int = 0, gg=tgg, mixed: bool = False):
    """A tiny llama GGUF (2 layers, dim 256, ffn 256, 4 / 2 heads, the toy
    32-token vocab of tests/make_tiny_gguf.py) with every projection and
    the classifier in ``ggml_type`` — K-quants need rows of 256. ``mixed``
    stores attn_k as Q6_K: kinds then differ inside the fused q|k|v."""
    rng = np.random.default_rng(seed)
    dim, hidden, L, H, KVH, V = 256, 256, 2, 4, 2, 32
    kv = dim // H * KVH
    s = lambda *sh: (rng.standard_normal(sh) * 0.08).astype(np.float32)  # noqa: E731
    tokens = ["<unk>", "<s>", "</s>", "▁", "a", "b", "c", "▁ab", "ab", "bc",
              "▁abc"] + [f"tok{i}" for i in range(V - 11)]
    scores = np.asarray([0, 0, 0, 0, 0, 0, 0, 5.0, 4.0, 3.0, 6.0] + [0.0] * (V - 11),
                        np.float32)
    meta = {"general.architecture": "llama", "llama.block_count": L,
            "llama.embedding_length": dim, "llama.feed_forward_length": hidden,
            "llama.attention.head_count": H, "llama.attention.head_count_kv": KVH,
            "llama.context_length": 128, "llama.rope.freq_base": 10000.0,
            "llama.attention.layer_norm_rms_epsilon": 1e-5,
            "tokenizer.ggml.tokens": tokens, "tokenizer.ggml.scores": scores,
            "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2}
    wt = lambda a, t=ggml_type: (a, t)  # noqa: E731
    tensors = {"token_embd.weight": s(V, dim), "output_norm.weight": 1.0 + 0.1 * s(dim),
               "output.weight": wt(s(V, dim))}
    for i in range(L):
        tensors[f"blk.{i}.attn_norm.weight"] = 1.0 + 0.1 * s(dim)
        tensors[f"blk.{i}.ffn_norm.weight"] = 1.0 + 0.1 * s(dim)
        tensors[f"blk.{i}.attn_q.weight"] = wt(s(dim, dim))
        tensors[f"blk.{i}.attn_k.weight"] = wt(s(kv, dim), gg.GGML_Q6_K if mixed else ggml_type)
        tensors[f"blk.{i}.attn_v.weight"] = wt(s(kv, dim))
        tensors[f"blk.{i}.attn_output.weight"] = wt(s(dim, dim))
        tensors[f"blk.{i}.ffn_gate.weight"] = wt(s(hidden, dim))
        tensors[f"blk.{i}.ffn_up.weight"] = wt(s(hidden, dim))
        tensors[f"blk.{i}.ffn_down.weight"] = wt(s(dim, hidden))
    gg.write_gguf(path, meta, tensors)
