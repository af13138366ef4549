"""Packed weights of the port against tpu_llm.quant.qtensor: the same ggml
bytes give the same device planes and the same dequantized values."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpu_llm.io import gguf as jgg
from tpu_llm.quant import blocks as jblocks
from tpu_llm.quant import qtensor as jq
from tpu_llm_torch.io import gguf as tgg
from tpu_llm_torch.quant import blocks as tblocks
from tpu_llm_torch.quant import qtensor as tq

KINDS = {"q4_0": (jgg.GGML_Q4_0, jblocks.quantize_q4_0),
         "q8_0": (jgg.GGML_Q8_0, jblocks.quantize_q8_0)}


@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
@pytest.mark.parametrize("rows,row_len", [(32, 64), (96, 256), (7, 96)])
def test_dequantize_matches_jax_exactly(kind, rows, row_len):
    rng = np.random.default_rng(rows + row_len)
    w = rng.standard_normal((rows, row_len)).astype(np.float32)
    ttype, quant = KINDS[kind]
    raw = np.frombuffer(quant(w.reshape(-1)), np.uint8)
    jqt = jq.qtensor_from_ggml(ttype, raw, rows, row_len)
    tqt = tq.qtensor_from_ggml(ttype, raw, rows, row_len)
    assert tqt.kind == jqt.kind and tqt.shape == tuple(jqt.shape) == (row_len, rows)
    np.testing.assert_array_equal(tqt.q.numpy(), np.asarray(jqt.q))
    np.testing.assert_array_equal(tqt.scales.numpy(), np.asarray(jqt.scales))
    np.testing.assert_allclose(tq.dequantize(tqt).numpy(),
                               np.asarray(jq.dequantize(jqt, jnp.float32)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
def test_quantize_tensor_matches_jax(kind):
    rng = np.random.default_rng(5)
    w = rng.standard_normal((128, 48)).astype(np.float32)
    a = tq.quantize_tensor(w, kind)
    b = jq.quantize_tensor(w, kind)
    np.testing.assert_array_equal(a.q.numpy(), np.asarray(b.q))
    np.testing.assert_array_equal(a.scales.numpy(), np.asarray(b.scales))


@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
def test_block_codecs_match_jax(kind):
    rng = np.random.default_rng(9)
    x = rng.standard_normal(32 * 20).astype(np.float32)
    tquant = getattr(tblocks, f"quantize_{kind}")
    tdeq = getattr(tblocks, f"dequantize_{kind}")
    raw = tquant(x)
    assert raw == getattr(jblocks, f"quantize_{kind}")(x)
    np.testing.assert_array_equal(tdeq(raw, x.size),
                                  getattr(jblocks, f"dequantize_{kind}")(raw, x.size))


def test_other_kinds_name_their_slice():
    """q4_0i4 is made only by to_int4: quantize_tensor refuses it with a
    ValueError, as the JAX package does; int16 (f16-bit) scale planes
    dequantize as the JAX package's; an unknown ggml type is refused."""
    with pytest.raises(ValueError):
        tq.quantize_tensor(np.zeros((32, 32), np.float32), "q4_0i4")
    with pytest.raises(ValueError):
        jq.quantize_tensor(np.zeros((32, 32), np.float32), "q4_0i4")
    rng = np.random.default_rng(4)
    bits = (rng.integers(0, 0x7C00, (1, 8)) | (rng.integers(0, 2, (1, 8)) << 15))
    bits = bits.astype(np.uint16).view(np.int16)
    q = rng.integers(0, 256, (16, 8)).astype(np.uint8)
    int16_planes = tq.QTensor(torch.from_numpy(q), torch.from_numpy(bits), "q4_0")
    want = jq.dequantize(jq.QTensor(jnp.asarray(q), jnp.asarray(bits), "q4_0"), jnp.float32)
    np.testing.assert_array_equal(tq.dequantize(int16_planes).numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        tq.qtensor_from_ggml(tgg.GGML_Q8_1, np.zeros(36, np.uint8), 1, 32)


def test_gguf_roundtrip_matches_jax_reader(tmp_path):
    """A file written by the port's write_gguf reads back the same through
    both readers (metadata, f32/q4_0/q8_0 tensors)."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((8, 64)).astype(np.float32)
    path = str(tmp_path / "x.gguf")
    tgg.write_gguf(path, {"general.architecture": "llama", "llama.block_count": 3,
                          "tokenizer.ggml.tokens": ["a", "b"]},
                   {"f": a, "q4": (a, tgg.GGML_Q4_0), "q8": (a, tgg.GGML_Q8_0)})
    t, j = tgg.GGUFFile(path), jgg.GGUFFile(path)
    assert t.metadata["llama.block_count"] == j.metadata["llama.block_count"] == 3
    assert list(t.metadata["tokenizer.ggml.tokens"]) == ["a", "b"]
    for name in ("f", "q4", "q8"):
        np.testing.assert_array_equal(t.dequantized(name), j.dequantized(name))
        np.testing.assert_array_equal(np.asarray(t.raw(name)), np.asarray(j.raw(name)))
    np.testing.assert_array_equal(t.dequantized("f"), a)
