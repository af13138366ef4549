"""The plain reference against the port on tiny seeded models on the CPU
(a test may import the port; the reference may not): Qwen2's layout
(q/k/v biases, neox RoPE, dense SwiGLU) and Mixtral's (interleaved RoPE,
the MoE FFN), a whole-prompt forward and decode steps through the cache,
in f32."""

import pytest
import torch

import tiny_cells
from benchmark import weights
from benchmark.reference import model as reference


def port_logits(raw, cfg, ids, n_decode):
    """Logits of the port at every prompt position (one forward), then at
    ``n_decode`` decode steps fed the next ids."""
    from tpu_llm_torch.models import llama as M

    params = weights.port_params(raw)
    params["tok_emb"] = params["tok_emb"].float()        # f32 activations
    pcfg = weights.port_config(cfg)
    T = len(ids) - n_decode
    cache = M.init_cache(pcfg, 1, len(ids) + 1, torch.float32, "cpu")
    x, cache = M.forward(params, pcfg, torch.tensor([ids[:T]]), cache, 0)
    out = [M.lm_head(params, pcfg, x)[0]]
    for p in range(T, len(ids)):
        lg, cache = M.decode_step(params, pcfg, torch.tensor([ids[p]]), cache, p)
        out.append(lg)
    return torch.cat(out)


@pytest.mark.parametrize("name", ["qwen2-7b", "mixtral-8x7b"])
def test_reference_matches_the_port(name):
    cfg = tiny_cells.tiny_config(name)["config"]
    raw = weights.draw(cfg, 2 ** 31 + 5, "cpu")
    ids = torch.randint(3, 250, (20,), generator=torch.Generator().manual_seed(1)).tolist()
    want = port_logits(raw, cfg, ids, n_decode=6)
    (got,) = reference.logits_at(cfg, raw, [ids], [(0, len(ids))])
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err
    # the served-token gaps of the port's own greedy choices are nought
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_q4_0_decoder_matches_the_port():
    from tpu_llm_torch.quant.qtensor import QTensor, dequantize

    cfg = tiny_cells.tiny_config("qwen2-7b")["config"]
    raw = weights.draw(cfg, 9, "cpu")
    w = raw["layers"][1]["w13"]
    assert torch.equal(reference.dequant_q4_0(w), dequantize(QTensor(w["q"], w["s"], "q4_0")))


def test_lower_precision_moves_the_logits():
    cfg = tiny_cells.tiny_config("mixtral-8x7b")["config"]
    raw = weights.draw(cfg, 3, "cpu")
    ids = list(range(3, 40))
    (f32,) = reference.logits_at(cfg, raw, [ids], [(0, len(ids))], "f32")
    (bf16,) = reference.logits_at(cfg, raw, [ids], [(0, len(ids))], "bf16")
    (fp8,) = reference.logits_at(cfg, raw, [ids], [(0, len(ids))], "fp8")
    e16, e8 = (bf16 - f32).abs().max(), (fp8 - f32).abs().max()
    assert 0 < e16 < e8
