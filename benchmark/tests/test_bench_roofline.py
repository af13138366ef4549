"""The roofline's operations and bytes against hand counts: K1 at one Qwen2
shape, and one Mixtral decode step."""

import pytest

import tiny_cells  # noqa: F401
from benchmark import roofline, weights
from benchmark.harness import load_json
from tiny_cells import ROOT


def test_k1_at_qwen2_wqkv_one_row():
    # x (1, 3584) bf16 @ wqkv (3584, 4608) q4_0 -> (1, 4608) bf16
    w = 3584 * 4608 // 2 + 112 * 4608 * 4          # nibbles + f32 scales
    assert w == 8_257_536 + 2_064_384
    ops, nb = roofline.k1_call(1, 3584, 4608, 2, 2, roofline.q4_0_bytes(3584, 4608))
    assert ops == 33_030_144
    assert nb == 10_321_920 + 7_168 + 9_216
    assert roofline.bound_s(ops, nb) == pytest.approx(10_338_304 / 3.35e12)


def test_k1_at_a_prefill_chunk_is_bound_by_operations():
    ops, nb = roofline.k1_call(512, 3584, 37888, 2, 2, roofline.q4_0_bytes(3584, 37888))
    assert ops == 2 * 512 * 3584 * 37888
    assert roofline.bound_s(ops, nb) == pytest.approx(ops / 989e12)


def test_one_mixtral_decode_step():
    d = weights.dims(load_json(ROOT, "benchmark/configs/mixtral-8x7b.json")["config"])
    # a layer: wqkv 4096 x 6144, wo 4096 x 4096, the 2 selected experts'
    # w1, w3 (4096 x 14336) and w2 (14336 x 4096), the f32 router 4096 x 8
    wqkv = 4096 * 6144 // 2 + 128 * 6144 * 4
    wo = 4096 * 4096 // 2 + 128 * 4096 * 4
    expert = 3 * (4096 * 14336 // 2 + 128 * 14336 * 4)
    layer = wqkv + wo + 2 * expert + 4096 * 8 * 4
    assert (wqkv, wo, expert, layer) == (15_728_640, 10_485_760, 110_100_480, 246_546_432)
    cls = 4096 * 32000 // 2 + 128 * 32000 * 4
    kv = 32 * (1000 * 1024 * 2 * 2 + 1 * 1024 * 2 * 2)   # read rows 0..999, write row 999
    total = 32 * layer + cls + kv + 4096 * 2 + 32000 * 4
    assert total == 8_102_745_088
    t = roofline.forward_cost(d, [(999, 1)], 1, kv_bytes=2)
    assert t == pytest.approx(total / 3.35e12)


def test_moe_union_and_attention_counts():
    assert roofline.expected_union(8, 2, 1) == 2
    assert roofline.expected_union(8, 2, 16) == pytest.approx(8 * (1 - 0.75 ** 16))
    ops, nb = roofline.decode_attn_call([9, 0], H=4, Hkv=2, D=8, q_bytes=4, kv_bytes=2)
    assert ops == 4 * 4 * 8 * (10 + 1)
    assert nb == 2 * (10 + 1) * 2 * 8 * 2 + 2 * (2 * 4 * 8 * 4)
    ops, nb = roofline.prefill_attn_call(1, 4, 2, H=2, Hkv=1, D=8, q_bytes=2, kv_bytes=2)
    assert ops == 4 * 2 * 8 * (3 + 4 + 5 + 6)
    assert nb == 2 * 6 * 8 * 2 + 2 * 4 * 2 * 8 * 2
