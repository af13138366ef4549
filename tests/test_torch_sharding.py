"""The port's sharding specs and cuts (tpu_llm_torch.parallel.sharding)
against tpu_llm.parallel.sharding on the CPU: the spec table for the
llama, qwen2, gemma, phi-2 and MoE layouts and its error; each rank's
slice of dense and quantized tensors equal, plane for plane, to the
shards shard_pytree places on the JAX package's virtual devices; the
block-boundary errors; the local cache and pool shapes."""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a test process (xdist runs 6 on 8 cores)

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from tests.make_tiny_gguf import build, build_moe
from tests.test_torch_families import _jax_load, write_family
from tests.test_torch_kquant import j_plane, np_plane, to_torch
from tpu_llm.parallel import make_mesh as jmake_mesh
from tpu_llm.parallel import sharding as JS
from tpu_llm.quant import qtensor as jq
from tpu_llm_torch.config import LlamaConfig as TConfig
from tpu_llm_torch.parallel import sharding as TS
from tpu_llm_torch.parallel.mesh import Mesh


def _fake_mesh(data, model, index=0):
    """A mesh's coordinates without a process group (nothing here runs a
    collective)."""
    return Mesh(data, model, index, torch.device("cpu"), "gloo",
                ranks=list(range(data * model)))


def _kind(spec):
    axes = tuple(spec)
    if axes and axes[-1] == "model":
        return TS.COL
    if len(axes) > 1 and axes[-2] == "model":
        return TS.ROW
    return None


@pytest.fixture(scope="module")
def family_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharding")
    out = {"llama": str(d / "llama.gguf"), "moe": str(d / "moe.gguf")}
    build(out["llama"])
    build_moe(out["moe"])
    for arch in ("qwen2", "gemma", "phi2"):
        out[arch] = str(d / f"{arch}.gguf")
        write_family(out[arch], arch)
    return out


@pytest.mark.parametrize("arch", ["llama", "qwen2", "gemma", "phi2", "moe"])
def test_spec_table_matches_jax(arch, family_files):
    jp, jcfg = _jax_load(family_files[arch], "f32")
    want = JS.llama_param_specs(jcfg, params=jp)
    fake = {k: None for k in jp if k != "layers"}
    fake["layers"] = [dict.fromkeys(jp["layers"])]
    got = TS.llama_param_specs(TConfig(**{f: getattr(jcfg, f) for f in (
        "dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size",
        "parallel_block", "use_layernorm", "use_bias", "n_experts")}), params=fake)
    assert {k: _kind(v) for k, v in want["layers"].items()} == got["layers"]
    assert {k: _kind(v) for k, v in want.items() if k != "layers"} == \
        {k: v for k, v in got.items() if k != "layers"}


def test_spec_error_names_the_keys():
    cfg = TConfig(dim=64, hidden_dim=96, n_layers=1, n_heads=4, n_kv_heads=2, vocab_size=32)
    with pytest.raises(NotImplementedError, match=r"no TP sharding spec for layer params \['wfoo'\]"):
        TS.llama_param_specs(cfg, params={"layers": [{"wq": None, "wfoo": None}]})


def _jax_shards(arr, spec, tp):
    mesh = jmake_mesh(1, tp)
    placed = jax.device_put(arr, NamedSharding(mesh, spec))
    order = {d: i for i, d in enumerate(mesh.devices.reshape(-1))}
    return [np.asarray(s.data) for s in sorted(placed.addressable_shards,
                                               key=lambda s: order[s.device])]


@pytest.mark.parametrize("kind,K,N", [("q4_0", 128, 64), ("q8_0", 128, 64), ("q4_1", 128, 64),
                                      ("q6_k", 512, 64)])
@pytest.mark.parametrize("spec", [TS.ROW, TS.COL])
def test_quantized_cuts_equal_jax_shards(kind, K, N, spec):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    jqt = jq.quantize_tensor(w, kind)
    tqt = to_torch(jqt)
    jspec = P("model", None) if spec == TS.ROW else P(None, "model")
    for plane in ("q", "scales", "mins"):
        jp = getattr(jqt, plane)
        if jp is None:
            assert getattr(tqt, plane) is None
            continue
        shards = _jax_shards(jp, jspec, 2)
        for idx in range(2):
            cut = TS.shard_params({"w": tqt, "layers": []}, {"w": spec, "layers": {}},
                                  _fake_mesh(1, 2, idx))["w"]
            np.testing.assert_array_equal(np_plane(getattr(cut, plane)),
                                          j_plane(shards[idx]), err_msg=plane)


def test_dense_cuts_equal_jax_shards():
    a = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    for spec, jspec in ((TS.ROW, P("model", None)), (TS.COL, P(None, "model"))):
        shards = _jax_shards(jnp.asarray(a), jspec, 4)
        for idx in range(4):
            cut = TS.shard_params({"w": torch.from_numpy(a), "layers": []},
                                  {"w": spec, "layers": {}}, _fake_mesh(1, 4, idx))["w"]
            np.testing.assert_array_equal(cut.numpy(), shards[idx])


@pytest.mark.parametrize("kind,K,tp,block", [("q4_0", 64, 4, 32), ("q6_k", 256, 2, 256)])
def test_k_cut_off_the_blocks_is_refused(kind, K, tp, block):
    qt = to_torch(jq.quantize_tensor(np.ones((K, 32), np.float32), kind))
    with pytest.raises(ValueError, match=rf"layers\[0\]\.w2: a {kind} K cut .* \({block} rows\)"):
        TS.shard_params({"layers": [{"w2": qt}]}, {"layers": {"w2": TS.ROW}},
                        _fake_mesh(1, tp))


def test_local_state_shapes_match_jax_shards():
    cfg = TConfig(dim=64, hidden_dim=96, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=32)
    mesh = jmake_mesh(2, 2)
    L, B, S, H, D = 2, 4, 16, 2, 16
    for quant in (False, True):
        want = NamedSharding(mesh, JS.llama_cache_spec(quant)["k"].q if quant else
                             JS.llama_cache_spec()["k"]).shard_shape((L, B, S, H, D))
        got = TS.llama_cache_spec(cfg, _fake_mesh(2, 2), B, S, quant=quant)
        assert got["kv"] == (want[1], want[2], want[3] * want[4])
        if quant:
            ws = NamedSharding(mesh, JS.llama_cache_spec(True)["k"].s).shard_shape((L, B, S, H))
            assert got["scales"] == (ws[1], ws[3], ws[2])
    pool = NamedSharding(mesh, JS.llama_paged_state_spec(L)["k"][0]).shard_shape((9, 4, H * D))
    got = TS.llama_paged_state_spec(cfg, _fake_mesh(2, 2), 9, 4, quantized=True)
    assert got["pool"] == pool
    assert got["scales"] == (9 * 8, 128)           # one local kv head, rounded to 8 rows
