"""The port's copy of the BPE tokenizer against tpu_llm.tokenizers on the
tiny test GGUF's vocabulary and through the tokenizer.bin side format."""

import pytest

from tests.make_tiny_gguf import build as build_tiny_gguf
from tpu_llm.io.gguf import GGUFFile as JGGUF
from tpu_llm.tokenizers.bpe import BPETokenizer as JTok
from tpu_llm.tokenizers.tokenizer_bin import write_tokenizer_bin
from tpu_llm_torch.io.gguf import GGUFFile as TGGUF
from tpu_llm_torch.tokenizers.bpe import BPETokenizer as TTok
import torch
torch.set_num_threads(1)  # one intra-op thread a test process (xdist runs 6 on 8 cores)

TEXTS = ["abc", " abc", "abcabc bc", "a b c ab", "cab\nb", "zzz abc", "",
         "<s>abc</s>"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tok") / "tiny.gguf")
    build_tiny_gguf(path)
    return path


@pytest.mark.parametrize("text", TEXTS)
def test_gguf_encode_decode_matches_jax(tiny, text):
    j, t = JTok.from_gguf(JGGUF(tiny)), TTok.from_gguf(TGGUF(tiny))
    assert (t.bos_id, t.eos_id, t.add_bos, t.vocab_size) == \
        (j.bos_id, j.eos_id, j.add_bos, j.vocab_size)
    for kw in ({}, {"add_bos": True}, {"parse_special": True}):
        ids = t.encode(text, **kw)
        assert ids == j.encode(text, **kw), kw
        assert t.decode(ids) == j.decode(ids)


def test_tokenizer_bin_matches_jax(tiny, tmp_path):
    j = JTok.from_gguf(JGGUF(tiny))
    path = str(tmp_path / "tok.bin")
    write_tokenizer_bin(path, j.tokens, j.scores)
    t = TTok.from_tokenizer_bin(path)
    jb = JTok.from_tokenizer_bin(path)
    for text in TEXTS:
        assert t.encode(text) == jb.encode(text)
