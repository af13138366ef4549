"""Greedy score-merge BPE tokenizer (SentencePiece-score style).

A copy of ``tpu_llm/tokenizers/bpe.py`` (GGUF constructor, encode,
token_bytes, decode, the tokenizer.bin side format). Algorithm: one token
per input byte, then repeatedly merge the adjacent pair whose
concatenation exists in the vocabulary with the highest SCORE, until no
merge applies. Token identity is byte content; decode is the raw stored
bytes. GGUF loading applies the leading-'▁' -> ' ' rewrite so
encode/decode operate on plain-text bytes.

The JAX package may run the merge loop in its C++ host library; this copy
always runs the Python loop, which computes the same ids.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

_SPM_SPACE = "▁".encode("utf-8")  # 0xE2 0x96 0x81

# GGUF tokenizer.ggml.token_type values (ggml llama_token_type enum)
TOKEN_TYPE_NORMAL = 1
TOKEN_TYPE_UNKNOWN = 2
TOKEN_TYPE_CONTROL = 3
TOKEN_TYPE_USER_DEFINED = 4
TOKEN_TYPE_UNUSED = 5
TOKEN_TYPE_BYTE = 6

_BYTE_TOKEN_RE = re.compile(rb"^<0x([0-9A-Fa-f]{2})>$")

# score sentinel: the token exists in the vocab but NO merge rule
# produces it — the merge loop refuses to
# merge into such tokens (true merge-rank BPE parity; the tokenizer.bin
# writer clamps it back to the reference's 0.0 convention)
UNMERGEABLE = -1e30

# the GPT-2 ByteLevel pre-tokenizer split (HF tokenizers' use_regex=true,
# llama.cpp's default BPE regex): merges never cross these boundaries.
# Needs the third-party ``regex`` module for \p classes; gpt2-family
# constructors enable it when available (SPM vocabs merge freely).
_GPT2_SPLIT = (r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"""
               r"""| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")


def _gpt2_pretok_re():
    try:
        import regex
    except ImportError:
        return None
    return regex.compile(_GPT2_SPLIT)

# Heuristic special-token surface forms, used only when the vocab carries
# no token_type metadata: SPM controls plus the <|...|> added-token style.
_SPECIAL_SURFACE_RE = re.compile(rb"^(</?s>|<unk>|<\|[^ <>|]+\|>)$")


def _gpt2_byte_decoder() -> dict:
    """GPT-2's bytes_to_unicode inverse: printable-char code point -> raw
    byte. Byte-level BPE vocabs store every byte as a printable unicode
    char (' '->'Ġ', '\\t'->'ĉ', 0xE9->'é'-page chars...); tokens must be
    mapped back char-by-char or non-ASCII text is double-encoded."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {c: b for b, c in zip(bs, cs)}


_GPT2_DECODER = _gpt2_byte_decoder()


def _gpt2_str_to_bytes(s: str) -> bytes:
    """Byte-level vocab string -> raw bytes. Strings containing chars
    outside the byte-unicode table (added/special tokens like
    <|im_start|>) are literal text, kept as UTF-8."""
    try:
        return bytes(_GPT2_DECODER[ord(c)] for c in s)
    except KeyError:
        return s.encode("utf-8")


class BPETokenizer:
    # whether prompts get a BOS prepended (tokenizer.ggml.add_bos_token;
    # qwen2-family GGUFs ship false). Engines consult this via the CLIs.
    add_bos = True

    def __init__(
        self,
        tokens: Sequence[bytes],
        scores: Sequence[float],
        bos_id: int = 1,
        eos_id: int = 2,
        token_types: Optional[Sequence[int]] = None,
        always_match: Optional[Dict[bytes, int]] = None,
        pretokenizer: Optional[str] = None,
    ):
        """``token_types`` is GGUF's ``tokenizer.ggml.token_type`` array when
        present; type 6 (BYTE) marks SentencePiece byte-fallback pieces.
        Without it, the SPM ``<0xNN>`` surface form is recognized instead.

        Byte tokens are stored with their RAW BYTE as content, so (a) the
        merge loop can merge across byte-fallback tokens exactly like over
        ordinary pieces (0xC3 + 0xA9 -> the 'é' piece when present) and
        (b) ``decode`` emits the byte, not the literal ``<0xNN>`` text.
        The reference reads pieces verbatim and has no byte-fallback at all
        (llama2.f90:651-655 yields -1 for unknown chars)."""
        self.scores = np.asarray(scores, dtype=np.float32)
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.tokens: List[bytes] = []
        self.is_byte: List[bool] = []
        for i, t in enumerate(tokens):
            t = bytes(t)
            if token_types is not None:
                byte_tok = int(token_types[i]) == TOKEN_TYPE_BYTE
                m = _BYTE_TOKEN_RE.match(t) if byte_tok else None
            else:
                m = _BYTE_TOKEN_RE.match(t)
                byte_tok = m is not None
            if byte_tok and m is not None:
                t = bytes([int(m.group(1), 16)])
            self.tokens.append(t)
            self.is_byte.append(byte_tok)
        # byte-content -> id over NON-byte tokens; first occurrence wins
        # (matches the reference's linear lookup). Byte tokens are reachable
        # only through byte_fallback, so a regular single-char piece is
        # preferred over its <0xNN> twin like SentencePiece does.
        self.index: Dict[bytes, int] = {}
        for i, t in enumerate(self.tokens):
            if not self.is_byte[i]:
                self.index.setdefault(t, i)
        self.byte_fallback: Dict[int, int] = {}
        for i, t in enumerate(self.tokens):
            if self.is_byte[i] and len(t) == 1 and t[0] not in self.byte_fallback:
                self.byte_fallback[t[0]] = i
        # special tokens (chat markers, <s>/</s>) matched verbatim by
        # encode(parse_special=True) before BPE — the merge loop can never
        # assemble them from characters (their scores are 0). CONTROL /
        # USER_DEFINED token_types where available, surface-form heuristic
        # otherwise.
        self.special: Dict[bytes, int] = {}
        for i, t in enumerate(self.tokens):
            if token_types is not None:
                sp = int(token_types[i]) in (TOKEN_TYPE_CONTROL,
                                             TOKEN_TYPE_USER_DEFINED)
            else:
                sp = _SPECIAL_SURFACE_RE.match(t) is not None
            if sp and t not in self.special:
                self.special[t] = i
        self._special_re = None
        if self.special:
            alts = sorted(self.special, key=len, reverse=True)
            self._special_re = re.compile(
                b"|".join(re.escape(t) for t in alts))
        # non-special ADDED tokens matched verbatim on EVERY encode (HF
        # matches added_tokens before BPE regardless of parse_special):
        # GPT-NeoX's multi-space run tokens (ids 50254-50276) are the
        # real-vocab case — without this, runs of spaces BPE to base-vocab
        # multi-space pieces and the ids diverge from the HF tokenizer the
        # model was trained with (pinned by tests/test_real_vocab.py)
        self.always_match: Dict[bytes, int] = dict(always_match or {})
        self._always_re = None
        if self.always_match:
            alts = sorted(self.always_match, key=len, reverse=True)
            self._always_re = re.compile(
                b"|".join(re.escape(t) for t in alts))
        # "gpt2": ByteLevel regex pre-tokenization — merges never cross
        # piece boundaries (e.g. '\n'+'\t' stays two tokens even though
        # the vocab has a merge for the pair). None for SPM vocabs.
        self._pretok_re = _gpt2_pretok_re() if pretokenizer == "gpt2" \
            else None

    # -- constructors ----------------------------------------------------

    @classmethod
    def from_gguf(cls, gguf, rewrite_leading_space: bool = True) -> "BPETokenizer":
        """Build from GGUF metadata (tokenizer.ggml.tokens / .scores),
        applying the reference's leading-'▁' rewrite.

        GPT-2-style vocabularies (tokenizer.ggml.model == "gpt2": qwen2,
        GPT-NeoX — merge ranks instead of scores) get score = #merges −
        rank like the reference's ssm/convert_tokens.py, but with the
        FULL byte-level unicode↔byte inverse (the reference maps only
        Ġ/Ċ, which garbles every non-ASCII and control byte — the same
        deliberate-deviation policy as the GQA indexing, SURVEY §2 #13)."""
        raw_tokens = gguf.metadata["tokenizer.ggml.tokens"]
        scores = gguf.metadata.get("tokenizer.ggml.scores")
        token_types = gguf.metadata.get("tokenizer.ggml.token_type")
        model = gguf.metadata.get("tokenizer.ggml.model", "llama")
        merges = gguf.metadata.get("tokenizer.ggml.merges")
        gpt2 = model == "gpt2" and merges is not None
        if scores is None:
            scores = np.zeros(len(raw_tokens), dtype=np.float32)
        to_b = _gpt2_str_to_bytes if gpt2 else None
        tokens: List[bytes] = []
        for t in raw_tokens:
            s = t if isinstance(t, str) else t.decode("utf-8", "replace")
            if gpt2:
                b = to_b(s)
            else:
                b = s.encode("utf-8")
                if rewrite_leading_space and b.startswith(_SPM_SPACE):
                    b = b" " + b[len(_SPM_SPACE):]
            tokens.append(b)
        if gpt2:
            scores = np.zeros(len(raw_tokens), dtype=np.float32)
            ids = {t: i for i, t in enumerate(tokens)}
            top = float(len(merges))
            merged_ids = set()
            for rank, merge in enumerate(merges):
                a, _, bpart = merge.partition(" ")
                tid = ids.get(to_b(a + bpart))
                if tid is not None:
                    merged_ids.add(tid)
                    if scores[tid] == 0.0:
                        scores[tid] = top - rank
            # multi-byte vocab entries no merge produces are unmergeable
            # (llama.cpp's merge-rank BPE can never assemble them);
            # specials keep 0 — they're matched, not merged
            for tid, t in enumerate(tokens):
                tt = int(token_types[tid]) if token_types is not None else 1
                if (len(t) > 1 and tid not in merged_ids
                        and tt == TOKEN_TYPE_NORMAL):
                    scores[tid] = UNMERGEABLE
        bos = gguf.hparam("tokenizer.ggml.bos_token_id", default=1)
        eos = gguf.hparam("tokenizer.ggml.eos_token_id", default=2)
        if token_types is not None:
            token_types = [int(t) for t in token_types]
        # USER_DEFINED tokens that are PURE WHITESPACE (NeoX/StableLM
        # multi-space runs) match verbatim before BPE, like HF's
        # AddedToken machinery — the models were trained with those ids.
        # Non-whitespace user-defined tokens (chat markers) stay gated
        # behind parse_special: matching them unconditionally would
        # reopen the injection surface encode() documents.
        always: Dict[bytes, int] = {}
        if gpt2 and token_types is not None:
            for i, t in enumerate(tokens):
                if (token_types[i] == TOKEN_TYPE_USER_DEFINED and t
                        and not t.strip(b" \t\n\r") and t not in always):
                    always[t] = i
        tok = cls(tokens, np.asarray(scores, np.float32), int(bos), int(eos),
                  token_types=token_types,
                  always_match=always or None,
                  pretokenizer="gpt2" if gpt2 else None)
        # real checkpoints declare whether prompts get a BOS prepended
        # (qwen2 ships add_bos_token = false); engines consult this.
        # When the key is absent, default by vocab family like llama.cpp
        # (llama_vocab::impl::load): SPM/"llama" vocabs prepend BOS,
        # "gpt2" byte-level vocabs do not.
        tok.add_bos = bool(gguf.metadata.get("tokenizer.ggml.add_bos_token",
                                             model != "gpt2"))
        return tok

    @classmethod
    def from_tokenizer_bin(cls, path: str, **kw) -> "BPETokenizer":
        from tpu_llm_torch.tokenizers.tokenizer_bin import read_tokenizer_bin

        tokens, scores, _ = read_tokenizer_bin(path)
        return cls(tokens, scores, **kw)

    # -- core API ----------------------------------------------------------

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    def token_bytes(self, tid: int) -> bytes:
        return self.tokens[tid]

    def decode(self, ids: Iterable[int]) -> bytes:
        return b"".join(self.tokens[int(i)] for i in ids)

    def encode(
        self,
        text: str | bytes,
        add_bos: bool = False,
        strict: bool = False,
        parse_special: bool = False,
    ) -> List[int]:
        """Greedy highest-score merge encode.

        ``strict=True`` raises on characters absent from the vocab (the
        reference would produce index -1); otherwise byte-fallback tokens
        are used when available and unknown bytes are skipped with the
        reference's single-char-lookup granularity.

        ``parse_special=True`` matches special tokens (``</s>``,
        ``<|user|>``, ...) verbatim and emits their ids directly, BPE-ing
        only the text between them — for tokenizing rendered chat
        templates, like llama.cpp's parse_special. Off by default so
        user-supplied text cannot inject control tokens.
        """
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)

        if self._always_re is not None and data:
            # added-token segmentation (leftmost-longest, like HF's
            # AddedToken matching) runs unconditionally; the segments
            # between matches recurse WITHOUT re-matching (they contain
            # no always-token by construction)
            m0 = self._always_re.search(data)
            if m0 is not None:
                ids: List[int] = [self.bos_id] if add_bos else []
                last = 0
                for m in self._always_re.finditer(data):
                    if m.start() > last:
                        ids.extend(self.encode(
                            data[last:m.start()], strict=strict,
                            parse_special=parse_special))
                    ids.append(self.always_match[m.group(0)])
                    last = m.end()
                if last < len(data):
                    ids.extend(self.encode(data[last:], strict=strict,
                                           parse_special=parse_special))
                return ids

        if parse_special and self._special_re is not None:
            ids: List[int] = [self.bos_id] if add_bos else []
            last = 0
            for m in self._special_re.finditer(data):
                ids.extend(self.encode(data[last:m.start()], strict=strict))
                ids.append(self.special[m.group(0)])
                last = m.end()
            ids.extend(self.encode(data[last:], strict=strict))
            return ids

        if self._pretok_re is not None and not strict and data:
            # ByteLevel pre-tokenization: BPE each piece independently so
            # merges never cross piece boundaries (HF/llama.cpp parity;
            # pinned against the rust tokenizer in test_real_vocab.py).
            # Non-UTF-8 input skips the split (byte-level BPE handles it).
            try:
                text_str = data.decode("utf-8")
            except UnicodeDecodeError:
                text_str = None
            if text_str is not None:
                pieces = self._pretok_re.findall(text_str)
                if len(pieces) > 1:
                    ids = [self.bos_id] if add_bos else []
                    for p in pieces:
                        ids.extend(self.encode(p.encode("utf-8"),
                                               strict=strict))
                    return ids

        ids: List[int] = []
        # init: one token per byte, preferring single-byte vocab entries
        for b in data:
            tid = self.index.get(bytes([b]))
            if tid is None:
                tid = self.byte_fallback.get(b)
            if tid is None:
                if strict:
                    raise ValueError(f"byte {b:#x} not in vocab")
                continue
            ids.append(tid)

        while len(ids) > 1:
            best_score = -1e10
            best_pos = -1
            best_id = -1
            for i in range(len(ids) - 1):
                merged = self.tokens[ids[i]] + self.tokens[ids[i + 1]]
                tid = self.index.get(merged)
                if tid is not None and self.scores[tid] > best_score:
                    best_score = float(self.scores[tid])
                    best_pos = i
                    best_id = tid
            if best_pos < 0:
                break
            ids[best_pos : best_pos + 2] = [best_id]

        if add_bos:
            ids.insert(0, self.bos_id)
        return ids
