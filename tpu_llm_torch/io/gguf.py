"""GGUF v1/v2/v3 reader and writer (host side, numpy + memmap).

A copy of ``tpu_llm/io/gguf.py``: magic "GGUF", u64 tensor/kv counts (u32
in v1), all KV value types, the tensor directory (name, ndims, dims, ggml
type, offset) and a data section aligned to ``general.alignment``
(default 32). Tensor data is memory-mapped; loaders slice per-tensor views
and decode or repack them lazily.

It decodes and writes f32, f16, bf16, the legacy quants (Q4_0, Q4_1,
Q5_0, Q5_1, Q8_0) and the K-quants (Q2_K ... Q6_K); any other type
raises ``ValueError``. Multi-part (gguf-split) checkpoints are not in
this slice of the port.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, BinaryIO, Dict, List, Tuple, Union

import numpy as np

from tpu_llm_torch.quant import blocks as qblocks

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian

# -- KV value types ----------------------------------------------------------
T_UINT8, T_INT8, T_UINT16, T_INT16, T_UINT32, T_INT32, T_FLOAT32, T_BOOL, \
    T_STRING, T_ARRAY, T_UINT64, T_INT64, T_FLOAT64 = range(13)

_SCALAR_FMT = {
    T_UINT8: "<B", T_INT8: "<b", T_UINT16: "<H", T_INT16: "<h",
    T_UINT32: "<I", T_INT32: "<i", T_FLOAT32: "<f", T_BOOL: "<?",
    T_UINT64: "<Q", T_INT64: "<q", T_FLOAT64: "<d",
}
_SCALAR_NP = {
    T_UINT8: np.uint8, T_INT8: np.int8, T_UINT16: np.uint16, T_INT16: np.int16,
    T_UINT32: np.uint32, T_INT32: np.int32, T_FLOAT32: np.float32,
    T_BOOL: np.bool_, T_UINT64: np.uint64, T_INT64: np.int64,
    T_FLOAT64: np.float64,
}

# -- GGML tensor dtypes ------------------------------------------------------
GGML_F32, GGML_F16, GGML_Q4_0, GGML_Q4_1 = 0, 1, 2, 3
GGML_Q5_0, GGML_Q5_1, GGML_Q8_0, GGML_Q8_1 = 6, 7, 8, 9
GGML_Q2_K, GGML_Q3_K, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K = 10, 11, 12, 13, 14
GGML_I8, GGML_I16, GGML_I32 = 24, 25, 26
GGML_F64 = 28
GGML_BF16 = 30

GGML_TYPE_NAMES = {
    GGML_F32: "f32", GGML_F16: "f16", GGML_BF16: "bf16", GGML_F64: "f64",
    GGML_Q4_0: "q4_0", GGML_Q4_1: "q4_1", GGML_Q8_0: "q8_0",
    GGML_Q5_0: "q5_0", GGML_Q5_1: "q5_1",
    GGML_Q2_K: "q2_k", GGML_Q3_K: "q3_k", GGML_Q4_K: "q4_k",
    GGML_Q5_K: "q5_k", GGML_Q6_K: "q6_k",
    GGML_I8: "i8", GGML_I16: "i16", GGML_I32: "i32",
}

# (block_size_elems, block_bytes) per type; simple types use block 1
_TYPE_TRAITS = {
    GGML_F32: (1, 4), GGML_F16: (1, 2), GGML_BF16: (1, 2), GGML_F64: (1, 8),
    GGML_I8: (1, 1), GGML_I16: (1, 2), GGML_I32: (1, 4),
    GGML_Q4_0: (qblocks.QK4_0, qblocks.Q4_0_BLOCK_BYTES),
    GGML_Q4_1: (qblocks.QK4_1, qblocks.Q4_1_BLOCK_BYTES),
    GGML_Q5_0: (qblocks.QK5_0, qblocks.Q5_0_BLOCK_BYTES),
    GGML_Q5_1: (qblocks.QK5_1, qblocks.Q5_1_BLOCK_BYTES),
    GGML_Q8_0: (qblocks.QK8_0, qblocks.Q8_0_BLOCK_BYTES),
    GGML_Q2_K: (qblocks.QK_K, qblocks.Q2_K_BLOCK_BYTES),
    GGML_Q3_K: (qblocks.QK_K, qblocks.Q3_K_BLOCK_BYTES),
    GGML_Q4_K: (qblocks.QK_K, qblocks.Q4_K_BLOCK_BYTES),
    GGML_Q5_K: (qblocks.QK_K, qblocks.Q5_K_BLOCK_BYTES),
    GGML_Q6_K: (qblocks.QK_K, qblocks.Q6_K_BLOCK_BYTES),
}


# block-quant types -> the suffix of their codecs in quant/blocks.py
QUANT_CODECS = {t: GGML_TYPE_NAMES[t] for t in (
    GGML_Q4_0, GGML_Q4_1, GGML_Q5_0, GGML_Q5_1, GGML_Q8_0,
    GGML_Q2_K, GGML_Q3_K, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K)}


def ggml_nbytes(ggml_type: int, n_elems: int) -> int:
    bs, bb = _TYPE_TRAITS[ggml_type]
    if n_elems % bs:
        raise ValueError(f"{n_elems} elems not a multiple of block {bs}")
    return (n_elems // bs) * bb


@dataclasses.dataclass
class GGUFTensorInfo:
    name: str
    dims: Tuple[int, ...]   # GGML order: dims[0] fastest-varying (row length)
    ggml_type: int
    offset: int             # relative to data-section start

    @property
    def n_elems(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @property
    def shape(self) -> Tuple[int, ...]:
        """Numpy (row-major) shape: reversed GGML dims."""
        return tuple(reversed(self.dims))

    @property
    def nbytes(self) -> int:
        return ggml_nbytes(self.ggml_type, self.n_elems)


class _Reader:
    def __init__(self, buf: memoryview, version: int):
        self.buf = buf
        self.pos = 0
        self.version = version

    def scalar(self, fmt: str):
        v = struct.unpack_from(fmt, self.buf, self.pos)[0]
        self.pos += struct.calcsize(fmt)
        return v

    def u32(self) -> int:
        return self.scalar("<I")

    def u64(self) -> int:
        return self.scalar("<Q")

    def count(self) -> int:
        # v1 uses u32 lengths/counts everywhere; v2+ uses u64
        return self.u32() if self.version == 1 else self.u64()

    def string(self) -> str:
        n = self.count()
        s = bytes(self.buf[self.pos : self.pos + n])
        self.pos += n
        return s.decode("utf-8", errors="replace")

    def value(self, vtype: int):
        if vtype in _SCALAR_FMT:
            return self.scalar(_SCALAR_FMT[vtype])
        if vtype == T_STRING:
            return self.string()
        if vtype == T_ARRAY:
            etype = self.u32()
            n = self.count()
            if etype in _SCALAR_NP and etype != T_BOOL:
                itemsize = np.dtype(_SCALAR_NP[etype]).itemsize
                arr = np.frombuffer(
                    self.buf, dtype=_SCALAR_NP[etype], count=n, offset=self.pos
                ).copy()
                self.pos += n * itemsize
                return arr
            return [self.value(etype) for _ in range(n)]
        raise ValueError(f"unknown GGUF value type {vtype}")


class GGUFFile:
    """Parsed GGUF file with memory-mapped tensor access."""

    def __init__(self, path: str, _shard: bool = False):
        self.path = path
        self._mmap = np.memmap(path, dtype=np.uint8, mode="r")
        buf = memoryview(self._mmap)

        magic, version = struct.unpack_from("<II", buf, 0)
        if magic != GGUF_MAGIC:
            raise ValueError(f"{path}: bad GGUF magic {magic:#x}")
        if version not in (1, 2, 3):
            raise ValueError(f"{path}: unsupported GGUF version {version}")
        self.version = version
        r = _Reader(buf, version)
        r.pos = 8
        n_tensors = r.count()
        n_kv = r.count()

        self.metadata: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = r.string()
            vtype = r.u32()
            self.metadata[key] = r.value(vtype)

        self.tensors: Dict[str, GGUFTensorInfo] = {}
        for _ in range(n_tensors):
            name = r.string()
            ndims = r.u32()
            dims = tuple(r.u64() if version > 1 else r.u32() for _ in range(ndims))
            ttype = r.u32()
            offset = r.u64() if version > 1 else r.u32()
            self.tensors[name] = GGUFTensorInfo(name, dims, ttype, offset)

        self.alignment = int(self.metadata.get("general.alignment", 32))
        self.data_offset = -(-r.pos // self.alignment) * self.alignment

        # each tensor's byte source: (mmap, data offset); shards add theirs
        self._sources: Dict[str, Tuple[Any, int]] = {
            n: (self._mmap, self.data_offset) for n in self.tensors}
        n_split = int(self.metadata.get("split.count", 1) or 1)
        if n_split > 1 and not _shard:
            self._merge_shards(path, n_split)

    def _merge_shards(self, path: str, n_split: int):
        """llama.cpp gguf-split checkpoints: opened at shard 00001 of
        ``<prefix>-NNNNN-of-NNNNN.gguf``, every shard's tensors (and the
        metadata keys the first lacks) join this file's."""
        import os
        import re

        m = re.match(r"^(.*)-(\d{5})-of-(\d{5})\.gguf$", path)
        if not m:
            raise ValueError(
                f"{path}: split.count={n_split} but the filename does not "
                f"follow the -NNNNN-of-NNNNN.gguf shard convention")
        prefix, no, total = m.group(1), int(m.group(2)), int(m.group(3))
        if no != 1:
            raise ValueError(f"{path}: open shard 00001 (this is {no:05d})")
        if total != n_split:
            raise ValueError(
                f"{path}: filename says {total} shards, split.count says {n_split}")
        self._shards = []
        for i in range(2, n_split + 1):
            sp = f"{prefix}-{i:05d}-of-{n_split:05d}.gguf"
            if not os.path.exists(sp):
                raise FileNotFoundError(f"missing GGUF shard {sp}")
            shard = GGUFFile(sp, _shard=True)
            self._shards.append(shard)
            for n, info in shard.tensors.items():
                if n in self.tensors:
                    raise ValueError(f"duplicate tensor {n!r} in shard {sp}")
                self.tensors[n] = info
                self._sources[n] = (shard._mmap, shard.data_offset)
            for k, v in shard.metadata.items():
                self.metadata.setdefault(k, v)

    # -- tensor access -------------------------------------------------------

    def raw(self, name: str) -> np.ndarray:
        """Raw bytes view of a tensor (no copy)."""
        t = self.tensors[name]
        mm, data_offset = self._sources[name]
        start = data_offset + t.offset
        return mm[start : start + t.nbytes]

    def array(self, name: str) -> np.ndarray:
        """Tensor as a numpy array in its storage dtype (quantized kinds:
        the raw block bytes, one row per tensor row; BF16 bit-cast to
        uint16)."""
        t = self.tensors[name]
        raw = self.raw(name)
        simple = {GGML_F32: np.float32, GGML_F16: np.float16,
                  GGML_BF16: np.uint16, GGML_I8: np.int8, GGML_I16: np.int16,
                  GGML_I32: np.int32, GGML_F64: np.float64}
        if t.ggml_type in simple:
            return raw.view(simple[t.ggml_type]).reshape(t.shape)
        row = t.dims[0]
        bs, bb = _TYPE_TRAITS[t.ggml_type]
        return raw.reshape(t.n_elems // row, (row // bs) * bb)

    def dequantized(self, name: str, dtype=np.float32) -> np.ndarray:
        """Tensor fully decoded to ``dtype``, numpy shape (reversed dims)."""
        t = self.tensors[name]
        raw = self.raw(name)
        if t.ggml_type in (GGML_F32, GGML_F16):
            return self.array(name).astype(dtype)
        if t.ggml_type == GGML_BF16:
            bits = raw.view(np.uint16).astype(np.uint32) << 16
            return bits.view(np.float32).reshape(t.shape).astype(dtype)
        codec = QUANT_CODECS.get(t.ggml_type)
        if codec is None:
            raise ValueError(f"unsupported ggml type {t.ggml_type} for tensor {name!r}")
        deq = getattr(qblocks, f"dequantize_{codec}")
        return deq(raw, t.n_elems).reshape(t.shape).astype(dtype)

    # -- convenience ---------------------------------------------------------

    def __contains__(self, name: str) -> bool:
        return name in self.tensors

    def hparam(self, *keys: str, default=None):
        for k in keys:
            if k in self.metadata:
                v = self.metadata[k]
                return int(v) if isinstance(v, (np.integer, int)) else v
        return default


# -- writer ------------------------------------------------------------------

def _write_string(f: BinaryIO, s: str):
    b = s.encode("utf-8")
    f.write(struct.pack("<Q", len(b)))
    f.write(b)


def _infer_vtype(v: Any) -> int:
    if isinstance(v, bool):
        return T_BOOL
    if isinstance(v, (int, np.integer)):
        return T_INT64 if v < 0 else T_UINT32 if v < 2**32 else T_UINT64
    if isinstance(v, (float, np.floating)):
        return T_FLOAT32
    if isinstance(v, str):
        return T_STRING
    raise ValueError(f"cannot infer GGUF type for {v!r}")


def _write_value(f: BinaryIO, v: Any, vtype: int | None = None):
    if isinstance(v, (list, tuple, np.ndarray)):
        f.write(struct.pack("<I", T_ARRAY))
        seq = list(v)
        if isinstance(v, np.ndarray):
            npk = {np.dtype(np.float32): T_FLOAT32, np.dtype(np.int32): T_INT32,
                   np.dtype(np.uint32): T_UINT32, np.dtype(np.int64): T_INT64}
            etype = npk.get(v.dtype)
            if etype is None:
                etype = _infer_vtype(seq[0]) if seq else T_INT32
        else:
            etype = _infer_vtype(seq[0]) if seq else T_INT32
            if seq and isinstance(seq[0], str):
                etype = T_STRING
        f.write(struct.pack("<I", etype))
        f.write(struct.pack("<Q", len(seq)))
        for item in seq:
            if etype == T_STRING:
                _write_string(f, item)
            else:
                f.write(struct.pack(_SCALAR_FMT[etype], item))
        return
    vt = vtype if vtype is not None else _infer_vtype(v)
    f.write(struct.pack("<I", vt))
    if vt == T_STRING:
        _write_string(f, v)
    else:
        f.write(struct.pack(_SCALAR_FMT[vt], v))


def _encode_tensor(data: np.ndarray, ggml_type: int) -> bytes:
    flat = np.ascontiguousarray(data)
    if ggml_type == GGML_F32:
        return flat.astype(np.float32).tobytes()
    if ggml_type == GGML_F16:
        return flat.astype(np.float16).tobytes()
    if ggml_type == GGML_BF16:
        f32 = flat.astype(np.float32).view(np.uint32)
        # round-to-nearest-even bf16 truncation
        rounded = ((f32 + 0x7FFF + ((f32 >> 16) & 1)) >> 16).astype(np.uint16)
        return rounded.tobytes()
    if ggml_type in QUANT_CODECS:
        return getattr(qblocks, f"quantize_{QUANT_CODECS[ggml_type]}")(flat.reshape(-1))
    if ggml_type == GGML_I32:
        return flat.astype(np.int32).tobytes()
    raise ValueError(f"writer: unsupported ggml type {ggml_type}")


def write_gguf(
    path: str,
    metadata: Dict[str, Any],
    tensors: Dict[str, Union[np.ndarray, Tuple[np.ndarray, int]]],
    alignment: int = 32,
    version: int = 3,
):
    """Write a GGUF file.

    ``tensors`` maps name -> numpy array (stored f32) or (array, ggml_type).
    Arrays are in numpy row-major shape; GGML dims are written reversed.
    """
    entries: List[Tuple[str, Tuple[int, ...], int, bytes]] = []
    for name, spec in tensors.items():
        if isinstance(spec, tuple):
            arr, ttype = spec
        else:
            arr, ttype = spec, GGML_F32
        dims = tuple(reversed(np.asarray(arr).shape))
        entries.append((name, dims, ttype, _encode_tensor(np.asarray(arr), ttype)))
    _write_entries(path, metadata, entries, alignment, version)


def write_gguf_split(gguf: "GGUFFile", prefix: str, n_split: int) -> List[str]:
    """llama.cpp gguf-split's layout: ``gguf``'s tensors, bytes unchanged,
    in ``n_split`` files ``<prefix>-NNNNN-of-NNNNN.gguf`` (contiguous runs
    in tensor order); the first shard carries the metadata, every shard
    ``split.no`` / ``split.count`` / ``split.tensors.count``. Returns the
    paths, shard 00001 first."""
    names = list(gguf.tensors)
    per = -(-len(names) // n_split)
    paths = []
    for i in range(n_split):
        meta = dict(gguf.metadata) if i == 0 else {
            "general.architecture": gguf.metadata.get("general.architecture", "llama")}
        meta.update({"split.no": i, "split.count": n_split,
                     "split.tensors.count": len(names)})
        entries = [(n, gguf.tensors[n].dims, gguf.tensors[n].ggml_type,
                    gguf.raw(n).tobytes()) for n in names[i * per:(i + 1) * per]]
        paths.append(f"{prefix}-{i + 1:05d}-of-{n_split:05d}.gguf")
        _write_entries(paths[-1], meta, entries, gguf.alignment, gguf.version)
    return paths


def _write_entries(path: str, metadata: Dict[str, Any],
                   entries: List[Tuple[str, Tuple[int, ...], int, bytes]],
                   alignment: int, version: int):
    """The file: header, metadata, tensor infos, then the aligned payloads
    of ``entries`` (name, ggml dims, ggml type, bytes)."""
    meta = dict(metadata)
    if alignment != 32:
        meta["general.alignment"] = np.uint32(alignment)

    with open(path, "wb") as f:
        f.write(struct.pack("<IIQQ", GGUF_MAGIC, version, len(entries), len(meta)))
        for k, v in meta.items():
            _write_string(f, k)
            if k == "general.alignment":
                _write_value(f, int(v), T_UINT32)
            else:
                _write_value(f, v)
        offset = 0
        for name, dims, ttype, payload in entries:
            _write_string(f, name)
            f.write(struct.pack("<I", len(dims)))
            for d in dims:
                f.write(struct.pack("<Q", d))
            f.write(struct.pack("<IQ", ttype, offset))
            offset += len(payload)
            offset = -(-offset // alignment) * alignment
        pad = -f.tell() % alignment
        f.write(b"\x00" * pad)
        for _, _, _, payload in entries:
            f.write(payload)
            pad = -len(payload) % alignment
            f.write(b"\x00" * pad)
