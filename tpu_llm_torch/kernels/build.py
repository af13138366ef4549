"""Build and bind the hand-written CUDA kernels in ``tpu_llm_torch/csrc``.

The sources have a plain C interface (no PyTorch headers), so each
``nvcc`` takes seconds. At first use the sources are compiled for
Hopper (``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` per
``.cu`` file, all started together, then linked into one shared
library, loaded with ``ctypes``. The library lives in a directory keyed
by a hash of the sources and flags (``tpu_llm_torch/_build/<hash>/``),
so a changed source rebuilds and an unchanged one loads at once.

Nothing here runs at import time: the CPU tests import every module of
the package and never build.

Every C entry point takes its pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launches;
``check`` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_ROOT = PKG / "_build"
LIB_NAME = "libtpu_llm_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argument types (all return int = cudaError_t)
SIGNATURES = {
    # x, x_bf16, row_scale, q, qh, scales, mins, s_dtype, pack, voff, block,
    # out, out_bf16, partial, counters, rows, K, N, ksplit, kb_per_split,
    # vec, stream
    "tlt_qmatmul": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                    _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # q, q_bf16, k_cache, v_cache, cache_bf16, k_cur, v_cur, pos, out,
    # part_acc, part_ml, counters, B, H, Hkv, D, S, rows_per_split, n_split,
    # sm_scale, stream
    "tlt_flash_decode": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # q, q_bf16, k_cache, v_cache, cache_bf16, out, B, T, H, Hkv, D, S,
    # offset, sm_scale, stream
    "tlt_flash_prefill": [_P, _I, _P, _P, _I, _P,
                          _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # q, q_bf16, k_pool, v_pool, pool_bf16, table, pos, out, part_acc,
    # part_ml, counters, B, H, Hkv, D, BS, MB, rows_per_split, n_split,
    # sm_scale, stream
    "tlt_paged_decode": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # q, q_bf16, k_pool, v_pool, k_scale, v_scale, HP, SP, table, pos, out,
    # part_acc, part_ml, counters, B, H, Hkv, D, BS, MB, rows_per_split,
    # n_split, sm_scale, stream
    "tlt_paged_decode_q": [_P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # kind -> CTAs of the cooperative launch that fit at once
    "tlt_ffn_grid": [_I],
    # x, q13, s13, s13_dtype, q2, s2, s2_dtype, kind, part_a, g, part_b, out,
    # counters, rows, E, F, ks_a, kbps_a, ks_b, kbps_b, grid, stream
    "tlt_ffn": [_P, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P,
                _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}

_lib = None
build_seconds = None   # wall time of the build this process ran, if any


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> Path:
    """Compile every .cu in parallel, link one .so into ``out_dir``."""
    nvcc = _nvcc()
    cu, _ = _sources()
    procs = []
    objs = []
    for src in cu:
        obj = out_dir / (src.stem + ".o")
        objs.append(obj)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT)))
    failed = []
    for src, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{src.name}:\n{out.decode(errors='replace')}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    lib = out_dir / LIB_NAME
    link = subprocess.run([nvcc, "-shared", "-o", str(lib), *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout.decode(errors="replace"))
    return lib


def library_path() -> Path:
    """Build the library if this source state has none; return its path."""
    global build_seconds
    final = BUILD_ROOT / _digest()
    lib = final / LIB_NAME
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build in a private directory, then rename: a concurrent build never
    # sees a half-written library
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        _compile(tmp)
        try:
            os.replace(tmp, final)
        except OSError:
            if not lib.exists():   # lost a race to an equal build: keep theirs
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        so = ctypes.CDLL(str(library_path()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(so, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = so
    return _lib


def check(code: int, name: str):
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {code}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
