"""Build the CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, under ``build/repro_torch/`` at the root
of the checkout, named by a hash of the sources and flags so an edit
rebuilds.  All missing libraries compile in parallel, one ``nvcc`` each.
A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("chunked_prefill_attention", "decode_attention",
           "paged_decode_attention", "wkv6")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# dtype, q, k, v, offset, lengths, out, B, Sq, Skv, Hq, Hkv, D, window,
# softcap, scale, stream
_ARGTYPES = {
    "chunked_prefill_attention": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _I, _I, _F, _F, _P],
    # dtype, q, k, v, cur_lens, out, part_o, part_ml, B, L, Hq, Hkv, D,
    # window, softcap, scale, split, stream
    "decode_attention": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _F, _F, _I, _P],
    # dtype, q, k, v, cur_lens, out, lse, part_o, part_ml, B, L, Hq, Hkv, D,
    # pos0, window, softcap, scale, split, stream
    "decode_attention_partial": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _I, _I, _I, _F, _F, _I, _P],
    # dtype, q, pool_k, pool_v, tables, cur_lens, out, part_o, part_ml, B,
    # MB, BS, Hq, Hkv, D, scale, split, stream
    "paged_decode_attention": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, _I, _F, _I, _P],
    # D
    "decode_blocks_per_sm": [_I],
    # r, k, v, w, u, s0, y, sT, ws, B, S, H, K, chunk, segment, stream
    "wkv6": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
             _P],
}

#: the C entry points of each library that has more than the one of its name
ENTRIES = {"decode_attention": ("decode_attention",
                                "decode_attention_partial",
                                "decode_blocks_per_sm")}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every kernel library not yet built; returns the seconds
    spent.  Waits for every compiler it started before raising."""
    t0 = time.perf_counter()
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        so = _lib_path(name)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """What nvcc printed (with ptxas' register / shared-memory report)."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    if name not in _LIBS:
        build_all()
        cdll = ctypes.CDLL(str(_lib_path(name)))
        for entry in ENTRIES.get(name, (name,)):
            fn = getattr(cdll, entry)
            fn.argtypes = _ARGTYPES[entry]
            fn.restype = ctypes.c_int
        _LIBS[name] = cdll
    return _LIBS[name]
