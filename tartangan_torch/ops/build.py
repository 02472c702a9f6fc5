"""Build and load the port's CUDA kernels.

Each source under ``tartangan_torch/csrc/`` is compiled by ``nvcc`` into a
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds) and loaded with ``ctypes``. K3's and K4/K5's sources are built twice,
once for each compute dtype (``-DTT_BFLOAT16`` for bfloat16), so the two
halves of their template instances compile in parallel. Libraries go to ``build/torch_kernels/``
at the repo root, named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so a changed source is rebuilt at its next
use. Nothing is built at import time. Builds run under a file lock in that
directory, so processes that need a library at once (the ranks of a mesh)
build it once.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = {"attention_fwd": "attention_fwd.cu",
           "attention_bwd": "attention_bwd.cu",
           "parity_conv": "parity_conv.cu",
           "parity_conv_bf16": "parity_conv.cu",
           "gblock": "gblock.cu",
           "gblock_bf16": "gblock.cu"}
# the libraries of one source built with other preprocessor definitions
DEFINES = {"parity_conv_bf16": ("-DTT_BFLOAT16",),
           "gblock_bf16": ("-DTT_BFLOAT16",)}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points whose argument types ``load`` sets once: (argtypes,
# restype); pointers and the stream as void*, so ctypes does not cut them
_GBLOCK = {
    "tt_gblock_a": ([_P] * 10 + [_LL] + [_I] * 6 + [_P], _I),
    "tt_gblock_b": ([_P] * 12 + [_LL] + [_I] * 6 + [_P], _I),
    "tt_gblock_workspace": ([_I] * 6, _LL),
}
_PARITY_CONV = {"tt_parity_conv": ([_P] * 4 + [_I] * 7 + [_P], _I)}
SIGNATURES = {"gblock": _GBLOCK, "gblock_bf16": _GBLOCK,
              "parity_conv": _PARITY_CONV, "parity_conv_bf16": _PARITY_CONV}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for path in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + DEFINES.get(name, ())


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compile every stale library in ``names`` (default: all), one ``nvcc``
    per source, all started together. Returns each built library's
    compiler output (register and shared-memory use); raises on a failed
    build."""
    names = list(SOURCES) if names is None else list(names)
    if all(library_path(n).exists() for n in names):
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_stale(names)


def _build_stale(names) -> dict[str, str]:
    stale = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not stale:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name, out in stale.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name), "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{logs[name]}")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel source ``name``, built if stale."""
    with _LOCK:
        if name not in _LIBS:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (argtypes, restype) in SIGNATURES.get(name, {}).items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
        return _LIBS[name]
