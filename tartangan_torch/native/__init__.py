"""The host's C++ libraries, loaded with ctypes: the batch gather and crop
(``crop.cpp``) and the zstd decoder with CRC32C (``zstd.cpp``, used by
``utils/zstd.py`` for orbax checkpoints).

The crop is the counterpart of ``tartangan_tpu/native/``. Each library is
built at first use with ``g++ -O3 -shared -fPIC`` (``-fopenmp`` for the
crop) into ``build/torch_native/`` at the repo root, named by a hash of
the source and the flags, under a file lock (ranks of a mesh, or test
workers, may ask at once); nothing is built at import time. Unlike the JAX
package's loader, a failed build or load raises: there is no quiet
fallback. ``crop_batch_plain`` and ``gather_batch_plain`` are the numpy
versions the tests hold the crop against.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..utils import tracing

SRC = Path(__file__).resolve().parent / "crop.cpp"
ZSTD_SRC = Path(__file__).resolve().parent / "zstd.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp")
ZSTD_FLAGS = ("-O3", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB = None
_ZSTD_LIB = None


def library_path(src: Path = None, flags=FLAGS,
                 stem: str = "libtartangan_native") -> Path:
    src = SRC if src is None else src
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{stem}-{digest[:16]}.so"


def build(src: Path = None, flags=FLAGS, stem: str = "libtartangan_native",
          what: str = "native crop") -> Path:
    """Compile a library (the crop's unless told otherwise) unless it is
    there; raises on a failed build."""
    src = SRC if src is None else src
    out = library_path(src, flags, stem)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *flags, str(src), "-o", str(tmp)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{what} build failed (g++ exit "
                                   f"{proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built if needed; the first load is a
    ``setup.libs`` span, noted with whether it compiled."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            with tracing.span("setup.libs", always=True) as span:
                span.set(lib="native_crop",
                         compiled=not library_path().exists())
                lib = ctypes.CDLL(str(build()))
                i64, ptr = ctypes.c_int64, ctypes.c_void_p
                lib.crop_batch_u8.argtypes = [ptr, i64, i64, i64, ptr, i64,
                                              ptr, ptr, i64, ptr]
                lib.crop_batch_u8.restype = None
                lib.gather_batch_u8.argtypes = [ptr, i64, ptr, i64, ptr]
                lib.gather_batch_u8.restype = None
            _LIB = lib
        return _LIB


def load_zstd() -> ctypes.CDLL:
    """The loaded zstd library (``zstd.cpp``), built if needed."""
    global _ZSTD_LIB
    with _LOCK:
        if _ZSTD_LIB is None:
            lib = ctypes.CDLL(str(build(ZSTD_SRC, ZSTD_FLAGS,
                                        "libtartangan_zstd", "native zstd")))
            i64, ptr = ctypes.c_int64, ctypes.c_void_p
            lib.tt_zstd_decompress.argtypes = [ptr, i64,
                                               ctypes.POINTER(i64),
                                               ctypes.c_char_p, i64]
            lib.tt_zstd_decompress.restype = ptr
            lib.tt_zstd_free.argtypes = [ptr]
            lib.tt_zstd_free.restype = None
            lib.tt_crc32c.argtypes = [ptr, i64, ctypes.c_uint32]
            lib.tt_crc32c.restype = ctypes.c_uint32
            lib.tt_xxh64.argtypes = [ptr, i64, ctypes.c_uint64]
            lib.tt_xxh64.restype = ctypes.c_uint64
            _ZSTD_LIB = lib
        return _ZSTD_LIB


def _check(images):
    if images.dtype != np.uint8 or images.ndim != 4 \
            or not images.flags.c_contiguous:
        raise ValueError("the native batcher takes a C-contiguous (N, H, W, "
                         f"C) uint8 archive, got {images.shape} "
                         f"{images.dtype}")


def crop_batch(images: np.ndarray, indices, ys, xs, size: int) -> np.ndarray:
    """``images[indices[i], ys[i]:ys[i] + size, xs[i]:xs[i] + size]`` for
    each i, (n, size, size, C) uint8, in one C call."""
    _check(images)
    _, h, w, c = images.shape
    indices = np.ascontiguousarray(indices, np.int64)
    ys = np.ascontiguousarray(ys, np.int32)
    xs = np.ascontiguousarray(xs, np.int32)
    n = len(indices)
    if len(ys) != n or len(xs) != n:
        raise ValueError("indices, ys and xs differ in length")
    if n and (indices.min() < 0 or indices.max() >= len(images)
              or ys.min() < 0 or ys.max() > h - size
              or xs.min() < 0 or xs.max() > w - size):
        raise IndexError("a crop falls outside the archive")
    out = np.empty((n, size, size, c), np.uint8)
    load().crop_batch_u8(images.ctypes.data, h, w, c, indices.ctypes.data,
                         n, ys.ctypes.data, xs.ctypes.data, size,
                         out.ctypes.data)
    return out


def gather_batch(images: np.ndarray, indices) -> np.ndarray:
    """``images[indices]`` in one C call."""
    _check(images)
    indices = np.ascontiguousarray(indices, np.int64)
    n = len(indices)
    if n and (indices.min() < 0 or indices.max() >= len(images)):
        raise IndexError("an index falls outside the archive")
    out = np.empty((n,) + images.shape[1:], np.uint8)
    load().gather_batch_u8(images.ctypes.data, int(np.prod(images.shape[1:])),
                           indices.ctypes.data, n, out.ctypes.data)
    return out


def crop_batch_plain(images, indices, ys, xs, size):
    """``crop_batch`` in numpy, a row of Python per image."""
    out = np.empty((len(indices), size, size, images.shape[3]), np.uint8)
    for i, idx in enumerate(indices):
        out[i] = images[idx, ys[i]:ys[i] + size, xs[i]:xs[i] + size]
    return out


def gather_batch_plain(images, indices):
    return images[np.asarray(indices)]
