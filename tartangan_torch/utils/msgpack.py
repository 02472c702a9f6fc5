"""Reader and writer for flax's msgpack checkpoint format, standard library only.

The JAX trainer writes each checkpoint artifact with
``flax.serialization.to_bytes`` (``train/components/model_checkpoint.py``):
a msgpack map of nested string-keyed maps whose leaves are arrays. Arrays
are msgpack ext type 1, whose payload is itself msgpack of
``(shape, dtype name, C-order bytes)``; numpy scalars are ext type 3 with the
same payload (see ``flax/serialization.py``: ``_MsgpackExtType``,
``_ndarray_to_bytes``).

``loads`` returns nested dicts of numpy arrays. A ``bfloat16`` leaf, which
numpy cannot hold, comes back as a ``torch.bfloat16`` tensor with the same
bits. ``dumps`` takes numpy arrays, numpy scalars and torch tensors as
leaves. Flax's chunked form for arrays over 2**30 bytes is not supported
and raises.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
_CHUNKED_KEY = "__msgpack_chunked_array__"


# ------------------------------------------------------------------ writer
def _pack_uint(out: bytearray, n: int, fix_max: int, fix_tag: int,
               tags: tuple) -> None:
    """A length or count header: a fixed form below ``fix_max``, else the
    8/16/32-bit form from ``tags`` (a 0 tag means that width does not exist)."""
    if n < fix_max:
        out.append(fix_tag | n)
        return
    for tag, fmt, limit in zip(tags, (">B", ">H", ">I"),
                               (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if tag and n <= limit:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack_int(out: bytearray, n: int) -> None:
    if 0 <= n < 128:
        out.append(n)
    elif -32 <= n < 0:
        out += struct.pack(">b", n)
    elif n >= 0:
        for tag, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                (0xCE, ">I", 0xFFFFFFFF),
                                (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= limit:
                out.append(tag)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"integer {n} too large for msgpack")
    else:
        for tag, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if n >= -limit:
                out.append(tag)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"integer {n} too small for msgpack")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_uint(out, n, 0, 0, (0xC7, 0xC8, 0xC9))
    out.append(code)
    out += data


def _array_payload(shape, dtype_name: str, buf: bytes) -> bytes:
    out = bytearray()
    _pack(out, [list(shape), dtype_name, buf])
    return bytes(out)


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int) and not isinstance(obj, np.generic):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_uint(out, len(data), 32, 0xA0, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_uint(out, len(data), 0, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_uint(out, len(obj), 16, 0x90, (0, 0xDC, 0xDD))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _pack_uint(out, len(obj), 16, 0x80, (0, 0xDE, 0xDF))
        for key, value in obj.items():
            _pack(out, key)
            _pack(out, value)
    elif isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        dtype_name = str(t.dtype).removeprefix("torch.")
        buf = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        _pack_ext(out, EXT_NDARRAY, _array_payload(t.shape, dtype_name, buf))
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _array_payload(
            obj.shape, obj.dtype.name, obj.tobytes("C")))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _array_payload(
            (), obj.dtype.name, np.asarray(obj).tobytes("C")))
    else:
        raise TypeError(f"cannot msgpack a {type(obj).__name__}")


def dumps(tree) -> bytes:
    """Serialize a nested dict of arrays as ``flax.serialization.to_bytes``
    does."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


# ------------------------------------------------------------------ reader
class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        tag = self.unpack(">B")
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self._map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return self._array(tag & 0x0F)
        if 0xA0 <= tag <= 0xBF:
            return bytes(self.take(tag & 0x1F)).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if tag in simple:
            return simple[tag]
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if tag in scalars:
            return self.unpack(scalars[tag])
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B",
                 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I",
                 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if tag in sized:
            n = self.unpack(sized[tag])
            if tag in (0xC4, 0xC5, 0xC6):
                return bytes(self.take(n))
            if tag in (0xD9, 0xDA, 0xDB):
                return bytes(self.take(n)).decode("utf-8")
            if tag in (0xDC, 0xDD):
                return self._array(n)
            if tag in (0xDE, 0xDF):
                return self._map(n)
            return self._ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if tag in fixext:
            return self._ext(fixext[tag])
        raise ValueError(f"unsupported msgpack type byte 0x{tag:02x}")

    def _array(self, n):
        return [self.read() for _ in range(n)]

    def _map(self, n):
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        if _CHUNKED_KEY in out:
            raise ValueError("chunked msgpack arrays (over 2**30 bytes) are "
                             "not supported")
        return out

    def _ext(self, n):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        arr = _array_from_payload(data)
        if code == EXT_NPSCALAR and isinstance(arr, np.ndarray):
            return arr[()]
        return arr


def _array_from_payload(data: bytes):
    shape, dtype_name, buf = _Reader(data).read()
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    shape = tuple(shape)
    if dtype_name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def loads(data: bytes):
    """Deserialize bytes written by ``flax.serialization.to_bytes``."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack object")
    return tree
