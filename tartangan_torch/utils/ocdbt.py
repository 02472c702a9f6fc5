"""The OCDBT key-value store as tensorstore writes it, standard library only.

An orbax checkpoint (``utils/orbax.py``) keeps its arrays in an OCDBT
store: an append-only B-tree of byte keys and byte values in files under
one directory. The layout this module reads and writes:

- ``manifest.ocdbt``: the store's config and its version tree. The newest
  version names the root node of the B-tree.
- B-tree nodes and out-of-line values live in data files (``d/<hex>``, or
  ``ocdbt.process_N/d/<hex>`` in the root store that orbax merges from its
  per-process stores). A reference is (data file, offset, length); every
  data-file path is relative to the store's root.
- The manifest and each node are framed: a 4-byte magic (``0c db 3a 2a``
  for a manifest, ``0c db 20 de`` for a node), the framed length (uint64
  little-endian), the format version (varint, 0) and the compression
  (varint: 0 none, 1 zstd), then the body, then the CRC32C of all that
  (uint32 little-endian). Values out of line are stored raw.
- Numbers in a body are varints; lists are stored column by column. Keys
  are prefix-compressed against the previous key, and a child node's keys
  are relative to the prefix its parent gives it (the entry's key cut to
  its ``subtree_common_prefix_length``).

``read_all(root)`` returns every key of the newest version with its value;
``write(root, items)`` makes a store with one version holding ``items``
(one leaf node, values over 1024 bytes in one data file), which tensorstore
and orbax open. An unknown format version, compression or manifest kind, a
bad magic, length or CRC raises ``ValueError``.
"""
from __future__ import annotations

import os
import struct
import time
import uuid
from dataclasses import dataclass

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
FORMAT_VERSION = 0
COMPRESSION_NONE, COMPRESSION_ZSTD = 0, 1
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


# ------------------------------------------------------------------ framing
class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data = data
        self.pos = 0
        self.what = what

    def varint(self) -> int:
        out = shift = 0
        while True:
            if self.pos >= len(self.data):
                raise ValueError(f"ocdbt: truncated {self.what}")
            byte = self.data[self.pos]
            self.pos += 1
            out |= (byte & 0x7F) << shift
            shift += 7
            if byte < 0x80:
                return out

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"ocdbt: truncated {self.what}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def unframe(data: bytes, magic: int, what: str) -> bytes:
    """The body of a framed manifest or node, its frame checked."""
    if len(data) < 18 or struct.unpack(">I", data[:4])[0] != magic:
        raise ValueError(f"ocdbt: {what} has a bad magic number")
    length = struct.unpack("<Q", data[4:12])[0]
    if length != len(data):
        raise ValueError(f"ocdbt: {what} is {len(data)} bytes, its header "
                         f"says {length}")
    crc = struct.unpack("<I", data[-4:])[0]
    if zstd.crc32c(data[:-4]) != crc:
        raise ValueError(f"ocdbt: {what} fails its CRC32C")
    head = _Reader(data[:-4], what)
    head.pos = 12
    version = head.varint()
    if version != FORMAT_VERSION:
        raise ValueError(f"ocdbt: {what} has format version {version}, "
                         f"only {FORMAT_VERSION} is known")
    compression = head.varint()
    body = data[head.pos:-4]
    if compression == COMPRESSION_ZSTD:
        return zstd.decompress(body)
    if compression == COMPRESSION_NONE:
        return body
    raise ValueError(f"ocdbt: {what} has unknown compression {compression}")


def frame(body: bytes, magic: int) -> bytes:
    """A manifest or node in its frame, the body as one stored zstd frame."""
    payload = _varint(FORMAT_VERSION) + _varint(COMPRESSION_ZSTD) \
        + zstd.compress_stored(body)
    head = struct.pack(">I", magic) + struct.pack("<Q", 12 + len(payload) + 4)
    data = head + payload
    return data + struct.pack("<I", zstd.crc32c(data))


# ---------------------------------------------------------- shared columns
def _read_prefixed(r: _Reader, n: int, extra_column: bool = False):
    """Prefix-compressed byte strings: prefix lengths [1:n], suffix lengths
    [0:n], (optionally one more column of n), then the suffixes."""
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    extra = r.varints(n) if extra_column else None
    out, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"ocdbt: bad key prefix in {r.what}")
        cur = prev[:prefix[i]] + r.take(suffix[i])
        out.append(cur)
        prev = cur
    return out, extra


def _write_prefixed(strings, extra=None) -> bytes:
    out = bytearray()
    prefix, prev = [], b""
    for s in strings:
        n = 0
        limit = min(len(s), len(prev))
        while n < limit and s[n] == prev[n]:
            n += 1
        prefix.append(n)
        prev = s
    for n in prefix[1:]:
        out += _varint(n)
    for s, n in zip(strings, prefix):
        out += _varint(len(s) - n)
    for e in extra or ():
        out += _varint(e)
    for s, n in zip(strings, prefix):
        out += s[n:]
    return bytes(out)


def _read_data_files(r: _Reader) -> list[str]:
    """A data-file table: each file's path (base path + relative path)
    relative to the store's root."""
    n = r.varint()
    paths, base_lengths = _read_prefixed(r, n, extra_column=True)
    for path, base in zip(paths, base_lengths):
        if base > len(path):
            raise ValueError(f"ocdbt: bad data-file path in {r.what}")
    return [p.decode() for p in paths]


def _write_data_files(paths) -> bytes:
    encoded = [p.encode() for p in paths]
    return _varint(len(encoded)) + _write_prefixed(encoded,
                                                   [0] * len(encoded))


# ----------------------------------------------------------------- manifest
@dataclass
class NodeRef:
    path: str        # data file, relative to the store's root
    offset: int
    length: int
    height: int


@dataclass
class Manifest:
    config: dict
    generation: int
    root: NodeRef | None
    num_keys: int


def _read_config(r: _Reader) -> dict:
    config = {"uuid": r.take(16).hex(), "manifest_kind": r.varint(),
              "max_inline_value_bytes": r.varint(),
              "max_decoded_node_bytes": r.varint(),
              "version_tree_arity_log2": r.u8()}
    compression = r.varint()
    if compression == COMPRESSION_ZSTD:
        config["compression"] = {"id": "zstd", "level": r.unpack("<i")}
    elif compression == COMPRESSION_NONE:
        config["compression"] = None
    else:
        raise ValueError(f"ocdbt: manifest config has unknown compression "
                         f"{compression}")
    return config


def read_manifest(root: str) -> Manifest:
    """The config and the newest version's root node of the store at
    ``root`` (the newest version is always among the manifest's inline
    versions; the older ones in version-tree nodes are not read)."""
    with open(os.path.join(root, "manifest.ocdbt"), "rb") as f:
        body = unframe(f.read(), MANIFEST_MAGIC, "manifest")
    r = _Reader(body, "manifest")
    config = _read_config(r)
    if config["manifest_kind"] != 0:
        raise ValueError("ocdbt: numbered manifests are not supported "
                         f"(manifest kind {config['manifest_kind']})")
    files = _read_data_files(r)
    n = r.varint()
    generation = r.varints(n)
    height = [r.u8() for _ in range(n)]
    file_id = r.varints(n)
    offset = r.varints(n)
    length = r.varints(n)
    num_keys = r.varints(n)
    r.varints(n)  # num_tree_bytes
    r.varints(n)  # num_indirect_value_bytes
    [r.unpack("<Q") for _ in range(n)]  # commit times
    if not n:
        return Manifest(config, 0, None, 0)
    i = max(range(n), key=generation.__getitem__)
    if file_id[i] >= len(files):
        raise ValueError("ocdbt: manifest root names a missing data file")
    ref = NodeRef(files[file_id[i]], offset[i], length[i], height[i])
    return Manifest(config, generation[i], ref, num_keys[i])


# -------------------------------------------------------------------- nodes
class _Files:
    """Data files read once each."""

    def __init__(self, root: str):
        self.root = root
        self.cache: dict[str, bytes] = {}

    def read(self, path: str, offset: int, length: int) -> bytes:
        data = self.cache.get(path)
        if data is None:
            with open(os.path.join(self.root, path), "rb") as f:
                data = self.cache[path] = f.read()
        if offset + length > len(data):
            raise ValueError(f"ocdbt: reference past the end of {path}")
        return data[offset:offset + length]


def _walk(files: _Files, ref: NodeRef, prefix: bytes, out: dict) -> None:
    what = f"node {ref.path}@{ref.offset}"
    r = _Reader(unframe(files.read(ref.path, ref.offset, ref.length),
                        NODE_MAGIC, what), what)
    height = r.u8()
    if height != ref.height:
        raise ValueError(f"ocdbt: {what} has height {height}, its parent "
                         f"says {ref.height}")
    table = _read_data_files(r)
    n = r.varint()

    def path_of(file_id):
        if file_id >= len(table):
            raise ValueError(f"ocdbt: {what} names a missing data file")
        return table[file_id]

    if height == 0:
        keys, _ = _read_prefixed(r, n)
        lengths = r.varints(n)
        kinds = r.varints(n)
        if any(k not in (0, 1) for k in kinds):
            raise ValueError(f"ocdbt: {what} has an unknown value kind")
        indirect = [i for i in range(n) if kinds[i] == 1]
        file_ids = r.varints(len(indirect))
        offsets = r.varints(len(indirect))
        where = {i: (path_of(f), o)
                 for i, f, o in zip(indirect, file_ids, offsets)}
        for i in range(n):
            if kinds[i] == 0:
                value = r.take(lengths[i])
            else:
                path, offset = where[i]
                value = files.read(path, offset, lengths[i])
            out[prefix + keys[i]] = value
    else:
        keys, common = _read_prefixed(r, n, extra_column=True)
        file_ids = r.varints(n)
        offsets = r.varints(n)
        lengths = r.varints(n)
        for _ in range(3):  # num_keys, num_tree_bytes, num_indirect_value_bytes
            r.varints(n)
        for i in range(n):
            if common[i] > len(keys[i]):
                raise ValueError(f"ocdbt: {what} has a bad common prefix")
            child = NodeRef(path_of(file_ids[i]), offsets[i], lengths[i],
                            height - 1)
            _walk(files, child, prefix + keys[i][:common[i]], out)
    if r.pos != len(r.data):
        raise ValueError(f"ocdbt: {what} has {len(r.data) - r.pos} bytes "
                         "after its entries")


def read_all(root: str) -> dict[bytes, bytes]:
    """Every key of the newest version of the store at ``root``, with its
    value, in key order."""
    manifest = read_manifest(root)
    out: dict[bytes, bytes] = {}
    if manifest.root is not None:
        _walk(_Files(root), manifest.root, b"", out)
    if len(out) != manifest.num_keys:
        raise ValueError(f"ocdbt: the tree holds {len(out)} keys, the "
                         f"manifest says {manifest.num_keys}")
    return out


# ------------------------------------------------------------------- writer
def _data_file_name() -> str:
    return f"d/{uuid.uuid4().hex}"


def write(root: str, items: dict) -> None:
    """Write ``items`` (bytes -> bytes) as a new store at ``root`` with one
    version: one leaf node, the values over ``MAX_INLINE_VALUE_BYTES`` in
    one data file beside it."""
    if not items:
        raise ValueError("ocdbt: a store needs at least one key")
    keys = sorted(items)
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    values_path = _data_file_name()
    kinds, offsets, blob = [], [], []
    size = 0
    for k in keys:
        v = bytes(items[k])
        if len(v) > MAX_INLINE_VALUE_BYTES:
            kinds.append(1)
            offsets.append(size)
            blob.append(v)
            size += len(v)
        else:
            kinds.append(0)
    if blob:
        with open(os.path.join(root, values_path), "wb") as f:
            for v in blob:
                f.write(v)
    node = bytearray([0])  # height 0: a leaf
    node += _write_data_files([values_path] if blob else [])
    node += _varint(len(keys))
    node += _write_prefixed(keys)
    for k in keys:
        node += _varint(len(items[k]))
    for kind in kinds:
        node += _varint(kind)
    for kind in kinds:  # every out-of-line value is in data file 0
        if kind:
            node += _varint(0)
    for off in offsets:
        node += _varint(off)
    for k, kind in zip(keys, kinds):
        if not kind:
            node += bytes(items[k])
    if len(node) > MAX_DECODED_NODE_BYTES:
        raise ValueError("ocdbt: the keys do not fit in one leaf node")
    node_path = _data_file_name()
    node_data = frame(bytes(node), NODE_MAGIC)
    with open(os.path.join(root, node_path), "wb") as f:
        f.write(node_data)

    body = bytearray(uuid.uuid4().bytes)
    body += _varint(0)  # manifest kind: single
    body += _varint(MAX_INLINE_VALUE_BYTES)
    body += _varint(MAX_DECODED_NODE_BYTES)
    body.append(VERSION_TREE_ARITY_LOG2)
    body += _varint(COMPRESSION_ZSTD) + struct.pack("<i", 0)
    body += _write_data_files([node_path])
    body += _varint(1)                   # one version
    body += _varint(1)                   # generation number
    body.append(0)                       # root height
    body += _varint(0)                   # root: data file 0
    body += _varint(0)                   # offset
    body += _varint(len(node_data))      # length
    body += _varint(len(keys))           # num_keys
    body += _varint(len(node_data))      # num_tree_bytes
    body += _varint(size)                # num_indirect_value_bytes
    body += struct.pack("<Q", time.time_ns())
    body += _varint(0)                   # no version-tree nodes
    with open(os.path.join(root, "manifest.ocdbt"), "wb") as f:
        f.write(frame(bytes(body), MANIFEST_MAGIC))
