"""Orbax's ``StandardCheckpointer`` layout, read and written without orbax.

The JAX trainer's ``--checkpoint-format orbax`` saves each artifact (a
pytree of numpy arrays) as a directory:

- ``_METADATA``: JSON. ``tree_metadata`` maps each leaf's key path (the
  repr of a tuple of strings) to its ``key_metadata`` (each key with its
  ``key_type``: 1 for a sequence position, 2 for a dict key) and
  ``value_metadata`` (``value_type`` ``np.ndarray`` or ``jax.Array`` for
  an array, ``None`` for an empty node such as optax's ``EmptyState``).
- ``_CHECKPOINT_METADATA``: JSON (handler name and timestamps).
- ``manifest.ocdbt`` and ``d/``: an OCDBT store (``utils/ocdbt.py``)
  holding one zarr v2 array per leaf: ``{name}/.zarray`` (JSON: shape,
  chunks, dtype, compressor, fill_value, order) and one key per chunk,
  ``{name}/i.j.k`` (``{name}/0`` for a 0-d array), each chunk a zstd frame
  (``utils/zstd.py``). ``name`` is the key path joined with dots.

``restore`` returns nested dicts as ``utils/msgpack.loads`` returns them
for the same artifact (flax's state-dict form): a sequence becomes a dict
keyed ``'0'``, ``'1'``, ...; an empty node becomes ``{}``; a bfloat16 leaf
comes back as a ``torch.bfloat16`` tensor, other leaves as numpy arrays.
``save`` takes that form back: a dict keyed exactly ``'0'`` to
``'n-1'`` (or a tuple or list) is written as a sequence, an empty dict (or
``None``) as an empty node, so the JAX package restores optax's states
into their tuples. Each leaf is written as one chunk; ``restore`` reads
any chunk grid. Paths are local directories: an ``s3://`` path raises
``ValueError``.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import time

import numpy as np
import torch

from . import ocdbt, zstd

KEY_SEQUENCE, KEY_DICT = 1, 2
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")
ARRAY_VALUE_TYPES = ("np.ndarray", "jax.Array", "scalar")
ZARR_DTYPES = {"float32": "<f4", "float64": "<f8", "int32": "<i4",
               "int64": "<i8", "uint32": "<u4", "uint8": "|u1",
               "bool": "|b1", "float16": "<f2", "bfloat16": "bfloat16"}


def _local(path) -> str:
    path = str(path)
    if "://" in path:
        raise ValueError(f"orbax checkpoints are local directories only, "
                         f"not {path}")
    return os.path.abspath(path)


# ------------------------------------------------------------------ leaves
def _as_array(leaf):
    """A leaf as (numpy array of its bytes' dtype, dtype name); bfloat16,
    which numpy cannot hold, as its int16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return np.asarray(arr, order="C"), arr.dtype.name  # keeps 0-d arrays


def _flatten(tree, path=((), ()), out=None):
    """[(key path, key types, leaf or None)] in the order orbax flattens a
    pytree (dict keys sorted, sequences in order)."""
    out = [] if out is None else out
    keys, types = path
    if tree is None or (isinstance(tree, dict) and not tree):
        out.append((keys, types, None))
        return out
    if isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
        kind = KEY_SEQUENCE
    elif isinstance(tree, dict):
        names = list(tree)
        if all(isinstance(k, str) for k in names) and sorted(
                names, key=lambda k: (len(k), k)) == [str(i) for i in
                                                      range(len(names))]:
            items = [(str(i), tree[str(i)]) for i in range(len(names))]
            kind = KEY_SEQUENCE
        else:
            items = sorted((str(k), v) for k, v in tree.items())
            kind = KEY_DICT
    else:
        out.append((keys, types, tree))
        return out
    for k, v in items:
        _flatten(v, (keys + (k,), types + (kind,)), out)
    return out


def _chunk_keys(grid):
    return [".".join(map(str, idx)) for idx in np.ndindex(*grid)] \
        if grid else ["0"]


# -------------------------------------------------------------------- save
def save(path, tree) -> None:
    """Write ``tree`` at ``path`` as ``StandardCheckpointer.save(path,
    tree, force=True)`` would: an existing directory is replaced."""
    path = _local(path)
    init = time.time_ns()
    leaves = _flatten(tree)
    items, meta = {}, {}
    for keys, types, leaf in leaves:
        entry = {"key_metadata": [{"key": k, "key_type": t}
                                  for k, t in zip(keys, types)]}
        meta[str(tuple(keys))] = entry
        if leaf is None:
            entry["value_metadata"] = {"value_type": "None",
                                       "skip_deserialize": True}
            continue
        entry["value_metadata"] = {"value_type": "np.ndarray",
                                   "skip_deserialize": False}
        arr, dtype = _as_array(leaf)
        if dtype not in ZARR_DTYPES:
            raise TypeError(f"orbax: no zarr dtype for {dtype} at {keys}")
        name = ".".join(keys)
        shape = list(arr.shape)
        zarray = {"chunks": [max(1, d) for d in shape],
                  "compressor": {"id": "zstd", "level": 1},
                  "dimension_separator": ".", "dtype": ZARR_DTYPES[dtype],
                  "fill_value": None, "filters": None, "order": "C",
                  "shape": shape, "zarr_format": 2}
        items[f"{name}/.zarray".encode()] = json.dumps(
            zarray, separators=(",", ":")).encode()
        if arr.size:  # an empty array has no chunk
            items[f"{name}/{_chunk_keys([1] * arr.ndim)[0]}".encode()] = \
                zstd.compress_stored(arr.tobytes())
    if os.path.lexists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    if items:  # a tree of empty nodes only has no store, as in orbax
        ocdbt.write(path, items)
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": meta, "use_ocdbt": True,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    with open(os.path.join(path, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": HANDLER, "metrics": {},
                   "performance_metrics": {}, "init_timestamp_nsecs": init,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)


# ----------------------------------------------------------------- restore
def _fill(zarray, dtype):
    """The array's fill value (a null one reads as 0)."""
    fill = zarray.get("fill_value")
    if fill is None:
        return 0
    if isinstance(fill, str):
        special = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if dtype.kind != "f" or fill not in special:
            _bad(f"fill_value {fill!r}")
        return special[fill]
    return fill


def _bad(what):
    raise ValueError(f"orbax: unsupported zarr {what}")


def _read_array(name: str, store: dict):
    raw = store.get(f"{name}/.zarray".encode())
    if raw is None:
        raise KeyError(f"orbax: no array {name!r} in the checkpoint")
    z = json.loads(raw)
    if z.get("zarr_format") != 2:
        _bad(f"format {z.get('zarr_format')}")
    if z.get("filters"):
        _bad(f"filters {z['filters']}")
    compressor = z.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        _bad(f"compressor {compressor}")
    bf16 = z["dtype"] == "bfloat16"
    dtype = np.dtype("<i2") if bf16 else np.dtype(z["dtype"])
    if dtype.hasobject or dtype.fields:
        _bad(f"dtype {z['dtype']}")
    shape, chunk = list(z["shape"]), list(z["chunks"])
    order = z.get("order", "C")
    if order not in ("C", "F"):
        _bad(f"order {order}")
    sep = z.get("dimension_separator", ".")
    fill = _fill(z, np.dtype("f4") if bf16 else dtype)
    if bf16:
        fill = torch.tensor(float(fill), dtype=torch.bfloat16).view(
            torch.int16).item()
    out = np.full(shape, fill, dtype)
    grid = [math.ceil(d / c) for d, c in zip(shape, chunk)]
    for key, idx in zip(_chunk_keys(grid), np.ndindex(*grid)):
        data = store.get(f"{name}/{key.replace('.', sep)}".encode())
        if data is None:
            continue  # a chunk never written holds the fill value
        if compressor is not None:
            data = zstd.decompress(data)
        if len(data) != math.prod(chunk) * dtype.itemsize:
            raise ValueError(f"orbax: chunk {key} of {name} is {len(data)} "
                             f"bytes, not a {chunk} {z['dtype']} chunk")
        block = np.frombuffer(data, dtype)
        block = block.reshape(chunk) if order == "C" \
            else block.reshape(chunk[::-1]).T
        sel = tuple(slice(i * c, min((i + 1) * c, d))
                    for i, c, d in zip(idx, chunk, shape))
        out[sel] = block[tuple(slice(0, s.stop - s.start) for s in sel)]
    if bf16:
        return torch.from_numpy(out).view(torch.bfloat16)
    return out


def _metadata(path: str) -> dict:
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"orbax: {path} uses zarr v3 (use_zarr3), which "
                         "is not supported")
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"orbax: {path} does not use OCDBT (use_ocdbt), "
                         "which is not supported")
    return meta


def restore(path):
    """The tree saved at ``path``, in ``utils/msgpack.loads``'s form."""
    path = _local(path)
    meta = _metadata(path)
    entries = meta["tree_metadata"].values()
    store = ocdbt.read_all(path) if any(
        e["value_metadata"]["value_type"] != "None" for e in entries) else {}
    tree: dict = {}
    for entry in entries:
        keys = [k["key"] for k in entry["key_metadata"]]
        value_type = entry["value_metadata"]["value_type"]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(str(k), {})
        if value_type == "None":
            node.setdefault(str(keys[-1]), {})
        elif value_type in ARRAY_VALUE_TYPES:
            node[str(keys[-1])] = _read_array(".".join(map(str, keys)),
                                              store)
        else:
            raise ValueError(f"orbax: unsupported value type {value_type} "
                             f"at {keys}")
    return tree

