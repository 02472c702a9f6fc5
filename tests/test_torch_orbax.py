"""The port's orbax checkpoints (``utils/zstd.py``, ``utils/ocdbt.py``,
``utils/orbax.py``) against zstandard, tensorstore, orbax and the JAX
package's own checkpoint component.

- The zstd decoder (``native/zstd.cpp``) equals ``zstandard.decompress``
  on a corpus made from a numpy seed, at levels -5, 1, 3 and 19, with and
  without the content checksum and size; walking the frames' block headers
  shows the corpus reaches raw, RLE and compressed blocks, raw, RLE,
  Huffman (1 and 4 streams, FSE-coded and direct weights) and treeless
  literals, and predefined, RLE, FSE and repeated sequence tables.
- OCDBT: tensorstore reads the port's store and the port reads
  tensorstore's (a B-tree of several levels, several versions), key for
  key.
- Orbax: what the JAX trainers' artifacts (the CNN trainer's and the text
  trainer's, with ``embedding`` and ``opt_emb``) become through
  ``ocp.StandardCheckpointer`` the port restores; what the port saves the
  JAX package's ``ModelCheckpointComponent.load_checkpoint`` restores.

Every comparison is bit for bit: same keys, dtypes, shapes and bytes.
"""
import torch_threads  # noqa: F401  (this process's share of the cores)
import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tartangan_torch.utils import msgpack, ocdbt, orbax, zstd

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "orbax_jax")
ARTIFACTS = ("d", "g", "g_target", "opt_d", "opt_g")


# ------------------------------------------------------------ frame walker
def zstd_features(data: bytes) -> set:
    """The kinds of block, literals and sequence tables in ``data``'s zstd
    frames, read from their headers (RFC 8878)."""
    feats, pos = set(), 0
    while pos < len(data):
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if magic & 0xFFFFFFF0 == 0x184D2A50:
            pos += 8 + int.from_bytes(data[pos + 4:pos + 8], "little")
            feats.add("skippable")
            continue
        assert magic == 0xFD2FB528
        fhd = data[pos + 4]
        single, fcs, checksum = fhd >> 5 & 1, fhd >> 6, fhd >> 2 & 1
        pos += 5 + (0 if single else 1) + (0, 1, 2, 4)[fhd & 3] \
            + (single, 2, 4, 8)[fcs]
        feats.add("checksum" if checksum else "no_checksum")
        feats.add("content_size" if single or fcs else "no_content_size")
        while True:
            head = int.from_bytes(data[pos:pos + 3], "little")
            pos += 3
            last, kind, size = head & 1, head >> 1 & 3, head >> 3
            feats.add(("raw_block", "rle_block", "compressed_block")[kind])
            if kind == 1:
                pos += 1
            else:
                if kind == 2:
                    feats |= _block_features(data[pos:pos + size])
                pos += size
            if last:
                break
        pos += 4 * checksum
    return feats


def _block_features(b: bytes) -> set:
    kind, sf = b[0] & 3, b[0] >> 2 & 3
    if kind < 2:
        if sf in (0, 2):
            head, regen = 1, b[0] >> 3
        elif sf == 1:
            head, regen = 2, (b[0] >> 4) + (b[1] << 4)
        else:
            head, regen = 3, (b[0] >> 4) + (b[1] << 4) + (b[2] << 12)
        feats = {("lit_raw", "lit_rle")[kind]}
        pos = head + (regen if kind == 0 else 1)
    else:
        head = 3 if sf < 2 else sf + 2
        bits = (10, 10, 14, 18)[sf]
        size = int.from_bytes(b[:head], "little") >> (4 + bits) \
            & ((1 << bits) - 1)
        streams = "_1stream" if sf == 0 else "_4streams"
        feats = {("lit_huffman" if kind == 2 else "lit_treeless") + streams}
        if kind == 2:
            feats.add("huf_weights_" + ("fse" if b[head] < 128 else "direct"))
        pos = head + size
    n = b[pos]
    if n == 0:
        return feats | {"no_sequences"}
    pos += 1 if n < 128 else (2 if n < 255 else 3)
    for shift in (6, 4, 2):
        feats.add("seq_" + ("predefined", "rle", "fse",
                            "repeat")[b[pos] >> shift & 3])
    return feats


# ------------------------------------------------------------------- (a) zstd
def _corpus():
    rng = np.random.default_rng(0)
    words = np.array("the quick brown fox jumps over a lazy dog and runs "
                     "far away from home".split())
    text = " ".join(words[rng.integers(0, len(words), 400_000)]).encode()
    runs = b"".join(bytes([int(v)]) * int(n) for v, n in zip(
        rng.integers(0, 4, 3000), rng.integers(1, 1200, 3000)))
    return {
        "empty": b"", "one_byte": b"\x07", "zeros": bytes(300_000),
        "runs": runs, "text": text[:2_000_000],
        "weights": (rng.standard_normal(300_000) * 0.05).astype(
            np.float32).tobytes(),
        "noise": rng.bytes(1_100_000),
        "ramp": (np.arange(1_000_000) % 251).astype(np.uint8).tobytes(),
    }


CORPUS_NAMES = list(_corpus())


@pytest.fixture(scope="module")
def compressed():
    """name -> (input, [zstd frames at levels -5, 1, 3, 19, each with
    checksum and size, and without both])."""
    zstandard = pytest.importorskip("zstandard")
    out = {}
    for name, data in _corpus().items():
        frames = [zstandard.ZstdCompressor(
            level=level, write_checksum=flags,
            write_content_size=flags).compress(data)
            for level in (-5, 1, 3, 19) for flags in (True, False)]
        out[name] = (data, frames)
    return out


@pytest.mark.parametrize("name", CORPUS_NAMES)
def test_decompress_matches_zstandard(compressed, name):
    import zstandard
    data, frames = compressed[name]
    for frame in frames:
        ours = zstd.decompress(frame)
        assert ours == zstandard.ZstdDecompressor().decompressobj(
        ).decompress(frame) == data


def test_corpus_reaches_every_block_kind(compressed):
    feats = set()
    for _, frames in compressed.values():
        for frame in frames:
            feats |= zstd_features(frame)
    assert feats >= {
        "raw_block", "rle_block", "compressed_block", "lit_raw", "lit_rle",
        "lit_huffman_1stream", "lit_huffman_4streams", "huf_weights_fse",
        "huf_weights_direct", "lit_treeless_1stream",
        "lit_treeless_4streams", "seq_predefined", "seq_rle", "seq_fse",
        "seq_repeat", "no_sequences", "checksum", "no_checksum",
        "content_size", "no_content_size"}, feats


def test_frames_back_to_back_and_skippable(compressed):
    text, frames = compressed["text"]
    weights, wframes = compressed["weights"]
    skippable = struct.pack("<II", 0x184D2A53, 5) + b"hello"
    data = frames[3] + skippable + wframes[0] + zstd.compress_stored(b"!")
    assert zstd.decompress(data) == text + weights + b"!"
    assert "skippable" in zstd_features(data)


def _frame_with_size(data: bytes, size: int) -> bytes:
    """A stored frame whose header states ``size``."""
    frame = bytearray(zstd.compress_stored(data))
    frame[5:13] = struct.pack("<Q", size)
    return bytes(frame)


@pytest.mark.parametrize("case", ["checksum", "dictionary", "magic",
                                  "past_size", "short", "truncated"])
def test_decoder_refuses(compressed, case):
    text, frames = compressed["text"]
    good = bytearray(frames[2])  # level 3, with checksum and size
    if case == "checksum":
        good[-1] ^= 0x40
        bad, match = bytes(good), "checksum"
    elif case == "dictionary":
        # frame header: single segment, a 1-byte dictionary id, 1-byte size
        bad = struct.pack("<IBBB", zstd.MAGIC, 0x21, 7, 1) + b"\x09\x00\x00x"
        match = "dictionary"
    elif case == "magic":
        good[0] ^= 1
        bad, match = bytes(good), "magic"
    elif case == "past_size":
        bad, match = _frame_with_size(b"0123456789", 4), "past"
    elif case == "short":
        bad, match = _frame_with_size(b"0123456789", 12), "shorter"
    else:
        bad, match = bytes(good[:len(good) // 2]), "truncated"
    with pytest.raises(ValueError, match=match):
        zstd.decompress(bad)


def test_crc32c_and_xxh64_known_vectors():
    # RFC 3720 (iSCSI) B.4 vectors and the common check value
    assert zstd.crc32c(b"") == 0
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(bytes(32)) == 0x8A9136AA
    assert zstd.crc32c(b"\xff" * 32) == 0x62A8AB43
    assert zstd.crc32c(bytes(range(32))) == 0x46DD794E
    assert zstd.crc32c(bytes(range(31, -1, -1))) == 0x113FDB5C
    assert zstd.crc32c(b"6789", zstd.crc32c(b"12345")) == 0xE3069283
    # XXH64 reference values (seed 0)
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"a") == 0xD24EC4F1A98C6E5B
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999


@pytest.mark.parametrize("size", [0, 1, 131072, 131073, 300_001])
def test_compress_stored_is_a_valid_frame(size):
    zstandard = pytest.importorskip("zstandard")
    data = np.random.default_rng(size).bytes(size)
    frame = zstd.compress_stored(data)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert zstd.decompress(frame) == data
    feats = zstd_features(frame)
    assert feats <= {"raw_block", "content_size", "no_checksum"}


def test_committed_fixture_has_compressed_frames():
    """The JAX-written fixture the smoke reads on the card decodes real
    compressed blocks: its zarr chunks and OCDBT nodes hold Huffman
    literals in 1 and 4 streams and FSE sequence tables."""
    feats = set()
    for name in ARTIFACTS:
        root = os.path.join(FIXTURE, f"{name}.orbax")
        for key, value in ocdbt.read_all(root).items():
            if not key.endswith(b".zarray"):
                feats |= zstd_features(value)
        for folder, _, files in os.walk(root):
            for file in files:
                with open(os.path.join(folder, file), "rb") as f:
                    data = f.read()
                if data[:2] == b"\x0c\xdb" and data[13] == 1:  # framed, zstd
                    feats |= zstd_features(data[14:-4])
    assert feats >= {"compressed_block", "lit_huffman_1stream",
                     "lit_huffman_4streams", "seq_fse"}, feats


# ------------------------------------------------------------------ (b) OCDBT
def _ts_read_all(root):
    ts = pytest.importorskip("tensorstore")
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{root}"}).result()
    return {k: bytes(kv.read(k).result().value) for k in kv.list().result()}


def test_tensorstore_reads_the_port_store(tmp_path):
    rng = np.random.default_rng(1)
    items = {f"a/{i:03d}/{'x' * int(rng.integers(0, 30))}".encode():
             rng.bytes(int(rng.integers(0, 4000))) for i in range(200)}
    items[b""] = b"the empty key"
    items[b"\x00\xff binary"] = b""
    ocdbt.write(str(tmp_path / "s"), items)
    assert _ts_read_all(str(tmp_path / "s")) == items
    assert ocdbt.read_all(str(tmp_path / "s")) == items


def test_port_reads_a_tensorstore_store(tmp_path):
    """Small nodes and a narrow version tree: a B-tree three levels deep,
    keys relative to their parents' prefixes, nodes at offsets inside
    shared data files, out-of-line values and several versions."""
    ts = pytest.importorskip("tensorstore")
    root = str(tmp_path / "ts")
    kv = ts.KvStore.open({
        "driver": "ocdbt", "base": f"file://{root}",
        "config": {"max_decoded_node_bytes": 600,
                   "max_inline_value_bytes": 16,
                   "version_tree_arity_log2": 2}}).result()
    rng = np.random.default_rng(2)
    for commit in range(6):
        with ts.Transaction() as txn:
            for i in range(40):
                key = f"key/{commit:02d}/{i:04d}/" + "x" * int(
                    rng.integers(0, 20))
                kv.with_transaction(txn).write(
                    key, rng.bytes(int(rng.integers(0, 40)))).result()
    manifest = ocdbt.read_manifest(root)
    assert manifest.root.height >= 2 and manifest.generation >= 6
    assert ocdbt.read_all(root) == _ts_read_all(root)
    assert len(ocdbt.read_all(root)) == 240


@pytest.mark.parametrize("case", ["crc", "version", "compression",
                                  "length"])
def test_ocdbt_refuses(tmp_path, case):
    ocdbt.write(str(tmp_path), {b"k": b"v"})
    path = tmp_path / "manifest.ocdbt"
    data = bytearray(path.read_bytes())
    if case == "crc":
        data[-8] ^= 1
        match = "CRC32C"
    else:
        if case == "version":
            data[12] = 1
            match = "format version"
        elif case == "compression":
            data[13] = 7
            match = "compression"
        else:
            data = data[:-5] + data[-4:]
            match = "header says"
        body = bytes(data[:-4])
        data = body + struct.pack("<I", zstd.crc32c(body))
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=match):
        ocdbt.read_all(str(tmp_path))


# ------------------------------------------------------------------ (c), (d)
def assert_trees_equal(ours, theirs, path=""):
    """Same keys, and each leaf the same dtype, shape and bytes."""
    if isinstance(theirs, dict):
        assert isinstance(ours, dict) and sorted(ours) == sorted(theirs), \
            (path, sorted(ours) if isinstance(ours, dict) else ours)
        for k in theirs:
            assert_trees_equal(ours[k], theirs[k], f"{path}/{k}")
        return
    if isinstance(theirs, torch.Tensor):
        assert isinstance(ours, torch.Tensor), path
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
        assert torch.equal(ours.view(torch.int16), theirs.view(torch.int16))
        return
    assert type(ours) is type(theirs), (path, type(ours), type(theirs))
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, path
    assert ours.tobytes() == theirs.tobytes(), path


TEXT_ARGS = ["--embedding-dims", "8", "--context", "2",
             "--pretrain-embedding", "0"]


@pytest.fixture(scope="module")
def jax_trainers(tmp_path_factory):
    """The JAX CNN trainer at config '8' and the text trainer at '16',
    step 0, under ``--checkpoint-format orbax``; no train step is
    compiled."""
    from tartangan_tpu.train.cnn import CNNTrainer
    from tartangan_tpu.train.text_cnn import TextCNNTrainer
    tmp = tmp_path_factory.mktemp("jax")
    images = np.random.default_rng(0).integers(0, 256, (8, 16, 16, 3),
                                               dtype=np.uint8)
    np.savez(tmp / "data.npz", images=images)
    (tmp / "docs.txt").write_text("\n".join(
        ["the quick brown fox jumps over the lazy dog ."] * 4
        + ["a stitch in time saves nine ."] * 4))
    common = ["--batch-size", "8", "--output", str(tmp / "out"),
              "--dtype", "f32", "--quiet-logs", "--checkpoint-format",
              "orbax"]
    cnn = CNNTrainer.create_from_cli([str(tmp / "data.npz"), "--config",
                                      "8", "--run-id", "cnn", *common])
    text = TextCNNTrainer.create_from_cli([str(tmp / "docs.txt"),
                                           "--config", "16", "--run-id",
                                           "text", *common, *TEXT_ARGS])
    for trainer in (cnn, text):
        trainer.build_models()
    return {"cnn": cnn, "text": text}


@pytest.mark.parametrize("kind", ["cnn", "text"])
def test_port_restores_jax_orbax_checkpoints(jax_trainers, tmp_path, kind):
    """``ocp.StandardCheckpointer`` (the JAX component's save) writes the
    trainer's artifacts; the port restores each equal to its msgpack."""
    import orbax.checkpoint as ocp
    artifacts = jax.device_get(jax_trainers[kind].checkpoint_artifacts())
    if kind == "text":
        assert {"embedding", "opt_emb"} <= set(artifacts)
    with ocp.StandardCheckpointer() as ckptr:
        for name, tree in artifacts.items():
            ckptr.save(str(tmp_path / f"{name}.orbax"), tree, force=True)
    for name, tree in artifacts.items():
        ours = orbax.restore(tmp_path / f"{name}.orbax")
        assert_trees_equal(ours, msgpack.loads(serialization.to_bytes(tree)))


def test_port_restores_the_committed_fixture():
    for name in ARTIFACTS:
        with open(os.path.join(FIXTURE, f"{name}.msgpack"), "rb") as f:
            twin = msgpack.loads(f.read())
        assert_trees_equal(orbax.restore(os.path.join(FIXTURE,
                                                      f"{name}.orbax")), twin)


def _checkpoint_component(trainer):
    from tartangan_tpu.train.components.model_checkpoint import (
        ModelCheckpointComponent,
    )
    return next(c for c in trainer.components.components
                if isinstance(c, ModelCheckpointComponent))


@pytest.mark.parametrize("kind", ["cnn", "text"])
def test_jax_load_checkpoint_restores_port_orbax(jax_trainers, kind):
    """The port saves the artifacts (as read from their msgpack) at step
    7; the JAX component's ``load_checkpoint`` under ``--checkpoint-format
    orbax`` restores them over a zeroed state, equal bit for bit."""
    trainer = jax_trainers[kind]
    artifacts = jax.device_get(trainer.checkpoint_artifacts())
    component = _checkpoint_component(trainer)
    trainer.steps = 7
    os.makedirs(component.checkpoint_root, exist_ok=True)
    for name, tree in artifacts.items():
        orbax.save(f"{component.checkpoint_root}/{name}.orbax",
                   msgpack.loads(serialization.to_bytes(tree)))
    with open(f"{component.checkpoint_root}/trainer.json", "w") as f:
        json.dump(trainer.get_state(), f)
    trainer.load_checkpoint_artifacts(
        jax.tree_util.tree_map(jnp.zeros_like, artifacts))
    component.load_checkpoint()
    restored = jax.device_get(trainer.checkpoint_artifacts())
    assert jax.tree_util.tree_structure(restored) == \
        jax.tree_util.tree_structure(artifacts)
    for (key, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(restored),
            jax.tree_util.tree_leaves_with_path(artifacts)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key


def test_bfloat16_leaves_both_ways(tmp_path):
    """A bfloat16 leaf: the port's save restored by orbax into a bfloat16
    template, and orbax's save restored by the port as a torch.bfloat16
    tensor, bit for bit; with 0-d leaves."""
    import orbax.checkpoint as ocp
    rng = np.random.default_rng(3)
    values = rng.standard_normal((5, 7)).astype(np.float32)
    bf = jnp.asarray(values, jnp.bfloat16)
    tree = {"w": np.asarray(bf), "n": np.asarray(3, np.int32),
            "s": {"x": rng.standard_normal(4)}}
    ours = {"w": torch.from_numpy(values).to(torch.bfloat16),
            "n": np.asarray(3, np.int32), "s": {"x": tree["s"]["x"]}}
    assert np.asarray(bf).view(np.int16).tobytes() == \
        ours["w"].view(torch.int16).numpy().tobytes()
    orbax.save(tmp_path / "port", ours)
    with ocp.StandardCheckpointer() as ckptr:
        back = ckptr.restore(str(tmp_path / "port"), tree)
        ckptr.save(str(tmp_path / "jax"), tree, force=True)
    assert back["w"].dtype == jnp.bfloat16
    assert np.asarray(back["w"]).tobytes() == np.asarray(bf).tobytes()
    assert np.asarray(back["s"]["x"]).tobytes() == tree["s"]["x"].tobytes()
    assert_trees_equal(orbax.restore(tmp_path / "jax"), ours)
    assert_trees_equal(orbax.restore(tmp_path / "port"), ours)


def test_port_restores_jax_array_leaves(tmp_path):
    """Leaves saved as ``jax.Array`` (``value_type`` jax.Array, with
    ``_sharding`` and ``array_metadatas`` beside the store), a tuple and an
    empty node restore in msgpack's form."""
    import orbax.checkpoint as ocp
    tree = {"a": jnp.arange(12.0).reshape(3, 4),
            "b": (jnp.int32(3), jnp.ones(5, jnp.bfloat16)), "c": None}
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(str(tmp_path / "c"), tree)
    assert (tmp_path / "c" / "_sharding").exists()
    ours = orbax.restore(tmp_path / "c")
    assert_trees_equal(ours, {
        "a": np.arange(12.0, dtype=np.float32).reshape(3, 4),
        "b": {"0": np.asarray(3, np.int32),
              "1": torch.ones(5, dtype=torch.bfloat16)},
        "c": {}})


def test_chunk_grid_and_fill_value_from_tensorstore(tmp_path):
    """Zarr arrays that tensorstore writes in a grid of chunks with edge
    chunks read as zarr defines them: an int32 one with a column of chunks
    never written, which holds the fill value, and a bfloat16 one."""
    ts = pytest.importorskip("tensorstore")
    root = tmp_path / "ck"
    orbax.save(root, {"a": np.zeros(2, np.float32)})
    arr = ts.open({"driver": "zarr",
                   "kvstore": {"driver": "ocdbt", "base": f"file://{root}",
                               "path": "b/"},
                   "metadata": {"shape": [10, 7], "chunks": [4, 3],
                                "dtype": "<i4", "fill_value": -3,
                                "compressor": {"id": "zstd", "level": 3}},
                   "create": True}).result()
    values = np.arange(70, dtype=np.int32).reshape(10, 7)
    arr[:, :6].write(values[:, :6]).result()
    halves = np.random.default_rng(4).standard_normal((5, 7)).astype(
        jnp.bfloat16)
    ts.open({"driver": "zarr",
             "kvstore": {"driver": "ocdbt", "base": f"file://{root}",
                         "path": "c/"},
             "metadata": {"shape": [5, 7], "chunks": [2, 3],
                          "dtype": "bfloat16",
                          "compressor": {"id": "zstd", "level": 1}},
             "create": True}).result().write(halves).result()
    meta = json.loads((root / "_METADATA").read_text())
    for name in ("b", "c"):
        meta["tree_metadata"][f"('{name}',)"] = {
            "key_metadata": [{"key": name, "key_type": 2}],
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False}}
    (root / "_METADATA").write_text(json.dumps(meta))
    want = values.copy()
    want[:, 6:] = -3
    back = orbax.restore(root)
    assert back["b"].dtype == np.int32 and np.array_equal(back["b"], want)
    assert back["c"].dtype == torch.bfloat16
    assert back["c"].view(torch.int16).numpy().tobytes() == \
        halves.view(np.int16).tobytes()


# --------------------------------------------------------------- (e) refusals
@pytest.mark.parametrize("case", ["s3_save", "s3_restore", "zarr3",
                                  "s3_trainer"])
def test_orbax_refusals(tmp_path, case):
    if case == "s3_save":
        with pytest.raises(ValueError, match="s3://bucket/run"):
            orbax.save("s3://bucket/run/g.orbax", {"a": np.zeros(1)})
    elif case == "s3_restore":
        with pytest.raises(ValueError, match="s3://bucket/run"):
            orbax.restore("s3://bucket/run/g.orbax")
    elif case == "zarr3":
        orbax.save(tmp_path / "c", {"a": np.zeros(1)})
        meta = json.loads((tmp_path / "c" / "_METADATA").read_text())
        meta["use_zarr3"] = True
        (tmp_path / "c" / "_METADATA").write_text(json.dumps(meta))
        with pytest.raises(ValueError, match="use_zarr3"):
            orbax.restore(tmp_path / "c")
    else:
        from tartangan_torch.train.components.model_checkpoint import (
            ModelCheckpointComponent,
        )

        class Args:
            checkpoint_format = "orbax"
            resume_training_step = None
            resume_training_latest = False

        class Trainer:
            args = Args()
            output_root = "s3://bucket/run"
            steps = 0

        component = ModelCheckpointComponent(Args())
        component.trainer = Trainer()
        with pytest.raises(ValueError, match="s3://bucket/run"):
            component.on_train_begin(0, {})
