"""The port's serving path: the flax msgpack reader/writer, the PNG writer,
and ``tartangan_torch.serve`` against ``tartangan_tpu.serve`` on one run
directory written by the JAX package.

Served images are compared as decoded uint8 pixels to within 1 (float32
differences of ~1e-5 can flip a rounding).
"""
import torch_threads  # noqa: F401  (this process's share of the cores)
import io
import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

from tartangan_tpu.configs import GAN_CONFIGS
from tartangan_tpu.models import factories as JF
from tartangan_tpu.models.pluggan import Generator as JaxGenerator
from tartangan_torch.utils import msgpack
from tartangan_torch.utils.imaging import encode_png, make_grid, to_uint8


def _tree(rng):
    return {
        "params": {
            "blocks_4": {"gamma": np.array(0.7, np.float32),
                         "theta": {"kernel": rng.standard_normal(
                             (1, 1, 8, 1)).astype(np.float32)}},
            "Dense_0": {"kernel": rng.standard_normal((5, 3)).astype(np.float32),
                        "bias": np.zeros(3, np.float32)},
            "half": jnp.asarray(rng.standard_normal(7), jnp.bfloat16),
            "scalar": np.float32(1.25),
            "steps": np.int32(-3),
        },
        "batch_stats": {"mean": np.arange(4, dtype=np.float64)},
    }


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _as_np(x):
    if isinstance(x, torch.Tensor):  # bf16 comes back as a torch tensor
        return x.float().numpy(), "bfloat16"
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x, \
        x.dtype.name


def test_msgpack_reads_flax_bytes(rng):
    tree = _tree(rng)
    ours = msgpack.loads(serialization.to_bytes(tree))
    for (path, a), (path2, b) in zip(_leaves(jax.device_get(tree)),
                                     _leaves(ours)):
        assert path == path2
        (a, adt), (b, bdt) = _as_np(a), _as_np(b)
        assert adt == bdt and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)
    assert ours["params"]["blocks_4"]["gamma"].shape == ()
    assert ours["params"]["half"].dtype == torch.bfloat16


def test_msgpack_writes_flax_bytes(rng):
    tree = jax.device_get(_tree(rng))
    ours = msgpack.loads(serialization.to_bytes(tree))
    data = msgpack.dumps(ours)
    assert data == serialization.to_bytes(tree)  # byte for byte
    back = serialization.msgpack_restore(data)
    for (_, a), (_, b) in zip(_leaves(tree), _leaves(back)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_msgpack_rejects_chunked_arrays():
    data = msgpack.dumps({"w": {"__msgpack_chunked_array__": True,
                                "shape": [2], "chunks": {}}})
    with pytest.raises(ValueError, match="chunked"):
        msgpack.loads(data)


@pytest.mark.parametrize("channels", [1, 3])
def test_png_writer_decodes_with_pil(rng, channels):
    arr = rng.integers(0, 256, size=(13, 21, channels), dtype=np.uint8)
    decoded = np.asarray(Image.open(io.BytesIO(encode_png(arr))))
    np.testing.assert_array_equal(decoded.reshape(arr.shape), arr)
    imgs = rng.uniform(-1, 1, size=(5, 8, 8, 3)).astype(np.float32)
    grid = make_grid(to_uint8(imgs), nrow=3)
    decoded = np.asarray(Image.open(io.BytesIO(encode_png(grid))))
    np.testing.assert_array_equal(decoded, grid)


# 'test128' has the attention layer after block 3 (blocks_4); halved, it
# serves 128x128 images with an 8-channel attention layer at 64x64
_ARGS = ["--config", "test128", "--model-scale", "0.5"]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A run directory as the JAX trainer lays it out, with nonzero gamma
    and distinct EMA target weights."""
    rng = np.random.default_rng(0)
    cfg = GAN_CONFIGS["test128"].scale_model(0.5)
    g = JaxGenerator(cfg, input_factory=JF.g_input_factory("mlp", "relu"),
                     block_factory=JF.g_block_factory("bn", "relu"),
                     output_factory=JF.g_output_factory("bn", "relu"))
    variables = jax.device_get(g.init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, cfg.latent_dims))))
    params = jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        variables["params"])
    params["blocks_4"]["gamma"] = np.array(0.9, np.float32)
    target = jax.tree_util.tree_map(lambda a: a * 1.1, params)
    run = tmp_path_factory.mktemp("run")
    ckpt = run / "checkpoints" / "5"
    ckpt.mkdir(parents=True)
    (run / "config.args").write_text("\n".join(["data.npz", *_ARGS]))
    (ckpt / "g.msgpack").write_bytes(serialization.to_bytes(
        {"params": params, "batch_stats": variables["batch_stats"]}))
    (ckpt / "g_target.msgpack").write_bytes(
        serialization.to_bytes({"params": target}))
    return str(run)


def _serve(module, argv, paths):
    app = module._ServeApp(module._ServeApp.parse_cli_args(argv))
    app.load_generator(target=not app.args.no_target)
    server = ThreadingHTTPServer(("127.0.0.1", 0), module.make_handler(app))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        return {p: urllib.request.urlopen(base + p, timeout=300).read()
                for p in paths}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


@pytest.mark.parametrize("no_target", [False, True])
def test_torch_serve_matches_jax_serve(jax_run, no_target):
    import tartangan_torch.serve as torch_serve
    import tartangan_tpu.serve as jax_serve
    paths = ["/", "/meta", "/generate?seed=7", "/grid?n=3&seed=3"]
    extra = ["--no-target"] if no_target else []
    ref = _serve(jax_serve, [jax_run, "--port", "0", *extra], paths)
    ours = _serve(torch_serve, [jax_run, "--port", "0", "--device", "cpu",
                                *extra], paths)
    assert ours["/"] == ref["/"]
    assert json.loads(ours["/meta"]) == json.loads(ref["/meta"]) == {
        "latent_dims": 64, "image_size": 128, "data_dims": 3}
    for p in paths[2:]:
        assert ours[p][:8] == b"\x89PNG\r\n\x1a\n"
        a = np.asarray(Image.open(io.BytesIO(ours[p])), np.int16)
        b = np.asarray(Image.open(io.BytesIO(ref[p])), np.int16)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1, p
        assert a.std() > 1  # not a blank image
