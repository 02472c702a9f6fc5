"""Checkpoints between the two trainers, in both directions: the JAX
package reads what the port's trainer writes (``serialization.from_bytes``
into the JAX trainer's templates, and ``tartangan_tpu.serve``), and the
port resumes from what the JAX trainer writes. A port-trained run also
serves through the port with its BatchNorm buffers untouched.
"""
import torch_threads  # noqa: F401  (this process's share of the cores)
import io
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import torch
from flax import serialization
from PIL import Image

from tartangan_torch.train.cnn import CNNTrainer
from tartangan_tpu.train.cnn import CNNTrainer as JaxCNNTrainer


def _argv(archive, out, run_id, *extra):
    return [archive, "--config", "16", "--batch-size", "8", "--epochs", "1",
            "--output", str(out), "--gen-freq", "100",
            "--checkpoint-freq", "100", "--run-id", run_id, "--dtype", "f32",
            "--quiet-logs", *extra]


def _leaves(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    return zip(la, lb)


def _get(module, run, paths, extra=()):
    app = module._ServeApp(module._ServeApp.parse_cli_args([run, *extra]))
    app.load_generator()
    server = ThreadingHTTPServer(("127.0.0.1", 0), module.make_handler(app))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        return app, {p: urllib.request.urlopen(base + p, timeout=300).read()
                     for p in paths}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def test_jax_reads_and_serves_a_port_trained_run(tiny_archive, tmp_path):
    out = tmp_path / "out"
    CNNTrainer.create_from_cli(_argv(tiny_archive, out, "port",
                                     "--device", "cpu")).train()
    ckpt = out / "port" / "checkpoints" / "3"

    # the JAX trainer's own templates restore the port's bytes
    jt = JaxCNNTrainer.create_from_cli(_argv(tiny_archive, tmp_path / "j",
                                             "tmpl"))
    jt.build_models()
    templates = jax.device_get(jt.checkpoint_artifacts())
    for name, template in templates.items():
        data = (ckpt / f"{name}.msgpack").read_bytes()
        restored = serialization.from_bytes(template, data)
        for a, b in _leaves(restored, template):
            assert np.shape(a) == np.shape(b)
            assert np.asarray(a).dtype == np.asarray(b).dtype, name
    assert int(serialization.from_bytes(
        templates["opt_d"], (ckpt / "opt_d.msgpack").read_bytes())[0].count) == 3

    import tartangan_torch.serve as torch_serve
    import tartangan_tpu.serve as jax_serve
    paths = ["/generate?seed=7", "/grid?n=2&seed=1"]
    _, ref = _get(jax_serve, str(out / "port"), paths, ["--port", "0"])
    app, ours = _get(torch_serve, str(out / "port"), paths,
                     ["--port", "0", "--device", "cpu"])
    a = np.asarray(Image.open(io.BytesIO(ours[paths[0]])), np.int16)
    b = np.asarray(Image.open(io.BytesIO(ref[paths[0]])), np.int16)
    assert a.shape == b.shape == (18, 18, 3)
    assert np.abs(a - b).max() <= 1

    # the served requests left every buffer of the generator as the
    # checkpoint holds it
    from tartangan_torch.convert import from_flax
    from tartangan_torch.utils import msgpack
    saved = from_flax(msgpack.loads((ckpt / "g.msgpack").read_bytes()))
    buffers = dict(app.g.named_buffers())
    assert buffers and set(buffers) <= set(saved)
    for k, v in buffers.items():
        torch.testing.assert_close(v, saved[k], rtol=0, atol=0)


def test_port_resumes_from_a_jax_checkpoint(tiny_archive, tmp_path):
    out = tmp_path / "out"
    jt = JaxCNNTrainer.create_from_cli(_argv(tiny_archive, out, "run"))
    jt.train()
    assert jt.steps == 3
    ours = CNNTrainer.create_from_cli(_argv(
        tiny_archive, out, "run", "--device", "cpu",
        "--resume-training-latest", "--epochs", "0"))
    ours.train()
    assert ours.steps == 3
    theirs = jax.device_get(jt.checkpoint_artifacts())
    mine = ours.checkpoint_artifacts()
    for name in ("g", "g_target", "d", "opt_g", "opt_d"):
        mine_tree = mine[name]
        ref = serialization.to_state_dict(theirs[name])
        for a, b in _leaves(mine_tree, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
