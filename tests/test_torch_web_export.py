"""The port's web export against the JAX package's: the ``torch.export``
program (``.pt2``) against G and the JAX StableHLO artifact, and the
attention custom op that lets ``torch.export`` record K1 by name.
"""
import json
import os

import jax
import numpy as np
import torch

from test_torch_explore import write_run
from tartangan_torch.models.attention import SelfAttention2d
from tartangan_torch.ops import attention as A


def test_attention_op_under_export():
    """Outside autograd the attention is the custom op: ``torch.export``
    records ``tartangan::attention`` by name (no Python or ctypes call in
    the graph), and the program gives the plain attention's output."""
    torch.manual_seed(0)
    layer = SelfAttention2d(16).requires_grad_(False)
    with torch.no_grad():
        layer.gamma.fill_(0.8)
    x = torch.randn(2, 16, 8, 8)
    program = torch.export.export(layer, (x,))
    targets = [n.target for n in program.graph.nodes
               if n.op == "call_function"]
    assert torch.ops.tartangan.attention.default in targets
    assert all(isinstance(t, torch._ops.OpOverload) for t in targets)
    plain = SelfAttention2d(16, use_kernel=False).requires_grad_(False)
    plain.load_state_dict(layer.state_dict())
    np.testing.assert_allclose(program.module()(x).numpy(),
                               plain(x).numpy(), rtol=1e-6, atol=1e-6)
    q, k, v = (torch.randn(2, n, c) for n, c in ((16, 2), (4, 2), (4, 3)))
    np.testing.assert_array_equal(A.attention_op(q, k, v).numpy(),
                                  A.attention_plain(q, k, v).numpy())


def test_web_export_roundtrip(tmp_path):
    """The .pt2 program, loaded back, gives G(train=True) within 1e-6 and
    the JAX .stablehlo's output within 1e-4 on the same z; the .json has
    the JAX app's keys; --onnx and --page write their files."""
    from tartangan_torch.export.web import WebExportApp
    from tartangan_tpu.export.web import WebExportApp as JaxWebExportApp
    run = write_run(tmp_path / "run", "test128")
    ours, ref = tmp_path / "t" / "ttgan", tmp_path / "j" / "ttgan"
    JaxWebExportApp(JaxWebExportApp.parse_cli_args(
        [run, "--output", str(ref), "--batch-size", "2"])).run()
    app = WebExportApp(WebExportApp.parse_cli_args(
        [run, "--output", str(ours), "--batch-size", "2", "--onnx", "--page",
         "--device", "cpu"]))
    app.run()
    for ext in ("pt2", "json", "onnx"):
        assert os.path.exists(f"{ours}.{ext}")
    assert os.path.exists(tmp_path / "t" / "index.html")
    with open(f"{ours}.json") as f, open(f"{ref}.json") as g:
        meta, ref_meta = json.load(f), json.load(g)
    assert set(meta) == set(ref_meta)
    assert {k: v for k, v in meta.items() if k != "format"} == \
        {k: v for k, v in ref_meta.items() if k != "format"}

    program = torch.export.load(f"{ours}.pt2")
    assert "tartangan.attention" in str(program.graph)
    z = np.random.default_rng(3).standard_normal((2, 64)).astype(np.float32)
    with torch.no_grad():
        out = program.module()(torch.from_numpy(z)).numpy()
        direct = app.g(torch.from_numpy(z), train=True).permute(0, 3, 2, 1)
    assert out.shape == (2, 128, 128, 3)
    np.testing.assert_allclose(out, direct.numpy(), rtol=1e-6, atol=1e-6)
    with open(f"{ref}.stablehlo", "rb") as f:
        exported = jax.export.deserialize(f.read())
    np.testing.assert_allclose(out, np.asarray(exported.call(z)),
                               rtol=1e-4, atol=1e-4)
