"""Generator -> ONNX, with no onnx-package dependency.

Counterpart of ``tartangan_tpu/export/onnx.py``, for the reference's
ONNX.js browser demo (reference prep4web.py:23-30): the ModelProto is
hand-encoded through utils/protobuf.py, so the export needs no onnx
package and the artifact runs under ONNX Runtime Web (see web/index.html).
``export_generator`` walks the port's ``Generator`` module by module and
reads its weights from ``convert.to_flax(g)``, the flax tree the JAX
emitter reads, in the JAX emitter's order, so the same weights give the
same bytes.

Graph design:
- NCHW throughout (ONNX Conv's native layout): the only layout shuffle is
  one Transpose after the input MLP's reshape. Output is (B, C, H, W)
  float32 in [-1, 1].
- BatchNorm is exported in eval semantics and FOLDED into per-channel
  Mul/Add constants (scale' = scale/sqrt(var+eps); the browser does no
  batch statistics).
- Nearest-2x upsampling is Resize(scales=[1,1,2,2], nearest/asymmetric/
  floor) — exactly pixel duplication, matching ops/resize.py.
- Self-attention is MatMul/Softmax/MatMul over (B, HW, C') views plus the
  1x1 convs, mirroring models/attention.py.

``evaluate`` lives in export/onnx_eval.py: a numpy interpreter for this op
subset.
"""
from __future__ import annotations

import numpy as np

from ..convert import to_flax
from ..models.attention import SelfAttention2d
from ..models.blocks import (
    GeneratorInputMLP,
    GeneratorOutput,
    ResidualGeneratorBlock,
    TiledZGeneratorInput,
)
from ..utils import protobuf as pb

FLOAT = 1
INT64 = 7

_ATTR_TYPE = {"f": 1, "i": 2, "s": 3, "t": 4, "floats": 6, "ints": 7}


def _tensor_proto(name: str, array: np.ndarray) -> bytes:
    array = np.ascontiguousarray(array)
    if array.dtype == np.int64:
        data_type = INT64
    else:
        array = array.astype(np.float32)
        data_type = FLOAT
    out = b"".join(pb.int_field(1, int(d)) for d in array.shape)
    out += pb.int_field(2, data_type)
    out += pb.string_field(8, name)
    out += pb.bytes_field(9, array.tobytes())
    return out


def _attribute(name: str, value) -> bytes:
    out = pb.string_field(1, name)
    if isinstance(value, float):
        out += pb.float_field(2, value) + pb.int_field(20, _ATTR_TYPE["f"])
    elif isinstance(value, int):
        out += pb.int_field(3, value) + pb.int_field(20, _ATTR_TYPE["i"])
    elif isinstance(value, str):
        out += pb.bytes_field(4, value.encode()) \
            + pb.int_field(20, _ATTR_TYPE["s"])
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], float):
            out += b"".join(pb.float_field(7, v) for v in value)
            out += pb.int_field(20, _ATTR_TYPE["floats"])
        else:
            out += b"".join(pb.int_field(8, int(v)) for v in value)
            out += pb.int_field(20, _ATTR_TYPE["ints"])
    else:
        raise TypeError(f"attribute {name}: {type(value)}")
    return out


def _value_info(name: str, shape) -> bytes:
    dims = b"".join(
        pb.bytes_field(1, pb.int_field(1, int(d))) for d in shape)
    tensor_type = pb.int_field(1, FLOAT) + pb.bytes_field(2, dims)
    return (pb.string_field(1, name)
            + pb.bytes_field(2, pb.bytes_field(1, tensor_type)))


class OnnxGraph:
    """Accumulates nodes/initializers and serializes a ModelProto."""

    def __init__(self, name: str):
        self.name = name
        self._nodes = []
        self._initializers = []
        self._inputs = []
        self._outputs = []
        self._n = 0

    def fresh(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def tensor(self, hint: str, array) -> str:
        name = self.fresh(hint)
        self._initializers.append(
            _tensor_proto(name, np.asarray(array)))
        return name

    def node(self, op_type: str, inputs, n_outputs: int = 1, **attrs):
        outputs = [self.fresh(op_type.lower()) for _ in range(n_outputs)]
        body = b"".join(pb.string_field(1, i) for i in inputs)
        body += b"".join(pb.string_field(2, o) for o in outputs)
        body += pb.string_field(3, outputs[0] + "_node")
        body += pb.string_field(4, op_type)
        body += b"".join(
            pb.bytes_field(5, _attribute(k, v)) for k, v in attrs.items())
        self._nodes.append(body)
        return outputs[0] if n_outputs == 1 else outputs

    def add_input(self, name: str, shape):
        self._inputs.append(_value_info(name, shape))
        return name

    def mark_output(self, name: str, shape):
        self._outputs.append(_value_info(name, shape))

    def model_bytes(self, opset: int = 13) -> bytes:
        graph = b"".join(pb.bytes_field(1, n) for n in self._nodes)
        graph += pb.string_field(2, self.name)
        graph += b"".join(pb.bytes_field(5, t) for t in self._initializers)
        graph += b"".join(pb.bytes_field(11, i) for i in self._inputs)
        graph += b"".join(pb.bytes_field(12, o) for o in self._outputs)
        opset_id = pb.string_field(1, "") + pb.int_field(2, opset)
        return (pb.int_field(1, 8)  # ir_version 8 (onnx 1.13 line)
                + pb.string_field(2, "tartangan-tpu")
                + pb.bytes_field(7, graph)
                + pb.bytes_field(8, opset_id))


# ----------------------------------------------------------- model walk
_ACT = {
    "relu": ("LeakyRelu", {"alpha": 0.2}),
    "selu": ("Selu", {}),
    "elu": ("Elu", {"alpha": 1.0}),
}


def _act(b: OnnxGraph, x: str, activation: str) -> str:
    op, attrs = _ACT[activation]
    return b.node(op, [x], **attrs)


def _find_bn(tree: dict) -> dict:
    """Descend the NormAct wrapper chain to the BatchNorm leaf dict."""
    if "scale" in tree or "mean" in tree:
        return tree
    (key,) = tree.keys()
    return _find_bn(tree[key])


def _norm_act(b, x, module, params, stats, normact_name, channels):
    """Folded eval-mode BatchNorm (or identity) + activation."""
    if module.norm == "bn":
        p = _find_bn(params[normact_name])
        s = _find_bn(stats[normact_name])
        scale = np.asarray(p["scale"], np.float32)
        bias = np.asarray(p["bias"], np.float32)
        mean = np.asarray(s["mean"], np.float32)
        var = np.asarray(s["var"], np.float32)
        mul = scale / np.sqrt(var + 1e-5)
        add = bias - mean * mul
        shape = (1, channels, 1, 1)
        x = b.node("Mul", [x, b.tensor("bn_scale", mul.reshape(shape))])
        x = b.node("Add", [x, b.tensor("bn_bias", add.reshape(shape))])
    elif module.norm != "id":
        raise NotImplementedError(f"norm '{module.norm}' in ONNX export")
    return _act(b, x, module.activation)


def _conv(b, x, conv_params, kernel: int, name_hint="w"):
    w = np.asarray(conv_params["kernel"], np.float32)  # HWIO
    w_onnx = b.tensor(name_hint, w.transpose(3, 2, 0, 1))
    inputs = [x, w_onnx]
    if "bias" in conv_params:
        inputs.append(b.tensor(name_hint + "_b",
                               np.asarray(conv_params["bias"], np.float32)))
    pad = (kernel - 1) // 2
    return b.node("Conv", inputs, kernel_shape=[kernel, kernel],
                  pads=[pad, pad, pad, pad], strides=[1, 1])


def _upsample_2x(b, x):
    roi = b.tensor("roi", np.zeros((0,), np.float32))
    scales = b.tensor("scales", np.array([1, 1, 2, 2], np.float32))
    return b.node("Resize", [x, roi, scales], mode="nearest",
                  coordinate_transformation_mode="asymmetric",
                  nearest_mode="floor")


def _emit_input_block(b, z, module, params, batch):
    if isinstance(module, GeneratorInputMLP):
        dense = params["Dense_0"]
        kernel = b.tensor("mlp_w", np.asarray(dense["kernel"], np.float32))
        bias = b.tensor("mlp_b", np.asarray(dense["bias"], np.float32))
        x = b.node("Gemm", [z, kernel, bias])
        x = _act(b, x, module.activation)
        size, c = module.size, module.output_dims
        shape = b.tensor("in_shape",
                         np.array([batch, size, size, c], np.int64))
        x = b.node("Reshape", [x, shape])
        return b.node("Transpose", [x], perm=[0, 3, 1, 2]), c, size
    if isinstance(module, TiledZGeneratorInput):
        c, size = module.latent_dims, module.size
        shape = b.tensor("in_shape", np.array([batch, c, 1, 1], np.int64))
        x = b.node("Reshape", [z, shape])
        target = b.tensor("tile_shape",
                          np.array([batch, c, size, size], np.int64))
        return b.node("Expand", [x, target]), c, size
    raise NotImplementedError(
        f"ONNX export of input block {type(module).__name__}")


def _emit_residual_block(b, x, module, params, stats, size):
    if module.upsample:
        x = _upsample_2x(b, x)
        size *= 2
    h = x
    normact_i = 0
    if not module.first_block:
        h = _norm_act(b, h, module, params, stats,
                      f"NormAct_{normact_i}", module.in_dims)
        normact_i += 1
    h = _conv(b, h, params["Conv_0"], 3, "conv0")
    h = _norm_act(b, h, module, params, stats,
                  f"NormAct_{normact_i}", module.out_dims)
    h = _conv(b, h, params["Conv_1"], 3, "conv1")
    if module.in_dims != module.out_dims:
        x = _conv(b, x, params["project_input"], 1, "proj")
    return b.node("Add", [x, h]), size


def _emit_attention(b, x, module, params, batch, size):
    c = module.in_dims
    ck = max(c // 8, 1)
    cv = max(c // 2, 1)
    hw = size * size
    theta = _conv(b, x, params["theta"], 1, "theta")
    phi = _conv(b, x, params["phi"], 1, "phi")
    phi = b.node("MaxPool", [phi], kernel_shape=[2, 2], strides=[2, 2])
    g = _conv(b, x, params["g"], 1, "g")
    g = b.node("MaxPool", [g], kernel_shape=[2, 2], strides=[2, 2])

    # NCHW (B,C',H,W) -> (B, HW, C') sequence views
    def seq(t, channels, length):
        t = b.node("Transpose", [t], perm=[0, 2, 3, 1])
        shape = b.tensor("seq_shape",
                         np.array([batch, length, channels], np.int64))
        return b.node("Reshape", [t, shape])

    q = seq(theta, ck, hw)
    k = seq(phi, ck, hw // 4)
    v = seq(g, cv, hw // 4)
    kt = b.node("Transpose", [k], perm=[0, 2, 1])
    logits = b.node("MatMul", [q, kt])
    beta = b.node("Softmax", [logits], axis=-1)
    o = b.node("MatMul", [beta, v])
    shape = b.tensor("o_shape",
                     np.array([batch, size, size, cv], np.int64))
    o = b.node("Reshape", [o, shape])
    o = b.node("Transpose", [o], perm=[0, 3, 1, 2])
    o = _conv(b, o, params["o"], 1, "attn_o")
    gamma = b.tensor("gamma", np.asarray(params["gamma"], np.float32))
    o = b.node("Mul", [o, gamma])
    return b.node("Add", [x, o])


def _emit_output_block(b, x, module, params, stats):
    x = _norm_act(b, x, module, params, stats, "NormAct_0", module.in_dims)
    x = _conv(b, x, params["Conv_0"], 1, "out_conv")
    if module.output_activation == "tanh":
        x = b.node("Tanh", [x])
    return x


def export_generator(g, batch_size: int = 1) -> bytes:
    """Serialize the generator's eval-mode forward as an ONNX ModelProto.

    ``g`` is the port's ``Generator``; its blocks are taken in order, each
    with its flax subtree (``blocks_i``). Only the residual generator
    blocks are exported (the default factory's ``GeneratorBlock``, the
    parity and the fused blocks raise ``NotImplementedError``, as in the
    JAX emitter).
    """
    cfg = g.config
    variables = to_flax(g)
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    b = OnnxGraph("tartangan_generator")
    z = b.add_input("z", (batch_size, cfg.latent_dims))
    x, _, size = _emit_input_block(
        b, z, g.input_block, params.get("input_block", {}), batch_size)

    for i, module in enumerate(g.blocks):
        sub = params[f"blocks_{i}"]
        if isinstance(module, SelfAttention2d):
            x = _emit_attention(b, x, module, sub, batch_size, size)
        elif isinstance(module, ResidualGeneratorBlock):
            x, size = _emit_residual_block(
                b, x, module, sub, stats.get(f"blocks_{i}", {}), size)
        else:
            raise NotImplementedError(
                f"ONNX export of {type(module).__name__}")

    output_mod = g.output_block
    if type(output_mod) is not GeneratorOutput:
        raise NotImplementedError(
            f"ONNX export of {type(output_mod).__name__}")
    x = _emit_output_block(b, x, output_mod, params["output_block"],
                           stats.get("output_block", {}))
    b.mark_output(x, (batch_size, cfg.data_dims, cfg.max_size, cfg.max_size))
    # stable public names for the demo page
    b._nodes.append(
        pb.string_field(1, x) + pb.string_field(2, "image")
        + pb.string_field(3, "output_alias") + pb.string_field(4, "Identity"))
    b._outputs[-1] = _value_info(
        "image", (batch_size, cfg.data_dims, cfg.max_size, cfg.max_size))
    return b.model_bytes()
