"""Numpy interpreter for the ONNX subset export/onnx.py emits.

A copy of ``tartangan_tpu/export/onnx_eval.py`` (numpy only), with two
jobs:
- the tests and ``chip_smoke.py`` hold the exported graph against the
  generator's eval-mode forward without an onnxruntime install
- a dependency-free server-side fallback for running exported artifacts

The parser walks the raw protobuf (utils/protobuf.py), the emitter's
zero-dependency stance.
"""
from __future__ import annotations

import struct

import numpy as np

from ..utils import protobuf as pb


# ---------------------------------------------------------------- parsing
def _parse_tensor(data: bytes):
    dims, data_type, name, raw = [], 1, "", b""
    for number, _, val in pb.walk_fields(data):
        if number == 1:
            dims.append(val)
        elif number == 2:
            data_type = val
        elif number == 8:
            name = val.decode()
        elif number == 9:
            raw = val
    dtype = {1: np.float32, 7: np.int64}[data_type]
    return name, np.frombuffer(raw, dtype).reshape(dims).copy()


def _parse_attribute(data: bytes):
    fields = pb.group_fields(data)
    name = fields[1][0].decode()
    atype = fields.get(20, [0])[0]
    if atype == 1:
        return name, struct.unpack("<f", fields[2][0])[0]
    if atype == 2:
        value = fields[3][0]
        if value >= (1 << 63):  # protobuf int64 is two's-complement
            value -= (1 << 64)
        return name, value
    if atype == 3:
        return name, fields[4][0].decode()
    if atype == 6:
        return name, [struct.unpack("<f", v)[0] for v in fields[7]]
    if atype == 7:
        return name, [v - (1 << 64) if v >= (1 << 63) else v
                      for v in fields[8]]
    raise ValueError(f"attribute type {atype}")


def _parse_node(data: bytes):
    fields = pb.group_fields(data)
    return {
        "inputs": [v.decode() for v in fields.get(1, [])],
        "outputs": [v.decode() for v in fields.get(2, [])],
        "op": fields[4][0].decode(),
        "attrs": dict(_parse_attribute(a) for a in fields.get(5, [])),
    }


def _value_info_name(data: bytes) -> str:
    return pb.group_fields(data)[1][0].decode()


def parse_model(model_bytes: bytes):
    """-> (nodes, initializers {name: ndarray}, input names, output names)."""
    model = pb.group_fields(model_bytes)
    graph = pb.group_fields(model[7][0])
    nodes = [_parse_node(n) for n in graph.get(1, [])]
    initializers = dict(_parse_tensor(t) for t in graph.get(5, []))
    inputs = [_value_info_name(v) for v in graph.get(11, [])]
    outputs = [_value_info_name(v) for v in graph.get(12, [])]
    return nodes, initializers, inputs, outputs


# -------------------------------------------------------------- operators
def _conv2d(x, w, bias, pads, strides):
    top, left, bottom, right = pads
    sh, sw = strides
    x = np.pad(x, ((0, 0), (0, 0), (top, bottom), (left, right)))
    batch, _, height, width = x.shape
    out_c, _, kh, kw = w.shape
    oh = (height - kh) // sh + 1
    ow = (width - kw) // sw + 1
    cols = np.empty((batch, x.shape[1], kh, kw, oh, ow), x.dtype)
    for i in range(kh):
        for j in range(kw):
            cols[:, :, i, j] = x[:, :, i:i + oh * sh:sh, j:j + ow * sw:sw]
    out = np.einsum("bcijhw,ocij->bohw", cols, w, optimize=True)
    if bias is not None:
        out = out + bias.reshape(1, out_c, 1, 1)
    return out


def _maxpool2(x, kernel, strides):
    kh, kw = kernel
    sh, sw = strides
    batch, ch, height, width = x.shape
    oh, ow = (height - kh) // sh + 1, (width - kw) // sw + 1
    windows = np.empty((batch, ch, kh, kw, oh, ow), x.dtype)
    for i in range(kh):
        for j in range(kw):
            windows[:, :, i, j] = x[:, :, i:i + oh * sh:sh,
                                    j:j + ow * sw:sw]
    return windows.max(axis=(2, 3))


def _resize_nearest(x, scales):
    assert list(scales[:2]) == [1.0, 1.0], scales
    return x.repeat(int(scales[2]), axis=2).repeat(int(scales[3]), axis=3)


def _reshape(x, shape):
    shape = [int(s) for s in shape]
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return x.reshape(shape)


def _gemm(a, w, bias, attrs):
    if attrs.get("transA"):
        a = a.T
    if attrs.get("transB"):
        w = w.T
    out = attrs.get("alpha", 1.0) * (a @ w)
    if bias is not None:
        out = out + attrs.get("beta", 1.0) * bias
    return out


def _softmax(x, axis):
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def _selu(x, alpha=1.6732632423543772, gamma=1.0507009873554805):
    return gamma * np.where(x > 0, x, alpha * (np.exp(x) - 1.0))


def evaluate(model_bytes: bytes, feeds: dict) -> dict:
    """Run the graph on numpy inputs; returns {output_name: ndarray}."""
    nodes, values, inputs, outputs = parse_model(model_bytes)
    missing = [n for n in inputs if n not in feeds]
    if missing:
        raise KeyError(f"missing graph inputs: {missing}")
    values.update({k: np.asarray(v) for k, v in feeds.items()})

    for node in nodes:
        op = node["op"]
        attrs = node["attrs"]
        ins = [values[n] if n else None for n in node["inputs"]]
        if op == "Conv":
            out = _conv2d(ins[0], ins[1],
                          ins[2] if len(ins) > 2 else None,
                          attrs["pads"], attrs["strides"])
        elif op == "Gemm":
            out = _gemm(ins[0], ins[1],
                        ins[2] if len(ins) > 2 else None, attrs)
        elif op == "MatMul":
            out = ins[0] @ ins[1]
        elif op == "Add":
            out = ins[0] + ins[1]
        elif op == "Mul":
            out = ins[0] * ins[1]
        elif op == "Reshape":
            out = _reshape(ins[0], ins[1])
        elif op == "Transpose":
            out = np.transpose(ins[0], attrs["perm"])
        elif op == "Expand":
            out = np.broadcast_to(
                ins[0], [int(d) for d in ins[1]]).copy()
        elif op == "Resize":
            out = _resize_nearest(ins[0], ins[2])
        elif op == "MaxPool":
            out = _maxpool2(ins[0], attrs["kernel_shape"],
                            attrs["strides"])
        elif op == "Softmax":
            out = _softmax(ins[0], attrs.get("axis", -1))
        elif op == "LeakyRelu":
            out = np.where(ins[0] > 0, ins[0],
                           attrs.get("alpha", 0.01) * ins[0])
        elif op == "Elu":
            alpha = attrs.get("alpha", 1.0)
            out = np.where(ins[0] > 0, ins[0],
                           alpha * (np.exp(ins[0]) - 1.0))
        elif op == "Selu":
            out = _selu(ins[0])
        elif op == "Tanh":
            out = np.tanh(ins[0])
        elif op == "Identity":
            out = ins[0]
        else:
            raise NotImplementedError(f"op {op}")
        values[node["outputs"][0]] = out

    return {name: values[name] for name in outputs}
