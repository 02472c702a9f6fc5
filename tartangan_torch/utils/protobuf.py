"""Minimal protobuf wire-format writer (and field walker).

A copy of ``tartangan_tpu/utils/protobuf.py``, for the TensorBoard event
writer (``utils/tb_events.py``) and the ONNX exporter (``export/onnx.py``)
and its interpreter (``export/onnx_eval.py``): the subsets of those public
schemas are small enough that hand-encoding beats depending on generated
bindings (no protoc output to vendor, no tensorflow or onnx dependency).

Wire types: 0 varint, 1 fixed64, 2 length-delimited, 5 fixed32.
"""
from __future__ import annotations

import struct


def varint(n: int) -> bytes:
    if n < 0:  # two's-complement 64-bit, per protobuf int32/int64 rules
        n &= (1 << 64) - 1
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        out.append(bits | (0x80 if n else 0))
        if not n:
            return bytes(out)


def field_header(number: int, wire_type: int) -> bytes:
    return varint((number << 3) | wire_type)


def double_field(number: int, value: float) -> bytes:
    return field_header(number, 1) + struct.pack("<d", value)


def float_field(number: int, value: float) -> bytes:
    return field_header(number, 5) + struct.pack("<f", value)


def int_field(number: int, value: int) -> bytes:
    return field_header(number, 0) + varint(value)


def bytes_field(number: int, value: bytes) -> bytes:
    return field_header(number, 2) + varint(len(value)) + value


def string_field(number: int, value: str) -> bytes:
    return bytes_field(number, value.encode("utf-8"))


def packed_ints_field(number: int, values) -> bytes:
    return bytes_field(number, b"".join(varint(v) for v in values))


def packed_floats_field(number: int, values) -> bytes:
    return bytes_field(number, b"".join(
        struct.pack("<f", v) for v in values))


# --------------------------------------------------------------- reading
def read_varint(data: bytes, i: int):
    val = 0
    shift = 0
    while True:
        b = data[i]
        i += 1
        val |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return val, i


def walk_fields(data: bytes):
    """Yield (field_number, wire_type, value) over a serialized message.
    Length-delimited values come back as bytes; varints as ints; fixed
    32/64 as raw 4/8-byte slices."""
    i = 0
    while i < len(data):
        key, i = read_varint(data, i)
        number, wire = key >> 3, key & 7
        if wire == 0:
            val, i = read_varint(data, i)
        elif wire == 1:
            val = data[i:i + 8]
            i += 8
        elif wire == 5:
            val = data[i:i + 4]
            i += 4
        elif wire == 2:
            length, i = read_varint(data, i)
            val = data[i:i + length]
            i += length
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield number, wire, val


def group_fields(data: bytes) -> dict:
    """{field_number: [values]} over a serialized message."""
    fields: dict = {}
    for number, _, val in walk_fields(data):
        fields.setdefault(number, []).append(val)
    return fields
