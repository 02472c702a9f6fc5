"""Dependency-free TensorBoard scalar-event writer and reader.

A copy of ``tartangan_tpu/utils/tb_events.py`` (the same bytes out), which
replaces the reference's ``torch.utils.tensorboard.SummaryWriter``
(reference components/metrics/tensorboard.py:9-25): TensorBoard only needs
an ``events.out.tfevents.*`` file holding TFRecord-framed Event protos, and
the scalar subset of that format is tiny, so both the protobuf encoding
(varint fields of the Event/Summary messages) and the TFRecord framing
(length + masked CRC32C) are implemented here directly. ``read_records``
and ``decode_scalar_event`` read such a file back, with its checksums.

Wire format notes (stable, public):
- TFRecord: u64le(len) . maskedcrc(len bytes) . data . maskedcrc(data),
  masked = rotr15(crc32c) + 0xa282ead8
- Event proto: 1=wall_time double, 2=step int64, 3=file_version string,
  5=summary message; Summary: repeated 1=Value{1=tag string,
  2=simple_value float}
"""
from __future__ import annotations

import os
import socket
import struct
import time

from .protobuf import (
    bytes_field as _bytes_field,
    double_field as _double_field,
    float_field as _float_field,
    group_fields,
    int_field as _varint_field,
)

# ---------------------------------------------------------------- crc32c
_CRC_TABLE = []


def _crc_table():
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reflected
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            _CRC_TABLE.append(crc)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf
def encode_scalar_event(step: int, scalars: dict, wall_time: float) -> bytes:
    """Event{wall_time, step, summary{Value{tag, simple_value}...}}."""
    summary = b"".join(
        _bytes_field(1, _bytes_field(1, tag.encode("utf-8"))
                     + _float_field(2, float(value)))
        for tag, value in scalars.items())
    return (_double_field(1, wall_time) + _varint_field(2, step)
            + _bytes_field(5, summary))


def encode_file_version_event(wall_time: float) -> bytes:
    return _double_field(1, wall_time) + _bytes_field(3, b"brain.Event:2")


def tfrecord(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", _masked_crc(header))
            + data + struct.pack("<I", _masked_crc(data)))


def read_records(path) -> list:
    """The data of every TFRecord in the file at ``path``, each checksum
    verified (ValueError on a mismatch or a cut record)."""
    with open(path, "rb") as f:
        raw = f.read()
    out, i = [], 0
    while i < len(raw):
        if i + 12 > len(raw):
            raise ValueError(f"{path}: cut record header at byte {i}")
        header = raw[i:i + 8]
        (length,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", raw[i + 8:i + 12])
        data = raw[i + 12:i + 12 + length]
        end = i + 12 + length + 4
        if crc != _masked_crc(header) or len(data) != length \
                or end > len(raw) or struct.unpack(
                    "<I", raw[end - 4:end])[0] != _masked_crc(data):
            raise ValueError(f"{path}: bad record at byte {i}")
        out.append(data)
        i = end
    return out


def decode_scalar_event(data: bytes):
    """(wall_time, step, {tag: value}) of an Event record; a record without
    a summary (the file-version record) gives an empty dict."""
    fields = group_fields(data)
    wall_time = struct.unpack("<d", fields[1][0])[0]
    step = fields.get(2, [0])[0]
    scalars = {}
    for summary in fields.get(5, []):
        for value in group_fields(summary).get(1, []):
            v = group_fields(value)
            scalars[v[1][0].decode("utf-8")] = struct.unpack(
                "<f", v[2][0])[0]
    return wall_time, step, scalars


# --------------------------------------------------------------- writer
class ScalarEventWriter:
    """Append-only scalar writer for one TensorBoard run directory."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}")
        self._file = open(os.path.join(logdir, name), "ab")
        self._file.write(tfrecord(encode_file_version_event(time.time())))
        self._file.flush()

    def add_scalars(self, step: int, scalars: dict):
        if not scalars:
            return
        self._file.write(
            tfrecord(encode_scalar_event(step, scalars, time.time())))
        self._file.flush()

    def close(self):
        self._file.close()
