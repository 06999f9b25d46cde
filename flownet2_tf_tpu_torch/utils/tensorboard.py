"""Minimal TensorBoard event writer (scalars), no TensorFlow needed.

Port of the scalar half of ``flownet2_tf_tpu/utils/tensorboard.py``, with
the few TFRecord framing and protobuf helpers it needs copied from
``flownet2_tf_tpu/data/tfrecord.py`` (the JAX package's copies import
JAX through its package). It writes ``events.out.tfevents.*`` files:
TFRecord-framed Event{wall_time, step, summary{value{tag,
simple_value}}}, readable by a stock TensorBoard. Image summaries are
not ported yet.
"""

from __future__ import annotations

import os
import socket
import struct
import time


def _crc_table():
    poly = 0x82F63B78  # CRC32C (Castagnoli)
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """Pure-Python CRC32C; event records are small."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _write_varint(value: int) -> bytes:
    if value < 0:
        value &= (1 << 64) - 1  # proto int64: 10-byte two's complement
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field_header(field: int, wire: int) -> bytes:
    return _write_varint((field << 3) | wire)


def _length_delimited(field: int, payload: bytes) -> bytes:
    return _field_header(field, 2) + _write_varint(len(payload)) + payload


def _double_field(field: int, value: float) -> bytes:
    return _field_header(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _field_header(field, 5) + struct.pack("<f", value)


def _varint_field(field: int, value: int) -> bytes:
    return _field_header(field, 0) + _write_varint(value)


class SummaryWriter:
    """Append-only TensorBoard event-file writer."""

    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        fname = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}"
        )
        self._path = os.path.join(log_dir, fname)
        self._f = open(self._path, "ab")
        # header event: wall_time + file_version
        header = _double_field(1, time.time()) + _length_delimited(
            3, b"brain.Event:2"
        )
        self._write_record(header)

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def _event(self, step: int, summary: bytes):
        event = (
            _double_field(1, time.time())
            + _varint_field(2, int(step))
            + _length_delimited(5, summary)
        )
        self._write_record(event)

    @staticmethod
    def _value(tag: str, value: float) -> bytes:
        return _length_delimited(
            1, _length_delimited(1, tag.encode()) + _float_field(2, value))

    def scalar(self, tag: str, value: float, step: int):
        self._event(step, self._value(tag, float(value)))

    def scalars(self, metrics: dict, step: int):
        self._event(step, b"".join(self._value(tag, float(v))
                                   for tag, v in metrics.items()))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()
