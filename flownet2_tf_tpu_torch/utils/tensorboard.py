"""Minimal TensorBoard event writer (scalars and images), no TensorFlow
needed.

Port of ``flownet2_tf_tpu/utils/tensorboard.py`` over the port's own
TFRecord framing and protobuf helpers (``data/tfrecord.py``, whose masked
CRC32C runs in the native IO runtime when it builds). It writes
``events.out.tfevents.*`` files: TFRecord-framed Event{wall_time, step,
summary{value{tag, simple_value | image}}}, readable by a stock
TensorBoard. For the same array, tag and step a record is byte-identical
to the JAX writer's, apart from the wall time.
"""

from __future__ import annotations

import os
import socket
import struct
import time
import zlib

import numpy as np

from flownet2_tf_tpu_torch.data.tfrecord import (
    _field_header,
    _length_delimited,
    _masked_crc,
    _write_varint,
)


def _double_field(field: int, value: float) -> bytes:
    return _field_header(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _field_header(field, 5) + struct.pack("<f", value)


def _varint_field(field: int, value: int) -> bytes:
    return _field_header(field, 0) + _write_varint(value)


def encode_png8(arr: np.ndarray) -> bytes:
    """Encode (H, W, 3) uint8 -> PNG bytes (filter 0, zlib level 6)."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


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

    def image(self, tag: str, array: np.ndarray, step: int):
        """array: (H, W, 3) uint8 (e.g. ``flowlib.flow_to_image``'s)."""
        image_proto = (
            _varint_field(1, array.shape[0])
            + _varint_field(2, array.shape[1])
            + _varint_field(3, 3)
            + _length_delimited(4, encode_png8(array))
        )
        val = _length_delimited(1, tag.encode()) + _length_delimited(
            4, image_proto)
        self._event(step, _length_delimited(1, val))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()
