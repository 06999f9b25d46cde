"""Dependency-free TFRecord + tf.train.Example reader/writer.

A copy of ``flownet2_tf_tpu/data/tfrecord.py`` (importing the original
pulls in JAX), for the reference layout: raw-bytes features ``image_a``,
``image_b``, ``flow``.

* TFRecord framing: [uint64 length][uint32 masked-crc32c(length)]
  [payload][uint32 masked-crc32c(payload)] -- CRC verified by
  :func:`read_records`.
* tf.train.Example: hand-rolled protobuf wire-format parser for the
  Features -> map<string, Feature> -> BytesList/FloatList/Int64List
  message shape. No protoc codegen needed for this fixed schema.

:func:`crc32c` runs the native IO runtime's SSE4.2 CRC32C
(``runtime/native.py``) when the library builds, else the pure-Python
loop :func:`crc32c_py` (a few MB/s), which stays the oracle the tests
hold the native one against.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Union

FeatureValue = Union[List[bytes], List[float], List[int]]

# --------------------------------------------------------------------------
# CRC32C (software implementation, Castagnoli polynomial)
# --------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table.append(crc)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c_py(data) -> int:
    """Pure-Python CRC32C (Castagnoli), the JAX package's ``crc32c_py``:
    the oracle of the native one, and the fallback without it. A Python
    byte loop: a few MB/s. ``data``: bytes, or a C-contiguous numpy
    array (its bytes)."""
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in memoryview(data).cast("B"):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c(data) -> int:
    """CRC32C of ``data`` (bytes, or a C-contiguous numpy array): the
    native runtime's when it is available, else :func:`crc32c_py`."""
    from flownet2_tf_tpu_torch.runtime import native

    lib = native.get_native_io()
    if lib is not None:
        return lib.crc32c(data)
    return crc32c_py(data)


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# --------------------------------------------------------------------------
# Record framing
# --------------------------------------------------------------------------

def read_records(path, verify_crc: bool = True) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file."""
    with open(os.fspath(path), "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise ValueError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:12])
            if verify_crc and _masked_crc(header[:8]) != len_crc:
                raise ValueError(f"{path}: length CRC mismatch")
            payload = f.read(length)
            if len(payload) < length:
                raise ValueError(f"{path}: truncated record payload")
            (data_crc,) = struct.unpack("<I", f.read(4))
            if verify_crc and _masked_crc(payload) != data_crc:
                raise ValueError(f"{path}: payload CRC mismatch")
            yield payload


def write_records(path, payloads) -> None:
    with open(os.fspath(path), "wb") as f:
        for payload in payloads:
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(payload)
            f.write(struct.pack("<I", _masked_crc(payload)))


# --------------------------------------------------------------------------
# Protobuf wire format (just enough for tf.train.Example)
# --------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(value: int) -> bytes:
    if value < 0:
        # proto int64 semantics: negatives encode as 10-byte two's
        # complement. Python's arithmetic shift would otherwise loop
        # forever (-1 >> 7 == -1).
        value &= (1 << 64) - 1
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _iter_fields(buf: bytes):
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field = tag >> 3
        wire = tag & 7
        if wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            yield field, buf[pos : pos + length], wire
            pos += length
        elif wire == 0:  # varint
            value, pos = _read_varint(buf, pos)
            yield field, value, wire
        elif wire == 5:  # 32-bit
            yield field, buf[pos : pos + 4], wire
            pos += 4
        elif wire == 1:  # 64-bit
            yield field, buf[pos : pos + 8], wire
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def parse_example(payload: bytes) -> Dict[str, FeatureValue]:
    """Parse a serialized tf.train.Example -> {name: list of values}."""
    features = {}
    for field, value, _ in _iter_fields(payload):
        if field != 1:  # Example.features
            continue
        for ffield, fvalue, _ in _iter_fields(value):
            if ffield != 1:  # Features.feature (map entry)
                continue
            name = None
            feat = None
            for mfield, mvalue, _ in _iter_fields(fvalue):
                if mfield == 1:
                    name = mvalue.decode("utf-8")
                elif mfield == 2:
                    feat = mvalue
            if name is None or feat is None:
                continue
            features[name] = _parse_feature(feat)
    return features


def _parse_feature(buf: bytes) -> FeatureValue:
    for field, value, _ in _iter_fields(buf):
        if field == 1:  # BytesList
            return [v for f, v, _ in _iter_fields(value) if f == 1]
        if field == 2:  # FloatList
            out: List[float] = []
            for f, v, w in _iter_fields(value):
                if f == 1 and w == 2:  # packed
                    out.extend(
                        struct.unpack(f"<{len(v) // 4}f", v)
                    )
                elif f == 1 and w == 5:
                    out.append(struct.unpack("<f", v)[0])
            return out
        if field == 3:  # Int64List
            out_i: List[int] = []
            for f, v, w in _iter_fields(value):
                if f == 1 and w == 2:
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        out_i.append(x)
                elif f == 1 and w == 0:
                    out_i.append(v)
            return out_i
    return []


# --------------------------------------------------------------------------
# Example serialization (for dataset-preparation tooling and tests)
# --------------------------------------------------------------------------

def _field_header(field: int, wire: int) -> bytes:
    return _write_varint((field << 3) | wire)


def _length_delimited(field: int, payload: bytes) -> bytes:
    return _field_header(field, 2) + _write_varint(len(payload)) + payload


def build_example(features: Dict[str, bytes]) -> bytes:
    """Serialize {name: raw bytes} into a tf.train.Example (BytesList)."""
    entries = b""
    for name, blob in features.items():
        bytes_list = _length_delimited(1, blob)
        feature = _length_delimited(1, bytes_list)
        entry = _length_delimited(1, name.encode("utf-8")) + _length_delimited(
            2, feature
        )
        entries += _length_delimited(1, entry)
    return _length_delimited(1, entries)
