"""A writer of TensorFlow 1 V2 checkpoints ("tensor bundles") with no
TensorFlow, for the tests of ``flownet2_tf_tpu_torch/tools/tf1_bundle.py``
and for ``chip_smoke.py``. The package ships no writer.

    write_bundle(prefix, {name: array}, num_shards=2)

writes ``prefix.index`` (a LevelDB-format table: data blocks of about
``block_size`` bytes with a restart point every ``restart_interval``
entries, an empty metaindex block, an index block with one restart per
entry, the 48-byte footer) and ``prefix.data-NNNNN-of-MMMMM``, each
tensor in shard ``i % num_shards`` of the sorted names. The keyword
arguments ``block_type``, ``endianness`` and ``sliced`` write the faults
the reader must name.

:func:`to_tf_layout` turns a flat JAX-layout parameter dict into the
variables of the upstream TF1 checkpoints: every name under a top scope,
each deconv kernel mirrored and laid out ``[H, W, out, in]``.
"""

from __future__ import annotations

import os
import re
import struct

import numpy as np

from flownet2_tf_tpu_torch.data.tfrecord import _write_varint, crc32c
from flownet2_tf_tpu_torch.tools import tf1_bundle as tb

_DTYPE_ENUM = {np.dtype(np.float32): tb.DT_FLOAT,
               np.dtype(np.float64): tb.DT_DOUBLE,
               np.dtype(np.int32): tb.DT_INT32,
               np.dtype(np.int64): tb.DT_INT64,
               np.dtype(np.float16): tb.DT_HALF,
               np.dtype(np.uint8): 4}  # DT_UINT8, which the reader refuses
_DECONV = re.compile(r"(^|/)(deconv\d|upsample_flow\d+to\d+|fuse_deconv\d|"
                     r"fuse_upsample_flow\d+to\d+)$")


class BFloat16:
    """A bfloat16 tensor to write: its uint16 bit patterns."""

    def __init__(self, bits: np.ndarray):
        self.bits = np.asarray(bits, np.uint16, order="C")


def _field(number, wire, payload: bytes) -> bytes:
    return _write_varint(number << 3 | wire) + payload


def _varint_field(number, value) -> bytes:
    return _field(number, 0, _write_varint(value))


def _bytes_field(number, payload: bytes) -> bytes:
    return _field(number, 2, _write_varint(len(payload)) + payload)


def header_proto(num_shards, endianness=0) -> bytes:
    """``BundleHeaderProto``: num_shards, endianness, version {producer 1}."""
    out = _varint_field(1, num_shards)
    if endianness:
        out += _varint_field(2, endianness)
    return out + _bytes_field(3, _varint_field(1, 1))


def entry_proto(dtype, shape, shard_id, offset, size, masked_crc,
                sliced=False) -> bytes:
    """``BundleEntryProto``, proto3 style: zero scalars are left out."""
    dims = b"".join(_bytes_field(2, _varint_field(1, d) if d else b"")
                    for d in shape)
    out = _varint_field(1, dtype) + _bytes_field(2, dims)
    for number, value in ((3, shard_id), (4, offset), (5, size)):
        if value:
            out += _varint_field(number, value)
    out += _field(6, 5, struct.pack("<I", masked_crc))
    if sliced:
        # one TensorSliceProto {extent {start 0 length 1}}
        out += _bytes_field(7, _bytes_field(1, _varint_field(2, 1)))
    return out


def _block(entries, restart_interval) -> bytes:
    out, restarts, last = bytearray(), [], b""
    for i, (key, value) in enumerate(entries):
        if i % restart_interval == 0:
            restarts.append(len(out))
            shared = 0
        else:
            shared = 0
            while (shared < min(len(key), len(last))
                   and key[shared] == last[shared]):
                shared += 1
        out += (_write_varint(shared) + _write_varint(len(key) - shared)
                + _write_varint(len(value)) + key[shared:] + value)
        last = key
    if not restarts:
        restarts = [0]
    out += b"".join(struct.pack("<I", r) for r in restarts)
    return bytes(out + struct.pack("<I", len(restarts)))


def _handle(offset, size) -> bytes:
    return _write_varint(offset) + _write_varint(size)


def write_table(path, entries, block_size=4096, restart_interval=16,
                block_type=0):
    """A LevelDB-format table of sorted ``(key, value)`` pairs."""
    out = bytearray()

    def emit(contents):
        offset = len(out)
        trailer = bytes([block_type])
        out.extend(contents + trailer + struct.pack(
            "<I", tb.mask_crc(crc32c(contents + trailer))))
        return _handle(offset, len(contents))

    index, pending, pending_bytes = [], [], 0
    for key, value in entries:
        pending.append((key, value))
        pending_bytes += len(key) + len(value) + 3
        if pending_bytes >= block_size:
            # the block's last key separates it from the next one
            index.append((key, emit(_block(pending, restart_interval))))
            pending, pending_bytes = [], 0
    if pending:
        index.append((pending[-1][0], emit(_block(pending, restart_interval))))
    meta = emit(_block([], 1))
    top = emit(_block(index, 1))
    footer = (meta + top).ljust(tb.FOOTER_LEN - 8, b"\0")
    out += footer + struct.pack("<Q", tb.TABLE_MAGIC)
    with open(path, "wb") as f:
        f.write(out)


def write_bundle(prefix, tensors, num_shards=1, block_size=4096,
                 restart_interval=16, block_type=0, endianness=0,
                 sliced=()):
    """Write ``tensors`` ({name: np.ndarray or BFloat16}) as a V2 bundle;
    names in ``sliced`` are marked as partitioned variables."""
    prefix = os.fspath(prefix)
    names = sorted(tensors)
    shards = [open(f"{prefix}.data-{i:05d}-of-{num_shards:05d}", "wb")
              for i in range(num_shards)]
    entries = [(tb.HEADER_KEY, header_proto(num_shards, endianness))]
    try:
        for i, name in enumerate(names):
            value = tensors[name]
            if isinstance(value, BFloat16):
                dtype, raw = tb.DT_BFLOAT16, value.bits
            else:
                raw = np.asarray(value, order="C")
                dtype = _DTYPE_ENUM[raw.dtype]
            shard = i % num_shards
            offset = shards[shard].tell()
            shards[shard].write(raw.tobytes())
            entries.append((name.encode(), entry_proto(
                dtype, raw.shape, shard, offset, raw.nbytes,
                tb.mask_crc(crc32c(raw)), name in sliced)))
    finally:
        for f in shards:
            f.close()
    write_table(prefix + ".index", entries, block_size, restart_interval,
                block_type)
    return prefix


def to_tf_layout(flat, scope, extras=True):
    """A flat JAX-layout parameter dict as the upstream TF1 checkpoint's
    variables: ``scope/`` before every name, deconv kernels mirrored and
    laid out ``[H, W, out, in]``; with ``extras``, an Adam slot of the
    first leaf and ``global_step`` (0-d int64), which the converter
    drops."""
    out = {}
    for path, value in flat.items():
        layer, leaf = path.rsplit("/", 1)
        value = np.asarray(value)
        if leaf == "weights" and _DECONV.search(layer):
            value = value[::-1, ::-1].transpose(0, 1, 3, 2)
        out[f"{scope}/{path}"] = np.asarray(value, order="C")
    if extras:
        first = sorted(out)[0]
        out[first + "/Adam"] = np.zeros_like(out[first])
        out["global_step"] = np.array(0, np.int64)
    return out
