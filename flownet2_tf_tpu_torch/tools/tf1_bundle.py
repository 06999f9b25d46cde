"""Reader of TensorFlow 1 checkpoints in the V2 "tensor bundle" format,
with no TensorFlow and no protobuf package: the port's counterpart of
``tf.train.load_checkpoint`` as ``flownet2_tf_tpu/tools/
convert_tf1_checkpoint.py::read_tf_checkpoint`` uses it.

A checkpoint ``PREFIX`` (e.g. ``checkpoints/FlowNet2/flownet-2.ckpt-0``)
is an index file ``PREFIX.index`` and data shards
``PREFIX.data-{shard:05d}-of-{num_shards:05d}``.

* ``.index`` is a LevelDB-format table. It ends in a 48-byte footer: the
  metaindex and index ``BlockHandle``s (each a varint64 offset and a
  varint64 size), zero-padded to 40 bytes, then the fixed64
  little-endian magic ``0xdb4775248b80fb57``. Each block is followed by a
  5-byte trailer: a type byte (0 = uncompressed) and the fixed32 masked
  CRC32C of the block and the type byte. A block holds entries
  ``varint32 shared, varint32 non_shared, varint32 value_len, key_delta,
  value``, with keys prefix-compressed between restart points, then a
  uint32 restart array and a uint32 restart count. The index block maps
  a separator key to the ``BlockHandle`` of each data block.
* The key ``""`` holds a ``BundleHeaderProto`` (``num_shards`` = 1,
  ``endianness`` = 2 with 0 = LITTLE, ``version`` = 3). Every other key
  is a variable name whose value is a ``BundleEntryProto``: ``dtype`` =
  1, ``shape`` = 2 (``TensorShapeProto.dim`` = 2, ``Dim.size`` = 1),
  ``shard_id`` = 3, ``offset`` = 4, ``size`` = 5, ``crc32c`` = 6 (fixed32,
  masked), ``slices`` = 7. The entries of a partitioned variable's slices
  have binary keys that start with a 0 byte; they are not variables.
* A tensor is ``size`` raw little-endian bytes at ``offset`` in its shard.

Tensors are read lazily, one ``np.fromfile`` at the entry's offset, and
each is checked against its masked CRC32C (``data/tfrecord.py::crc32c``,
the native runtime's when it builds). DT_FLOAT, DT_DOUBLE, DT_INT32,
DT_INT64, DT_BFLOAT16 and DT_HALF are read; a bfloat16 tensor comes back
as the float32 array of the same values (numpy has no bfloat16). Every
fault raises :class:`TF1CheckpointError` naming its cause: a compressed
block (no snappy here), a big-endian bundle, a sliced (partitioned)
variable, a V1 checkpoint, an unsupported dtype on a tensor that is read,
and any CRC mismatch.
"""

from __future__ import annotations

import os
import re
import struct

import numpy as np

from flownet2_tf_tpu_torch.data.tfrecord import (
    _iter_fields,
    _read_varint,
    crc32c,
)

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_LEN = 48
BLOCK_TRAILER_LEN = 5
HEADER_KEY = b""
# tensorflow/core/framework/types.proto
DT_FLOAT, DT_DOUBLE, DT_INT32, DT_INT64 = 1, 2, 3, 9
DT_BFLOAT16, DT_HALF = 14, 19
_NUMPY_DTYPES = {
    DT_FLOAT: np.dtype("<f4"),
    DT_DOUBLE: np.dtype("<f8"),
    DT_INT32: np.dtype("<i4"),
    DT_INT64: np.dtype("<i8"),
    DT_BFLOAT16: np.dtype("<u2"),
    DT_HALF: np.dtype("<f2"),
}


class TF1CheckpointError(ValueError):
    """A TF1 checkpoint this reader cannot read, with the cause named."""


def mask_crc(crc: int) -> int:
    """LevelDB's and TensorFlow's masked CRC32C: rotate right by 15 bits,
    add 0xa282ead8 (mod 2**32)."""
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _fixed32(buf, pos):
    return struct.unpack_from("<I", buf, pos)[0]


def _block_handle(buf, pos=0):
    """A ``BlockHandle`` at ``pos``: ((offset, size), position after it)."""
    offset, pos = _read_varint(buf, pos)
    size, pos = _read_varint(buf, pos)
    return (offset, size), pos


def _read_block(index: bytes, handle, path) -> bytes:
    """The contents of the block at ``handle``, its trailer checked."""
    offset, size = handle
    end = offset + size
    if end + BLOCK_TRAILER_LEN > len(index):
        raise TF1CheckpointError(f"{path}: block at {offset} runs past the "
                                 "end of the file")
    kind = index[end]
    if kind != 0:
        raise TF1CheckpointError(
            f"{path}: block at {offset} is compressed (type {kind}; 1 is "
            "snappy): only uncompressed tables are read, and no snappy is "
            "installed")
    if mask_crc(crc32c(index[offset:end + 1])) != _fixed32(index, end + 1):
        raise TF1CheckpointError(
            f"{path}: CRC mismatch in the block at {offset}")
    return index[offset:end]


def _block_entries(block: bytes, path):
    """Yield a block's (key, value) pairs in order."""
    if len(block) < 4:
        raise TF1CheckpointError(f"{path}: truncated block")
    n_restarts = _fixed32(block, len(block) - 4)
    limit = len(block) - 4 - 4 * n_restarts
    if limit < 0:
        raise TF1CheckpointError(f"{path}: bad restart count {n_restarts}")
    pos, key = 0, b""
    while pos < limit:
        shared, pos = _read_varint(block, pos)
        non_shared, pos = _read_varint(block, pos)
        value_len, pos = _read_varint(block, pos)
        if shared > len(key) or pos + non_shared + value_len > limit:
            raise TF1CheckpointError(f"{path}: corrupt block entry")
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        yield key, block[pos:pos + value_len]
        pos += value_len


def read_table(path) -> dict:
    """Every (key, value) of the LevelDB-format table at ``path``."""
    with open(path, "rb") as f:
        index = f.read()
    if len(index) < FOOTER_LEN:
        raise TF1CheckpointError(f"{path}: shorter than the table footer")
    footer = index[-FOOTER_LEN:]
    magic = struct.unpack_from("<Q", footer, FOOTER_LEN - 8)[0]
    if magic != TABLE_MAGIC:
        raise TF1CheckpointError(
            f"{path}: bad table magic {magic:#x} (want {TABLE_MAGIC:#x})")
    _, pos = _block_handle(footer)  # the metaindex: empty in a bundle
    index_handle, _ = _block_handle(footer, pos)
    table = {}
    for _, handle in _block_entries(_read_block(index, index_handle, path),
                                    path):
        block = _read_block(index, _block_handle(handle)[0], path)
        table.update(_block_entries(block, path))
    return table


def _parse_header(value: bytes, path) -> int:
    """A ``BundleHeaderProto``: checks the byte order, returns the
    shard count."""
    num_shards, endianness = 1, 0
    for field, v, _ in _iter_fields(value):
        if field == 1:
            num_shards = v
        elif field == 2:
            endianness = v
    if endianness != 0:
        raise TF1CheckpointError(
            f"{path}: the bundle is big-endian (endianness {endianness}); "
            "only little-endian bundles are read")
    return num_shards


def _parse_shape(value: bytes):
    dims = []
    for field, dim, _ in _iter_fields(value):
        if field == 2:
            size = 0
            for dfield, v, _ in _iter_fields(dim):
                if dfield == 1:
                    size = v - (1 << 64) if v >= 1 << 63 else v
            dims.append(size)
    return tuple(dims)


def parse_entry(value: bytes) -> dict:
    """A ``BundleEntryProto`` as a dict: dtype, shape, shard_id, offset,
    size, crc32c (masked, as stored) and sliced (whether it lists
    slices). Absent fields take proto3's defaults (0, no dims)."""
    entry = {"dtype": 0, "shape": (), "shard_id": 0, "offset": 0, "size": 0,
             "crc32c": 0, "sliced": False}
    for field, v, _ in _iter_fields(value):
        if field == 1:
            entry["dtype"] = v
        elif field == 2:
            entry["shape"] = _parse_shape(v)
        elif field == 3:
            entry["shard_id"] = v
        elif field == 4:
            entry["offset"] = v
        elif field == 5:
            entry["size"] = v
        elif field == 6:
            entry["crc32c"] = struct.unpack("<I", v)[0]
        elif field == 7:
            entry["sliced"] = True
    return entry


_CHECKPOINT_LINE = re.compile(r'^model_checkpoint_path:\s*"(.*)"\s*$')


def checkpoint_prefix(path) -> str:
    """The prefix ``path`` names: itself, or for a directory the latest
    prefix its ``checkpoint`` file names (relative to the directory),
    as ``tf.train.load_checkpoint`` resolves it."""
    path = os.fspath(path)
    if not os.path.isdir(path):
        return path
    state = os.path.join(path, "checkpoint")
    if not os.path.isfile(state):
        raise FileNotFoundError(f"{path}: a directory with no 'checkpoint' "
                                "file names no checkpoint")
    with open(state) as f:
        for line in f:
            m = _CHECKPOINT_LINE.match(line.strip())
            if m:
                return os.path.join(path, m.group(1))
    raise ValueError(f"{state}: no model_checkpoint_path line")


class CheckpointReader:
    """The tensors of one TF1 V2 checkpoint, read lazily: the methods of
    ``tf.train.load_checkpoint``'s reader that the converter uses."""

    def __init__(self, path):
        self.prefix = checkpoint_prefix(path)
        index = self.prefix + ".index"
        if not os.path.isfile(index):
            if os.path.isfile(self.prefix):
                raise TF1CheckpointError(
                    f"{self.prefix}: a V1 checkpoint (one file, no .index); "
                    "only V2 bundles are read: re-save it in the V2 format")
            raise FileNotFoundError(f"{index}: no such checkpoint index")
        table = read_table(index)
        if HEADER_KEY not in table:
            raise TF1CheckpointError(f"{index}: no bundle header entry")
        self.num_shards = _parse_header(table.pop(HEADER_KEY), index)
        # a partitioned variable's slice entries have binary keys (their
        # OrderedCode encoding starts with a 0 byte): not variables
        self._entries = {key.decode(): parse_entry(value)
                         for key, value in table.items()
                         if not key.startswith(b"\x00")}

    def get_variable_to_shape_map(self) -> dict:
        return {k: list(e["shape"]) for k, e in self._entries.items()}

    def shard_path(self, shard_id: int) -> str:
        return (f"{self.prefix}.data-{shard_id:05d}-of-"
                f"{self.num_shards:05d}")

    def get_tensor(self, name) -> np.ndarray:
        entry = self._entries[name]
        if entry["sliced"]:
            raise TF1CheckpointError(
                f"{name}: a sliced (partitioned) variable; sliced entries "
                "are not read")
        dtype = _NUMPY_DTYPES.get(entry["dtype"])
        if dtype is None:
            raise TF1CheckpointError(
                f"{name}: unsupported dtype {entry['dtype']} (read: float, "
                "double, int32, int64, bfloat16, half)")
        shape, size = entry["shape"], entry["size"]
        if size != dtype.itemsize * int(np.prod(shape, dtype=np.int64)):
            raise TF1CheckpointError(
                f"{name}: {size} bytes do not hold shape {shape}")
        path = self.shard_path(entry["shard_id"])
        with open(path, "rb") as f:
            f.seek(entry["offset"])
            raw = np.fromfile(f, np.uint8, size)
        if raw.size != size:
            raise TF1CheckpointError(f"{path}: truncated at {name}")
        if mask_crc(crc32c(raw)) != entry["crc32c"]:
            raise TF1CheckpointError(f"{name}: CRC mismatch in {path}")
        arr = raw.view(dtype).reshape(shape)
        if entry["dtype"] == DT_BFLOAT16:
            return (arr.astype(np.uint32) << 16).view(np.float32)
        return arr.astype(dtype.newbyteorder("="), copy=False)


def load_checkpoint(path) -> CheckpointReader:
    """``tf.train.load_checkpoint``: a prefix, or a directory whose
    ``checkpoint`` file names the latest prefix."""
    return CheckpointReader(path)
