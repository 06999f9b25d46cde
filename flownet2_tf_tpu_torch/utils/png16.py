"""Minimal 16-bit RGB PNG codec (pure Python + zlib).

A copy of ``flownet2_tf_tpu/utils/png16.py``: importing the original
pulls in JAX. KITTI optical-flow ground truth is stored as
16-bit-per-channel RGB PNG, which PIL downconverts to 8-bit on read, so
the port carries this codec: color type 2 (truecolor), bit depth 16,
big-endian samples, all five scanline filters on read, filter 0 on
write.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png16(arr: np.ndarray, path) -> None:
    """Write (H, W, 3) uint16 array as a 16-bit RGB PNG."""
    arr = np.asarray(arr)
    if arr.ndim != 3 or arr.shape[2] != 3 or arr.dtype != np.uint16:
        raise ValueError(f"expected (H, W, 3) uint16, got {arr.shape} {arr.dtype}")
    h, w = arr.shape[:2]
    ihdr = struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0)
    be = arr.astype(">u2").tobytes()
    stride = w * 6
    raw = bytearray()
    for y in range(h):
        raw.append(0)  # filter type 0 (None)
        raw += be[y * stride : (y + 1) * stride]
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(bytes(raw), 6)))
        f.write(_chunk(b"IEND", b""))


def read_png16(path) -> np.ndarray:
    """Read a 16-bit RGB PNG into an (H, W, 3) uint16 array."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG")
    pos = len(_SIGNATURE)
    width = height = None
    bitdepth = colortype = interlace = None
    idat = bytearray()
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            width, height, bitdepth, colortype, _, _, interlace = (
                struct.unpack(">IIBBBBB", payload)
            )
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    if bitdepth != 16 or colortype != 2:
        raise ValueError(
            f"{path}: expected 16-bit RGB PNG, got depth={bitdepth} "
            f"colortype={colortype}"
        )
    if interlace:
        raise ValueError(f"{path}: interlaced PNG not supported")
    raw = zlib.decompress(bytes(idat))
    bpp = 6  # bytes per pixel (3 channels x 2 bytes)
    stride = width * bpp
    # None/Sub/Up defilter vectorized (what real encoders emit most);
    # per-byte Python loops made filtered KITTI-size reads seconds per
    # image. Average/Paeth stay as loops (sequential left-dependence
    # through a nonlinearity); uint8 adds wrap mod 256 natively.
    raw_np = np.frombuffer(raw, dtype=np.uint8).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype = int(raw_np[y, 0])
        line = raw_np[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: per-lane prefix sum, mod 256
            cur = (
                np.cumsum(line.reshape(-1, bpp).astype(np.uint32), axis=0)
                & 0xFF
            ).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype == 3:  # Average
            buf = bytearray(line.tobytes())
            pv = prev
            for i in range(stride):
                left = buf[i - bpp] if i >= bpp else 0
                buf[i] = (buf[i] + ((left + int(pv[i])) >> 1)) & 0xFF
            cur = np.frombuffer(bytes(buf), np.uint8)
        elif ftype == 4:  # Paeth
            buf = bytearray(line.tobytes())
            pv = prev
            for i in range(stride):
                a = buf[i - bpp] if i >= bpp else 0
                b = int(pv[i])
                c = int(pv[i - bpp]) if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                if pa <= pb and pa <= pc:
                    pr = a
                elif pb <= pc:
                    pr = b
                else:
                    pr = c
                buf[i] = (buf[i] + pr) & 0xFF
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"{path}: bad filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return (
        np.frombuffer(out.tobytes(), dtype=">u2")
        .reshape(height, width, 3)
        .astype(np.uint16)
    )
