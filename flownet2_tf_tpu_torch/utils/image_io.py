"""Host-side image IO (copy of ``flownet2_tf_tpu/utils/image_io.py``).

A copy, not an import: ``flownet2_tf_tpu.utils`` pulls in optax and so
JAX. Pure-NumPy binary-PPM (P6) fast path, PIL for everything else.
"""

from __future__ import annotations

import os

import numpy as np


def read_image(path):
    """Read an image file -> (H, W, 3) uint8 array."""
    path = os.fspath(path)
    if path.endswith(".ppm"):
        try:
            return _read_ppm(path)
        except ValueError:
            pass  # non-P6 ppm: fall through to PIL
    from PIL import Image

    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, dtype=np.uint8)


def write_image(arr, path):
    """Write an (H, W, 3) uint8 array (other dtypes are clipped to 0..255)
    in the format the path's extension names (PIL)."""
    from PIL import Image

    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(os.fspath(path))


def _read_ppm(path):
    """Minimal binary PPM (P6, maxval<=255) reader, no PIL dependency."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"P6"):
        raise ValueError(f"{path}: not a binary P6 PPM")
    # Header: magic, width, height, maxval, separated by whitespace;
    # '#' starts a comment that runs to end of line.
    fields = []
    i = 2
    while len(fields) < 3:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i] != 0x0A:
                i += 1
            continue
        j = i
        while j < len(data) and not data[j : j + 1].isspace():
            j += 1
        fields.append(int(data[i:j]))
        i = j
    i += 1  # single whitespace after maxval
    w, h, maxval = fields
    if maxval > 255:
        raise ValueError(f"{path}: 16-bit PPM not supported by fast path")
    img = np.frombuffer(data, dtype=np.uint8, count=w * h * 3, offset=i)
    return img.reshape(h, w, 3).copy()


def load_image_pair(path_a, path_b, dtype=np.float32):
    """Load two images, scale to [0, 1] float, return (H, W, 3) pair."""
    a = read_image(path_a).astype(dtype) / 255.0
    b = read_image(path_b).astype(dtype) / 255.0
    if a.shape != b.shape:
        raise ValueError(f"image pair shape mismatch: {a.shape} vs {b.shape}")
    return a, b
