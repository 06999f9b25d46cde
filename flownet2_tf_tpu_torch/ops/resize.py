"""Bilinear resize with TF1 ``align_corners=False`` semantics.

Port of ``flownet2_tf_tpu/ops/resize.py``. TF1 maps destination pixel
``i`` to source coordinate ``i * (in / out)`` and clamps at the border.
``torch.nn.functional.interpolate(..., align_corners=False)`` uses
half-pixel centers instead and gives different numbers, so it is not
used here.

The rows and columns are read so that a gradient through the resize
repeats bit for bit: on CUDA by advanced indexing, whose backward
(``index_put_`` with ``accumulate``) sorts the indices and sums each
source pixel's contributions in that order (``index_select``'s
``index_add_`` uses atomics there); on the CPU by ``index_select``,
whose ``index_add_`` sums serially.
"""

from __future__ import annotations

import torch


def _take(t, dim, idx):
    """``t.index_select(dim, idx)``, read by advanced indexing on CUDA."""
    if t.is_cuda:
        return t[(slice(None),) * dim + (idx,)]
    return t.index_select(dim, idx)


def resize_bilinear_tf1(x, out_h: int, out_w: int):
    """Resize NHWC ``x`` to (out_h, out_w), TF1 align_corners=False rules."""
    if x.ndim != 4:
        raise ValueError(f"expected NHWC, got {tuple(x.shape)}")
    n, h, w, c = x.shape
    if (h, w) == (out_h, out_w):
        return x
    compute_dtype = torch.promote_types(x.dtype, torch.float32)
    x = x.to(compute_dtype)
    dev = x.device

    src_y = torch.arange(out_h, dtype=compute_dtype, device=dev) * (h / out_h)
    src_x = torch.arange(out_w, dtype=compute_dtype, device=dev) * (w / out_w)
    y0 = torch.floor(src_y).long()
    x0 = torch.floor(src_x).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wy = (src_y - y0.to(compute_dtype))[None, :, None, None]
    wx = (src_x - x0.to(compute_dtype))[None, None, :, None]

    rows0 = _take(x, 1, y0)
    rows1 = _take(x, 1, y1)

    def horiz(rows):
        left = _take(rows, 2, x0)
        right = _take(rows, 2, x1)
        return left * (1.0 - wx) + right * wx

    top = horiz(rows0)
    bot = horiz(rows1)
    return top * (1.0 - wy) + bot * wy
