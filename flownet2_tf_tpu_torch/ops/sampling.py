"""Bilinear gather at absolute float coordinates, border-replicate.

Port of ``flownet2_tf_tpu/ops/sampling.py::bilinear_gather`` and
``bilinear_gather_multi``. The JAX package's packed 4-tap table and
per-sample unroll work around XLA's TPU gather emitter; here each tap is
a plain gather by index.

Border semantics: sample coordinates are clamped to [0, size-1] BEFORE
the floor split, so a clamped coordinate yields a lerp weight of 0 or 1
at the border. ``grid_sample`` is not used: its border and
coordinate conventions differ.
"""

from __future__ import annotations

import torch


def _gather_lerp(flat, x2, y2, w):
    """Sample ``flat`` ((B, h*w, C)) at pre-clamped coords (B, h', w').

    Returns (B, h', w', C). The right and bottom taps clamp to the last
    column and row, like the edge-padded table of the JAX package.
    """
    b, hw, c = flat.shape
    h = hw // w
    out_shape = x2.shape
    x0 = torch.floor(x2)
    y0 = torch.floor(y2)
    wx = (x2 - x0)[..., None]
    wy = (y2 - y0)[..., None]
    xi0 = x0.long()
    yi0 = y0.long()
    xi1 = torch.clamp(xi0 + 1, max=w - 1)
    yi1 = torch.clamp(yi0 + 1, max=h - 1)

    def tap(yi, xi):
        idx = (yi * w + xi).reshape(b, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(*out_shape, c)

    w00 = (1 - wx) * (1 - wy)
    w01 = wx * (1 - wy)
    w10 = (1 - wx) * wy
    w11 = wx * wy
    dt = flat.dtype
    return (
        tap(yi0, xi0) * w00.to(dt)
        + tap(yi0, xi1) * w01.to(dt)
        + tap(yi1, xi0) * w10.to(dt)
        + tap(yi1, xi1) * w11.to(dt)
    )


def bilinear_gather(image, x2, y2):
    """Sample NHWC ``image`` at float coords (B, h', w'), border-replicate.

    Returns (B, h', w', C).
    """
    n, h, w, c = image.shape
    x2 = torch.clamp(x2, 0.0, w - 1)
    y2 = torch.clamp(y2, 0.0, h - 1)
    return _gather_lerp(image.reshape(n, h * w, c), x2, y2, w)


def bilinear_gather_multi(image, x2, y2):
    """Sample ONE image ((1, h, w, c)) at M coordinate sets (M, h', w').

    Returns (M, h', w', C). The image is broadcast, not copied, over the
    M coordinate sets.
    """
    n, h, w, c = image.shape
    if n != 1:
        raise ValueError(
            f"bilinear_gather_multi expects a single image, got {n}"
        )
    m = x2.shape[0]
    x2 = torch.clamp(x2, 0.0, w - 1)
    y2 = torch.clamp(y2, 0.0, h - 1)
    flat = image.reshape(1, h * w, c).expand(m, -1, -1)
    return _gather_lerp(flat, x2, y2, w)
