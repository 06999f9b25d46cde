"""Bilinear gather at absolute float coordinates, border-replicate.

Port of ``flownet2_tf_tpu/ops/sampling.py::bilinear_gather`` and
``bilinear_gather_multi``. The JAX package's packed 4-tap table and
per-sample unroll work around XLA's TPU gather emitter; here each tap is
a plain read of the flattened image by index.

The read is chosen for its backward, so that a gradient through a warp
repeats bit for bit on either device: on CUDA advanced indexing, whose
backward (``index_put_`` with ``accumulate``) sorts the indices and sums
each pixel's contributions in that order (``gather``'s ``scatter_add``
uses atomics there); on the CPU ``gather``, whose ``scatter_add`` sums
serially (an index's backward uses atomics across threads there). The
forward values are the same copies either way.

Border semantics: sample coordinates are clamped to [0, size-1] BEFORE
the floor split, so a clamped coordinate yields a lerp weight of 0 or 1
at the border. ``grid_sample`` is not used: its border and
coordinate conventions differ.
"""

from __future__ import annotations

import torch


def _clip(v, hi):
    """``v`` clamped to [0, hi] as ``jnp.clip`` clamps it, gradient
    included: a coordinate exactly on a bound takes half the gradient
    (``torch.maximum``/``minimum`` split ties as JAX's ``max``/``min``
    do; ``torch.clamp`` would pass all of it)."""
    return torch.minimum(torch.maximum(v, v.new_zeros(())),
                         v.new_full((), float(hi)))


def _read(flat, idx):
    """Rows of ``flat`` at ``idx`` (B, N): (B, N, C). ``flat`` is (B, h*w,
    C), one table per row of ``idx``, or (h*w, C), one shared by all."""
    if flat.is_cuda:
        if flat.ndim == 2:
            return flat[idx]
        return flat[torch.arange(idx.shape[0], device=idx.device)[:, None],
                    idx]
    table = flat if flat.ndim == 3 else flat.expand(idx.shape[0], -1, -1)
    return torch.gather(table, 1,
                        idx[..., None].expand(-1, -1, flat.shape[-1]))


def _gather_lerp(flat, x2, y2, w):
    """Sample ``flat`` at pre-clamped coords (B, h', w'): ``flat`` is
    (B, h*w, C), one image per coordinate set, or (h*w, C), one image
    shared by all B sets.

    Returns (B, h', w', C). The right and bottom taps clamp to the last
    column and row, like the edge-padded table of the JAX package.
    """
    hw, c = flat.shape[-2:]
    h = hw // w
    out_shape = x2.shape
    b = out_shape[0]
    x0 = torch.floor(x2)
    y0 = torch.floor(y2)
    wx = (x2 - x0)[..., None]
    wy = (y2 - y0)[..., None]
    xi0 = x0.long()
    yi0 = y0.long()
    xi1 = torch.clamp(xi0 + 1, max=w - 1)
    yi1 = torch.clamp(yi0 + 1, max=h - 1)

    def tap(yi, xi):
        return _read(flat, (yi * w + xi).reshape(b, -1)).reshape(
            *out_shape, c)

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
    return _gather_lerp(image.reshape(n, h * w, c), _clip(x2, w - 1),
                        _clip(y2, h - 1), w)


def bilinear_gather_multi(image, x2, y2):
    """Sample ONE image ((1, h, w, c)) at M coordinate sets (M, h', w').

    Returns (M, h', w', C). The M coordinate sets read the one image.
    """
    n, h, w, c = image.shape
    if n != 1:
        raise ValueError(
            f"bilinear_gather_multi expects a single image, got {n}"
        )
    return _gather_lerp(image.reshape(h * w, c), _clip(x2, w - 1),
                        _clip(y2, h - 1), w)
