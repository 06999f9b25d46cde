"""Synthetic image pairs and flows, drawn from the seed on the device
and kept on the host, where a user's frames would come from.

A frame is smooth noise (a coarse uniform grid, bicubically upsampled,
plus fine noise); the second frame is the first warped by a smooth flow
of up to ``max_flow`` pixels, so the pair holds real motion for the
correlation to find. Every seed gives the same sizes (and the same
ladder of exposures, where a mix asks for one)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.harness.weights import generator


def _smooth(g, shape, cell, device):
    n, c, h, w = shape
    coarse = torch.rand((n, c, h // cell + 2, w // cell + 2), generator=g,
                        device=device)
    up = F.interpolate(coarse, size=(h + 2 * cell, w + 2 * cell),
                       mode="bicubic", align_corners=False)
    return up[:, :, cell:cell + h, cell:cell + w]


def _backward_warp(image, flow):
    n, _, h, w = image.shape
    xs = torch.arange(w, device=image.device, dtype=image.dtype)
    ys = torch.arange(h, device=image.device, dtype=image.dtype)
    gx = (xs[None, None, :] + flow[:, 0]) * (2.0 / (w - 1)) - 1.0
    gy = (ys[None, :, None] + flow[:, 1]) * (2.0 / (h - 1)) - 1.0
    return F.grid_sample(image, torch.stack([gx, gy], -1), mode="bilinear",
                         padding_mode="border", align_corners=True)


def make_pairs(seed, n, height, width, device, max_flow=20.0, chunk=8,
               exposure=None):
    """``(image_a, image_b, flow)`` as CPU tensors: NHWC f32 images in
    [0, 1] and the NHW2 flow with ``image_a[y, x] ~ image_b[y + v,
    x + u]``. Drawn ``chunk`` pairs at a time on ``device``.
    ``exposure``: per pair, a factor that scales both frames (dark
    scenes beside bright ones); None leaves them at 1."""
    g = generator(seed, 2, device)
    outs = ([], [], [])
    for start in range(0, n, chunk):
        m = min(chunk, n - start)
        img = _smooth(g, (m, 3, height, width), 16, device)
        img = (img + 0.02 * torch.randn(img.shape, generator=g,
                                        device=device)).clamp_(0.0, 1.0)
        if exposure is not None:
            img = img * torch.as_tensor(exposure[start:start + m],
                                        dtype=img.dtype,
                                        device=device)[:, None, None, None]
        flow = (_smooth(g, (m, 2, height, width), 64, device) * 2.0
                - 1.0) * max_flow
        # b[p] = a[p - flow]: a[y, x] = b[y + v, x + u]
        b = _backward_warp(img, -flow)
        for out, t in zip(outs, (img, b, flow)):
            out.append(t.permute(0, 2, 3, 1).contiguous().cpu())
    return tuple(torch.cat(o) for o in outs)


def to_uint8(images):
    """[0, 1] f32 images as the uint8 a decoder yields."""
    return (images * 255.0).round_().clamp_(0, 255).to(torch.uint8)
