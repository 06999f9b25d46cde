"""Bilinear backward warping.

Port of the exact (k=1) path of ``flownet2_tf_tpu/ops/flow_warp.py``:
``warped[n, y, x, c] = image[n, y + v(y,x), x + u(y,x), c]`` sampled
bilinearly, with sample coordinates clamped to the image border
(``border='clamp'``), or with out-of-frame samples set to 0
(``border='zero'``). The half-resolution and S2D stack-warp variants of
the JAX package are not ported yet.
"""

from __future__ import annotations

import torch

from flownet2_tf_tpu_torch.ops.sampling import (
    bilinear_gather,
    bilinear_gather_multi,
)

_BORDERS = ("clamp", "zero")


def _coords(flows, h, w):
    """Absolute f32 sample coordinates (x + u, y + v) of NHW2 ``flows``.

    Coordinates stay f32 whatever the image dtype: bf16 would quantize
    x ~ 1024 to ~4 px.
    """
    flows = flows.to(torch.float32)
    xs = torch.arange(w, dtype=torch.float32, device=flows.device)
    ys = torch.arange(h, dtype=torch.float32, device=flows.device)
    return xs[None, None, :] + flows[..., 0], ys[None, :, None] + flows[..., 1]


def _mask_border(out, x2, y2, h, w, border):
    if border not in _BORDERS:
        raise ValueError(f"border must be one of {_BORDERS}, got {border!r}")
    if border == "zero":
        inside = (x2 >= 0.0) & (x2 <= w - 1) & (y2 >= 0.0) & (y2 <= h - 1)
        out = out * inside[..., None].to(out.dtype)
    return out


def _float_image(image):
    return image if image.is_floating_point() else image.to(torch.float32)


def flow_warp(image, flow, border: str = "clamp"):
    """Warp ``image`` (NHWC) backward by ``flow`` (NHW2, (u, v) order)."""
    if image.ndim != 4 or flow.ndim != 4 or flow.shape[-1] != 2:
        raise ValueError(
            f"flow_warp expects NHWC image and NHW2 flow, got "
            f"{tuple(image.shape)} / {tuple(flow.shape)}"
        )
    if image.shape[:3] != flow.shape[:3]:
        raise ValueError(
            f"image/flow spatial mismatch: {tuple(image.shape)} vs "
            f"{tuple(flow.shape)}"
        )
    n, h, w, c = image.shape
    x2, y2 = _coords(flow, h, w)
    out = bilinear_gather(_float_image(image), x2, y2)
    return _mask_border(out, x2, y2, h, w, border)


def flow_warp_multi(image, flows, border: str = "clamp"):
    """Warp ONE image ((1, H, W, C)) by M flows ((M, H, W, 2)) at once.

    The FlowNet2 fusion stage warps the same ``input_b`` by the CSS and
    SD flows. Returns (M, H, W, C).
    """
    if image.shape[0] != 1 or image.shape[1:3] != flows.shape[1:3]:
        raise ValueError(
            f"flow_warp_multi expects (1,H,W,C) image and (M,H,W,2) "
            f"flows, got {tuple(image.shape)} / {tuple(flows.shape)}"
        )
    n, h, w, c = image.shape
    x2, y2 = _coords(flows, h, w)
    out = bilinear_gather_multi(_float_image(image), x2, y2)
    return _mask_border(out, x2, y2, h, w, border)


def stack_warp(image, flow, border: str = "clamp"):
    """The warp at stack boundaries (second-stage inputs): the exact
    full-resolution :func:`flow_warp` (the JAX package's k=1)."""
    return flow_warp(image, flow, border)


def stack_warp_multi(image, flows, border: str = "clamp"):
    """Multi-flow stack warp (FlowNet2 fusion double warp), k=1."""
    return flow_warp_multi(image, flows, border)
