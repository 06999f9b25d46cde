"""Bilinear backward warping.

Port of ``flownet2_tf_tpu/ops/flow_warp.py``:
``warped[n, y, x, c] = image[n, y + v(y,x), x + u(y,x), c]`` sampled
bilinearly, with sample coordinates clamped to the image border
(``border='clamp'``), or with out-of-frame samples set to 0
(``border='zero'``).

The stack warps (second-stage inputs, the FlowNet2 fusion double warp)
take the coordinate-grid factor ``warp_res`` as an argument: 1 is the
exact full-resolution warp, 2 (the JAX package's half-res serving
preset) and 4 warp a k x k area-pooled image by the pooled flow in
coarse pixels and upsample the result back (:func:`flow_warp_coarse`),
an approximation. The JAX package reads that factor from thread-local
and environment knobs at trace time; here it is only ever an argument.
Its TPU-only knobs (the 2x2 pool's lowering, a bf16 warp source, the S2D
forms) are not ported. The warp chain runs f32.
"""

from __future__ import annotations

import torch

from flownet2_tf_tpu_torch.ops.resize import resize_bilinear_tf1
from flownet2_tf_tpu_torch.ops.sampling import (
    bilinear_gather,
    bilinear_gather_multi,
)

_BORDERS = ("clamp", "zero")
WARP_RES = (1, 2, 4)


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


def _pool(x, k):
    """Exact k x k area mean of NHWC ``x`` (k in {1, 2, 4}; H, W % k == 0,
    which the %64 input contract guarantees)."""
    if k == 1:
        return x
    n, h, w, c = x.shape
    return x.reshape(n, h // k, k, w // k, k, c).mean(dim=(2, 4))


def pool2(x):
    """The exact 2x2 area mean of NHWC ``x`` in f32: the half-res fusion
    input's image pool (the JAX package's ``_pool2``). Unlike the coarse
    warps below, its users keep the pooled grid's quarter-pixel offset
    (``models/stacks.py::_fusion_input_halfres``)."""
    return _pool(_float_image(x), 2)


def _coarse_flow(flow_pooled, k):
    """A k-pooled flow in coarse-grid pixels, compensating the pooled
    grid's (k-1)/2-px offset: pooled pixel j sits at full-res k*j +
    (k-1)/2, while the TF1 upsample reads coarse position x/k for output
    x, so without the term the warp shifts by +(k-1)/2 px."""
    return flow_pooled * (1.0 / k) - (k - 1) / (2.0 * k)


def flow_warp_coarse(image, flow, k, border: str = "clamp"):
    """:func:`flow_warp` computed on the k x k-pooled image with the
    pooled flow in coarse pixels, bilinearly upsampled back to (H, W):
    k**2 fewer samples, other numbers than the full-res warp."""
    n, h, w, c = image.shape
    image_c = _pool(_float_image(image), k)
    flow_c = _coarse_flow(_pool(flow.to(torch.float32), k), k)
    return resize_bilinear_tf1(flow_warp(image_c, flow_c, border), h, w)


def flow_warp_half(image, flow, border: str = "clamp"):
    """:func:`flow_warp_coarse` at k=2 (the serving preset)."""
    return flow_warp_coarse(image, flow, 2, border)


def flow_warp_multi_coarse(image, flows, k, border: str = "clamp"):
    """Coarse-grid variant of :func:`flow_warp_multi`."""
    n, h, w, c = image.shape
    image_c = _pool(_float_image(image), k)
    flows_c = _coarse_flow(_pool(flows.to(torch.float32), k), k)
    return resize_bilinear_tf1(flow_warp_multi(image_c, flows_c, border),
                               h, w)


def flow_warp_multi_half(image, flows, border: str = "clamp"):
    """:func:`flow_warp_multi_coarse` at k=2."""
    return flow_warp_multi_coarse(image, flows, 2, border)


def check_warp_res(warp_res):
    if warp_res not in WARP_RES:
        raise ValueError(f"warp_res must be one of {WARP_RES}, got "
                         f"{warp_res!r}")


def stack_warp(image, flow, border: str = "clamp", warp_res: int = 1):
    """The warp at stack boundaries (second-stage inputs): the exact
    full-res :func:`flow_warp` at ``warp_res=1``, else the coarse-grid
    approximation at that factor."""
    check_warp_res(warp_res)
    if warp_res > 1:
        return flow_warp_coarse(image, flow, warp_res, border)
    return flow_warp(image, flow, border)


def stack_warp_multi(image, flows, border: str = "clamp", warp_res: int = 1):
    """Multi-flow stack warp (FlowNet2 fusion double warp), at
    ``warp_res`` like :func:`stack_warp`."""
    check_warp_res(warp_res)
    if warp_res > 1:
        return flow_warp_multi_coarse(image, flows, warp_res, border)
    return flow_warp_multi(image, flows, border)
