"""Correlation (cost-volume) op.

Port of ``flownet2_tf_tpu/ops/correlation.py``. Same signature, same NHWC
output with ``D**2`` channels in dy-major, dx-minor order (441 for the
FlowNetC configuration ``k=1, d=20, s1=1, s2=2, pad=20``):

``out[n, y', x', (dy_i * D + dx_i)] =
    1/(K*K*C) * sum_{ky,kx,c} a_pad[n, y1+ky, x1+kx, c]
                             * b_pad[n, y1+dy+ky, x1+dx+kx, c]``

with ``y1 = border + y'*stride_1``, ``dy = (dy_i - r)*stride_2``,
``r = max_displacement // stride_2`` and ``D = 2r + 1``.

Routing:

* the FlowNetC family (``k=1, s1=1, pad == d, d % s2 == 0``) goes through
  the registered op ``flownet2::correlation``
  (``ops/cuda/correlation_kernel.py``) on every device, so an exported
  graph holds one such node on the CPU as on the card. Its CUDA kernel
  launches the hand-written CUDA kernels (forward, and backward under
  autograd); its CPU kernel is the plain version below, and its CPU
  backward the plain versions of the backward kernels
  (:func:`_correlation_da_form`, :func:`_mirror_shift_grad`);
* any other configuration takes the plain version, with autograd
  through it, on the CPU and raises on CUDA.
"""

from __future__ import annotations

import math

import torch

from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel


def correlation(
    input_a,
    input_b,
    kernel_size: int = 1,
    max_displacement: int = 20,
    stride_1: int = 1,
    stride_2: int = 2,
    pad: int = 20,
):
    """Cost volume between two NHWC feature maps -> (N, H', W', D**2) f32."""
    if input_a.ndim != 4 or input_a.shape != input_b.shape:
        raise ValueError(
            f"correlation expects matching NHWC inputs, got "
            f"{tuple(input_a.shape)} vs {tuple(input_b.shape)}"
        )
    if kernel_size % 2 != 1:
        raise ValueError("kernel_size must be odd")
    if correlation_kernel.supported(kernel_size, max_displacement, stride_1,
                                    stride_2, pad):
        return correlation_kernel.correlation_cuda(
            input_a, input_b, max_displacement, stride_2
        )
    if input_a.device.type != "cpu":
        raise ValueError(
            f"correlation on {input_a.device}: the CUDA kernel covers "
            "kernel_size=1, stride_1=1, pad == max_displacement, "
            f"max_displacement % stride_2 == 0; got k={kernel_size} "
            f"d={max_displacement} s1={stride_1} s2={stride_2} pad={pad}"
        )
    return _correlation_oracle(input_a, input_b, kernel_size,
                               max_displacement, stride_1, stride_2, pad)


def correlation_output_shape(shape, kernel_size, max_displacement, stride_1,
                             stride_2, pad):
    n, h, w, c = shape
    kr = (kernel_size - 1) // 2
    border = max_displacement + kr
    out_h = int(math.ceil((h + 2 * pad - 2 * border) / stride_1))
    out_w = int(math.ceil((w + 2 * pad - 2 * border) / stride_1))
    r = max_displacement // stride_2
    d = 2 * r + 1
    return (n, out_h, out_w, d * d)


def _correlation_oracle(a, b, kernel_size, max_displacement, stride_1,
                        stride_2, pad):
    """The plain version: a loop over the D**2 displacements of a product
    and channel sum, then a windowed sum. It is the numerics contract the
    CUDA kernel is held against, on any device."""
    n, h, w, c = a.shape
    _, out_h, out_w, _ = correlation_output_shape(
        a.shape, kernel_size, max_displacement, stride_1, stride_2, pad
    )
    r = max_displacement // stride_2
    compute_dtype = torch.promote_types(a.dtype, torch.float32)
    a = a.to(compute_dtype)
    b = b.to(compute_dtype)

    # Zero-pad a by `pad` and b by an extra max_displacement so every
    # displacement shift is an in-bounds slice.
    s = max_displacement
    a_pad = torch.nn.functional.pad(a, (0, 0, pad, pad, pad, pad))
    b_pad = torch.nn.functional.pad(
        b, (0, 0, pad + s, pad + s, pad + s, pad + s)
    )
    # Window starts span [max_displacement, ...]; extent (out-1)*s1 + K.
    y_lo = max_displacement
    ext_h = (out_h - 1) * stride_1 + kernel_size
    ext_w = (out_w - 1) * stride_1 + kernel_size
    a_roi = a_pad[:, y_lo:y_lo + ext_h, y_lo:y_lo + ext_w]

    planes = []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            y0 = s + y_lo + dy * stride_2
            x0 = s + y_lo + dx * stride_2
            b_shift = b_pad[:, y0:y0 + ext_h, x0:x0 + ext_w]
            m = (a_roi * b_shift).sum(dim=-1)  # (N, ext_h, ext_w)
            if kernel_size == 1 and stride_1 == 1:
                win = m
            else:
                win = sum(
                    m[:, ky:ky + (out_h - 1) * stride_1 + 1:stride_1,
                      kx:kx + (out_w - 1) * stride_1 + 1:stride_1]
                    for ky in range(kernel_size)
                    for kx in range(kernel_size)
                )
            planes.append(win)
    cv = torch.stack(planes, dim=-1)
    norm = 1.0 / (kernel_size * kernel_size * c)
    return cv * norm


def _shifted(x, dy, dx):
    """``x[:, y + dy, x + dx]`` over the (H, W) frame, zero outside it."""
    n, h, w = x.shape[:3]
    pad_y, pad_x = abs(dy), abs(dx)
    xp = torch.nn.functional.pad(x, (0, 0, pad_x, pad_x, pad_y, pad_y))
    return xp[:, pad_y + dy:pad_y + dy + h, pad_x + dx:pad_x + dx + w]


def _mirror_shift_grad(g, r, s2):
    """The plain version of the backward's shift kernel:
    ``g'[n, y, x, k] = g[n, y + dy_k, x + dx_k, D*D-1-k]`` with ``(dy_k,
    dx_k) = ((k // D - r)*s2, (k % D - r)*s2)``, zero where that pixel is
    outside the frame. Since the displacement of channel ``D*D-1-k`` is
    minus that of ``k``, ``db = _correlation_da_form(g', a, r, s2)``."""
    d = 2 * r + 1
    planes = [
        _shifted(g[..., d * d - 1 - k:d * d - k], (k // d - r) * s2,
                 (k % d - r) * s2)
        for k in range(d * d)
    ]
    return torch.cat(planes, dim=-1)


def _correlation_da_form(G, S, r, s2):
    """The plain version of the backward kernels' common body:
    ``out[n, p, c] = (1/C) sum_k G[n, p, k] * S[n, p + delta_k, c]`` over
    in-frame terms, ``delta_k = ((k // D - r)*s2, (k % D - r)*s2)``, in
    ``G``'s and ``S``'s promoted dtype (at least f32). ``(G, S) = (g, b)``
    gives the correlation's ``da``; ``(_mirror_shift_grad(g), a)`` its
    ``db``."""
    d = 2 * r + 1
    dtype = torch.promote_types(torch.promote_types(G.dtype, S.dtype),
                                torch.float32)
    G, S = G.to(dtype), S.to(dtype)
    out = torch.zeros(S.shape, dtype=dtype, device=S.device)
    for k in range(d * d):
        out += G[..., k:k + 1] * _shifted(S, (k // d - r) * s2,
                                          (k % d - r) * s2)
    return out * (1.0 / S.shape[-1])
