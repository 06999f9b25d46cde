"""Shared model substrate: conv blocks, channel norm, the f32 policy, the
MSRA init and the endpoint-error loss primitives.

Port of the plain path of ``flownet2_tf_tpu/models/common.py``. Layers are
``nn.Module``s holding ``weights`` (OIHW for convs, the
``conv_transpose2d`` layout for deconvs) and ``biases``; the module tree
mirrors the JAX package's parameter scopes
(``FlowNetCSS/FlowNetCS/FlowNetC/conv1/weights``), so
``training/warmstart.py`` maps one onto the other by name. Activations run
NCHW inside the models.

Padding conventions (Caffe's, like the JAX package):

* conv k x k, stride s: symmetric spatial padding (k-1)//2;
* deconv 4 x 4, stride 2, pad 1: an exact 2x upsample.

The S2D head transforms, ``cast_params_for_inference`` and the bf16
policy of the JAX package are not ported yet.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

LEAK = 0.1


def leaky_relu(x, leak: float = LEAK):
    """LeakyReLU, slope 0.1 (reference ``src/utils.py::LeakyReLU``)."""
    return F.leaky_relu(x, leak)


def check_divisible_by_64(h: int, w: int):
    """The 6 stride-2 stages require H, W = 0 (mod 64). The inference
    runtime (training/infer.py) pads arbitrary sizes up and crops back."""
    if h % 64 or w % 64:
        raise ValueError(
            f"input spatial size ({h}, {w}) must be divisible by 64; use "
            "flownet2_tf_tpu_torch.training.infer (or the CLI), which pads "
            "and crops back automatically"
        )


class _SafeSqrt(torch.autograd.Function):
    """sqrt whose derivative is 0.5 / sqrt(s) where s > 0 and exactly 0 at
    s == 0 (the JAX package's ``_safe_sqrt``, trap C5): the stacked nets
    hit exact zeros (warped == input bitwise, zero flows), where the bare
    derivative is inf and would turn an unfrozen stack's weight grads into
    inf/NaN. The forward stays a bare sqrt."""

    @staticmethod
    def forward(ctx, s):
        y = torch.sqrt(s)
        ctx.save_for_backward(s, y)
        return y

    @staticmethod
    def backward(ctx, grad):
        s, y = ctx.saved_tensors
        tiny = torch.finfo(y.dtype).tiny
        dy = torch.where(s > 0, 0.5 / torch.clamp(y, min=tiny),
                         torch.zeros_like(y))
        return grad * dy


def channel_norm(x):
    """Per-pixel L2 norm over the last (channel) axis of NHWC ``x``,
    keepdims -> (..., 1). Brightness error and flow magnitude of the
    stacked nets; gradient guarded at exact zeros (``_SafeSqrt``)."""
    return _SafeSqrt.apply(torch.sum(torch.square(x), dim=-1, keepdim=True))


def average_endpoint_error(labels, predictions):
    """sqrt(sum_c (pred - gt)^2 + 1e-12) summed over pixels, divided by
    the batch: the multi-scale loss primitive (trap C6)."""
    sq = torch.sum(torch.square(predictions.float() - labels.float()), dim=3)
    return torch.sum(torch.sqrt(sq + 1e-12)) / labels.shape[0]


def endpoint_error_mean(labels, predictions):
    """Per-pixel mean EPE (a metric, not the loss)."""
    sq = torch.sum(torch.square(predictions.float() - labels.float()), dim=-1)
    return torch.mean(torch.sqrt(sq + 1e-12))


@contextlib.contextmanager
def f32_policy():
    """The f32 parity path: no TF32 anywhere.

    cuDNN runs f32 convolutions in TF32 by default (about three decimal
    digits), which the JAX package's ``Precision.HIGHEST`` f32 path never
    does (ROADMAP trap C4). Inside this context both cuDNN convs and
    matmuls run in full f32; the previous settings come back on exit.
    """
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


class Conv(nn.Module):
    """Caffe-padded k x k conv, stride s, + optional LeakyReLU.

    ``weights``: (out, in, k, k); the JAX package stores HWIO.
    """

    def __init__(self, k: int, cin: int, cout: int, stride: int = 1,
                 act: bool = True):
        super().__init__()
        self.weights = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.biases = nn.Parameter(torch.zeros(cout))
        self.stride = stride
        self.act = act

    @staticmethod
    def from_jax(w):
        """HWIO -> OIHW."""
        return w.transpose(3, 2, 0, 1)

    @staticmethod
    def to_jax(w):
        """OIHW -> HWIO."""
        return w.transpose(2, 3, 1, 0)

    @staticmethod
    def jax_shape(shape):
        o, i, kh, kw = shape
        return (kh, kw, i, o)

    def forward(self, x):
        k = self.weights.shape[-1]
        y = F.conv2d(x, self.weights, self.biases, stride=self.stride,
                     padding=(k - 1) // 2)
        return leaky_relu(y) if self.act else y


class Deconv(nn.Module):
    """4x4 stride-2 transposed conv, Caffe pad=1 (exact 2x upsample),
    + optional LeakyReLU.

    ``weights``: (in, out, 4, 4), the ``conv_transpose2d`` layout. The JAX
    package stores the kernel in forward-conv HWIO for an input-dilated
    conv with pad 2; that conv equals ``conv_transpose2d`` of the
    spatially flipped kernel with padding 1 (ROADMAP trap C2).
    """

    def __init__(self, cin: int, cout: int, act: bool = True, k: int = 4):
        super().__init__()
        self.weights = nn.Parameter(torch.zeros(cin, cout, k, k))
        self.biases = nn.Parameter(torch.zeros(cout))
        self.act = act

    @staticmethod
    def from_jax(w):
        """Forward-conv HWIO -> flipped (in, out, kh, kw)."""
        return w[::-1, ::-1].transpose(2, 3, 0, 1)

    @staticmethod
    def to_jax(w):
        """Flipped (in, out, kh, kw) -> forward-conv HWIO."""
        return w.transpose(2, 3, 0, 1)[::-1, ::-1]

    @staticmethod
    def jax_shape(shape):
        i, o, kh, kw = shape
        return (kh, kw, i, o)

    def forward(self, x):
        y = F.conv_transpose2d(x, self.weights, self.biases, stride=2,
                               padding=1)
        return leaky_relu(y) if self.act else y


def msra_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every Conv/Deconv of ``module`` the way the JAX package's
    ``model.init`` does: weights MSRA, std sqrt(2 / fan_in) times a normal
    truncated to +-2 (``fan_in = k * k * cin``), biases zero. The draws come
    from ``generator`` (CPU), layer by layer in sorted scope order; the bits
    differ from ``jax.random``, the distribution does not."""
    layers = sorted((name, m) for name, m in module.named_modules()
                    if isinstance(m, (Conv, Deconv)))
    with torch.no_grad():
        for _, layer in layers:
            kh, kw, cin, _ = layer.jax_shape(tuple(layer.weights.shape))
            w = torch.empty(layer.weights.shape)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                        generator=generator)
            layer.weights.copy_(w * (2.0 / (kh * kw * cin)) ** 0.5)
            layer.biases.zero_()
    return module


def predict_flow(cin: int) -> Conv:
    """3x3 stride-1 2-channel conv, no activation (``predict_flowN``)."""
    return Conv(3, cin, 2, act=False)


def nchw(x):
    """NHWC -> NCHW, contiguous.

    A copy on purpose: a bare permute would hand cuDNN channels_last
    tensors, and every layer after would inherit that layout, while
    cuDNN's f32 conv kernels on Hopper work in NCHW and transpose around
    each call (PERF.md, PR 1 findings).
    """
    return x.permute(0, 3, 1, 2).contiguous()


def nhwc(x):
    """NCHW -> NHWC view."""
    return x.permute(0, 2, 3, 1)
