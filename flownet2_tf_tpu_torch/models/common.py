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

Mixed precision (the JAX package's ``_conv_io_dtypes``): every layer's
``forward`` takes the model's ``compute_dtype`` (None or float32: the f32
path; bfloat16: the bf16 policy). Under bf16 a feature layer (``act``)
casts its input, weights and bias to bf16 and returns bf16; a flow head,
flow upsampler or interconv (``act=False``) runs in f32, except an
interconv built with ``interconv=True`` (the models' ``bf16_interconv``,
the JAX package's ``get_bf16_interconv``), which follows the compute
dtype. The parameters stay f32 masters (training) unless
:func:`cast_params_for_inference` pre-cast the layers that follow the
compute dtype (serving). ``torch.autocast`` is not used: its op lists
would put the f32 layers in bf16. The S2D head transforms are TPU layout
work and are not ported.

Feature precision on the f32 path (:func:`set_f32_features`, the JAX
package's ``get_f32_features_precision``): ``"highest"`` (the default)
runs every conv in full f32; ``"default"`` lets cuDNN run the feature
layers (``act``) in TF32, flow heads, upsamplers and interconvs staying
full f32.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from flownet2_tf_tpu_torch.utils.precision import f32_policy  # noqa: F401

LEAK = 0.1

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# The activation layout each compute dtype's convs run in, chosen on the
# H100 (PERF.md): cuDNN's f32 convs work in NCHW and transpose around a
# channels_last input; its bf16 tensor-core convs work in NHWC.
_CHANNELS_LAST = {torch.float32: False, torch.bfloat16: True}


def scope(name: str):
    """A profiler scope named like the JAX package's ``jax.named_scope``
    at the same site: ``torch.profiler.record_function(name)`` while a
    profiler is active (``tools/profiler.py`` reads the scopes' device
    time from it), a null context otherwise.

    JAX's scopes are trace-time metadata with no runtime op; a
    ``record_function`` is a dispatcher call on every entry. The gate
    keeps the launch-bound forward from paying for about a hundred of
    them per call, and keeps ``torch.export`` from tracing profiler
    nodes into a served graph."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


_REMAT = contextvars.ContextVar("flownet2_remat", default=False)


@contextlib.contextmanager
def remat(enabled: bool = True):
    """Inside this context the models run their segments (:func:`segment`)
    under ``torch.utils.checkpoint``: a segment keeps only its inputs for
    the backward and recomputes its inside there (the JAX package's
    ``TrainConfig.remat``, which wraps the whole forward in
    ``jax.checkpoint``; one checkpoint around a whole torch forward would
    recompute every activation at once and save no peak memory). The
    recompute runs the same ops on the same inputs, so the gradients are
    bitwise the ones without remat wherever the kernels are deterministic
    (``f32_policy``; the caller keeps the backward inside it)."""
    token = _REMAT.set(bool(enabled))
    try:
        yield
    finally:
        _REMAT.reset(token)


def segment(owner: nn.Module, fn, *args):
    """``fn(*args)``, checkpointed when :func:`remat` is on and something
    in it needs a gradient: a trainable parameter of ``owner`` (the net
    whose layers ``fn`` runs) or an input. A frozen stage saves nothing
    for the backward anyway and runs plainly."""
    if (_REMAT.get() and torch.is_grad_enabled()
            and (any(torch.is_tensor(a) and a.requires_grad for a in args)
                 or any(p.requires_grad for p in owner.parameters()))):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def conv_segments(net: nn.Module, x, names, keep, compute_dtype=None,
                  scope_prefix: str = ""):
    """Run ``net``'s convs ``names`` in order from ``x``, one
    :func:`segment` ending at each name in ``keep`` (the outputs a later
    layer reads); returns ``{name: output}`` for ``keep``. Each conv runs
    in the profiler scope ``scope_prefix + name``, or in none if
    ``scope_prefix`` is None."""
    acts, group = {}, []
    for name in names:
        group.append(name)
        if name in keep:
            x = segment(net, functools.partial(
                _run_convs, net, tuple(group), compute_dtype, scope_prefix),
                x)
            acts[name] = x
            group = []
    if group:
        raise ValueError(f"conv_segments: {group} end in no kept output")
    return acts


def _run_convs(net, names, compute_dtype, scope_prefix, x):
    for name in names:
        with (contextlib.nullcontext() if scope_prefix is None
              else scope(scope_prefix + name)):
            x = getattr(net, name)(x, compute_dtype)
    return x


def compute_dtype_of(name) -> torch.dtype:
    """``'float32'`` / ``'bfloat16'`` -> the torch dtype; raises on any
    other name."""
    if str(name) not in COMPUTE_DTYPES:
        raise ValueError(
            f"compute_dtype {name!r}: the torch port runs "
            f"{tuple(COMPUTE_DTYPES)}"
        )
    return COMPUTE_DTYPES[str(name)]


def leaky_relu(x, leak: float = LEAK):
    """LeakyReLU, slope 0.1 (reference ``src/utils.py::LeakyReLU``).

    The slope is taken in ``x``'s dtype, as the JAX package's
    ``leak * x`` takes it: under bf16 that is bf16(0.1) = 0.10009765625.
    """
    return F.leaky_relu(x, _leak_in(leak, x.dtype))


@functools.lru_cache(maxsize=None)
def _leak_in(leak: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(leak, dtype=dtype))


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


def io_dtype(compute_dtype, act: bool, interconv: bool = False
             ) -> torch.dtype:
    """The dtype a layer computes in (``_conv_io_dtypes``): the compute
    dtype for a feature layer (``act``), or an interconv that follows it
    (``interconv``), under the bf16 policy; else f32.

    A bf16 conv returns bf16 (cuDNN accumulates in f32 inside), so each
    conv's output dtype equals its operands' and autograd's transposed
    convs stay single-dtype."""
    if compute_dtype is None or compute_dtype == torch.float32:
        return torch.float32
    if compute_dtype != torch.bfloat16:
        raise ValueError(
            f"compute_dtype {compute_dtype}: the torch port runs float32 "
            "or bfloat16"
        )
    return compute_dtype if act or interconv else torch.float32


def set_f32_features(module: nn.Module, mode: str = "highest"):
    """Set the feature precision of ``module``'s layers on the f32 path:
    ``"default"`` runs each feature layer (``act``, convs and deconvs) in
    TF32, ``"highest"`` in full f32. Returns ``module``.

    The JAX package's ``'default'`` lowers those convs at XLA's DEFAULT
    precision, which rounds the operands to bf16 (8 mantissa bits); TF32
    keeps 10, so the port's ``'default'`` is the closer of the two to the
    exact path. On the CPU there is no TF32: ``'default'`` is bitwise
    ``'highest'`` there. The flag covers each layer's forward only:
    autograd's backward convs run after the forward has returned, in
    ``f32_policy``'s full f32. It is process state, not a graph node, so
    a ``torch.export`` graph does not carry it (an artifact serves the
    exact features)."""
    if mode not in ("highest", "default"):
        raise ValueError(f"f32 features precision must be 'highest'|"
                         f"'default', got {mode!r}")
    tf32 = mode == "default"
    for layer in module.modules():
        if isinstance(layer, (Conv, Deconv)):
            layer.tf32 = tf32 and layer.act
    return module


def check_f32_master(layer, io: torch.dtype):
    """An f32-policy layer must hold f32 weights (``_check_f32_master``).
    bf16 weights there mean the module was pre-cast
    (:func:`cast_params_for_inference`, or a whole-module ``.bfloat16()``)
    and is now run under another policy; casting the quantized copy back
    to f32 would claim the exact path at bf16 weight precision."""
    if io == torch.float32 and layer.weights.dtype == torch.bfloat16:
        raise ValueError(
            f"{layer!r}: f32-policy layer holds bfloat16 weights; the "
            "module was pre-cast for another policy (or another "
            "bf16_interconv setting). Reload the f32 weights, and pre-cast "
            "with cast_params_for_inference only for bf16 inference"
        )


def _layer_forward(layer, x, compute_dtype, op, **kw):
    io = io_dtype(compute_dtype, layer.act, layer.interconv)
    check_f32_master(layer, io)
    args = (x.to(io), layer.weights.to(io), layer.biases.to(io))
    if layer.tf32 and io == torch.float32:
        # the feature layer's TF32 (set_f32_features), inside f32_policy,
        # whose deterministic algorithms stay on
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            y = op(*args, **kw)
        finally:
            torch.backends.cudnn.allow_tf32 = prev
    else:
        y = op(*args, **kw)
    return leaky_relu(y) if layer.act else y


class Conv(nn.Module):
    """Caffe-padded k x k conv, stride s, + optional LeakyReLU.

    ``weights``: (out, in, k, k); the JAX package stores HWIO.
    ``interconv``: an unactivated interconv that follows the compute dtype
    under the bf16 policy (the models' ``bf16_interconv``); its flow head
    stays f32. ``tf32``: see :func:`set_f32_features`.
    """

    tf32 = False

    def __init__(self, k: int, cin: int, cout: int, stride: int = 1,
                 act: bool = True, interconv: bool = False):
        super().__init__()
        self.weights = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.biases = nn.Parameter(torch.zeros(cout))
        self.stride = stride
        self.act = act
        self.interconv = interconv

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

    def extra_repr(self):
        o, i, k, _ = self.weights.shape
        return (f"{i}->{o}, k={k}, stride={self.stride}, act={self.act}"
                + (", interconv=True" if self.interconv else ""))

    def forward(self, x, compute_dtype=None):
        k = self.weights.shape[-1]
        return _layer_forward(self, x, compute_dtype, F.conv2d,
                              stride=self.stride, padding=(k - 1) // 2)


class Deconv(nn.Module):
    """4x4 stride-2 transposed conv, Caffe pad=1 (exact 2x upsample),
    + optional LeakyReLU.

    ``weights``: (in, out, 4, 4), the ``conv_transpose2d`` layout. The JAX
    package stores the kernel in forward-conv HWIO for an input-dilated
    conv with pad 2; that conv equals ``conv_transpose2d`` of the
    spatially flipped kernel with padding 1 (ROADMAP trap C2).
    """

    interconv = False  # no deconv is an interconv
    tf32 = False

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

    def extra_repr(self):
        i, o, k, _ = self.weights.shape
        return f"{i}->{o}, k={k}, act={self.act}"

    def forward(self, x, compute_dtype=None):
        if io_dtype(compute_dtype, True) == torch.float32:  # the f32 path
            return _layer_forward(self, x, compute_dtype, _DeconvF32.apply)
        return _layer_forward(self, x, compute_dtype, F.conv_transpose2d,
                              stride=2, padding=1)


class _DeconvF32(torch.autograd.Function):
    """The f32 path's deconv: forward :func:`deconv_subpixel`, backward
    the transposed conv's own (a strided conv for the input's gradient,
    and the weight gradient), so an f32 train step computes the
    transposed conv's gradients with cuDNN's algorithms for them
    (``tools/determinism_ab.py`` times the step both ways)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return deconv_subpixel(x, w, b)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        return torch.ops.aten.convolution_backward(
            grad.contiguous(), x, w, [w.shape[1]], [2, 2], [1, 1], [1, 1],
            True, [0, 0], 1, list(ctx.needs_input_grad))


def deconv_subpixel(x, w, b):
    """``conv_transpose2d(x, w, b, stride=2, padding=1)`` of a 4x4 kernel
    as one ``conv2d`` and an interleave: the f32 path's deconv.

    Output pixel (2p + a, 2q + b) of the transposed conv reads the 2x2
    input window at rows p - 1 + a, p + a (and columns alike) through 4
    of the 16 taps, so the four output parities are the four 2x2 kernels
    of the spatially flipped weight's even and odd taps: one conv2d with
    4 x Cout outputs over the input padded by 1, each parity's plane cut
    at its offset. The same multiply-adds as the transposed conv, summed
    in another order.

    Why: the f32 path runs cuDNN's deterministic algorithms
    (``f32_policy``), and those have no fast transposed conv in f32: on
    the H100 ``fuse_deconv0`` (162 -> 16 channels, 224x512 -> 448x1024)
    took 49.8 ms against 0.47 ms with the default, atomic ones
    (``tools/determinism_ab.py``, PERF.md). A forward conv's algorithms
    are deterministic and fast alike. Under the bf16 policy every deconv
    stays cuDNN's transposed conv: its bf16 ones lose nothing to the
    deterministic algorithms, and its f32 flow upsamplers (2 channels)
    take channels_last activations, which this form would turn into
    NCHW copies."""
    n, cin, h, wd = x.shape
    cout = w.shape[1]
    if tuple(w.shape[2:]) != (4, 4):
        raise ValueError(f"deconv_subpixel takes 4x4 kernels, got "
                         f"{tuple(w.shape)}")
    # flipped row 2r + a (r: window row, a: output parity), columns alike
    k = (w.flip((2, 3)).reshape(cin, cout, 2, 2, 2, 2)
         .permute(1, 3, 5, 0, 2, 4).reshape(cout * 4, cin, 2, 2))
    planes = F.conv2d(x, k, b.repeat_interleave(4), padding=1).view(
        n, cout, 2, 2, h + 1, wd + 1)
    out = planes.new_empty(n, cout, h, 2, wd, 2)
    for a in (0, 1):
        for c in (0, 1):
            out[:, :, :, a, :, c] = planes[:, :, a, c, a:a + h, c:c + wd]
    return out.view(n, cout, 2 * h, 2 * wd)


def cast_params_for_inference(module: nn.Module,
                              compute_dtype=torch.bfloat16) -> nn.Module:
    """Pre-cast, in place, the weights and biases of the layers that follow
    the compute dtype (feature layers, ``act``; interconvs built with
    ``interconv=True``) to the bf16 compute dtype, for serving: each
    forward then skips the f32 -> bf16 weight casts and reads half the
    weight bytes, with outputs bitwise equal (bf16(w) == bf16(bf16(w))).
    Flow heads, flow upsamplers and the other interconvs keep f32, the
    JAX package's ``_F32_LAYER_MARKERS`` (less ``"interconv"`` when its
    knob is on).

    Inference only: the trainer keeps f32 masters. ``to_jax_params`` (and
    so a checkpoint) still returns f32. Returns ``module``."""
    with torch.no_grad():
        for layer in module.modules():
            if (isinstance(layer, (Conv, Deconv))
                    and (layer.act or layer.interconv)):
                for p in (layer.weights, layer.biases):
                    p.data = p.data.to(compute_dtype)
    return module


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


def nchw(x, compute_dtype=None):
    """NHWC -> NCHW in the layout the compute dtype's convs run in.

    f32: a contiguous NCHW copy, on purpose: a bare permute would hand
    cuDNN channels_last tensors, every layer after would inherit that
    layout, and cuDNN's f32 conv kernels on Hopper work in NCHW and
    transpose around each call (PERF.md, Findings). bf16: the
    channels_last view (no copy of an NHWC-contiguous tensor), which the
    convs, concats and casts after it keep.
    """
    x = x.permute(0, 3, 1, 2)
    if _CHANNELS_LAST[io_dtype(compute_dtype, True)]:
        return x.contiguous(memory_format=torch.channels_last)
    return x.contiguous()


def nhwc(x):
    """NCHW -> NHWC view."""
    return x.permute(0, 2, 3, 1)
