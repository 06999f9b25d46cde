"""Wrapper of the hand-written CUDA correlation kernel (``csrc/correlation.cu``).

Replaces the TPU kernel
``flownet2_tf_tpu/ops/pallas/correlation_kernel.py::correlation_pallas``:
its forward ``_corr_row_kernel`` (and the XLA einsum form the JAX package
runs in its place) and its ``custom_vjp`` backward ``_bwd``, which
differentiates the jnp oracle.

Both directions are registered torch ops (``torch.library.custom_op``),
so that ``torch.export`` can trace a model that holds them
(``tools/aot.py``): a ``ctypes`` launch needs data pointers, which the
fake tensors of a trace do not have.

* ``flownet2::correlation`` (:func:`correlation_op`): ``(a, b,
  max_displacement, stride_2)`` -> the (N, H, W, D**2) f32 cost volume.
* ``flownet2::correlation_backward`` (:func:`correlation_backward_op`):
  ``(g, a, b, max_displacement, stride_2)`` -> ``(da, db)`` in the input
  dtype, like ``_bwd``. ``da`` comes from ``b`` and the f32 cost-volume
  gradient ``g``, ``db`` from ``a`` and the mirror-shifted gradient
  ``g'`` (plain version: ``ops/correlation.py::_mirror_shift_grad``),
  which its kernel stages straight from ``g``. Both kernels run one body
  (plain version: ``_correlation_da_form``).

Each op has a fake kernel (shapes and dtypes only), a CUDA kernel and a
CPU kernel; ``register_autograd`` makes the backward op the forward's
gradient. The CUDA kernels launch ``correlation_fwd_f32_kernel`` (exact
FFMA) or ``correlation_fwd_bf16_kernel`` (``mma.sync`` on tensor cores)
by the features' dtype, and the da/db kernels, on the current stream;
the launch counts are taken there and only there.

* A CPU tensor takes the plain versions: ``_correlation_oracle`` forward,
  ``_correlation_da_form`` with ``_mirror_shift_grad`` backward.
* A CUDA tensor launches the kernels, or raises: there is no fallback.

The supported family is the JAX package's ``pallas_correlation_supported``
without its Mosaic tiling guards (W % 8, C % 128).
"""

from __future__ import annotations

import ctypes

import torch
import torch.utils.flop_counter

# Launches of the forward and of the backward CUDA kernels in this
# process, counted where the wrapper launches them and nowhere else (one
# backward launch runs the da and the db kernel); the same launches again
# by the dtype of the features they took.
LAUNCHES = 0
BWD_LAUNCHES = 0
LAUNCHES_BY_DTYPE = {"float32": 0, "bfloat16": 0}
BWD_LAUNCHES_BY_DTYPE = {"float32": 0, "bfloat16": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_fns: dict = {}


def reset_launch_counts():
    """Set every launch count to 0."""
    global LAUNCHES, BWD_LAUNCHES
    LAUNCHES = BWD_LAUNCHES = 0
    for counts in (LAUNCHES_BY_DTYPE, BWD_LAUNCHES_BY_DTYPE):
        for k in counts:
            counts[k] = 0


def _dtype_name(t):
    return str(t.dtype).split(".")[-1]


def supported(kernel_size, max_displacement, stride_1, stride_2, pad) -> bool:
    return (
        kernel_size == 1
        and stride_1 == 1
        and pad == max_displacement
        and stride_2 > 0
        and max_displacement % stride_2 == 0
    )


# entry point -> number of pointer arguments before the 7 ints and stream
_SIGNATURES = {"flownet2_correlation_fwd": 3, "flownet2_correlation_bwd": 5}


def _entry(name):
    fn = _fns.get(name)
    if fn is None:
        from flownet2_tf_tpu_torch.ops.cuda import _build

        fn = getattr(_build.load("correlation"), name)
        fn.argtypes = ([ctypes.c_void_p] * _SIGNATURES[name]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def build():
    """Compile (if stale) and load the kernel library; no launch."""
    for name in _SIGNATURES:
        _entry(name)


def _check(a, b):
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(
            f"correlation kernel needs both inputs on one CUDA device, got "
            f"{a.device} / {b.device}"
        )
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(
            f"correlation kernel takes float32 or bfloat16 inputs of one "
            f"dtype, got {a.dtype} / {b.dtype}"
        )
    if a.ndim != 4 or a.shape != b.shape:
        raise ValueError(
            f"correlation kernel expects matching NHWC inputs, got "
            f"{tuple(a.shape)} vs {tuple(b.shape)}"
        )
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("correlation kernel expects NHWC-contiguous inputs")
    if max(a.shape) >= 2**31 or a.numel() >= 2**62:
        raise ValueError(f"correlation kernel: shape {tuple(a.shape)} too large")


def _launch(a, b, max_displacement, stride_2):
    global LAUNCHES
    _check(a, b)
    n, h, w, c = a.shape
    r = max_displacement // stride_2
    d = 2 * r + 1
    out = torch.empty((n, h, w, d * d), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry("flownet2_correlation_fwd")(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), n, h, w, c,
            max_displacement, stride_2, int(a.dtype == torch.bfloat16),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"correlation kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    LAUNCHES_BY_DTYPE[_dtype_name(a)] += 1
    return out


def correlation_cuda_backward(grad, a, b, max_displacement, stride_2):
    """Launch the backward kernels: (da, db) for the cost volume's
    gradient ``grad`` (N, H, W, D**2), in the dtype of ``a`` and ``b``."""
    global BWD_LAUNCHES
    _check(a, b)
    n, h, w, c = a.shape
    r = max_displacement // stride_2
    d = 2 * r + 1
    if grad.device != a.device or tuple(grad.shape) != (n, h, w, d * d):
        raise ValueError(
            f"correlation backward: gradient {tuple(grad.shape)} on "
            f"{grad.device}, expected {(n, h, w, d * d)} on {a.device}"
        )
    # the f32 gradient, like _bwd's g.astype(float32); contiguous NHWC
    g = grad.to(torch.float32).contiguous()
    da = torch.empty_like(a)
    db = torch.empty_like(b)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry("flownet2_correlation_bwd")(
            g.data_ptr(), a.data_ptr(), b.data_ptr(), da.data_ptr(),
            db.data_ptr(), n, h, w, c, max_displacement, stride_2,
            int(a.dtype == torch.bfloat16), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"correlation backward kernel launch failed: CUDA error {rc}")
    BWD_LAUNCHES += 1
    BWD_LAUNCHES_BY_DTYPE[_dtype_name(a)] += 1
    return da, db


# The registered ops. ``torch.export`` traces them as single graph nodes
# (``flownet2::correlation``, ``flownet2::correlation_backward``) through
# their fake kernels, which give shapes and dtypes and touch no data; the
# graph then calls the device's kernel at run time.


@torch.library.custom_op("flownet2::correlation", mutates_args=(),
                         device_types="cpu")
def correlation_op(a: torch.Tensor, b: torch.Tensor, max_displacement: int,
                   stride_2: int) -> torch.Tensor:
    """The cost volume, (N, H, W, D**2) f32. CPU kernel: the plain
    version, ``ops/correlation.py::_correlation_oracle``."""
    from flownet2_tf_tpu_torch.ops.correlation import _correlation_oracle

    return _correlation_oracle(a, b, 1, max_displacement, 1, stride_2,
                               max_displacement)


@correlation_op.register_kernel("cuda")
def _correlation_op_cuda(a, b, max_displacement, stride_2):
    return _launch(a, b, max_displacement, stride_2)


@correlation_op.register_fake
def _correlation_op_fake(a, b, max_displacement, stride_2):
    n, h, w, _ = a.shape
    d = 2 * (max_displacement // stride_2) + 1
    return a.new_empty((n, h, w, d * d), dtype=torch.float32)


@torch.library.custom_op("flownet2::correlation_backward", mutates_args=(),
                         device_types="cpu")
def correlation_backward_op(
    grad: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
    max_displacement: int, stride_2: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(da, db) in the dtype of ``a`` and ``b`` for the cost volume's
    gradient ``grad``. CPU kernel: the plain versions of the backward
    kernels, ``_correlation_da_form`` on (g, b) for da and on the
    mirror-shifted gradient and ``a`` for db (``ops/correlation.py``)."""
    from flownet2_tf_tpu_torch.ops.correlation import (
        _correlation_da_form,
        _mirror_shift_grad,
    )

    r = max_displacement // stride_2
    g = grad.to(torch.float32)
    da = _correlation_da_form(g, b, r, stride_2)
    db = _correlation_da_form(_mirror_shift_grad(g, r, stride_2), a, r,
                              stride_2)
    return da.to(a.dtype), db.to(b.dtype)


@correlation_backward_op.register_kernel("cuda")
def _correlation_backward_op_cuda(grad, a, b, max_displacement, stride_2):
    return correlation_cuda_backward(grad, a, b, max_displacement, stride_2)


@correlation_backward_op.register_fake
def _correlation_backward_op_fake(grad, a, b, max_displacement, stride_2):
    return a.new_empty(a.shape), b.new_empty(b.shape)


def _setup_context(ctx, inputs, output):
    a, b, max_displacement, stride_2 = inputs
    ctx.save_for_backward(a, b)
    ctx.max_displacement = max_displacement
    ctx.stride_2 = stride_2


def _backward(ctx, grad):
    a, b = ctx.saved_tensors
    da, db = correlation_backward_op(grad, a, b, ctx.max_displacement,
                                     ctx.stride_2)
    return da, db, None, None


correlation_op.register_autograd(_backward, setup_context=_setup_context)


def correlation_flops(a_shape, b_shape, max_displacement, stride_2, *args,
                      out_shape=None, **kwargs) -> int:
    """``torch.utils.flop_counter`` formula of ``flownet2::correlation``:
    2 N H W D**2 C, every displacement counted (in frame or not)."""
    n, h, w, c = a_shape
    d = 2 * (max_displacement // stride_2) + 1
    return 2 * n * h * w * d * d * c


torch.utils.flop_counter.register_flop_formula(
    torch.ops.flownet2.correlation)(correlation_flops)


def correlation_cuda(a, b, max_displacement: int = 20, stride_2: int = 2):
    """FlowNetC cost volume, (N, H, W, D**2) f32, dy-major, through the
    ``flownet2::correlation`` op (differentiable by its registered
    backward).

    ``a``, ``b``: NHWC, f32 or bf16. The configuration is the supported
    family with ``kernel_size=1, stride_1=1, pad=max_displacement``.
    """
    if not supported(1, max_displacement, 1, stride_2, max_displacement):
        raise ValueError(
            f"correlation kernel: max_displacement={max_displacement} is "
            f"not a multiple of stride_2={stride_2}"
        )
    return correlation_op(a, b, max_displacement, stride_2)
