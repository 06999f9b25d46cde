"""Wrapper of the hand-written CUDA correlation kernel (``csrc/correlation.cu``).

Replaces the TPU kernel
``flownet2_tf_tpu/ops/pallas/correlation_kernel.py::_corr_row_kernel``
(and the XLA einsum form the JAX package runs in its place). Forward
only: the backward (da, db) is a training kernel still to port
(ROADMAP "Queue 2", correlation backward).

* A CPU tensor takes the plain version,
  ``ops/correlation.py::_correlation_oracle``.
* A CUDA tensor launches the kernel, or raises: there is no fallback.

The supported family is the JAX package's ``pallas_correlation_supported``
without its Mosaic tiling guards (W % 8, C % 128).
"""

from __future__ import annotations

import ctypes

import torch

# Launches of the CUDA kernel in this process, counted where the wrapper
# launches it and nowhere else.
LAUNCHES = 0

_DTYPES = (torch.float32, torch.bfloat16)
_fn = None


def supported(kernel_size, max_displacement, stride_1, stride_2, pad) -> bool:
    return (
        kernel_size == 1
        and stride_1 == 1
        and pad == max_displacement
        and stride_2 > 0
        and max_displacement % stride_2 == 0
    )


def _entry():
    global _fn
    if _fn is None:
        from flownet2_tf_tpu_torch.ops.cuda import _build

        fn = _build.load("correlation").flownet2_correlation_fwd
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def build():
    """Compile (if stale) and load the kernel library; no launch."""
    _entry()


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
        rc = _entry()(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), n, h, w, c,
            max_displacement, stride_2, int(a.dtype == torch.bfloat16),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"correlation kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


class _CorrelationFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, max_displacement, stride_2):
        return _launch(a, b, max_displacement, stride_2)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "the correlation backward kernel is not ported yet (ROADMAP "
            "'Queue 2': correlation backward, needed to train FlowNetC)"
        )


def correlation_cuda(a, b, max_displacement: int = 20, stride_2: int = 2):
    """FlowNetC cost volume, (N, H, W, D**2) f32, dy-major.

    ``a``, ``b``: NHWC, f32 or bf16. The configuration is the supported
    family with ``kernel_size=1, stride_1=1, pad=max_displacement``.
    """
    if not supported(1, max_displacement, 1, stride_2, max_displacement):
        raise ValueError(
            f"correlation kernel: max_displacement={max_displacement} is "
            f"not a multiple of stride_2={stride_2}"
        )
    if a.device.type == "cpu" and b.device.type == "cpu":
        from flownet2_tf_tpu_torch.ops.correlation import _correlation_oracle

        return _correlation_oracle(a, b, 1, max_displacement, 1, stride_2,
                                   max_displacement)
    return _CorrelationFn.apply(a, b, max_displacement, stride_2)
