"""The f32 parity path's backend flags, apart from the model code.

``f32_policy`` lives here, not in ``models/common.py`` (which re-exports
it), because the serving loader (``tools/aot.py``) needs it and imports
no model module: the flags are process state, not graph nodes, so an
exported graph does not carry them.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def f32_policy(compute_dtype=None):
    """The f32 parity path: no TF32 and cuDNN's deterministic algorithms.

    cuDNN runs f32 convolutions in TF32 by default (about three decimal
    digits), which the JAX package's ``Precision.HIGHEST`` f32 path never
    does (ROADMAP trap C4). Its default transposed-conv (deconv)
    algorithms sum with atomics, so two runs of one forward differ in the
    last bits, where the JAX reference repeats itself bit for bit. Inside
    this context cuDNN convs and matmuls run in full f32 and, on the f32
    path (``compute_dtype`` None or float32), cuDNN picks only
    deterministic algorithms; the previous settings come back on exit.

    Every model forward, served call and train step enters it with its
    compute dtype. Under the bf16 policy (its f32 layers need the TF32
    flags too) the caller's ``cudnn.deterministic`` is left as it is: on
    the H100 the deterministic algorithms were not shown to cost bf16 b1
    at most 3% (``tools/determinism_ab.py``, PERF.md). The f32 deconvs
    run as sub-pixel convs (``models/common.py::deconv_subpixel``):
    cuDNN's deterministic f32 transposed convs are slow.
    """
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if compute_dtype is None or compute_dtype == torch.float32:
        torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = prev
