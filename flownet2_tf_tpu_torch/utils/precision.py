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
    """No TF32, and cuDNN's deterministic algorithms, under both policies.

    cuDNN runs f32 convolutions in TF32 by default (about three decimal
    digits), which the JAX package's ``Precision.HIGHEST`` f32 path never
    does (ROADMAP trap C4); the bf16 policy's f32 layers (flow heads,
    upsamplers, interconvs) need the same. cuDNN's default algorithms
    (the transposed convs', and some of the backward convs') sum with
    atomics, so two runs of one forward or train step would differ in
    the last bits, where the JAX reference repeats itself bit for bit.
    Inside this context cuDNN convs and matmuls run in full f32 and cuDNN
    picks only deterministic algorithms, whatever ``compute_dtype`` is
    (None, float32 or bfloat16: every forward, served call and train
    step enters it with its own); the previous settings come back on
    exit. The one exception is opt-in: a model built with
    ``f32_features='default'`` turns cuDNN's TF32 back on around each of
    its f32 feature layers' convs and restores it after
    (``models/common.py::set_f32_features``). The price on the H100 is measured by
    ``tools/determinism_ab.py`` (PERF.md). The f32 deconvs run as
    sub-pixel convs (``models/common.py::deconv_subpixel``): cuDNN's
    deterministic f32 transposed convs are slow.
    """
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = prev
