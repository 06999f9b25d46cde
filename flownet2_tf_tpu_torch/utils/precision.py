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
