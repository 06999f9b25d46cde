"""flownet2_tf_tpu_torch — the PyTorch/CUDA port of ``flownet2_tf_tpu``.

The JAX package beside this one is the reference; every module here
mirrors its counterpart's path and name (``ops/correlation.py``,
``models/stacks.py``, ``training/infer.py`` ...), so a reader can hold
the two side by side. This package imports ``torch`` and never ``jax``.

What runs on the card: cuDNN for the convs and deconvs (forward and
backward), plain torch for the elementwise, gather, loss and optimizer
ops, and hand-written CUDA kernels for the FlowNetC correlation, forward
and backward (``csrc/correlation.cu``), built with ``nvcc`` at first use
(``ops/cuda/_build.py``). On the CPU every op takes its plain torch
version.

Public functions keep the JAX package's NHWC layout for images, flows and
cost volumes; the models run NCHW inside.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy, like the JAX package: importing the package loads no model code.
    if name in ("get_model", "MODEL_NAMES"):
        from flownet2_tf_tpu_torch.models import registry

        return getattr(registry, name)
    raise AttributeError(name)
