"""Inference runtime: single-pair flow.

Port of the single-pair half of ``flownet2_tf_tpu/training/infer.py``.
Arbitrary input sizes are edge-padded up to the next multiple of 64 and
the flow is cropped back. Inference runs under ``torch.inference_mode()``
at the compute dtype asked for: ``float32`` (TF32 off,
``models/common.py::f32_policy``) or ``bfloat16`` (the bf16 policy, with
the feature layers' weights pre-cast once after loading,
``models/common.py::cast_params_for_inference``). The device is explicit:
asking for CUDA where there is none raises; nothing falls back to the
CPU. Dataset evaluation (``evaluate_dataset``) is not ported yet.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from flownet2_tf_tpu_torch.models.common import (
    COMPUTE_DTYPES as _DTYPES,
    cast_params_for_inference,
    compute_dtype_of,
)
from flownet2_tf_tpu_torch.models.registry import get_model
from flownet2_tf_tpu_torch.training.warmstart import (
    load_jax_params,
    load_params_tree,
)
from flownet2_tf_tpu_torch.utils import flowlib
from flownet2_tf_tpu_torch.utils.image_io import load_image_pair

COMPUTE_DTYPES = tuple(_DTYPES)  # ("float32", "bfloat16")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it is CUDA and no CUDA
    device is available."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False; pass --device cpu to run the plain CPU path"
        )
    return device


def load_model(model_name, params, device="cuda"):
    """Build ``model_name`` on ``device`` and fill it from a JAX-layout
    tree; returns the module in eval mode."""
    device = resolve_device(device)
    model = get_model(model_name).build(device)
    return load_jax_params(model, params)


def pad_to_multiple(x, multiple=64):
    """Edge-pad NHWC bottom/right to the next multiple; returns (x, h, w)."""
    n, h, w, c = x.shape
    ph = (-h) % multiple
    pw = (-w) % multiple
    if ph == 0 and pw == 0:
        return x, h, w
    rows = torch.arange(h + ph, device=x.device).clamp_(max=h - 1)
    cols = torch.arange(w + pw, device=x.device).clamp_(max=w - 1)
    return x.index_select(1, rows).index_select(2, cols), h, w


def forward_flow(model, image_a, image_b, compute_dtype=None):
    """Run a loaded model on NHWC float tensors of any size; returns the
    full-res (N, H, W, 2) f32 flow tensor, cropped back from the %64 pad.
    ``compute_dtype``: None or a torch dtype, as the model's forward."""
    with torch.inference_mode():
        a, h, w = pad_to_multiple(image_a)
        b, _, _ = pad_to_multiple(image_b)
        preds = model({"input_a": a, "input_b": b}, compute_dtype)
        return preds["flow"][:, :h, :w, :]


def infer_flow(model_name, params, image_a, image_b, device="cuda",
               compute_dtype="float32"):
    """Run a model on a single pair or batch; returns full-res flow.

    ``image_a/b``: (H, W, 3) or (N, H, W, 3) float arrays in [0, 1].
    ``params``: a JAX-layout tree. ``compute_dtype``: 'float32' or
    'bfloat16'. Returns a numpy f32 array.
    """
    cd = compute_dtype_of(compute_dtype)
    device = resolve_device(device)
    model = load_model(model_name, params, device)
    if cd == torch.bfloat16:
        cast_params_for_inference(model, cd)
    a = torch.as_tensor(np.asarray(image_a, np.float32), device=device)
    b = torch.as_tensor(np.asarray(image_b, np.float32), device=device)
    squeeze = a.ndim == 3
    if squeeze:
        a, b = a[None], b[None]
    flow = forward_flow(model, a, b, cd).cpu().numpy()
    return flow[0] if squeeze else flow


def test_pair(model_name, checkpoint, input_a_path, input_b_path, out_dir,
              save_image=True, save_flo=True, compute_dtype="float32",
              device="cuda"):
    """Pair of image files -> .png / .flo outputs; returns the predicted
    (H, W, 2) flow."""
    compute_dtype_of(compute_dtype)
    device = resolve_device(device)
    params = load_params_tree(checkpoint)
    a, b = load_image_pair(input_a_path, input_b_path)
    flow = infer_flow(model_name, params, a, b, device=device,
                      compute_dtype=compute_dtype)
    write_flow_outputs(flow, out_dir, input_a_path,
                       save_flo=save_flo, save_image=save_image)
    return flow


def write_flow_outputs(flow, out_dir, input_a_path, save_flo=True,
                       save_image=True):
    """Output convention: <out>/<stem(input_a)>_flow.{flo,png}; returns
    the stem."""
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.join(
        os.fspath(out_dir),
        os.path.splitext(os.path.basename(os.fspath(input_a_path)))[0]
        + "_flow",
    )
    if save_flo:
        flowlib.write_flow(flow, stem + ".flo")
    if save_image:
        flowlib.write_flow_png(flow, stem + ".png")
    return stem
