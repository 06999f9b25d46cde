"""One-shot TF1 checkpoint -> JAX-layout ``.npz`` converter, with no
TensorFlow.

Port of ``flownet2_tf_tpu/tools/convert_tf1_checkpoint.py``. The upstream
project ships slim checkpoints (``./checkpoints/FlowNet{S,C,CS,CSS,SD,2}/
flownet-X.ckpt-0``) with variables scoped like
``FlowNet2/FlowNetCSS/FlowNetCS/FlowNetC/conv1/weights``; the port's
parameter trees use those scope names, so conversion is a mechanical
re-layout:

* conv kernels: TF1 slim stores HWIO, copied as they are;
* deconv (conv2d_transpose) kernels: TF1 stores ``[H, W, out, in]`` and
  applies the spatially mirrored kernel; the JAX layout holds a forward
  input-dilated conv, so the kernel is mirrored and transposed to
  ``[H, W, in, out]``;
* Adam slots, ``global_step`` and other train-only bookkeeping: dropped
  (and never read from disk).

The checkpoint is read by ``tools/tf1_bundle.py`` instead of TensorFlow.
Coverage and shapes are checked against the port's own parameter shapes
(``training/warmstart.py::jax_param_shapes``), with the JAX converter's
error messages. The ``.npz`` it writes is what both packages load.
:func:`semantic_canary` then runs the converted weights on the bundled
sample pair on the caller's device.
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np

from flownet2_tf_tpu_torch.tools.tf1_bundle import load_checkpoint
from flownet2_tf_tpu_torch.training.warmstart import unflatten

# leaf layer-name prefixes that hold transposed-conv kernels
_DECONV_RE = re.compile(
    r"(^|/)(deconv\d|upsample_flow\d+to\d+|fuse_deconv\d|"
    r"fuse_upsample_flow\d+to\d+)$"
)

_SKIP_RE = re.compile(
    r"(Adam|Momentum|beta1_power|beta2_power|global_step|ExponentialMoving)"
)

_TOP_SCOPES = (
    "FlowNet2", "FlowNetCSS", "FlowNetCS", "FlowNetC", "FlowNetS",
    "FlowNetSD",
)


def _strip_top_scope(name: str) -> str:
    parts = name.split("/")
    if parts and parts[0] in _TOP_SCOPES:
        parts = parts[1:]
    return "/".join(parts)


def _param_path(name: str):
    """The JAX-layout key a TF variable converts to, or None if the
    converter drops it."""
    if _SKIP_RE.search(name):
        return None
    path = _strip_top_scope(name)
    if not path.endswith("/weights") and not path.endswith("/biases"):
        return None
    return path


def convert_variables(tf_vars: dict) -> dict:
    """{tf_variable_name: np.ndarray} -> flattened JAX-layout param dict."""
    out = {}
    for name, value in tf_vars.items():
        path = _param_path(name)
        if path is None:
            continue
        layer = path.rsplit("/", 1)[0]
        value = np.asarray(value)
        if path.endswith("/weights") and _DECONV_RE.search(layer):
            if value.ndim != 4:
                raise ValueError(f"{name}: deconv kernel must be 4D")
            # [H, W, out, in] mirrored -> [H, W, in, out]
            value = value[::-1, ::-1].transpose(0, 1, 3, 2).copy()
        out[path] = value
    return out


def read_tf_checkpoint(path: str) -> dict:
    """{variable name: np.ndarray} of every variable of the TF1
    checkpoint at ``path`` (a prefix, or a directory with a
    ``checkpoint`` file)."""
    reader = load_checkpoint(path)
    return {name: reader.get_tensor(name)
            for name in reader.get_variable_to_shape_map()}


def _kept_names(reader):
    """The variables :func:`convert_variables` keeps."""
    return [n for n in reader.get_variable_to_shape_map()
            if _param_path(n) is not None]


def expected_shapes(model_name: str) -> dict:
    """The flat JAX-layout key -> shape of ``model_name``'s parameters
    (the model built on the meta device: no memory, no data)."""
    from flownet2_tf_tpu_torch.models.registry import get_model
    from flownet2_tf_tpu_torch.training.warmstart import jax_param_shapes

    return jax_param_shapes(get_model(model_name).build("meta"))


def convert(tf_checkpoint_path: str, model_name: str, out_path: str) -> int:
    """Convert and validate against ``model_name``'s parameter shapes.

    Reads only the variables the conversion keeps. Returns the number of
    converted leaves; writes a .npz usable by ``training/warmstart.py``
    and ``training/infer.py`` (and the JAX package's loaders).
    """
    expected = expected_shapes(model_name)
    reader = load_checkpoint(tf_checkpoint_path)
    kept = _kept_names(reader)
    missing = sorted(set(expected) - {_param_path(n) for n in kept})
    if missing:
        raise ValueError(
            f"conversion incomplete: {len(missing)} missing leaves, e.g. "
            f"{missing[:5]}"
        )
    flat = convert_variables({n: reader.get_tensor(n) for n in kept})
    for k, shape in expected.items():
        if tuple(flat[k].shape) != tuple(shape):
            raise ValueError(
                f"shape mismatch at {k}: ckpt {flat[k].shape} vs model "
                f"{shape}"
            )
    extra = sorted(set(flat) - set(expected))
    if extra:
        # tolerated (e.g. train-only extras) but reported, on stderr so
        # that `cli convert` prints one JSON line
        print(f"note: {len(extra)} unmatched ckpt leaves dropped: "
              f"{extra[:5]}", file=sys.stderr)
    np.savez(out_path, **{k: flat[k] for k in expected})
    return len(expected)


def convert_tree(tf_checkpoint_path: str) -> dict:
    """Convert without model validation -> nested parameter tree."""
    reader = load_checkpoint(tf_checkpoint_path)
    return unflatten(convert_variables(
        {n: reader.get_tensor(n) for n in _kept_names(reader)}))


DEFAULT_SAMPLE_DIR = "data/samples"


def semantic_canary(params_path: str, model_name: str,
                    sample_dir: str = DEFAULT_SAMPLE_DIR, device="cuda",
                    warp_res: int = 1, **knobs) -> dict:
    """Run a converted checkpoint on the bundled sample pair on
    ``device`` (f32, ``training/infer.py::infer_flow``) and check that the
    flow is *semantically* sane, not just shape-compatible. ``warp_res``
    and ``knobs``: the knobs of ``infer.load_model`` the CLI was given.

    Name and shape validation would load a semantically mismatched
    checkpoint cleanly (e.g. a wrong fusion concat order) and predict
    garbage. The flow must be finite and its mean magnitude must land in
    the plausible band [1e-3, 200] px for the FlyingChairs sample pair
    (``data/samples/0img{0,1}.ppm``; its GT flow tops out around tens of
    px). When ``0flow.flo`` is there, the EPE against it is reported, not
    asserted: a partially trained checkpoint is still a valid conversion.

    Returns {"mean_mag": float, "max_mag": float, "epe_vs_sample_gt":
    float|None}. Raises ``ValueError`` when the canary fails.
    """
    from flownet2_tf_tpu_torch.training import infer
    from flownet2_tf_tpu_torch.training.warmstart import load_params_tree
    from flownet2_tf_tpu_torch.utils import flowlib
    from flownet2_tf_tpu_torch.utils.image_io import load_image_pair

    a_path = os.path.join(sample_dir, "0img0.ppm")
    b_path = os.path.join(sample_dir, "0img1.ppm")
    if not (os.path.exists(a_path) and os.path.exists(b_path)):
        raise FileNotFoundError(
            f"sample pair not found under {sample_dir!r}; pass "
            "--sample_dir or --no_canary"
        )
    params = load_params_tree(params_path)
    a, b = load_image_pair(a_path, b_path)
    flow = infer.infer_flow(model_name, params, a, b, device=device,
                            compute_dtype="float32", warp_res=warp_res,
                            **knobs)

    if not np.all(np.isfinite(flow)):
        raise ValueError(
            "semantic canary FAILED: converted model predicts non-finite "
            "flow on the sample pair — conversion is shape-compatible "
            "but semantically wrong"
        )
    mag = np.sqrt(np.sum(np.square(flow), axis=-1))
    mean_mag = float(mag.mean())
    max_mag = float(mag.max())
    # trained FlowNet checkpoints predict O(1..30) px mean magnitude on
    # the chairs sample; hundreds of px mean = garbage (e.g. scrambled
    # concat order or a missing *20 scale)
    if not (1e-3 <= mean_mag <= 200.0):
        raise ValueError(
            f"semantic canary FAILED: mean flow magnitude {mean_mag:.3g} "
            "px on the sample pair is outside the plausible band "
            "[1e-3, 200]"
        )
    result = {"mean_mag": mean_mag, "max_mag": max_mag,
              "epe_vs_sample_gt": None}
    gt_path = os.path.join(sample_dir, "0flow.flo")
    if os.path.exists(gt_path):
        gt = flowlib.read_flow(gt_path)
        if gt.shape == flow.shape:
            epe = float(
                np.mean(np.sqrt(np.sum(np.square(flow - gt), axis=-1)))
            )
            result["epe_vs_sample_gt"] = epe
    return result
