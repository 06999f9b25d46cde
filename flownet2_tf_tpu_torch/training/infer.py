"""Inference runtime: single-pair flow and dataset evaluation.

Port of ``flownet2_tf_tpu/training/infer.py``. Arbitrary input sizes are
edge-padded up to the next multiple of 64 and the flow is cropped back.
Inference runs under ``torch.inference_mode()`` at the compute dtype
asked for: ``float32`` (TF32 off, ``models/common.py::f32_policy``) or
``bfloat16`` (the bf16 policy, with the feature layers' weights pre-cast
once after loading, ``models/common.py::cast_params_for_inference``).
The device is explicit: asking for CUDA where there is none raises;
nothing falls back to the CPU.

``evaluate_dataset`` scores a dataset by the mean of per-pair AEEs: pairs
are padded to %64 shape buckets (KITTI's mask ANDed with the padding's),
batched within a bucket, and the masked AEE is reduced on the device, so
only per-pair sums and counts cross to the host.
"""

from __future__ import annotations

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
from flownet2_tf_tpu_torch.utils.flowlib import write_flow_outputs
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


def load_model(model_name, params, device="cuda", warp_res=1, fusion_res=1,
               bf16_interconv=False, f32_features="highest"):
    """Build ``model_name`` on ``device`` with its knobs and fill it from a
    JAX-layout tree; returns the module in eval mode. ``warp_res``: the
    stack warps' grid (1 exact, 2 half, 4 quarter); ``fusion_res``:
    FlowNet2's fusion grid (1 exact, 2 half); ``bf16_interconv``: the
    interconvs follow the bf16 compute dtype; ``f32_features``:
    ``"highest"`` or ``"default"`` (TF32 feature layers on the f32 path).
    A model ignores the knobs it does not read (``ModelSpec.build_for``)."""
    device = resolve_device(device)
    model = get_model(model_name).build_for(
        device, warp_res=warp_res, fusion_res=fusion_res,
        bf16_interconv=bf16_interconv, f32_features=f32_features)
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


def inference_model(model_name, params, device, compute_dtype, warp_res=1,
                    **knobs):
    """``load_model`` (``knobs``: its other knobs), with the layers that
    follow the compute dtype pre-cast once when ``compute_dtype`` (a torch
    dtype) is bfloat16."""
    model = load_model(model_name, params, device, warp_res, **knobs)
    if compute_dtype == torch.bfloat16:
        cast_params_for_inference(model, compute_dtype)
    return model


def infer_flow(model_name, params, image_a, image_b, device="cuda",
               compute_dtype="float32", warp_res=1, fusion_res=1,
               bf16_interconv=False, f32_features="highest"):
    """Run a model on a single pair or batch; returns full-res flow.

    ``image_a/b``: (H, W, 3) or (N, H, W, 3) float arrays in [0, 1].
    ``params``: a JAX-layout tree. ``compute_dtype``: 'float32' or
    'bfloat16'. ``warp_res``, ``fusion_res``, ``bf16_interconv``,
    ``f32_features``: the knobs of :func:`load_model` (``cli --warp_res``,
    ``--fusion_res``, ``FLOWNET2_TPU_BF16_INTERCONV``,
    ``--f32_features``). Returns a numpy f32 array.
    """
    cd = compute_dtype_of(compute_dtype)
    device = resolve_device(device)
    model = inference_model(model_name, params, device, cd, warp_res,
                            fusion_res=fusion_res,
                            bf16_interconv=bf16_interconv,
                            f32_features=f32_features)
    a = torch.as_tensor(np.asarray(image_a, np.float32), device=device)
    b = torch.as_tensor(np.asarray(image_b, np.float32), device=device)
    squeeze = a.ndim == 3
    if squeeze:
        a, b = a[None], b[None]
    flow = forward_flow(model, a, b, cd).cpu().numpy()
    return flow[0] if squeeze else flow


def test_pair(model_name, checkpoint, input_a_path, input_b_path, out_dir,
              save_image=True, save_flo=True, compute_dtype="float32",
              device="cuda", warp_res=1, spatial_tiles=0,
              spatial_overlap=128, **knobs):
    """Pair of image files -> .png / .flo outputs; returns the predicted
    (H, W, 2) flow. ``knobs``: :func:`load_model`'s other knobs.

    ``spatial_tiles`` > 1 runs halo-banded tiled inference
    (``parallel/spatial.py``, the bands spread over the visible devices of
    ``device``'s platform, one batch on one device): the pair is
    edge-padded to %64 on the host and the flow cropped back."""
    compute_dtype_of(compute_dtype)
    device = resolve_device(device)
    params = load_params_tree(checkpoint)
    a, b = load_image_pair(input_a_path, input_b_path)
    if spatial_tiles and int(spatial_tiles) > 1:
        from flownet2_tf_tpu_torch.parallel.spatial import infer_flow_spatial

        h, w = a.shape[:2]
        pad = ((0, (-h) % 64), (0, (-w) % 64), (0, 0))
        flow = infer_flow_spatial(
            model_name, params, np.pad(np.asarray(a, np.float32), pad,
                                       mode="edge"),
            np.pad(np.asarray(b, np.float32), pad, mode="edge"),
            n_tiles=int(spatial_tiles), overlap=int(spatial_overlap),
            device=device, compute_dtype=compute_dtype,
            warp_res=warp_res, **knobs)[:h, :w]
    else:
        flow = infer_flow(model_name, params, a, b, device=device,
                          compute_dtype=compute_dtype, warp_res=warp_res,
                          **knobs)
    write_flow_outputs(flow, out_dir, input_a_path,
                       save_flo=save_flo, save_image=save_image)
    return flow


def _aee_on_device(model, batch, compute_dtype):
    """Forward and masked AEE on the device; returns a (2, N) tensor of
    per-pair EPE sums and valid-pixel counts, the only values that cross
    to the host.

    ``batch``: device tensors already padded to a %64 bucket, with a
    ``valid`` mask that is 0 in the padding. The EPE is the JAX package's
    ``sqrt(sum d^2 + 1e-12)`` over the padded grid.
    """
    with torch.inference_mode():
        preds = model({"input_a": batch["input_a"],
                       "input_b": batch["input_b"]}, compute_dtype)
        epe = torch.sqrt(
            torch.sum(torch.square(preds["flow"] - batch["flow"]), dim=-1)
            + 1e-12)
        valid = batch["valid"]
        # per-pair sums: the metric is the mean of per-pair AEEs, so pairs
        # stay separable when batched
        return torch.stack([torch.sum(epe * valid, dim=(1, 2)),
                            torch.sum(valid, dim=(1, 2))])


def _bucket_batch(item, multiple=64):
    """Pad one {image_a, image_b, flow} item to the next %``multiple``
    bucket: images edge-padded, GT zero-padded, validity mask 0 in the
    padding (and ANDed with the KITTI mask when present). Returns numpy
    arrays with a batch axis of 1."""
    a = np.asarray(item["image_a"], np.float32)
    b = np.asarray(item["image_b"], np.float32)
    gt = np.asarray(item["flow"], np.float32)
    h, w = a.shape[:2]
    ph = (-h) % multiple
    pw = (-w) % multiple
    if gt.shape[-1] == 3:  # KITTI: [u, v, valid]
        valid = gt[..., 2]
        gt = gt[..., :2]
    else:
        valid = np.ones((h, w), np.float32)
    if ph or pw:
        pad_img = ((0, ph), (0, pw), (0, 0))
        a = np.pad(a, pad_img, mode="edge")
        b = np.pad(b, pad_img, mode="edge")
        gt = np.pad(gt, pad_img)
        valid = np.pad(valid, ((0, ph), (0, pw)))
    return {"input_a": a[None], "input_b": b[None], "flow": gt[None],
            "valid": valid[None]}


def evaluate_dataset(model_name, params, dataset, compute_dtype="float32",
                     limit=None, verbose=False, batch_size=1, device="cuda",
                     warp_res=1, fusion_res=1, bf16_interconv=False,
                     f32_features="highest"):
    """Average endpoint error over a dataset of {image_a, image_b, flow}:
    the mean of per-pair AEEs.

    Honors KITTI validity masks ((H, W, 3) ground truth); a pair with no
    valid pixel counts as AEE 0. Pairs are decoded one after another on
    the host and padded to %64 shape buckets; ``batch_size`` > 1 batches
    pairs within a bucket, and tail batches run at their true size.
    ``params``: a JAX-layout tree; bf16 pre-casts the weights once. The
    knobs: :func:`load_model`'s.
    """
    cd = compute_dtype_of(compute_dtype)
    device = resolve_device(device)
    n = len(dataset) if limit is None else min(limit, len(dataset))
    model = inference_model(model_name, params, device, cd, warp_res,
                            fusion_res=fusion_res,
                            bf16_interconv=bf16_interconv,
                            f32_features=f32_features)
    batch_size = max(1, int(batch_size))
    aee_sum = 0.0
    seen = 0

    def flush(items):
        nonlocal aee_sum, seen
        batch = {key: torch.from_numpy(
                     np.concatenate([it[key] for it in items])).to(device)
                 for key in items[0]}
        totals, counts = _aee_on_device(model, batch, cd).cpu().numpy()
        for t, c in zip(totals, counts):
            seen += 1
            aee = float(t) / max(float(c), 1.0)
            aee_sum += aee
            if verbose:
                print(f"  [{seen}/{n}] AEE {aee:.4f}")

    pending = {}  # bucket shape -> padded single-pair batches
    for i in range(n):
        item = _bucket_batch(dataset[i])
        key = item["input_a"].shape[1:3]
        pending.setdefault(key, []).append(item)
        if len(pending[key]) == batch_size:
            flush(pending.pop(key))
    for items in pending.values():
        flush(items)
    return aee_sum / max(n, 1)
