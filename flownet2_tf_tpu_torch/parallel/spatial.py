"""Spatial tiling of inference: halo-overlapped bands along H, spread over
devices.

Port of ``flownet2_tf_tpu/parallel/spatial.py``. The frame is cut into
``n_tiles`` horizontal bands (``parallel/tiles.py``: ``extract_tiles``,
``stitch_tiles``, the row copies, kept apart from the model code); each
band runs through the network and only its core rows are kept. The tiled
flow converges to the untiled one as the overlap grows (n=2 at overlap
H/4 is exact).

The bands are spread over a list of devices as the JAX package spreads
them over its mesh: ``mesh_for_batch(n_tiles, len(devices))`` devices
take the bands in contiguous groups, each device its own copy of the
model. One device (the default on a machine with one card) runs all the
bands as one batch. Several entries of the list may name one device.
"""

from __future__ import annotations

import numpy as np
import torch

from flownet2_tf_tpu_torch.models.common import compute_dtype_of
from flownet2_tf_tpu_torch.parallel.mesh import (
    mesh_for_batch,
    scatter_gather,
    serving_devices,
    visible_devices,
)
from flownet2_tf_tpu_torch.parallel.tiles import (  # noqa: F401
    _tile_plan,
    band_height,
    extract_tiles,
    stitch_tiles,
)
from flownet2_tf_tpu_torch.training.infer import (
    inference_model,
    resolve_device,
)


def forward_tiles(model, tiles_a, tiles_b, compute_dtype):
    """The (n_tiles, tile_h, W, 2) flow of a loaded model on the bands,
    run as one batch."""
    return model({"input_a": tiles_a, "input_b": tiles_b},
                 compute_dtype)["flow"]


def band_devices(n_tiles, device="cuda", devices=None) -> list:
    """The devices the ``n_tiles`` bands run on, one group of contiguous
    bands each: the first ``mesh_for_batch(n_tiles, len(devices))`` of
    ``devices`` (their platform's; several entries may name one device),
    all of them when ``n_tiles`` is None. ``devices=None`` means every
    visible device of ``device``'s platform, or ``device`` alone when it
    names an index."""
    if devices is None:
        device = resolve_device(device)
        devices = ([device] if device.index is not None
                   else visible_devices(device.type))
    platform = resolve_device(torch.device(devices[0]).type).type
    devices = serving_devices(platform, len(devices), devices,
                              kind="spatial_tiles")
    if n_tiles is None:
        return devices
    return devices[:mesh_for_batch(n_tiles, len(devices))]


def infer_flow_spatial(model_name, params, image_a, image_b, n_tiles=None,
                       overlap: int = 128, device="cuda",
                       compute_dtype="float32", warp_res=1, devices=None,
                       **knobs):
    """Tiled flow inference: the bands spread over devices in groups.

    ``image_a/b``: (H, W, 3) float arrays in [0, 1]; W must be %64 (pad
    with ``training.infer.pad_to_multiple`` first if needed). ``params``:
    a JAX-layout tree. ``devices``: the device list (:func:`band_devices`;
    default every visible device of ``device``'s platform); ``n_tiles=None``
    means one band per device. ``knobs``: ``training/infer.py::load_model``'s
    other knobs. Returns the (H, W, 2) f32 flow as a numpy array.
    """
    devices = band_devices(n_tiles, device, devices)
    if n_tiles is None:
        n_tiles = len(devices)
    cd = compute_dtype_of(compute_dtype)
    a, b = (torch.as_tensor(np.asarray(x, np.float32),
                            device=devices[0])[None]
            for x in (image_a, image_b))
    if a.shape[2] % 64 != 0:
        # bands are cut along H; W passes through the six stride-2 stages
        # untiled
        raise ValueError(
            f"infer_flow_spatial requires W % 64 == 0, got W={a.shape[2]}; "
            "edge-pad with training.infer.pad_to_multiple and crop the "
            "flow back")
    # one model copy per device, shared by the entries that repeat it
    models = {}
    for d in devices:
        if d not in models:
            models[d] = inference_model(model_name, params, d, cd, warp_res,
                                        **knobs)
    with torch.inference_mode():
        tiles_a, core, offsets, h = extract_tiles(a, n_tiles, overlap)
        tiles_b, _, _, _ = extract_tiles(b, n_tiles, overlap)
        fns = [lambda ta, tb, m=models[d]: forward_tiles(m, ta, tb, cd)
               for d in devices]
        flow_tiles = scatter_gather(fns, devices, (tiles_a, tiles_b),
                                    devices[0])
        flow = stitch_tiles(flow_tiles, core, offsets, h)
    return flow[0].cpu().numpy()
