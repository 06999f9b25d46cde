"""Spatial tiling of inference: halo-overlapped bands along H.

Port of ``flownet2_tf_tpu/parallel/spatial.py``. The frame is cut into
``n_tiles`` horizontal bands of ``core`` rows (a multiple of 64), each
extended by ``overlap`` halo rows on both sides; each band runs through
the network and only its core rows are kept. Windows are interior-
clamped: a band at a frame edge shifts inward and fills its halo with
real image rows, so the tiled flow converges to the untiled one as the
overlap grows (n=2 at overlap H/4 is exact). Only the bottom pad to a
multiple of 64 is synthetic (edge rows).

The JAX package places one band per device of its mesh. The port runs
all N bands as one batch on one device: with one card per machine there
is no second device to place a band on, as on the JAX package's
one-device mesh. One band per card waits for a machine with several
cards (ROADMAP Queue 1 item 16).

``extract_tiles`` and ``stitch_tiles`` are pure row copies, traceable by
``torch.export`` (``tools/aot.py`` freezes them into a serving graph).
"""

from __future__ import annotations

import numpy as np
import torch

from flownet2_tf_tpu_torch.models.common import compute_dtype_of
from flownet2_tf_tpu_torch.training.infer import (
    inference_model,
    resolve_device,
)


def _tile_plan(height: int, n_tiles: int, overlap: int, multiple: int = 64):
    """-> (core, padded_h): uniform band height (multiple of 64) and the
    padded image height the bands tile exactly."""
    if overlap % 32 != 0:
        raise ValueError("overlap must be a multiple of 32")
    core = -(-height // n_tiles)
    core = -(-core // multiple) * multiple
    return core, core * n_tiles


def extract_tiles(image, n_tiles: int, overlap: int):
    """(1, H, W, C) -> (n_tiles, core + 2*overlap, W, C) with
    interior-clamped halo windows; returns (tiles, core, offsets, H).

    Band i's core rows are [i*core, (i+1)*core); its window is the core
    extended by ``overlap`` on both sides, then shifted inward so it stays
    inside the (bottom edge-padded) frame; a window taller than the
    padded frame is the whole frame. ``offsets[i]`` is the core's row
    offset inside band i's window (for :func:`stitch_tiles`)."""
    _, h, _, _ = image.shape
    core, padded_h = _tile_plan(h, n_tiles, overlap)
    tile_h = core + 2 * overlap
    if padded_h > h:
        rows = torch.arange(padded_h, device=image.device).clamp(max=h - 1)
        image = image[:, rows]
    if tile_h >= padded_h:
        starts = [0] * n_tiles
        tile_h = padded_h
    else:
        starts = [min(max(i * core - overlap, 0), padded_h - tile_h)
                  for i in range(n_tiles)]
    tiles = torch.stack([image[0, s:s + tile_h] for s in starts])
    offsets = [i * core - s for i, s in enumerate(starts)]
    return tiles, core, offsets, h


def stitch_tiles(tile_out, core: int, offsets, height: int):
    """(n_tiles, tile_h, W, C) -> (1, H, W, C), keeping band cores at
    their per-band ``offsets`` (from :func:`extract_tiles`)."""
    kept = torch.cat([tile_out[i, off:off + core]
                      for i, off in enumerate(offsets)])
    return kept[None, :height]


def forward_tiles(model, tiles_a, tiles_b, compute_dtype):
    """The (n_tiles, tile_h, W, 2) flow of a loaded model on the bands,
    run as one batch."""
    return model({"input_a": tiles_a, "input_b": tiles_b},
                 compute_dtype)["flow"]


def infer_flow_spatial(model_name, params, image_a, image_b, n_tiles=None,
                       overlap: int = 128, device="cuda",
                       compute_dtype="float32", warp_res=1, **knobs):
    """Tiled flow inference: the bands run as one batch on ``device``.

    ``image_a/b``: (H, W, 3) float arrays in [0, 1]; W must be %64 (pad
    with ``training.infer.pad_to_multiple`` first if needed). ``params``:
    a JAX-layout tree. ``n_tiles=None`` means one band per device, which
    is one here. ``knobs``: ``training/infer.py::load_model``'s other
    knobs. Returns the (H, W, 2) f32 flow as a numpy array.
    """
    if n_tiles is None:
        n_tiles = 1
    cd = compute_dtype_of(compute_dtype)
    device = resolve_device(device)
    a, b = (torch.as_tensor(np.asarray(x, np.float32), device=device)[None]
            for x in (image_a, image_b))
    if a.shape[2] % 64 != 0:
        # bands are cut along H; W passes through the six stride-2 stages
        # untiled
        raise ValueError(
            f"infer_flow_spatial requires W % 64 == 0, got W={a.shape[2]}; "
            "edge-pad with training.infer.pad_to_multiple and crop the "
            "flow back")
    model = inference_model(model_name, params, device, cd, warp_res,
                            **knobs)
    with torch.inference_mode():
        tiles_a, core, offsets, h = extract_tiles(a, n_tiles, overlap)
        tiles_b, _, _, _ = extract_tiles(b, n_tiles, overlap)
        flow_tiles = forward_tiles(model, tiles_a, tiles_b, cd)
        flow = stitch_tiles(flow_tiles, core, offsets, h)
    return flow[0].cpu().numpy()
