"""Halo-overlapped bands along H: the row copies of spatial tiling.

Port of ``extract_tiles``/``stitch_tiles`` of
``flownet2_tf_tpu/parallel/spatial.py``, apart from the model code, so
that ``tools/aot.py::load_serving`` can cut and stitch the bands of a
spatial artifact without importing a model module. The frame is cut into
``n_tiles`` horizontal bands of ``core`` rows (a multiple of 64), each
extended by ``overlap`` halo rows on both sides. Windows are interior-
clamped: a band at a frame edge shifts inward and fills its halo with
real image rows. Only the bottom pad to a multiple of 64 is synthetic
(edge rows). Pure row copies, traceable by ``torch.export``.
"""

from __future__ import annotations

import torch


def _tile_plan(height: int, n_tiles: int, overlap: int, multiple: int = 64):
    """-> (core, padded_h): uniform band height (multiple of 64) and the
    padded image height the bands tile exactly."""
    if overlap % 32 != 0:
        raise ValueError("overlap must be a multiple of 32")
    core = -(-height // n_tiles)
    core = -(-core // multiple) * multiple
    return core, core * n_tiles


def band_height(height: int, n_tiles: int, overlap: int) -> int:
    """The rows of each band :func:`extract_tiles` cuts from a frame of
    ``height`` rows: the core and its two halos, at most the padded
    frame."""
    core, padded_h = _tile_plan(height, n_tiles, overlap)
    return min(core + 2 * overlap, padded_h)


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
    tile_h = band_height(h, n_tiles, overlap)
    if padded_h > h:
        rows = torch.arange(padded_h, device=image.device).clamp(max=h - 1)
        image = image[:, rows]
    if tile_h == padded_h:
        starts = [0] * n_tiles
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
