"""Optical-flow IO, color rendering and evaluation (host-side, NumPy).

Copy of ``flownet2_tf_tpu/utils/flowlib.py``; importing the original
pulls in JAX.

* Middlebury ``.flo``: magic float ``202021.25``, int32 width, int32
  height, then H x W x 2 little-endian float32 (u, v).
* KITTI 16-bit PNG flow: ``(uint16 - 2**15) / 64``, valid mask in the
  3rd channel (``utils/png16.py``).
* PFM flow (FlyingThings3D): 3-channel ``PF``, rows bottom to top, the
  scale's sign giving the endianness.
* ``flow_to_image``: 55-color Middlebury color wheel, per-image
  max-magnitude normalization, ``UNKNOWN_FLOW_THRESH = 1e7``.
* ``flow_error`` / ``evaluate_flow``: average endpoint error over valid
  pixels.
"""

from __future__ import annotations

import functools
import os

import numpy as np

TAG_FLOAT = 202021.25  # .flo magic number ("PIEH" as float)
UNKNOWN_FLOW_THRESH = 1e7


def read_flow(filename):
    """Read a flow file: Middlebury ``.flo`` -> (H, W, 2) float32; ``.pfm``
    -> (H, W, 2); KITTI ``.png`` -> (H, W, 3) [u, v, valid]."""
    filename = os.fspath(filename)
    if filename.endswith(".pfm"):
        return read_pfm_flow(filename)
    if filename.endswith(".png"):
        return read_kitti_png_flow(filename)
    with open(filename, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != np.float32(TAG_FLOAT):
            raise ValueError(
                f"{filename}: invalid .flo magic {magic!r} "
                f"(expected {TAG_FLOAT})"
            )
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        if w <= 0 or h <= 0 or w > 100000 or h > 100000:
            raise ValueError(f"{filename}: implausible size {w}x{h}")
        data = np.fromfile(f, np.float32, count=2 * w * h)
        if data.size != 2 * w * h:
            raise ValueError(
                f"{filename}: truncated payload ({data.size} of {2 * w * h})"
            )
    return data.reshape(h, w, 2)


def write_flow(flow, filename):
    """Write an (H, W, 2) flow field to a Middlebury ``.flo`` file."""
    flow = np.asarray(flow, dtype=np.float32)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow.shape}")
    h, w = flow.shape[:2]
    with open(os.fspath(filename), "wb") as f:
        np.float32(TAG_FLOAT).tofile(f)
        np.int32(w).tofile(f)
        np.int32(h).tofile(f)
        flow.astype("<f4").tofile(f)


def read_kitti_png_flow(filename):
    """Read KITTI flow PNG -> (H, W, 3) float32 [u, v, valid].

    Encoding: ``flow = (uint16 - 2**15) / 64.0``; channel 2 is the validity
    mask, and u and v are zeroed where it is 0.
    """
    from flownet2_tf_tpu_torch.utils.png16 import read_png16

    img = read_png16(os.fspath(filename))
    flow = np.empty(img.shape[:2] + (3,), dtype=np.float32)
    flow[:, :, 0] = (img[:, :, 0].astype(np.float32) - 2.0**15) / 64.0
    flow[:, :, 1] = (img[:, :, 1].astype(np.float32) - 2.0**15) / 64.0
    flow[:, :, 2] = (img[:, :, 2] > 0).astype(np.float32)
    flow[:, :, 0] *= flow[:, :, 2]
    flow[:, :, 1] *= flow[:, :, 2]
    return flow


def write_kitti_png_flow(flow, filename, valid=None):
    """Write (H, W, 2) flow to KITTI 16-bit PNG encoding."""
    from flownet2_tf_tpu_torch.utils.png16 import write_png16

    flow = np.asarray(flow, dtype=np.float32)
    h, w = flow.shape[:2]
    if valid is None:
        valid = np.ones((h, w), dtype=np.uint16)
    out = np.zeros((h, w, 3), dtype=np.uint16)
    out[:, :, 0] = np.clip(flow[:, :, 0] * 64.0 + 2.0**15, 0, 65535).astype(
        np.uint16
    )
    out[:, :, 1] = np.clip(flow[:, :, 1] * 64.0 + 2.0**15, 0, 65535).astype(
        np.uint16
    )
    out[:, :, 2] = valid.astype(np.uint16)
    write_png16(out, os.fspath(filename))


def read_pfm_flow(filename):
    """Read a PFM flow file (FlyingThings3D ground truth) -> (H, W, 2)."""
    with open(os.fspath(filename), "rb") as f:
        header = f.readline().rstrip()
        color = header == b"PF"
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    if not color:
        # grayscale 'Pf' files are disparity/depth maps, not flow
        raise ValueError(
            f"{filename}: single-channel PFM ('Pf') is not an optical "
            "flow file; flow ground truth is 3-channel 'PF' (u, v, 0)"
        )
    data = data.reshape((h, w, 3))
    data = np.flipud(data)  # PFM stores rows bottom-to-top
    return np.ascontiguousarray(data[:, :, :2].astype(np.float32))


@functools.cache
def make_color_wheel():
    """The 55-color Middlebury color wheel, shape (55, 3) float
    (RY=15, YG=6, GC=4, CB=11, BM=13, MR=6)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    colorwheel = np.zeros((ncols, 3))
    col = 0
    colorwheel[0:RY, 0] = 255
    colorwheel[0:RY, 1] = np.floor(255 * np.arange(0, RY) / RY)
    col += RY
    colorwheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(0, YG) / YG)
    colorwheel[col : col + YG, 1] = 255
    col += YG
    colorwheel[col : col + GC, 1] = 255
    colorwheel[col : col + GC, 2] = np.floor(255 * np.arange(0, GC) / GC)
    col += GC
    colorwheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(0, CB) / CB)
    colorwheel[col : col + CB, 2] = 255
    col += CB
    colorwheel[col : col + BM, 2] = 255
    colorwheel[col : col + BM, 0] = np.floor(255 * np.arange(0, BM) / BM)
    col += BM
    colorwheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(0, MR) / MR)
    colorwheel[col : col + MR, 0] = 255
    colorwheel.setflags(write=False)
    return colorwheel


def compute_color(u, v):
    """Map normalized flow components to RGB via the color wheel.

    NaNs are zeroed. Returns an (H, W, 3) float image in [0, 255].
    """
    colorwheel = make_color_wheel()
    u = np.asarray(u, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    h, w = u.shape
    img = np.zeros((h, w, 3))

    nan_idx = np.isnan(u) | np.isnan(v)
    u = np.where(nan_idx, 0, u)
    v = np.where(nan_idx, 0, v)

    ncols = colorwheel.shape[0]
    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1) + 1
    k0 = np.floor(fk).astype(int)
    k1 = k0 + 1
    k1[k1 == ncols + 1] = 1
    f = fk - k0

    for i in range(colorwheel.shape[1]):
        tmp = colorwheel[:, i]
        col0 = tmp[k0 - 1] / 255
        col1 = tmp[(k1 - 1) % ncols] / 255
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        notidx = np.logical_not(idx)
        col[notidx] *= 0.75
        img[:, :, i] = np.floor(255 * col * (1 - nan_idx))
    return img


def flow_to_image(flow, max_flow=None):
    """Render an (H, W, 2) flow field as an (H, W, 3) uint8 RGB image.

    Per-image max-magnitude normalization (unless ``max_flow`` is given);
    pixels with |u| or |v| above ``UNKNOWN_FLOW_THRESH`` are blanked.
    """
    flow = np.asarray(flow)
    u = flow[:, :, 0].astype(np.float64)
    v = flow[:, :, 1].astype(np.float64)

    idx_unknown = (np.abs(u) > UNKNOWN_FLOW_THRESH) | (
        np.abs(v) > UNKNOWN_FLOW_THRESH
    )
    u = np.where(idx_unknown, 0, u)
    v = np.where(idx_unknown, 0, v)

    rad = np.sqrt(u**2 + v**2)
    maxrad = max(-1.0, float(np.max(rad))) if max_flow is None else float(max_flow)

    eps = np.finfo(float).eps
    u = u / (maxrad + eps)
    v = v / (maxrad + eps)

    img = compute_color(u, v)
    img[idx_unknown] = 0
    return np.uint8(img)


def write_flow_png(flow, filename, max_flow=None):
    """Visualize flow and save as PNG."""
    from PIL import Image

    Image.fromarray(flow_to_image(flow, max_flow=max_flow)).save(
        os.fspath(filename)
    )


def flow_error(tu, tv, u, v):
    """Average endpoint error between GT (tu, tv) and estimate (u, v).

    Pixels whose GT magnitude exceeds ``UNKNOWN_FLOW_THRESH`` are excluded.
    """
    tu = np.asarray(tu, dtype=np.float64)
    tv = np.asarray(tv, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)

    idx_unknown = (np.abs(tu) > UNKNOWN_FLOW_THRESH) | (
        np.abs(tv) > UNKNOWN_FLOW_THRESH
    )
    valid = ~idx_unknown
    if not np.any(valid):
        return 0.0
    du = tu[valid] - u[valid]
    dv = tv[valid] - v[valid]
    epe = np.sqrt(du**2 + dv**2)
    return float(np.mean(epe))


def evaluate_flow(gt_flow, pred_flow):
    """AEE between two (H, W, 2[/3]) flow fields; honors a KITTI valid mask
    in channel 2 of the GT if present."""
    gt_flow = np.asarray(gt_flow)
    pred_flow = np.asarray(pred_flow)
    if gt_flow.shape[2] == 3:
        mask = gt_flow[:, :, 2] > 0.5
        if not np.any(mask):
            return 0.0
        du = gt_flow[:, :, 0][mask] - pred_flow[:, :, 0][mask]
        dv = gt_flow[:, :, 1][mask] - pred_flow[:, :, 1][mask]
        return float(np.mean(np.sqrt(du**2 + dv**2)))
    return flow_error(
        gt_flow[:, :, 0], gt_flow[:, :, 1], pred_flow[:, :, 0], pred_flow[:, :, 1]
    )


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
        write_flow(flow, stem + ".flo")
    if save_image:
        write_flow_png(flow, stem + ".png")
    return stem
