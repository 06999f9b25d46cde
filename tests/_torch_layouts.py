"""Tiny on-disk dataset layouts for the torch port's tests, written from a
seed with numpy into a test's temp directory (no fixture files are
committed). Each writer returns the root to hand to the reader."""

import os

import numpy as np

from flownet2_tf_tpu_torch.utils import flowlib
from flownet2_tf_tpu_torch.utils.image_io import write_image


def _image(rng, h, w):
    return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)


def _flow(rng, h, w):
    return (rng.randn(h, w, 2) * 3).astype(np.float32)


def write_pfm(flow, path, big_endian=False):
    """A 3-channel 'PF' file holding (u, v, 0), rows bottom to top; the
    scale's sign gives the endianness (negative: little)."""
    h, w = flow.shape[:2]
    rgb = np.concatenate([flow, np.zeros((h, w, 1), np.float32)], axis=-1)
    with open(path, "wb") as f:
        f.write(b"PF\n%d %d\n%s\n" % (w, h, b"1.0" if big_endian else b"-1.0"))
        np.flipud(rgb).astype(">f4" if big_endian else "<f4").tofile(f)


def chairs(root, n=4, h=16, w=24, seed=0):
    """FlyingChairs release: NNNNN_img1.ppm, _img2.ppm, _flow.flo."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        stem = os.path.join(root, f"{i:05d}")
        write_image(_image(rng, h, w), stem + "_img1.ppm")
        write_image(_image(rng, h, w), stem + "_img2.ppm")
        flowlib.write_flow(_flow(rng, h, w), stem + "_flow.flo")
    return root


def things_full(root, h=16, w=24, seed=0, frames=3):
    """FlyingThings3D: frames_cleanpass/{TRAIN,TEST}/A/0000/left/NNNN.png
    and optical_flow/.../into_future/left/OpticalFlowIntoFuture_NNNN_L.pfm."""
    rng = np.random.RandomState(seed)
    for split in ("TRAIN", "TEST"):
        img = os.path.join(root, "frames_cleanpass", split, "A", "0000",
                           "left")
        flo = os.path.join(root, "optical_flow", split, "A", "0000",
                           "into_future", "left")
        os.makedirs(img)
        os.makedirs(flo)
        for i in range(6, 6 + frames):
            write_image(_image(rng, h, w), os.path.join(img, f"{i:04d}.png"))
            write_pfm(_flow(rng, h, w),
                      os.path.join(flo, f"OpticalFlowIntoFuture_{i:04d}_L.pfm"),
                      big_endian=(i % 2 == 1))
    return root


def things_subset(root, h=16, w=24, seed=0, frames=3):
    """FlyingThings3D subset: {train,val}/image_clean/left/NNNNNNN.png and
    {train,val}/flow/left/NNNNNNN.pfm."""
    rng = np.random.RandomState(seed)
    for split in ("train", "val"):
        img = os.path.join(root, split, "image_clean", "left")
        flo = os.path.join(root, split, "flow", "left")
        os.makedirs(img)
        os.makedirs(flo)
        for i in range(frames):
            write_image(_image(rng, h, w), os.path.join(img, f"{i:07d}.png"))
            write_pfm(_flow(rng, h, w), os.path.join(flo, f"{i:07d}.pfm"))
    return root


def sdhom(root, h=16, w=24, seed=0, n=2, ext=".flo"):
    """ChairsSDHom: data/{train,test}/{t0,t1,flow}/NNNNN.{png,png,flo|pfm}."""
    rng = np.random.RandomState(seed)
    for split in ("train", "test"):
        base = os.path.join(root, "data", split)
        for sub in ("t0", "t1", "flow"):
            os.makedirs(os.path.join(base, sub))
        for i in range(n):
            for sub in ("t0", "t1"):
                write_image(_image(rng, h, w),
                            os.path.join(base, sub, f"{i:05d}.png"))
            path = os.path.join(base, "flow", f"{i:05d}{ext}")
            if ext == ".pfm":
                write_pfm(_flow(rng, h, w), path)
            else:
                flowlib.write_flow(_flow(rng, h, w), path)
    return root


def sintel(root, sizes=((16, 24), (16, 24)), frames=3, seed=0):
    """MPI-Sintel training: {clean,final}/<seq>/frame_NNNN.png and
    flow/<seq>/frame_NNNN.flo, one sequence per entry of ``sizes``."""
    rng = np.random.RandomState(seed)
    for s, (h, w) in enumerate(sizes):
        seq = f"seq_{s}"
        for render_pass in ("clean", "final"):
            d = os.path.join(root, "training", render_pass, seq)
            os.makedirs(d)
            for i in range(1, frames + 1):
                write_image(_image(rng, h, w),
                            os.path.join(d, f"frame_{i:04d}.png"))
        d = os.path.join(root, "training", "flow", seq)
        os.makedirs(d)
        for i in range(1, frames):
            flowlib.write_flow(_flow(rng, h, w),
                               os.path.join(d, f"frame_{i:04d}.flo"))
    return root


def kitti(root, sizes=((20, 30), (18, 29)), img_dir="colored_0", seed=0):
    """KITTI: training/<img_dir>/NNNNNN_{10,11}.png and training/flow_occ/
    NNNNNN_10.png (16-bit, about half the pixels valid)."""
    rng = np.random.RandomState(seed)
    base = os.path.join(root, "training")
    os.makedirs(os.path.join(base, img_dir))
    os.makedirs(os.path.join(base, "flow_occ"))
    for i, (h, w) in enumerate(sizes):
        for suf in ("_10.png", "_11.png"):
            write_image(_image(rng, h, w),
                        os.path.join(base, img_dir, f"{i:06d}{suf}"))
        valid = (rng.rand(h, w) < 0.5).astype(np.uint16)
        flowlib.write_kitti_png_flow(
            _flow(rng, h, w), os.path.join(base, "flow_occ", f"{i:06d}_10.png"),
            valid=valid)
    return root
