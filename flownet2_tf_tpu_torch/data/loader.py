"""Host-side input pipeline: datasets and the batch loader.

Numpy copies of ``flownet2_tf_tpu/data/loader.py``, copied, not
imported, because importing the JAX package pulls in JAX:

* ``SyntheticFlowDataset`` (with ``_bilinear_upsample`` and
  ``_backward_resample``): images and flows byte-identical to the JAX
  package's for the same seed and index, in every ``motion`` regime,
  with ``uint8_images`` and with ``cache``;
* the readers of the datasets' published layouts: FlyingChairs (with its
  1-in-36 ``validate`` holdout), FlyingThings3D (full and subset
  layouts), ChairsSDHom, MPI-Sintel and KITTI (``colored_0`` and
  ``image_2``), and reference-layout TFRecords (``TFRecordFlowDataset``,
  through the native IO runtime, ``runtime/native.py``, when it builds,
  else pure Python);
* ``BatchLoader`` and ``_parallel_fetch`` (the same batch order and
  ``start_batch`` resume), and ``load_batch``, which builds a loader from
  a dataset config (``data/dataset_configs.py``).

Datasets yield dicts {'image_a', 'image_b', 'flow'} as float32 numpy
arrays, images in [0, 1]; ``TFRecordFlowDataset(raw_uint8=True)`` (what
``load_batch`` builds) keeps the images uint8, and the trainer converts
them on the device (``training/loop.py::_images_to_float``). KITTI's flow
is (H, W, 3) [u, v, valid]. The trainer moves each batch to the device
and augments it there (``data/augmentation.py``).
"""

from __future__ import annotations

import glob
import os
import queue
import struct
import threading
from typing import Iterator, Sequence

import numpy as np

from flownet2_tf_tpu_torch.data import tfrecord
from flownet2_tf_tpu_torch.utils import flowlib
from flownet2_tf_tpu_torch.utils.image_io import read_image


class SyntheticFlowDataset:
    """Procedural image pairs with analytically known flow.

    Each example: a smooth random texture A; flow = per-example random
    affine field; B = A backward-warped by the flow (so that
    flow_warp(B, flow) ~= A). Deterministic per (seed, index); no dataset
    download needed. Byte-identical to the JAX package's for every
    ``motion`` regime, ``uint8_images`` and ``cache``.
    """

    def __init__(self, size=1024, height=64, width=64, seed=0,
                 max_flow=5.0, cache=False, uint8_images=False,
                 motion="default"):
        self.size = int(size)
        self.height = int(height)
        self.width = int(width)
        self.seed = int(seed)
        self.max_flow = float(max_flow)
        # motion regime:
        #   'default'  — translation ~ U(-max_flow, max_flow) (legacy;
        #                tests/goldens pin this distribution)
        #   'large'    — |translation| in [10, 40] px: the regime the
        #                CSS branch (correlation, +-160 px at full res)
        #                exists for and FlowNetSD's all-3x3 receptive
        #                field cannot reach
        #   'subpixel' — |translation| <= 0.9 px, tiny rotation/zoom:
        #                the small-displacement regime FlowNetSD was
        #                added for (FlowNet2 paper §4)
        #   'mixed'    — even indices large, odd indices subpixel
        if motion not in ("default", "large", "subpixel", "mixed"):
            raise ValueError(f"unknown motion regime {motion!r}")
        self.motion = motion
        # uint8_images: quantize rendered images to 8-bit, as real
        # datasets are (Chairs/Sintel PPM/PNG); the trainer converts them
        # on the device (training/loop.py::_images_to_float), and they
        # are a quarter of the image bytes to the device (flow stays f32)
        self.uint8_images = bool(uint8_images)
        # cache=True memoizes rendered scenes (a numpy render costs tens
        # of ms per example), for loops that re-visit indices; ~2.6 MB
        # per 256x320 scene
        self._cache = {} if cache else None

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        if self._cache is not None:
            item = self._cache.get(idx)
            if item is None:
                item = self._render(idx)
                self._cache[idx] = item
            return item
        return self._render(idx)

    def _render(self, idx):
        rng = np.random.RandomState((self.seed * 1_000_003 + idx) % 2**31)
        h, w = self.height, self.width
        # smooth texture: low-res noise upsampled
        small = rng.rand(h // 8 + 2, w // 8 + 2, 3).astype(np.float32)
        img_a = _bilinear_upsample(small, h, w)

        # affine flow field: f(p) = M p + t, small coefficients
        regime = self.motion
        if regime == "mixed":
            regime = "large" if idx % 2 == 0 else "subpixel"
        if regime == "large":
            # large translation, but keep the rotation/zoom coefficients
            # small: _backward_resample inverts the field with one
            # fixed-point step, which is exact for pure translation and
            # O(coef^2 * |p|) for the linear part — the GT stays honest
            ang = rng.uniform(-0.02, 0.02)
            scale = rng.uniform(-0.02, 0.02)
            mag = rng.uniform(10.0, 40.0, 2)
            tx, ty = mag * rng.choice([-1.0, 1.0], 2)
        elif regime == "subpixel":
            ang = rng.uniform(-0.002, 0.002)
            scale = rng.uniform(-0.002, 0.002)
            tx, ty = rng.uniform(-0.9, 0.9, 2)
        else:
            ang = rng.uniform(-0.05, 0.05)
            scale = rng.uniform(-0.03, 0.03)
            tx, ty = rng.uniform(-self.max_flow, self.max_flow, 2)
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        cx, cy = (w - 1) / 2, (h - 1) / 2
        u = (np.cos(ang) * (1 + scale) - 1) * (xs - cx) - np.sin(ang) * (
            ys - cy
        ) + tx
        v = np.sin(ang) * (xs - cx) + (np.cos(ang) * (1 + scale) - 1) * (
            ys - cy
        ) + ty
        flow = np.stack([u, v], axis=-1).astype(np.float32)

        # B such that warping B backward by flow reproduces A:
        # B(p + f(p)) = A(p)  =>  B(q) = A(finv(q)).
        if regime in ("large", "subpixel"):
            # the field is affine — invert it EXACTLY:
            # q = c + L (p - c) + t  =>  p = c + L^-1 (q - c - t).
            # The 'default' path below keeps its first-order inverse
            # (the JAX package's frozen-seed tests pin that rendering);
            # at 40 px translations the first-order error reaches ~0.9 px
            # of sampling offset, label noise on the GT.
            ca, sa = np.cos(ang), np.sin(ang)
            L = np.array([[ca * (1 + scale), -sa],
                          [sa, ca * (1 + scale)]], np.float64)
            li = np.linalg.inv(L)
            dqx = xs - cx - tx
            dqy = ys - cy - ty
            px = cx + li[0, 0] * dqx + li[0, 1] * dqy
            py = cy + li[1, 0] * dqx + li[1, 1] * dqy
            inv_disp = np.stack([px - xs, py - ys], axis=-1).astype(
                np.float32)
            img_b = _backward_resample(img_a, inv_disp)
        else:
            # first-order inverse (exact for pure translation): for the
            # small default fields the residual is negligible
            img_b = _backward_resample(img_a, -flow)
        if self.uint8_images:
            img_a = (np.clip(img_a, 0.0, 1.0) * 255.0 + 0.5).astype(
                np.uint8
            )
            img_b = (np.clip(img_b, 0.0, 1.0) * 255.0 + 0.5).astype(
                np.uint8
            )
        return {"image_a": img_a, "image_b": img_b, "flow": flow}


def _bilinear_upsample(img, h, w):
    ys = np.linspace(0, img.shape[0] - 1.001, h)
    xs = np.linspace(0, img.shape[1] - 1.001, w)
    y0 = ys.astype(int)
    x0 = xs.astype(int)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x0 + 1]
    c = img[y0 + 1][:, x0]
    d = img[y0 + 1][:, x0 + 1]
    return (
        a * (1 - wy) * (1 - wx)
        + b * (1 - wy) * wx
        + c * wy * (1 - wx)
        + d * wy * wx
    ).astype(np.float32)


def _backward_resample(img, flow):
    h, w = img.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    x2 = np.clip(xs + flow[..., 0], 0, w - 1)
    y2 = np.clip(ys + flow[..., 1], 0, h - 1)
    x0 = np.floor(x2).astype(int)
    y0 = np.floor(y2).astype(int)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    wx = (x2 - x0)[..., None]
    wy = (y2 - y0)[..., None]
    return (
        img[y0, x0] * (1 - wy) * (1 - wx)
        + img[y0, x1] * (1 - wy) * wx
        + img[y1, x0] * wy * (1 - wx)
        + img[y1, x1] * wy * wx
    ).astype(np.float32)


def _read_float_image(path):
    return read_image(path).astype(np.float32) / 255.0


class FlyingChairsRawDataset:
    """FlyingChairs release layout: NNNNN_img1.ppm / _img2.ppm / _flow.flo.

    ``split``: 'all' (default: every pair), or 'train'/'validate' for a
    deterministic 1-in-36 holdout (~635 of 22872 pairs, the size of the
    official validation split, whose index file the release layout does
    not carry). The two splits are disjoint and stable across runs.
    """

    def __init__(self, root, split: str = "all"):
        self.root = os.fspath(root)
        ids = sorted(
            os.path.basename(p)[:-9]
            for p in glob.glob(os.path.join(self.root, "*_img1.ppm"))
        )
        if split == "validate":
            ids = ids[::36]
        elif split == "train":
            holdout = set(ids[::36])
            ids = [i for i in ids if i not in holdout]
        elif split != "all":
            raise ValueError(
                f"FlyingChairs raw split must be 'all'|'train'|'validate', "
                f"got {split!r}"
            )
        self.ids = ids
        if not self.ids:
            raise FileNotFoundError(f"no *_img1.ppm under {self.root}")

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx):
        stem = os.path.join(self.root, self.ids[idx])
        return {
            "image_a": _read_float_image(stem + "_img1.ppm"),
            "image_b": _read_float_image(stem + "_img2.ppm"),
            "flow": flowlib.read_flow(stem + "_flow.flo"),
        }


class TFRecordFlowDataset:
    """Reference-layout TFRecords: Example{image_a, image_b, flow} raw
    bytes, uint8 images and float32 flow at the config's H x W.

    With the native IO runtime (``runtime/native.py``; ``use_native``,
    the default, and a library that builds), the record index comes from
    its C++ scan and whole batches decode over its threads
    (``fetch_batch``), each payload's CRC checked; otherwise records are
    found by a Python offset index and parsed by ``data/tfrecord.py``,
    without the CRC check. Both give the same bytes. ``raw_uint8`` keeps
    the images uint8 on the host: a quarter of the bytes to the device,
    where the trainer converts them.
    """

    def __init__(self, path, height, width, use_native: bool = True,
                 raw_uint8: bool = False):
        self.path = os.fspath(path)
        self.height = int(height)
        self.width = int(width)
        self.raw_uint8 = bool(raw_uint8)
        self._offsets = None
        self._native = None
        self._native_handle = None
        if use_native:
            from flownet2_tf_tpu_torch.runtime.native import get_native_io

            self._native = get_native_io()
            if self._native is not None:
                try:
                    self._native_handle = self._native.tfrecord_open(
                        self.path)
                except ValueError:
                    self._native = None

    @property
    def native(self) -> bool:
        """Whether batches decode through the native runtime."""
        return self._native_handle is not None

    def fetch_batch(self, idxs, num_workers: int = 4):
        if self._native_handle is not None:
            return self._native.decode_batch(
                self._native_handle, list(idxs), self.height, self.width,
                n_threads=num_workers, raw_uint8=self.raw_uint8,
            )
        items = [self[int(i)] for i in idxs]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    def __del__(self):
        if getattr(self, "_native_handle", None) is not None:
            try:
                self._native.tfrecord_close(self._native_handle)
            except Exception:
                pass

    def _index(self):
        if self._offsets is None:
            offsets = []
            with open(self.path, "rb") as f:
                pos = 0
                while True:
                    header = f.read(12)
                    if len(header) < 12:
                        break
                    (length,) = struct.unpack("<Q", header[:8])
                    offsets.append(pos)
                    pos += 12 + length + 4
                    f.seek(pos)
            self._offsets = offsets
        return self._offsets

    def __len__(self):
        if self._native_handle is not None:
            # the native open already indexed every record
            return int(self._native.tfrecord_count(self._native_handle))
        return len(self._index())

    def __getitem__(self, idx):
        offsets = self._index()
        with open(self.path, "rb") as f:
            f.seek(offsets[idx])
            header = f.read(12)
            (length,) = struct.unpack("<Q", header[:8])
            payload = f.read(length)
        feats = tfrecord.parse_example(payload)
        h, w = self.height, self.width
        image_a = np.frombuffer(feats["image_a"][0], np.uint8).reshape(
            h, w, 3
        )
        image_b = np.frombuffer(feats["image_b"][0], np.uint8).reshape(
            h, w, 3
        )
        if self.raw_uint8:
            image_a = image_a.copy()
            image_b = image_b.copy()
        else:
            image_a = image_a.astype(np.float32) / 255.0
            image_b = image_b.astype(np.float32) / 255.0
        flow = np.frombuffer(feats["flow"][0], np.float32).reshape(h, w, 2)
        return {"image_a": image_a, "image_b": image_b, "flow": flow.copy()}


class _PairFiles:
    """A dataset of (image_a, image_b, flow) file triples."""

    pairs: list

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx):
        a, b, flo = self.pairs[idx]
        return {
            "image_a": _read_float_image(a),
            "image_b": _read_float_image(b),
            "flow": flowlib.read_flow(flo),
        }


class FlyingThings3DDataset(_PairFiles):
    """FlyingThings3D layout (as used for FlowNet fine-tuning):
    frames_cleanpass/TRAIN/<A|B|C>/NNNN/left/NNNN.png pairs with
    optical_flow/TRAIN/.../into_future/left/OpticalFlowIntoFuture_NNNN_L.pfm
    ground truth. Also accepts the flattened 'subset' layout
    (train/image_clean/left + train/flow/left)."""

    def __init__(self, root, split="TRAIN", pass_name="frames_cleanpass"):
        self.root = os.fspath(root)
        self.pairs = []
        # split: TRAIN -> train/ (subset) | TRAIN/ (full); anything else
        # -> val/ (subset) | TEST/ (full): the held-out frames
        is_train = str(split).lower() == "train"
        subset_split = "train" if is_train else "val"
        split = "TRAIN" if is_train else "TEST"
        subset_img = os.path.join(
            self.root, subset_split, "image_clean", "left")
        if os.path.isdir(subset_img):
            flow_dir = os.path.join(
                self.root, subset_split, "flow", "left")
            frames = sorted(glob.glob(os.path.join(subset_img, "*.png")))
            for a, b in zip(frames[:-1], frames[1:]):
                stem = os.path.splitext(os.path.basename(a))[0]
                flo = os.path.join(flow_dir, stem + ".pfm")
                if os.path.exists(flo):
                    self.pairs.append((a, b, flo))
        else:
            img_root = os.path.join(self.root, pass_name, split)
            flow_root = os.path.join(self.root, "optical_flow", split)
            for scene in sorted(glob.glob(os.path.join(img_root, "*", "*"))):
                rel = os.path.relpath(scene, img_root)
                frames = sorted(
                    glob.glob(os.path.join(scene, "left", "*.png"))
                )
                for a, b in zip(frames[:-1], frames[1:]):
                    num = os.path.splitext(os.path.basename(a))[0]
                    flo = os.path.join(
                        flow_root, rel, "into_future", "left",
                        f"OpticalFlowIntoFuture_{num}_L.pfm",
                    )
                    if os.path.exists(flo):
                        self.pairs.append((a, b, flo))
        if not self.pairs:
            raise FileNotFoundError(
                f"no FlyingThings3D pairs under {self.root}"
            )


class ChairsSDHomDataset(_PairFiles):
    """ChairsSDHom (small-displacement set used to train FlowNetSD):
    data/<split>/{t0,t1,flow}/NNNNN.{png,png,flo|pfm}."""

    def __init__(self, root, split="train"):
        self.root = os.fspath(root)
        base = os.path.join(self.root, "data", split)
        if not os.path.isdir(base):
            base = os.path.join(self.root, split)
        t0 = sorted(glob.glob(os.path.join(base, "t0", "*.png")))
        self.pairs = []
        for a in t0:
            name = os.path.basename(a)
            stem = os.path.splitext(name)[0]
            b = os.path.join(base, "t1", name)
            flo = os.path.join(base, "flow", stem + ".flo")
            if not os.path.exists(flo):
                flo = os.path.join(base, "flow", stem + ".pfm")
            if os.path.exists(b) and os.path.exists(flo):
                self.pairs.append((a, b, flo))
        if not self.pairs:
            raise FileNotFoundError(f"no ChairsSDHom triplets under {base}")


class SintelDataset(_PairFiles):
    """MPI-Sintel training layout: training/{clean|final}/<seq>/frame_NNNN.png
    with training/flow/<seq>/frame_NNNN.flo ground truth."""

    def __init__(self, root, render_pass="clean", split="training"):
        self.root = os.fspath(root)
        img_dir = os.path.join(self.root, split, render_pass)
        flow_dir = os.path.join(self.root, split, "flow")
        self.pairs = []
        for seq in sorted(os.listdir(img_dir)) if os.path.isdir(img_dir) else []:
            frames = sorted(glob.glob(os.path.join(img_dir, seq, "frame_*.png")))
            for a, b in zip(frames[:-1], frames[1:]):
                stem = os.path.basename(a)[:-4]
                flo = os.path.join(flow_dir, seq, stem + ".flo")
                if os.path.exists(flo):
                    self.pairs.append((a, b, flo))
        if not self.pairs:
            raise FileNotFoundError(f"no Sintel pairs under {img_dir}")


class KittiDataset(_PairFiles):
    """KITTI flow layout: colored_0/ (KITTI 2012) or image_2/ (KITTI 2015)
    image pairs *_10.png/*_11.png with flow_occ/ (or flow_noc/) 16-bit PNG
    ground truth, read as (H, W, 3) [u, v, valid]."""

    def __init__(self, root, split="training", flow_kind="flow_occ"):
        self.root = os.fspath(root)
        base = os.path.join(self.root, split)
        img_dir = os.path.join(base, "colored_0")
        if not os.path.isdir(img_dir):
            img_dir = os.path.join(base, "image_2")  # KITTI2015 layout
        self.pairs = []
        for first in sorted(glob.glob(os.path.join(img_dir, "*_10.png"))):
            second = first.replace("_10.png", "_11.png")
            stem = os.path.basename(first)
            flo = os.path.join(base, flow_kind, stem)
            if os.path.exists(second) and os.path.exists(flo):
                self.pairs.append((first, second, flo))
        if not self.pairs:
            raise FileNotFoundError(f"no KITTI pairs under {img_dir}")


class BatchLoader:
    """Shuffling, epoch-repeating, prefetching batch iterator.

    ``num_workers`` decode threads fill a bounded queue (the reference's
    tf.train.batch num_threads analogue); batches are stacked NumPy
    arrays.
    """

    def __init__(self, dataset, batch_size, shuffle=True, seed=0,
                 num_workers=4, prefetch=4, drop_remainder=True):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, int(num_workers))
        self.prefetch = int(prefetch)
        self.drop_remainder = drop_remainder

    def _epoch_order(self, epoch):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        return order

    def batches(self, epochs=None, start_batch=0) -> Iterator[dict]:
        """Yield batches forever (epochs=None) or for N epochs.

        ``start_batch`` skips the first N batches of the stream without
        fetching them — the epoch order is a pure function of
        ``(seed, epoch)``, so a trainer resuming at step N sees exactly
        the batches an uninterrupted run would have seen (sample-exact
        resume; ``epochs`` still counts whole epochs from the stream
        head).
        """
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        n_examples = len(self.dataset)
        limit = (
            n_examples - n_examples % self.batch_size
            if self.drop_remainder
            else n_examples
        )
        if limit <= 0:
            # an empty stream would otherwise hang forever at
            # epochs=None (nothing enqueued, no sentinel)
            raise ValueError(
                f"dataset yields no batches: {n_examples} examples, "
                f"batch_size {self.batch_size}"
                + (" (drop_remainder)" if self.drop_remainder else "")
            )
        per_epoch = max(1, -(-limit // self.batch_size))
        start_epoch = int(start_batch) // per_epoch
        skip_in_epoch = (int(start_batch) % per_epoch) * self.batch_size

        def producer():
            epoch = start_epoch
            skip = skip_in_epoch
            final = None  # end-of-stream sentinel; exceptions propagate
            try:
                while not stop.is_set():
                    if epochs is not None and epoch >= epochs:
                        break
                    order = self._epoch_order(epoch)
                    for start in range(skip, limit, self.batch_size):
                        idxs = order[start : start + self.batch_size]
                        if hasattr(self.dataset, "fetch_batch"):
                            batch = self.dataset.fetch_batch(
                                idxs, num_workers=self.num_workers
                            )
                        else:
                            items = _parallel_fetch(
                                self.dataset, idxs, self.num_workers
                            )
                            batch = {
                                k: np.stack([it[k] for it in items])
                                for k in items[0]
                            }
                        while not stop.is_set():
                            try:
                                out_q.put(batch, timeout=0.5)
                                break
                            except queue.Full:
                                continue
                        if stop.is_set():
                            return
                    epoch += 1
                    skip = 0
            except BaseException as e:
                # a producer failure (decode error, bad shapes, IO) must
                # reach the consumer as the error it is — the old
                # None-always finally turned it into a clean end of
                # stream and training would "complete" at step 0
                final = e
            finally:
                while not stop.is_set():
                    try:
                        out_q.put(final, timeout=0.5)
                        break
                    except queue.Full:
                        continue

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            # synchronous shutdown: a producer mid-fetch must not
            # outlive the caller (it would race file/tempdir teardown)
            thread.join(timeout=5.0)


def _parallel_fetch(dataset, idxs: Sequence[int], num_workers: int):
    if num_workers <= 1 or len(idxs) <= 1:
        return [dataset[int(i)] for i in idxs]
    results = [None] * len(idxs)
    lock = threading.Lock()
    pos = {"i": 0}

    def worker():
        while True:
            with lock:
                i = pos["i"]
                if i >= len(idxs):
                    return
                pos["i"] = i + 1
            results[i] = dataset[int(idxs[i])]

    threads = [
        threading.Thread(target=worker)
        for _ in range(min(num_workers, len(idxs)))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results  # type: ignore[return-value]


_RAW_DATASETS = {
    "flying_chairs": FlyingChairsRawDataset,
    "flying_things_3d": FlyingThings3DDataset,
    "chairs_sdhom": ChairsSDHomDataset,
    "sintel": SintelDataset,
    "kitti": KittiDataset,
}

# KITTI ground truth is sparse (a validity mask in the 3rd flow channel)
# and its frames vary in size per sequence: both break dense-EPE training
# batches. KITTI is an eval dataset (training/infer.py::evaluate_dataset
# honors the mask).
_EVAL_ONLY_DATASETS = {"kitti"}


def _raw_dataset_for_split(name, raw_cls, raw_root, split):
    """Raw-layout datasets honor the requested split (the TFRecord path
    reads PATHS[split]); 'validate' never aliases the training set."""
    if split == "train":
        if name == "flying_chairs":
            return raw_cls(raw_root, split="train")
        return raw_cls(raw_root)
    if name == "flying_chairs":
        return raw_cls(raw_root, split="validate")
    if name == "flying_things_3d":
        return raw_cls(raw_root, split="TEST")
    if name == "chairs_sdhom":
        return raw_cls(raw_root, split="test")
    raise ValueError(
        f"dataset {name!r} has no raw-layout {split!r} split; provide "
        f"TFRecords via PATHS[{split!r}]"
    )


def load_batch(dataset_config, split="train", dataset=None):
    """A BatchLoader for ``split`` of a dataset config dict, and the
    config's augmentation spec: returns ``(loader, preprocess)``.

    An existing ``PATHS[split]`` TFRecord file is preferred (read with
    uint8 images); else the raw layout under ``RAW_ROOT``.
    """
    name = dataset_config.get("NAME", "flying_chairs")
    if split == "train" and name in _EVAL_ONLY_DATASETS:
        raise ValueError(
            f"dataset {name!r} is eval-only (sparse GT with a validity "
            "mask and per-sequence frame sizes); use `cli eval --dataset "
            f"{name}`; training supports flying_chairs, flying_things_3d, "
            "chairs_sdhom and sintel"
        )
    if dataset is None:
        path = dataset_config.get("PATHS", {}).get(split)
        if path and os.path.exists(path):
            dataset = TFRecordFlowDataset(
                path,
                dataset_config["IMAGE_HEIGHT"],
                dataset_config["IMAGE_WIDTH"],
                raw_uint8=True,
            )
        else:
            raw_root = dataset_config.get("RAW_ROOT")
            if raw_root and os.path.isdir(raw_root):
                raw_cls = _RAW_DATASETS.get(name, FlyingChairsRawDataset)
                dataset = _raw_dataset_for_split(
                    name, raw_cls, raw_root, split
                )
            else:
                raise FileNotFoundError(
                    f"no data for {dataset_config.get('NAME')}: checked "
                    f"TFRecords {path!r} and RAW_ROOT {raw_root!r}"
                )
    loader = BatchLoader(
        dataset,
        batch_size=dataset_config.get("BATCH_SIZE", 8),
        shuffle=(split == "train"),
    )
    return loader, dataset_config.get("PREPROCESS", {})
