"""Host-side input pipeline: the synthetic dataset and the batch loader.

Numpy copies of ``flownet2_tf_tpu/data/loader.py``'s
``SyntheticFlowDataset`` (with ``_bilinear_upsample`` and
``_backward_resample``), ``BatchLoader`` and ``_parallel_fetch``. They are
copied, not imported, because importing the JAX package pulls in JAX; the
synthetic images and flows are byte-identical to the JAX package's for the
same seed and index, and the batch order and ``start_batch`` resume are
the same. The raw-layout and TFRecord dataset readers and ``load_batch``
are not ported yet (ROADMAP).

Datasets yield dicts {'image_a', 'image_b', 'flow'} as float32 numpy
arrays, images in [0, 1]; the trainer moves each batch to the device and
augments it there (``data/augmentation.py``).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np


class SyntheticFlowDataset:
    """Procedural image pairs with analytically known flow.

    Each example: a smooth random texture A; flow = per-example random
    affine field; B = A backward-warped by the flow (so that
    flow_warp(B, flow) ~= A). Deterministic per (seed, index); no dataset
    download needed.
    """

    def __init__(self, size=1024, height=64, width=64, seed=0,
                 max_flow=5.0):
        self.size = int(size)
        self.height = int(height)
        self.width = int(width)
        self.seed = int(seed)
        self.max_flow = float(max_flow)

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        return self._render(idx)

    def _render(self, idx):
        rng = np.random.RandomState((self.seed * 1_000_003 + idx) % 2**31)
        h, w = self.height, self.width
        # smooth texture: low-res noise upsampled
        small = rng.rand(h // 8 + 2, w // 8 + 2, 3).astype(np.float32)
        img_a = _bilinear_upsample(small, h, w)

        # affine flow field: f(p) = M p + t, small coefficients (the JAX
        # package's 'default' motion regime; its 'large', 'subpixel' and
        # 'mixed' regimes are not ported)
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
        # B(p + f(p)) = A(p)  =>  B(q) = A(finv(q)), with the first-order
        # inverse (exact for pure translation; the residual is negligible
        # for these small fields)
        img_b = _backward_resample(img_a, -flow)
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
