"""Build reference-layout TFRecords from raw datasets.

Copy of ``flownet2_tf_tpu/tools/make_tfrecords.py``. Records hold the
raw-bytes features ``image_a``, ``image_b`` (uint8 HxWx3) and ``flow``
(float32 HxWx2), written by ``data/tfrecord.py``: readable by TF's
TFRecordDataset and by both packages' readers. The records' CRC32C runs
in the native IO runtime (``runtime/native.py``) when it builds, else in
pure Python (a few MB/s: a 384x512 FlyingChairs record is about
2.75 MB).

CLI: ``python -m flownet2_tf_tpu_torch.cli make-tfrecords --data_root ...
--out train.tfrecords [--out_val val.tfrecords --val_count 640]``.
"""

from __future__ import annotations

import numpy as np

from flownet2_tf_tpu_torch.data import tfrecord


def example_from_item(item) -> bytes:
    image_a = item["image_a"]
    image_b = item["image_b"]
    flow = np.ascontiguousarray(item["flow"][..., :2], np.float32)
    if image_a.dtype != np.uint8:
        image_a = np.clip(image_a * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if image_b.dtype != np.uint8:
        image_b = np.clip(image_b * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return tfrecord.build_example(
        {
            "image_a": image_a.tobytes(),
            "image_b": image_b.tobytes(),
            "flow": flow.tobytes(),
        }
    )


def write_dataset(dataset, out_path, indices=None, log_every=1000):
    """Serialize dataset items to a TFRecord file; returns count."""
    if indices is None:
        indices = range(len(dataset))
    written = 0

    def payloads():
        nonlocal written
        for n, i in enumerate(indices):
            if log_every and n and n % log_every == 0:
                print(f"  {n} examples written...", flush=True)
            yield example_from_item(dataset[int(i)])
            written += 1

    tfrecord.write_records(out_path, payloads())
    return written


def convert_flying_chairs(data_root, out_train, out_val=None,
                          val_count=640, seed=0):
    """Raw FlyingChairs -> train/val TFRecords (deterministic split,
    last ``val_count`` of a seeded shuffle go to validation — the
    reference's published split was a fixed list; a seeded shuffle keeps
    this self-contained and reproducible)."""
    from flownet2_tf_tpu_torch.data.loader import FlyingChairsRawDataset

    ds = FlyingChairsRawDataset(data_root)
    order = np.arange(len(ds))
    np.random.RandomState(seed).shuffle(order)
    if out_val and val_count:
        train_idx, val_idx = order[:-val_count], order[-val_count:]
    else:
        train_idx, val_idx = order, []
    n_train = write_dataset(ds, out_train, train_idx)
    n_val = 0
    if out_val and len(val_idx):
        n_val = write_dataset(ds, out_val, val_idx)
    return n_train, n_val
