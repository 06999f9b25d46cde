"""The torch port's dataset evaluation and uint8 image feed, held against
the JAX package's on the same seeded params and data."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from flownet2_tf_tpu.models.registry import get_model as jax_model  # noqa: E402
from flownet2_tf_tpu.training import infer as jinfer  # noqa: E402
from flownet2_tf_tpu_torch.data import loader  # noqa: E402
from flownet2_tf_tpu_torch.tools import make_tfrecords  # noqa: E402
from flownet2_tf_tpu_torch.training import infer  # noqa: E402
from flownet2_tf_tpu_torch.training.loop import (  # noqa: E402
    TrainConfig,
    Trainer,
    _images_to_float,
)


class Pairs:
    """Seeded pairs at the given sizes; ``masked``: KITTI-style (H, W, 3)
    GT [u, v, valid] with about half the pixels valid."""

    def __init__(self, sizes, masked=False, seed=0):
        self.sizes, self.masked, self.seed = sizes, masked, seed

    def __len__(self):
        return len(self.sizes)

    def __getitem__(self, i):
        h, w = self.sizes[i]
        r = np.random.RandomState(self.seed + i)
        flow = (r.randn(h, w, 2) * 2).astype(np.float32)
        if self.masked:
            valid = (r.rand(h, w, 1) < 0.5).astype(np.float32)
            flow = np.concatenate([flow * valid, valid], axis=-1)
        return {"image_a": r.rand(h, w, 3).astype(np.float32),
                "image_b": r.rand(h, w, 3).astype(np.float32),
                "flow": flow}


# two %64 buckets (64x64, 64x128), one size off the grid in each
MIXED = [(64, 64), (50, 70), (64, 128), (60, 60), (64, 64)]


@pytest.fixture(scope="module")
def params():
    return {name: jax.device_get(jax_model(name).init(jax.random.PRNGKey(1)))
            for name in ("s", "c")}


@pytest.mark.parametrize("model", ["s", "c"])
def test_evaluate_dataset_matches_jax(params, model):
    """f32 within 1e-4 relative for batch sizes 1 and 2; bf16 within the
    JAX package's own bf16-vs-f32 AEE gap."""
    ds = Pairs(MIXED, masked=True)
    aee = {}
    for dtype in ("float32", "bfloat16"):
        for bs in (1, 2):
            aee["jax", dtype, bs] = jinfer.evaluate_dataset(
                model, params[model], ds, compute_dtype=dtype, batch_size=bs)
            aee["port", dtype, bs] = infer.evaluate_dataset(
                model, params[model], ds, compute_dtype=dtype, batch_size=bs,
                device="cpu")
    for bs in (1, 2):
        want = aee["jax", "float32", bs]
        assert np.isfinite(want) and want > 0
        assert aee["port", "float32", bs] == pytest.approx(want, rel=1e-4)
        gap = abs(aee["jax", "bfloat16", bs] - want)
        assert abs(aee["port", "bfloat16", bs]
                   - aee["jax", "bfloat16", bs]) <= gap, aee


def test_evaluate_dataset_flownet2_matches_jax():
    """FlowNet2 (kept in memory: its .npz is 650 MB), f32, a KITTI-style
    mask, two pairs in one bucket batched together, one off the grid."""
    tree = jax.device_get(jax.jit(jax_model("2").init)(jax.random.PRNGKey(1)))
    ds = Pairs([(64, 64), (50, 60)], masked=True)
    want = jinfer.evaluate_dataset("2", tree, ds, batch_size=2)
    got = infer.evaluate_dataset("2", tree, ds, batch_size=2, device="cpu")
    assert np.isfinite(want) and want > 0
    assert got == pytest.approx(want, rel=1e-4)


def test_batched_equals_per_pair():
    """batch_size 3 over a ragged dataset (2 buckets whose sizes 3 does not
    divide: tail batches at their true size) equals per-pair evaluation:
    the metric is the mean of per-pair AEEs."""
    sizes = [(60, 60), (64, 64), (57, 62), (100, 62), (64, 64), (62, 58),
             (100, 64)]
    tree = jax.device_get(jax_model("s").init(jax.random.PRNGKey(3)))
    one = infer.evaluate_dataset("s", tree, Pairs(sizes, seed=100),
                                 device="cpu")
    three = infer.evaluate_dataset("s", tree, Pairs(sizes, seed=100),
                                   batch_size=3, device="cpu")
    np.testing.assert_allclose(three, one, rtol=1e-6)
    assert infer.evaluate_dataset("s", tree, Pairs(sizes, seed=100), limit=2,
                                  device="cpu") == pytest.approx(
        infer.evaluate_dataset("s", tree, Pairs(sizes[:2], seed=100),
                               device="cpu"), rel=1e-6)


def test_pair_without_valid_pixels_counts_as_zero(params):
    ds = Pairs([(64, 64), (64, 64)], masked=True)
    empty = dict(ds[0])
    empty["flow"] = np.zeros_like(empty["flow"])  # valid channel all 0

    class Two:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            return empty if i == 0 else ds[1]

    class Second:
        def __len__(self):
            return 1

        def __getitem__(self, i):
            return ds[1]

    tree = params["s"]
    for bs in (1, 2):
        both = infer.evaluate_dataset("s", tree, Two(), batch_size=bs,
                                      device="cpu")
        alone = infer.evaluate_dataset("s", tree, Second(), device="cpu")
        assert alone > 0
        assert both == pytest.approx(alone / 2, rel=1e-6)


def test_bucket_batch_pads_and_masks():
    item = Pairs([(50, 70)], masked=True)[0]
    got = infer._bucket_batch(item)
    want = jinfer._bucket_batch(item)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert got["input_a"].shape == (1, 64, 128, 3)
    assert not got["valid"][0, 50:].any() and not got["valid"][0, :, 70:].any()
    np.testing.assert_array_equal(got["valid"][0, :50, :70],
                                  item["flow"][..., 2])


def test_images_to_float_is_a_true_division():
    u8 = torch.arange(256, dtype=torch.uint8)
    want = np.arange(256, dtype=np.float32) / 255.0  # what the readers do
    got = _images_to_float(u8)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    f = torch.rand(4)
    assert _images_to_float(f) is f


def test_uint8_feed_gives_the_float_feed_loss(tmp_path):
    """Trainer.train_step on one TFRecord batch fed as uint8 (converted on
    the device) and as float (converted by the reader): the same images
    reach the model, and the same loss comes out."""
    src = loader.SyntheticFlowDataset(size=2, height=64, width=64, seed=5)
    rec = tmp_path / "x.tfrecords"
    make_tfrecords.write_dataset(src, rec, log_every=0)
    feeds = {}
    for raw in (True, False):
        ds = loader.TFRecordFlowDataset(rec, 64, 64, raw_uint8=raw)
        feeds[raw] = ds.fetch_batch([0, 1])
    assert feeds[True]["image_a"].dtype == np.uint8
    assert feeds[False]["image_a"].dtype == np.float32

    losses = {}
    for raw, batch in feeds.items():
        trainer = Trainer(TrainConfig(
            model="s", schedule="short", log_dir=str(tmp_path / f"r{raw}"),
            tensorboard=False, compute_dtype="float32", device="cpu"))
        on_device = trainer._to_device(batch)
        np.testing.assert_array_equal(on_device[0].numpy(),
                                      feeds[False]["image_a"])
        state = trainer.init_state()
        preprocess = {"crop_height": 64, "crop_width": 64, "image_a": {},
                      "image_b": {}}
        metrics = trainer.train_step(state, batch, preprocess)
        losses[raw] = float(metrics["loss"])
    assert np.isfinite(losses[True])
    assert losses[True] == losses[False]
