"""The rest of the port's trainer against the JAX package, on the CPU: the
synthetic dataset's motion regimes, ``cache`` and ``uint8_images``; the
device prefetcher (``parallel/mesh.py``); ``remat``; the TensorBoard
image summaries; and the device default of ``ModelSpec.build``. Each
comparison states its tolerance.
"""

import inspect
import os
import shutil
import struct
import threading
import time
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from flownet2_tf_tpu.data import loader as jloader  # noqa: E402
from flownet2_tf_tpu.data import tfrecord as jtfrecord  # noqa: E402
from flownet2_tf_tpu.models.registry import get_model as jax_model  # noqa: E402
from flownet2_tf_tpu.ops import dispatch  # noqa: E402
from flownet2_tf_tpu.parallel import mesh as jmesh  # noqa: E402
from flownet2_tf_tpu.training import loop as jloop  # noqa: E402
from flownet2_tf_tpu.training import warmstart as jws  # noqa: E402
from flownet2_tf_tpu.utils import tensorboard as jtensorboard  # noqa: E402
from flownet2_tf_tpu_torch import cli  # noqa: E402
from flownet2_tf_tpu_torch.data import loader  # noqa: E402
from flownet2_tf_tpu_torch.models import common, flownet_c  # noqa: E402
from flownet2_tf_tpu_torch.models.registry import ModelSpec, get_model  # noqa: E402
from flownet2_tf_tpu_torch.parallel import mesh  # noqa: E402
from flownet2_tf_tpu_torch.training import loop, warmstart  # noqa: E402
from flownet2_tf_tpu_torch.training.loop import TrainConfig, Trainer  # noqa: E402
from flownet2_tf_tpu_torch.utils import tensorboard  # noqa: E402

SMOKE_SCHEDULE = {"name": "smoke", "step_values": [40],
                  "learning_rates": [3e-4, 1e-4], "momentum": 0.9,
                  "momentum2": 0.999, "weight_decay": 1e-6, "max_iter": 60}


@pytest.fixture(autouse=True)
def _drop_run_dirs(tmp_path):
    """Checkpoints of these tests are ~0.5 GB each: delete them when the
    test ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _cfg(tmp_path, name, **kw):
    base = dict(model="s", schedule=SMOKE_SCHEDULE,
                log_dir=str(tmp_path / name), device="cpu", log_every=1000,
                checkpoint_every=0, tensorboard=False,
                compute_dtype="float32", augment=False)
    base.update(kw)
    return TrainConfig(**base)


def _batch(n=2, h=64, w=64, seed=0):
    ds = loader.SyntheticFlowDataset(size=n, height=h, width=w, seed=seed)
    return {k: np.stack([ds[i][k] for i in range(n)])
            for k in ("image_a", "image_b", "flow")}


# ---------------------------------------------------------------------------
# The synthetic dataset's regimes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("motion,uint8_images,cache", [
    (m, u8, cache) for m in ("default", "large", "subpixel", "mixed")
    for u8, cache in ((False, False), (True, True))])
def test_synthetic_regimes_are_byte_identical(motion, uint8_images, cache):
    """Every motion regime, with and without ``uint8_images`` and
    ``cache``: images and flows byte-identical to the JAX package's."""
    kw = dict(size=4, height=64, width=96, seed=3, motion=motion,
              uint8_images=uint8_images, cache=cache)
    ours, ref = loader.SyntheticFlowDataset(**kw), \
        jloader.SyntheticFlowDataset(**kw)
    for i in range(len(ref)):
        for k in ("image_a", "image_b", "flow"):
            want = ref[i][k]
            assert ours[i][k].dtype == want.dtype == (
                np.uint8 if uint8_images and k != "flow" else np.float32)
            assert ours[i][k].tobytes() == want.tobytes(), (i, k)
    assert (ours[1] is ours[1]) == cache  # a cached scene is kept
    with pytest.raises(ValueError, match="motion"):
        loader.SyntheticFlowDataset(motion="fast")


# ---------------------------------------------------------------------------
# DevicePrefetcher (tests/test_training.py:516-612 for the port)
# ---------------------------------------------------------------------------

def test_device_prefetcher_yields_all_batches_and_propagates_errors():
    """Every source batch in order as (host, device) pairs, and a source
    exception reaches the consumer as itself."""
    batches = [{"x": np.full((2, 4), i, np.float32),
                "u8": np.full((2, 3), i, np.uint8)} for i in range(5)]
    pf = mesh.DevicePrefetcher(iter(batches), "cpu")
    seen = []
    for host, dev in pf:
        assert isinstance(dev["x"], torch.Tensor)
        assert dev["u8"].dtype == torch.uint8  # dtypes cross unchanged
        np.testing.assert_array_equal(dev["x"].numpy(), host["x"])
        seen.append(int(host["x"][0, 0]))
    assert seen == [0, 1, 2, 3, 4]
    pf.close()

    def boom():
        yield {"x": np.zeros((2, 4), np.float32)}
        raise RuntimeError("decode failed")

    pf = mesh.DevicePrefetcher(boom(), "cpu")
    next(pf)
    try:
        with pytest.raises(RuntimeError, match="decode failed"):
            next(pf)
    finally:
        pf.close()


def test_device_prefetcher_close_stops_worker():
    def endless():
        i = 0
        while True:
            yield {"x": np.full((2, 4), i, np.float32)}
            i += 1

    pf = mesh.DevicePrefetcher(endless(), "cpu")
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()


def test_device_prefetcher_close_shuts_down_loader_producer():
    """``close`` over a real BatchLoader stream ends the loader's producer
    thread too: the worker is joined before the source generator is
    closed."""
    ds = loader.SyntheticFlowDataset(size=16, height=32, width=32, seed=0)
    bl = loader.BatchLoader(ds, batch_size=2, shuffle=False, num_workers=1,
                            prefetch=1)
    before = set(threading.enumerate())
    pf = mesh.DevicePrefetcher(bl.batches(), "cpu", depth=1)
    next(pf)
    pf.close()
    deadline = time.time() + 10.0
    while time.time() < deadline:
        leaked = [t for t in threading.enumerate()
                  if t not in before and t.is_alive()]
        if not leaked:
            break
        time.sleep(0.05)
    assert not leaked, [t.name for t in leaked]


def test_device_prefetcher_inline_mode():
    """``threaded=False`` stages on the consumer's thread with the same
    iteration; the trainer's modes map as the JAX package's, 'auto'
    being 'thread'."""
    batches = [{"x": np.full((2, 4), i, np.float32)} for i in range(3)]
    pf = mesh.DevicePrefetcher(iter(batches), "cpu", threaded=False)
    assert [int(h["x"][0, 0]) for h, d in pf] == [0, 1, 2]
    pf.close()
    for mode in ("thread", "inline"):
        assert loop._use_threaded_prefetch(mode) is \
            jloop._use_threaded_prefetch(mode)
    assert loop._use_threaded_prefetch("auto") is True
    with pytest.raises(ValueError, match="device_prefetch"):
        loop._use_threaded_prefetch("bogus")
    with pytest.raises(ValueError, match="device_prefetch"):
        Trainer(TrainConfig(device="cpu", device_prefetch="bogus"))


def test_fit_threaded_and_inline_prefetch_agree(tmp_path):
    """Two 3-step fits, the batches staged by the worker thread and
    inline, with a bf16 flow on the wire and augmentation on: the same
    batch order reaches the steps, so the checkpoints are bitwise
    equal."""
    pre = {"crop_height": 64, "crop_width": 64, "image_a": {},
           "image_b": {}}
    params = {}
    for mode in ("thread", "inline"):
        ds = loader.SyntheticFlowDataset(size=6, height=64, width=96,
                                         seed=4, uint8_images=True)
        bl = loader.BatchLoader(ds, batch_size=2, num_workers=2)
        trainer = Trainer(_cfg(tmp_path, mode, device_prefetch=mode,
                               augment=True,
                               transfer_flow_dtype="bfloat16"))
        state = trainer.fit(bl, preprocess=pre, max_steps=3)
        assert state.step == 3
        params[mode] = warmstart.flatten(
            warmstart.load_params_tree(tmp_path / mode))
    for k, v in params["thread"].items():
        assert np.array_equal(v, params["inline"][k]), k


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def _correlation_calls(monkeypatch):
    calls = []
    real = flownet_c.correlation

    def spy(*args, **kwargs):
        calls.append(torch.is_grad_enabled())
        return real(*args, **kwargs)

    monkeypatch.setattr(flownet_c, "correlation", spy)
    return calls


@pytest.mark.parametrize("model", ["s", "c", "cs"])
def test_remat_step_is_bitwise_the_step(tmp_path, monkeypatch, model):
    """One f32 step with remat and one without, from the same init and
    batch: the loss, the grad norm and every updated parameter bitwise
    equal. The correlation runs twice under remat (its segment is
    recomputed in the backward), once without, and not again for a
    frozen FlowNetC (FlowNetCS), which runs no segment."""
    calls = _correlation_calls(monkeypatch)
    batch = _batch()
    out = {}
    for remat in (False, True):
        del calls[:]
        trainer = Trainer(_cfg(tmp_path, f"r{remat}", model=model,
                               remat=remat))
        state = trainer.init_state()
        metrics = trainer.train_step(state, batch)
        out[remat] = (metrics, [p.detach().clone()
                                for p in state.model.parameters()])
        if model == "c":
            assert len(calls) == (2 if remat else 1), calls
        if model == "cs":
            assert len(calls) == 1
    for k in ("loss", "data_loss", "epe", "grad_norm"):
        assert torch.equal(out[True][0][k], out[False][0][k]), k
    for got, want in zip(out[True][1], out[False][1]):
        assert torch.equal(got, want)


def test_segment_checkpoints_only_what_needs_a_gradient(monkeypatch):
    """A segment is checkpointed only inside ``common.remat``, with grad
    enabled, and when a parameter of its net or an input needs a
    gradient; otherwise (a frozen stage on plain inputs) it is a plain
    call. A checkpointed segment runs again in the backward."""
    import torch.utils.checkpoint as tuc

    net = get_model("s").build("cpu")
    checkpoints, calls = [], []
    real = tuc.checkpoint

    def spy(fn, *args, **kwargs):
        checkpoints.append(kwargs)
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(tuc, "checkpoint", spy)

    def fn(x):
        calls.append(torch.is_grad_enabled())
        return torch.sin(x)  # saves x: the backward unpacks it

    x, const = torch.ones(2, requires_grad=True), torch.ones(2)
    with common.remat(False):
        common.segment(net, fn, x)
    with common.remat(True), torch.no_grad():
        common.segment(net, fn, x)
    with common.remat(True):
        common.segment(net.requires_grad_(False), fn, const)
    assert not checkpoints and calls == [True, False, True]
    with common.remat(True):
        common.segment(net.requires_grad_(True), fn, const)
        y = common.segment(net.requires_grad_(False), fn, x)
    assert [kw["use_reentrant"] for kw in checkpoints] == [False, False]
    y.sum().backward()
    assert calls == [True, False, True, True, True, True]  # + recompute
    assert torch.equal(x.grad, torch.cos(torch.ones(2)))


def test_remat_step_matches_jax_remat_step(tmp_path):
    """The port's remat step against the JAX package's (``TrainConfig(
    remat=True)``, tests/test_training.py:413) from the same JAX-initialised
    FlowNetS weights and batch: the loss to rtol 1e-5 and the grad norm to
    rtol 1e-4, and each leaf's gradient against JAX's ``jax.checkpoint``
    gradient to a relative L2 error of 1e-4 (f32 sums in another order, as
    in ``test_full_loss_gradient_matches_jax``)."""
    batch = _batch(seed=5)
    jtrainer = jloop.Trainer(
        jloop.TrainConfig(model="s", schedule=SMOKE_SCHEDULE,
                          log_dir=str(tmp_path / "jax"), augment=False,
                          compute_dtype="float32", remat=True,
                          tensorboard=False, checkpoint_every=0),
        mesh=jmesh.make_mesh(jax.devices()[:1]))
    with dispatch.use_s2d(False):
        jstate = jtrainer.init_state()
        params = jax.device_get(jstate["params"])
        step_fn = jtrainer.get_step_fn(None)
        _, jmetrics = step_fn(jstate, jmesh.shard_batch(jtrainer.mesh, batch),
                              jax.random.PRNGKey(0))

        jm = jax_model("s")
        apply = jax.checkpoint(
            lambda p, inp: jm.apply(p, inp, training=True),
            policy=jax.checkpoint_policies.dots_with_no_batch_dims_saveable)

        def loss_fn(p):
            preds = apply(p, {"input_a": batch["image_a"],
                              "input_b": batch["image_b"]})
            return jm.loss(batch["flow"], preds) + SMOKE_SCHEDULE[
                "weight_decay"] * jloop.optim.l2_regularization(p)

        want = jws.flatten(jax.device_get(jax.jit(jax.grad(loss_fn))(params)))

    trainer = Trainer(_cfg(tmp_path, "port", remat=True))
    state = trainer.init_state()
    warmstart.load_jax_params(state.model, params)
    metrics = trainer.train_step(state, batch)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jmetrics["grad_norm"]), rtol=1e-4)
    with torch.no_grad():  # grads into the weights, then the JAX layout
        for p in state.model.parameters():
            p.copy_(p.grad)
    got = warmstart.flatten(warmstart.to_jax_params(state.model))
    assert got.keys() == want.keys()
    for k in want:
        w = np.asarray(want[k])
        err = np.linalg.norm(got[k] - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= 1e-4, (k, err)


# ---------------------------------------------------------------------------
# Image summaries
# ---------------------------------------------------------------------------

def _events(log_dir):
    files = [f for f in os.listdir(log_dir) if "tfevents" in f]
    assert len(files) == 1
    return list(jtfrecord.read_records(os.path.join(log_dir, files[0])))


def _image_events(records):
    """[(step, tag, png)] of the image values in event records, parsed
    with the JAX package's protobuf reader."""
    out = []
    for rec in records:
        event = {f: v for f, v, _ in jtfrecord._iter_fields(rec)}
        for field, value, _ in jtfrecord._iter_fields(event.get(5, b"")):
            val = {f: v for f, v, _ in jtfrecord._iter_fields(value)}
            if field == 1 and 4 in val:
                image = {f: v for f, v, _ in jtfrecord._iter_fields(val[4])}
                out.append((event[2], val[1].decode(), image[4]))
    return out


def _png_pixels(png):
    """(H, W, 3) uint8 of an 8-bit RGB, filter-0 PNG (``encode_png8``'s
    form), its chunk CRCs checked."""
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(png):
        (n,) = struct.unpack(">I", png[pos:pos + 4])
        tag, data = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", png[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + data) & 0xFFFFFFFF
        chunks[tag] = data
        pos += 12 + n
    w, h = struct.unpack(">II", chunks[b"IHDR"][:8])
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


def test_image_records_are_byte_identical_to_jax(tmp_path, rng):
    """``encode_png8`` and ``SummaryWriter.image`` (and the scalar
    events) give the JAX writer's bytes for the same array, tag and step;
    only the event's wall time (its first 9 bytes) differs."""
    img = rng.randint(0, 256, (13, 21, 3), dtype=np.uint8)
    png = tensorboard.encode_png8(img)
    assert png == jtensorboard.encode_png8(img)
    np.testing.assert_array_equal(_png_pixels(png), img)
    for name, module in (("port", tensorboard), ("jax", jtensorboard)):
        w = module.SummaryWriter(str(tmp_path / name))
        w.image("pred_flow", img, 7)
        w.scalars({"loss": 1.5, "epe": 0.25}, 7)
        w.close()
    port, ref = _events(tmp_path / "port"), _events(tmp_path / "jax")
    assert len(port) == len(ref) == 3
    assert port[0][9:] == ref[0][9:]
    for a, b in zip(port[1:], ref[1:]):
        assert a[:1] == b[:1] == b"\x09"  # field 1, 64-bit: the wall time
        assert a[9:] == b[9:]


def test_fit_writes_four_images_per_summary(tmp_path):
    """``image_summary_every=2`` over a 4-step FlowNetS fit on uint8
    images with a crop: four images at steps 2 and 4 (inputs, predicted
    and GT flows) at the crop's size, each a valid PNG; the inputs are
    the cropped first example."""
    pre = {"crop_height": 64, "crop_width": 64, "image_a": {},
           "image_b": {}}
    ds = loader.SyntheticFlowDataset(size=4, height=64, width=96, seed=1,
                                     uint8_images=True)
    bl = loader.BatchLoader(ds, batch_size=2, shuffle=False, num_workers=1)
    trainer = Trainer(_cfg(tmp_path, "run", tensorboard=True,
                           image_summary_every=2, augment=True))
    trainer.fit(bl, preprocess=pre, max_steps=4)
    images = [(step, tag, _png_pixels(png))
              for step, tag, png in _image_events(_events(tmp_path / "run"))]
    assert [(s, t) for s, t, _ in images] == [
        (s, t) for s in (2, 4)
        for t in ("input_a", "input_b", "pred_flow", "gt_flow")]
    assert all(px.shape == (64, 64, 3) for _, _, px in images)
    # step 4 summarised batch 2, whose first example is ds[2]
    want = np.uint8(np.clip(ds[2]["image_a"][:, 16:80] / np.float32(255),
                            0, 1) * 255)
    np.testing.assert_array_equal(images[4][2], want)


def test_cli_train_remat_and_image_summaries(tmp_path, capsys, monkeypatch):
    """``cli train --remat --image_summary_every 1`` (FlowNetC, f32, 2
    steps): the correlation runs twice per step (forward and recompute)
    and once per summary, under no_grad; the help texts and defaults are
    the JAX CLI's."""
    from flownet2_tf_tpu import cli as jcli

    calls = _correlation_calls(monkeypatch)
    rc = cli.main(["train", "--model", "c", "--synthetic",
                   "--synthetic_size", "2", "--synthetic_height", "64",
                   "--synthetic_width", "64", "--batch_size", "2",
                   "--schedule", "short", "--log_every", "1", "--max_steps",
                   "2", "--log_dir", str(tmp_path / "run"),
                   "--compute_dtype", "float32", "--device", "cpu",
                   "--remat", "--image_summary_every", "1",
                   "--checkpoint_every", "0"])
    assert rc == 0
    assert calls == [True, True, False] * 2
    assert [(s, t) for s, t, _ in _image_events(
        _events(tmp_path / "run"))] == [
        (s, t) for s in (1, 2)
        for t in ("input_a", "input_b", "pred_flow", "gt_flow")]

    def flags(parser):
        sub = next(a for a in parser._actions if a.dest == "command")
        train = sub.choices["train"]
        return {a.dest: (a.default, a.help) for a in train._actions
                if a.dest in ("remat", "image_summary_every")}

    assert flags(cli.build_parser()) == flags(jcli.build_parser())


# ---------------------------------------------------------------------------
# The entry points' device default
# ---------------------------------------------------------------------------

def test_model_spec_builds_on_the_card_by_default():
    """``ModelSpec.build()`` defaults to ``"cuda"`` like every other entry
    point; the CPU takes ``"cpu"``."""
    assert inspect.signature(ModelSpec.build).parameters[
        "device"].default == "cuda"
    assert next(get_model("s").build("cpu").parameters()).device.type == \
        "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            get_model("s").build()
