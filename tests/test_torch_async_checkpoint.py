"""Asynchronous checkpoint saving in the port's trainer
(``training/loop.py::Trainer.save``) against the JAX package's orbax
manager (``enable_async_checkpointing=True``), on the CPU.

``save(state)`` returns once the state is copied to the host and a writer
thread writes ``<step>/``; ``save(state, wait=True)`` returns once it is
on disk. FlowNetS at 64x64, f32, as in tests/test_torch_train.py. A write
is held at a gate (a wrapped ``_write_checkpoint`` waiting on a
``threading.Event``) where a test must act while it is in flight. Every
comparison of checkpoints is bitwise. Each checkpoint is about 460 MB
(the parameters and Adam's two moments), so each test's ``tmp_path`` is
deleted when it ends. Child processes are bounded by ``utils/procs.py``.
"""

import hashlib
import inspect
import json
import os
import shutil
import socket
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from flownet2_tf_tpu.models.registry import get_model as jax_model  # noqa: E402
from flownet2_tf_tpu.training import loop as jloop  # noqa: E402
from flownet2_tf_tpu.training import warmstart as jws  # noqa: E402
from flownet2_tf_tpu_torch.data import dataset_configs, loader  # noqa: E402
from flownet2_tf_tpu_torch.training import warmstart  # noqa: E402
from flownet2_tf_tpu_torch.training.loop import (  # noqa: E402
    OPTIMIZER_FILE,
    TrainConfig,
    Trainer,
)
from flownet2_tf_tpu_torch.utils import procs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAVE_EXIT_CHILD = os.path.join(REPO, "tests", "_torch_save_exit_child.py")
DDP_CHILD = os.path.join(REPO, "tests", "_torch_ddp_child.py")
# the longest a test waits for a thread or a held write (s)
WAIT_S = 120
# how long a save that must be blocked is watched before it is released
BLOCKED_S = 0.5
# a child's hard limit (s): it starts, trains one or two steps, saves and
# exits in ~30 s
CHILD_TIMEOUT_S = 240
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "COORDINATOR_ADDRESS", "NUM_PROCESSES",
              "PROCESS_ID")

SMOKE_SCHEDULE = {"name": "smoke", "step_values": [40],
                  "learning_rates": [3e-4, 1e-4], "momentum": 0.9,
                  "momentum2": 0.999, "weight_decay": 1e-6, "max_iter": 60}


@pytest.fixture(autouse=True)
def _drop_run_dirs(tmp_path):
    """Delete each test's checkpoints (~460 MB each) when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _cfg(tmp_path, name, **kw):
    base = dict(model="s", schedule=SMOKE_SCHEDULE,
                log_dir=str(tmp_path / name), device="cpu", log_every=1000,
                checkpoint_every=0, tensorboard=False,
                compute_dtype="float32", augment=False)
    base.update(kw)
    return TrainConfig(**base)


def _batch(seed, n=2, h=64, w=64):
    ds = loader.SyntheticFlowDataset(size=n, height=h, width=w, seed=seed)
    return {k: np.stack([ds[i][k] for i in range(n)])
            for k in ("image_a", "image_b", "flow")}


def _ckpt(tmp_path, name, step):
    return tmp_path / name / "checkpoints" / str(step)


def _steps_on_disk(tmp_path, name):
    return sorted(os.listdir(tmp_path / name / "checkpoints"))


def _read(step_dir):
    """(params.npz as a dict, optimizer.pt as saved) of one checkpoint."""
    with np.load(step_dir / warmstart.PARAMS_FILE) as z:
        params = {k: z[k] for k in z.files}
    return params, torch.load(step_dir / OPTIMIZER_FILE, weights_only=True)


def _assert_same_tree(a, b, path="optimizer.pt"):
    """Equal nested containers; tensors equal bitwise, in dtype and
    shape."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}/{i}")
    else:
        assert a == b, path


def _assert_same_checkpoint(a_dir, b_dir):
    pa, oa = _read(a_dir)
    pb, ob = _read(b_dir)
    assert pa.keys() == pb.keys()
    for k in pa:
        assert pa[k].dtype == pb[k].dtype and np.array_equal(pa[k], pb[k]), k
    _assert_same_tree(oa, ob)


def _flat_params(model):
    return warmstart.flatten(warmstart.to_jax_params(model))


class _Gate:
    """Holds every write of ``trainer`` until :meth:`release`: its
    ``_write_checkpoint``, wrapped, waits on an event; ``committed`` lists
    the steps whose writes returned, in order."""

    def __init__(self, trainer):
        self.open = threading.Event()
        self.entered = threading.Event()
        self.committed = []
        write = trainer._write_checkpoint

        def held(step, *args):
            self.entered.set()
            if not self.open.wait(WAIT_S):
                raise TimeoutError("the gate was never released")
            write(step, *args)
            self.committed.append(step)

        trainer._write_checkpoint = held

    def release(self):
        self.open.set()


@pytest.fixture
def gate():
    """``gate(trainer)`` -> a :class:`_Gate`; every gate is released, and
    every trainer's writer joined, when the test ends."""
    made = []

    def make(trainer):
        made.append((_Gate(trainer), trainer))
        return made[-1][0]

    yield make
    for g, trainer in made:
        g.release()
        if trainer._writer is not None:
            trainer._writer.join(WAIT_S)


def _in_thread(fn):
    """Run ``fn`` on a thread; returns (thread, its result or error)."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # read by the test
            out["error"] = e

    thread = threading.Thread(target=run, name="test-caller")
    thread.start()
    return thread, out


def test_save_keeps_the_jax_signature():
    """``save(state, wait=False)``, exactly the JAX package's parameters."""
    jax_params = list(inspect.signature(jloop.Trainer.save).parameters
                      .values())
    ours = list(inspect.signature(Trainer.save).parameters.values())
    assert [(p.name, p.default) for p in ours] == [
        (p.name, p.default) for p in jax_params]


def test_save_returns_while_the_write_is_held(tmp_path, gate):
    """(1) ``save()`` returns with its write held at the gate, and no
    ``<step>/`` exists until the gate opens. ``restore_or_init`` started
    meanwhile waits for the write and then resumes from it."""
    trainer = Trainer(_cfg(tmp_path, "run"))
    state = trainer.init_state()
    trainer.train_step(state, _batch(0))
    g = gate(trainer)
    trainer.save(state)
    assert g.entered.wait(WAIT_S)
    assert not _ckpt(tmp_path, "run", 1).exists()
    reader, out = _in_thread(trainer.restore_or_init)
    reader.join(BLOCKED_S)
    assert reader.is_alive(), "restore_or_init read before the write ended"
    assert not _ckpt(tmp_path, "run", 1).exists()
    g.release()
    reader.join(WAIT_S)
    assert not reader.is_alive()
    assert "error" not in out, out
    restored, resumed = out["value"]
    assert resumed and restored.step == 1
    assert _steps_on_disk(tmp_path, "run") == ["1"]
    assert g.committed == [1]
    want = _flat_params(state.model)
    got = _flat_params(restored.model)
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_step_during_the_write_does_not_reach_the_checkpoint(tmp_path,
                                                             gate):
    """(2) A ``train_step`` run while the write of step 1 is held changes
    the live parameters and Adam's moments and step counts in place; the
    checkpoint of step 1 is still bitwise that of ``save(wait=True)`` on
    a twin trainer at step 1 (every tensor of ``optimizer.pt`` and every
    array of ``params.npz``)."""
    trainer = Trainer(_cfg(tmp_path, "async"))
    state = trainer.init_state()
    twin = Trainer(_cfg(tmp_path, "sync"))
    twin_state = twin.init_state()
    for t, s in ((trainer, state), (twin, twin_state)):
        t.train_step(s, _batch(0))
    g = gate(trainer)
    trainer.save(state)
    assert g.entered.wait(WAIT_S)
    moments = {k: v.clone() for k, v in state.optimizer.state_dict()[
        "state"][0].items()}
    trainer.train_step(state, _batch(1))
    assert state.step == 2
    live = state.optimizer.state_dict()["state"][0]
    assert all(not torch.equal(live[k], moments[k]) for k in moments)
    g.release()
    trainer.wait_until_finished()
    twin.save(twin_state, wait=True)
    # wait=True returned after the write
    assert _steps_on_disk(tmp_path, "sync") == ["1"]
    assert _steps_on_disk(tmp_path, "async") == ["1"]
    _assert_same_checkpoint(_ckpt(tmp_path, "async", 1),
                            _ckpt(tmp_path, "sync", 1))
    params, saved = _read(_ckpt(tmp_path, "async", 1))
    assert saved["step"] == 1
    assert float(saved["optimizer"]["state"][0]["step"]) == 1.0
    now = _flat_params(state.model)
    assert any(not np.array_equal(now[k], params[k]) for k in params)


def test_second_save_waits_and_saves_commit_in_order(tmp_path, gate,
                                                     monkeypatch):
    """(3) A second ``save`` blocks until the first write has committed,
    and only then copies its own step (a save reuses the host buffers of
    the last one); the writes commit in step order, each holding its own
    step's parameters, and keep-K (2 here) removes an older checkpoint
    only after a newer one's rename."""
    events = []
    replace, rmtree = os.replace, shutil.rmtree

    def spy_replace(src, dst):
        events.append(("commit", os.path.basename(dst)))
        replace(src, dst)

    def spy_rmtree(path, *args, **kw):
        if os.path.exists(path):
            events.append(("remove", os.path.basename(path)))
        rmtree(path, *args, **kw)

    trainer = Trainer(_cfg(tmp_path, "run", keep_checkpoints=2))
    state = trainer.init_state()
    trainer.save(state, wait=True)
    monkeypatch.setattr(os, "replace", spy_replace)
    monkeypatch.setattr(shutil, "rmtree", spy_rmtree)
    g = gate(trainer)
    want = {}
    trainer.train_step(state, _batch(0))
    want[1] = _flat_params(state.model)
    trainer.save(state)
    assert g.entered.wait(WAIT_S)
    trainer.train_step(state, _batch(1))
    want[2] = _flat_params(state.model)
    second, out = _in_thread(lambda: trainer.save(state))
    second.join(BLOCKED_S)
    assert second.is_alive(), "the second save did not wait for the first"
    assert _steps_on_disk(tmp_path, "run") == ["0"]
    g.release()
    second.join(WAIT_S)
    assert not second.is_alive() and "error" not in out, out
    trainer.wait_until_finished()
    monkeypatch.undo()
    assert g.committed == [1, 2]
    assert _steps_on_disk(tmp_path, "run") == ["1", "2"]
    for step, params in want.items():
        saved, _ = _read(_ckpt(tmp_path, "run", step))
        assert saved.keys() == params.keys()
        for k in params:
            assert np.array_equal(saved[k], params[k]), (step, k)
    assert [e for e in events if e[0] == "commit"] == [("commit", "1"),
                                                       ("commit", "2")]
    assert [e for e in events if e[0] == "remove"] == [("remove", "0")]
    assert events.index(("remove", "0")) > events.index(("commit", "2"))


class _FailingSave:
    """``torch.save`` that raises ``OSError`` for the checkpoints of the
    given steps (after ``params.npz`` is in ``<step>.tmp/``), every time
    or only the first ``times`` times."""

    def __init__(self, steps, times=None):
        self.steps = set(steps)
        self.times = times
        self.real = torch.save

    def __call__(self, obj, path, *args, **kw):
        if isinstance(obj, dict) and obj.get("step") in self.steps and (
                self.times is None or self.times > 0):
            if self.times is not None:
                self.times -= 1
            raise OSError(28, "No space left on device (injected)")
        return self.real(obj, path, *args, **kw)


def test_failed_write_raises_at_the_next_save_and_at_the_wait(
        tmp_path, monkeypatch, capsys):
    """(4) A writer that raises ``OSError``: the error surfaces at the
    next ``save`` and at the wait, on this thread, once; no ``<step>/``
    or ``<step>.tmp/`` is left, the older checkpoint stays, and
    ``restore_or_init`` resumes from it."""
    trainer = Trainer(_cfg(tmp_path, "run", keep_checkpoints=1))
    state = trainer.init_state()
    trainer.save(state, wait=True)
    monkeypatch.setattr(torch, "save", _FailingSave({1, 2, 3}))
    state.step = 1
    trainer.save(state)
    state.step = 5
    with pytest.raises(OSError, match="injected") as info:
        trainer.save(state)
    assert any("checkpoint writer of step 1" in n
               for n in info.value.__notes__)
    assert "the checkpoint of step 1 was not written" in (
        capsys.readouterr().err)
    # the failed save wrote nothing: the trainer goes on
    assert trainer._writer is None
    state.step = 2
    trainer.save(state)
    with pytest.raises(OSError, match="injected"):
        trainer.wait_until_finished()
    trainer.wait_until_finished()  # raised once
    state.step = 3
    with pytest.raises(OSError, match="injected"):
        trainer.save(state, wait=True)
    assert _steps_on_disk(tmp_path, "run") == ["0"]
    monkeypatch.undo()
    restored, resumed = Trainer(_cfg(tmp_path, "run")).restore_or_init()
    assert resumed and restored.step == 0


def test_failed_write_raises_at_the_end_of_fit(tmp_path, monkeypatch):
    """(4) In ``fit``: a failed periodic write raises at the next save,
    whose step the interrupt checkpoint then writes; a failed last write
    raises at fit's final wait and leaves the previous checkpoint, which
    ``restore_or_init`` resumes from."""

    class Batches:
        def batches(self, start_batch=0):
            for i in range(start_batch, 100):
                yield _batch(i)

    cfg = _cfg(tmp_path, "run", checkpoint_every=1, keep_checkpoints=5)
    monkeypatch.setattr(torch, "save", _FailingSave({1}))
    with pytest.raises(OSError, match="injected"):
        Trainer(cfg).fit(Batches(), max_steps=3)
    assert _steps_on_disk(tmp_path, "run") == ["2"]

    monkeypatch.setattr(torch, "save", _FailingSave({3}))
    cfg = _cfg(tmp_path, "run", checkpoint_every=0)
    with pytest.raises(OSError, match="injected"):
        Trainer(cfg).fit(Batches(), max_steps=3)
    assert _steps_on_disk(tmp_path, "run") == ["2"]
    monkeypatch.undo()
    state, resumed = Trainer(cfg).restore_or_init()
    assert resumed and state.step == 2


def test_failed_last_write_is_written_again_by_the_interrupt_save(
        tmp_path, monkeypatch, capsys):
    """(4) A last write that fails once: ``fit`` raises its error at the
    final wait, and the interrupt checkpoint, seeing that step not on
    disk, writes it once more; the checkpoint is that of a synchronous
    save of the same step."""

    class Batches:
        def batches(self, start_batch=0):
            for i in range(start_batch, 100):
                yield _batch(i)

    monkeypatch.setattr(torch, "save", _FailingSave({2}, times=1))
    trainer = Trainer(_cfg(tmp_path, "run", checkpoint_every=0))
    with pytest.raises(OSError, match="injected") as info:
        trainer.fit(Batches(), max_steps=2)
    assert not any("a checkpoint write failed too" in n
                   for n in getattr(info.value, "__notes__", []))
    assert "the checkpoint of step 2 was not written" in (
        capsys.readouterr().err)
    assert _steps_on_disk(tmp_path, "run") == ["2"]
    monkeypatch.undo()

    sync = Trainer(_cfg(tmp_path, "sync"))
    state = sync.init_state()
    for i in range(2):
        sync.train_step(state, _batch(i))
    sync.save(state, wait=True)
    _assert_same_checkpoint(_ckpt(tmp_path, "run", 2),
                            _ckpt(tmp_path, "sync", 2))


def test_writer_error_while_fit_handles_another(tmp_path, monkeypatch,
                                                capsys):
    """(4) The data stream breaks while a write that will fail is in
    flight: ``fit`` re-raises the stream's error with the write's error
    noted on it and printed, and leaves no ``<step>/``."""

    class Failing:
        def batches(self, start_batch=0):
            for i in range(start_batch, 2):
                yield _batch(i)
            raise RuntimeError("stream broke")

    monkeypatch.setattr(torch, "save", _FailingSave({2}))
    trainer = Trainer(_cfg(tmp_path, "run", checkpoint_every=2))
    with pytest.raises(RuntimeError, match="stream broke") as info:
        trainer.fit(Failing(), max_steps=5)
    assert any("a checkpoint write failed too" in n and "injected" in n
               for n in info.value.__notes__)
    err = capsys.readouterr().err
    assert "a checkpoint write failed while fit was handling" in err
    assert "OSError" in err
    assert not (tmp_path / "run" / "checkpoints").exists() or (
        _steps_on_disk(tmp_path, "run") == [])


def test_process_exiting_after_save_leaves_a_complete_checkpoint(
        tmp_path):
    """(5) A child process trains a step, calls ``save()`` and returns
    from ``main`` while its write has not begun: the interpreter waits for
    the writer, and the checkpoint it leaves resumes bitwise here."""
    spec = {"config": dict(model="s", schedule=SMOKE_SCHEDULE,
                           log_dir=str(tmp_path / "run"), device="cpu",
                           tensorboard=False, checkpoint_every=0,
                           compute_dtype="float32", augment=False),
            "batch": {"n": 2, "height": 64, "width": 64, "seed": 0},
            "result": str(tmp_path / "digests.json"), "hold_s": 1.0}
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(spec))
    rc, output = procs.run([sys.executable, SAVE_EXIT_CHILD, str(spec_path)],
                           timeout=CHILD_TIMEOUT_S)
    assert rc == 0, output[-3000:]
    with open(spec["result"]) as f:
        child = json.load(f)
    assert child["step"] == 1
    assert _steps_on_disk(tmp_path, "run") == ["1"]
    assert sorted(os.listdir(_ckpt(tmp_path, "run", 1))) == sorted(
        [warmstart.PARAMS_FILE, OPTIMIZER_FILE])
    state, resumed = Trainer(TrainConfig(**spec["config"])).restore_or_init()
    assert resumed and state.step == 1
    assert len(state.optimizer.state) == len(list(state.model.parameters()))
    got = {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
           for k, v in _flat_params(state.model).items()}
    assert got == child["digests"]


def test_fit_checkpoints_are_those_of_synchronous_saves(tmp_path):
    """(6) ``fit`` with a checkpoint every step, interrupted at step 2
    and resumed to 4 as in ``test_resume_is_sample_exact`` (FlyingChairs
    augmentation, 64x64 crops): each checkpoint is bitwise that of the
    same step driven by hand with ``train_step`` and ``save(wait=True)``."""
    pre = dict(dataset_configs.FLYING_CHAIRS_DATASET_CONFIG["PREPROCESS"])
    pre["crop_height"], pre["crop_width"] = 64, 64

    def stream():
        ds = loader.SyntheticFlowDataset(size=8, height=64, width=96, seed=2)
        return loader.BatchLoader(ds, batch_size=2, num_workers=1)

    def cfg(name):
        return _cfg(tmp_path, name, augment=True, checkpoint_every=1,
                    keep_checkpoints=2)

    hand = Trainer(cfg("hand"))
    hand_state = hand.init_state()
    batches = stream().batches()
    try:
        for stop in (2, 4):
            state = Trainer(cfg("fit")).fit(stream(), preprocess=pre,
                                            max_steps=stop)
            assert state.step == stop
            while hand_state.step < stop:
                hand.train_step(hand_state, next(batches), pre)
                hand.save(hand_state, wait=True)
            kept = [str(stop - 1), str(stop)]
            assert _steps_on_disk(tmp_path, "fit") == kept
            assert _steps_on_disk(tmp_path, "hand") == kept
            for step in kept:
                _assert_same_checkpoint(_ckpt(tmp_path, "fit", step),
                                        _ckpt(tmp_path, "hand", step))
    finally:
        batches.close()


def test_jax_package_reads_the_async_checkpoint(tmp_path, gate):
    """(7) The JAX package's ``load_params_tree`` reads an asynchronous
    checkpoint written while the next step ran: the JAX model's shapes,
    and the port's parameters at the saved step, bitwise."""
    trainer = Trainer(_cfg(tmp_path, "run"))
    state = trainer.init_state()
    trainer.train_step(state, _batch(0))
    want = _flat_params(state.model)
    g = gate(trainer)
    trainer.save(state)
    assert g.entered.wait(WAIT_S)
    trainer.train_step(state, _batch(1))
    g.release()
    trainer.wait_until_finished()
    tree = jws.load_params_tree(
        str(_ckpt(tmp_path, "run", 1) / warmstart.PARAMS_FILE))
    abstract = jax.eval_shape(jax_model("s").init, jax.random.PRNGKey(0))
    shapes = {k: tuple(v.shape) for k, v in jws.flatten(
        jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0),
                                                         s.shape),
                               abstract)).items()}
    flat = jws.flatten(tree)
    assert {k: v.shape for k, v in flat.items()} == shapes
    assert flat.keys() == want.keys()
    for k in want:
        assert flat[k].dtype == np.float32, k
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_ranks_async_saves(tmp_path):
    """(8) Two gloo ranks (``tests/_torch_ddp_child.py``, mode ``async``,
    each bounded): ``fit`` with an asynchronous checkpoint each step ends
    on both ranks without a deadlock, only rank 0 writes, and the final
    checkpoint is bitwise that of the same steps saved synchronously."""
    steps, world = 2, 2
    batch = tmp_path / "batch.npz"
    np.savez(batch, **_batch(7, n=4))
    spec = {"mode": "async", "model": "s", "batch": str(batch),
            "steps": steps, "result": str(tmp_path / "result"),
            "log_dir": str(tmp_path / "run")}
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(spec))
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    started = []
    try:
        for rank in range(world):
            log = tmp_path / f"rank{rank}.log"
            started.append((procs.start(
                [sys.executable, DDP_CHILD, str(spec_path)], str(log),
                env=dict(env, RANK=str(rank), WORLD_SIZE=str(world),
                         MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))),
                log))
        for rank, (proc, log) in enumerate(started):
            rc = procs.wait(proc, CHILD_TIMEOUT_S)
            assert rc == 0, (rank, log.read_text()[-3000:])
    finally:
        for proc, _ in started:
            procs.kill_group(proc)
    results = []
    for rank in range(world):
        with open(f"{spec['result']}.{rank}.json") as f:
            results.append(json.load(f))
    assert results[0]["writes"] == [*range(1, steps + 1)] * 2
    assert results[1]["writes"] == []
    assert _steps_on_disk(tmp_path, "run") == [str(steps)]
    assert _steps_on_disk(tmp_path, "run_sync") == [str(steps)]
    _assert_same_checkpoint(_ckpt(tmp_path, "run", steps),
                            _ckpt(tmp_path, "run_sync", steps))
    params, _ = _read(_ckpt(tmp_path, "run", steps))
    for rank in range(world):
        with np.load(f"{spec['result']}.{rank}.npz") as z:
            for k in z.files:
                np.testing.assert_array_equal(z[k], params[k], err_msg=k)
