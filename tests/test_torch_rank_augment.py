"""Augmentation under data parallelism: each rank of a process group
augments its local batch with draws of its own (``training/loop.py::
step_seed``), as the JAX step's one key gives each process's slice of the
global array its own draws. A ``torch.Generator`` cannot reproduce JAX's
draws, so these tests hold the structure, not the numbers.

Ranks run in child processes (``tests/_torch_ddp_child.py``, mode
``augment``) over gloo on the CPU, FlowNetS at 64x64 with the FlyingChairs
augmentation spec, every rank on the same local batch from one seed. Each
child is bounded by ``utils/procs.py`` (its own session, a timeout, its
group killed when the wait ends).
"""

import json
import os
import shutil
import socket
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from flownet2_tf_tpu_torch.data import dataset_configs  # noqa: E402
from flownet2_tf_tpu_torch.training import warmstart  # noqa: E402
from flownet2_tf_tpu_torch.training.loop import (  # noqa: E402
    TrainConfig,
    Trainer,
    step_seed,
)
from flownet2_tf_tpu_torch.utils import procs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import _torch_ddp_child as tchild  # noqa: E402

CHILD = os.path.join(REPO, "tests", "_torch_ddp_child.py")
# a child's hard limit (s): the ranks start, run 2 + 1 + 1 steps and exit
# in ~20 s
CHILD_TIMEOUT_S = 150
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "COORDINATOR_ADDRESS", "NUM_PROCESSES",
              "PROCESS_ID")
STEPS = 2
LOCAL_BATCH = 2

@pytest.fixture(autouse=True)
def _drop_test_files(tmp_path):
    """Each run here writes FlowNetC checkpoints of about 150 MB: delete what each test wrote when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)



def _preprocess():
    pre = dict(dataset_configs.FLYING_CHAIRS_DATASET_CONFIG["PREPROCESS"])
    pre["crop_height"], pre["crop_width"] = 64, 64
    return pre


def _batch(n=LOCAL_BATCH, h=64, w=64, seed=123):
    rng = np.random.RandomState(seed)
    return {"image_a": rng.rand(n, h, w, 3).astype(np.float32),
            "image_b": rng.rand(n, h, w, 3).astype(np.float32),
            "flow": (rng.rand(n, h, w, 2) * 4 - 2).astype(np.float32)}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _run_ranks(tmp_path, world):
    """``world`` ranks of the child in mode ``augment``, each with the
    same local batch of ``LOCAL_BATCH``; returns per rank its augmented
    inputs by step, its parameters and its resumed run's parameters.
    The children's files (checkpoints of ~460 MB each) are deleted once
    read, so no more than one run's files are on disk at a time."""
    tmp_path = tmp_path / f"ranks{world}"
    tmp_path.mkdir()
    try:
        return _read_ranks(tmp_path, world)
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)


def _read_ranks(tmp_path, world):
    batch = tmp_path / "batch.npz"
    np.savez(batch, **_batch(LOCAL_BATCH * world))
    spec = {"mode": "augment", "model": "s", "batch": str(batch),
            "steps": STEPS, "preprocess": _preprocess(),
            "result": str(tmp_path / "result"),
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
                [sys.executable, CHILD, str(spec_path)], str(log),
                env=dict(env, RANK=str(rank), WORLD_SIZE=str(world),
                         MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))),
                log))
        for rank, (proc, log) in enumerate(started):
            rc = procs.wait(proc, CHILD_TIMEOUT_S)
            assert rc == 0, (rank, log.read_text()[-3000:])
    finally:
        for proc, _ in started:
            procs.kill_group(proc)
    out = []
    for rank in range(world):
        prefix = f"{spec['result']}.{rank}"
        drawn = _load(prefix + ".aug.npz")
        out.append({"aug": [drawn[f"arr_{i}"] for i in range(len(drawn))],
                    "params": _load(prefix + ".npz"),
                    "resumed": _load(prefix + ".resumed.npz")})
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("rank_augment")
    yield _run_ranks(tmp_path, 2)
    shutil.rmtree(tmp_path, ignore_errors=True)


def _assert_params_equal(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_step_seed_is_distinct_per_rank_and_unchanged_at_rank_0():
    """Rank 0 keeps the single-process seed ``((seed + 17) << 32) +
    step``; at every step of a long run no two of 64 ranks share a seed."""
    for seed in (0, 1, 7, 2 ** 31):
        for step in (0, 1, 5, 12345, 2 ** 32 - 1):
            assert step_seed(seed, step) == step_seed(seed, step, 0) == (
                ((seed + 17) << 32) + step) & (2 ** 64 - 1)
    for step in range(0, 100_000, 997):
        seeds = {step_seed(0, step, r) for r in range(64)}
        assert len(seeds) == 64, step


def test_ranks_draw_different_augmentations(two_ranks):
    """Same local batch, same seed, augmentation on: at each step the two
    ranks' augmented ``image_a`` differ (they were bitwise equal when
    every rank seeded from ``(seed, step)`` alone)."""
    for step in range(STEPS):
        a0, a1 = two_ranks[0]["aug"][step], two_ranks[1]["aug"][step]
        assert a0.shape == a1.shape == (LOCAL_BATCH, 64, 64, 3)
        assert np.isfinite(a0).all() and np.isfinite(a1).all()
        # most pixels move under another affine draw and another noise
        assert np.mean(a0 != a1) > 0.9, step
    assert len(two_ranks[0]["aug"]) == STEPS


def test_ranks_stay_bitwise_equal_with_augmentation(two_ranks):
    """DDP averages the ranks' gradients: the parameters after 2
    augmented steps are bitwise equal across the ranks."""
    _assert_params_equal(two_ranks[1]["params"], two_ranks[0]["params"])


def test_two_rank_resume_repeats_the_run(two_ranks):
    """A 2-rank run stopped after step 1 and resumed from its checkpoint
    by fresh trainers ends bitwise where the uninterrupted run does."""
    for rank in range(2):
        _assert_params_equal(two_ranks[rank]["resumed"],
                             two_ranks[0]["params"])


def test_world_size_1_is_the_plain_augmented_step(tmp_path):
    """One rank in a group of 1 (DDP-wrapped) against the plain
    ``Trainer`` in this process, augmentation on: 2 steps bitwise equal,
    and the same draws."""
    (rank0,) = _run_ranks(tmp_path, 1)
    trainer = Trainer(TrainConfig(
        model="s", schedule=tchild.SCHEDULE, log_dir=str(tmp_path / "one"),
        device="cpu", compute_dtype="float32", augment=True,
        tensorboard=False, checkpoint_every=0, log_every=1))
    with open(os.devnull, "w") as devnull:
        stdout, sys.stdout = sys.stdout, devnull
        try:
            state = trainer.fit(tchild.ShardLoader(_batch()),
                                preprocess=_preprocess(), max_steps=STEPS)
        finally:
            sys.stdout = stdout
    assert state.ddp is None and state.step == STEPS
    _assert_params_equal(
        rank0["params"],
        warmstart.flatten(warmstart.to_jax_params(state.model)))
    _assert_params_equal(rank0["resumed"], rank0["params"])
