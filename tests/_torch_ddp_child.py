"""One rank of a data-parallel run of the port's trainer on the CPU (gloo),
for tests/test_torch_parallel.py and tests/test_torch_rank_augment.py.

    python tests/_torch_ddp_child.py SPEC.json

The environment names the group (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``, or the JAX package's manual names).
The spec says what to run; the rank writes ``<result>.<rank>.json`` (its
metrics) and ``<result>.<rank>.npz`` (its parameters in the JAX layout):

* ``mode: "steps"``: ``Trainer.train_step`` on this rank's shard of the
  global batch in ``batch`` (an .npz), ``steps`` times, after loading the
  JAX-layout weights in ``params`` when given. The model is first
  initialised from ``seed + rank``, so that DDP's broadcast from rank 0
  shows in ``init.<rank>.npz``;
* ``mode: "fit"``: ``Trainer.fit`` over the shard for ``steps`` steps,
  checkpointing into ``log_dir``; then a fresh trainer's
  ``restore_or_init`` and an ``evaluate`` over a rank-own eval batch.
  With ``fail_after: n`` the loader raises after n batches instead, and
  the rank records the error it got from ``fit``;
* ``mode: "augment"``: every rank takes the same local batch (the first
  ``len(batch) // world`` examples, as every loader of ``cli train``
  yields the same batches) and ``Trainer.fit`` runs ``steps`` steps with
  augmentation on (``preprocess``) from one seed. Each step's augmented
  ``image_a`` goes to ``<result>.<rank>.aug.npz``. A second run stops
  after one step, and a fresh trainer resumes it from its checkpoint to
  ``steps``: its parameters go to ``<result>.<rank>.resumed.npz``;
* ``mode: "async"``: ``Trainer.fit`` for ``steps`` steps with an
  asynchronous checkpoint after each into ``log_dir``, then the same
  steps driven by hand with ``train_step`` and ``save(wait=True)`` into
  ``<log_dir>_sync``. The rank records the steps whose checkpoints it
  wrote (``writes``).
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

torch.set_num_threads(1)

from flownet2_tf_tpu_torch.data import augmentation  # noqa: E402
from flownet2_tf_tpu_torch.parallel import mesh  # noqa: E402
from flownet2_tf_tpu_torch.training import warmstart  # noqa: E402
from flownet2_tf_tpu_torch.training.loop import TrainConfig, Trainer  # noqa: E402

# tests/_mp_child.py's schedule: the JAX package's two-process test
SCHEDULE = {"name": "mp-test", "step_values": [100],
            "learning_rates": [1e-4, 1e-4], "momentum": 0.9,
            "momentum2": 0.999, "weight_decay": 0.0, "max_iter": 2}


class ShardLoader:
    """Yields the same local shard forever (``start_batch`` ignored), or
    raises after ``fail_after`` batches."""

    def __init__(self, shard, fail_after=None):
        self.shard = shard
        self.fail_after = fail_after

    def batches(self, start_batch=0, epochs=None):
        n = 0
        while epochs is None or n < epochs:
            if n == self.fail_after:
                raise RuntimeError(f"loader failed after {n} batches")
            yield dict(self.shard)
            n += 1


def _flat(model):
    return warmstart.flatten(warmstart.to_jax_params(model))


def _augmented_runs(cfg, shard, spec, prefix):
    """``mode: "augment"``: the uninterrupted run (its augmented inputs
    recorded) and the run resumed at step 1; returns the first."""
    real = augmentation.augment_batch
    drawn = []

    def spy(gen, image_a, image_b, flow, preprocess):
        out = real(gen, image_a, image_b, flow, preprocess)
        drawn.append(out[0].numpy().copy())
        return out

    cfg = dict(cfg, augment=True)
    pre, steps = spec["preprocess"], spec["steps"]
    augmentation.augment_batch = spy
    try:
        state = Trainer(TrainConfig(**cfg)).fit(
            ShardLoader(shard), preprocess=pre, max_steps=steps)
    finally:
        augmentation.augment_batch = real
    np.savez(f"{prefix}.aug.npz", *drawn)
    cfg["log_dir"] = spec["log_dir"] + "_resumed"
    Trainer(TrainConfig(**cfg)).fit(ShardLoader(shard), preprocess=pre,
                                    max_steps=1)
    resumed = Trainer(TrainConfig(**cfg)).fit(
        ShardLoader(shard), preprocess=pre, max_steps=steps)
    np.savez(f"{prefix}.resumed.npz", **_flat(resumed.model))
    return state


def _async_and_sync_runs(cfg, shard, spec, out):
    """``mode: "async"``: the fit with asynchronous saves, then the
    synchronous run by hand; returns the fit's state."""
    writes = []
    real = Trainer._write_checkpoint

    def counted(self, step, *args):
        writes.append(step)
        return real(self, step, *args)

    cfg = dict(cfg, checkpoint_every=1, keep_checkpoints=1)
    Trainer._write_checkpoint = counted
    try:
        state = Trainer(TrainConfig(**cfg)).fit(ShardLoader(shard),
                                                max_steps=spec["steps"])
        sync = Trainer(TrainConfig(**dict(
            cfg, log_dir=spec["log_dir"] + "_sync")))
        sync_state = sync.init_state()
        for _ in range(spec["steps"]):
            sync.train_step(sync_state, shard)
            sync.save(sync_state, wait=True)
    finally:
        Trainer._write_checkpoint = real
    out["writes"] = writes
    return state


def main(spec_path):
    with open(spec_path) as f:
        spec = json.load(f)
    assert mesh.maybe_initialize_distributed(True, device="cpu",
                                             timeout_s=120)
    try:
        rank, world = mesh.process_index(), mesh.process_count()
        with np.load(spec["batch"]) as z:
            full = {k: z[k] for k in z.files}
        local = len(full["image_a"]) // world
        first = 0 if spec["mode"] == "augment" else rank * local
        shard = {k: v[first:first + local] for k, v in full.items()}
        cfg = dict(model=spec["model"], schedule=SCHEDULE,
                   log_dir=spec["log_dir"], device="cpu",
                   compute_dtype="float32", augment=False,
                   tensorboard=False, checkpoint_every=0, log_every=1,
                   grad_accum=spec.get("grad_accum", 1),
                   remat=spec.get("remat", False), frozen=spec.get("frozen"))
        out = {"rank": rank, "world": world}
        prefix = f"{spec['result']}.{rank}"
        if spec["mode"] == "steps":
            trainer = Trainer(TrainConfig(seed=rank, **cfg))
            state = trainer.init_state()
            out["ddp"] = state.ddp is not None
            np.savez(f"{spec['result']}.init.{rank}.npz",
                     **_flat(state.model))
            if spec.get("params"):
                warmstart.load_jax_params(
                    state.model, warmstart.load_params_tree(spec["params"]))
            for i in range(spec["steps"]):
                metrics = trainer.train_step(state, shard)
                for k in ("loss", "data_loss", "epe", "grad_norm"):
                    out[f"{k}{i}"] = float(metrics[k])
        elif spec["mode"] == "augment":
            state = _augmented_runs(cfg, shard, spec, prefix)
        elif spec["mode"] == "async":
            state = _async_and_sync_runs(cfg, shard, spec, out)
        elif spec.get("fail_after"):
            trainer = Trainer(TrainConfig(**cfg))
            state = trainer.init_state()
            try:
                trainer.fit(ShardLoader(shard, spec["fail_after"]),
                            max_steps=spec["steps"], state=state)
            except RuntimeError as e:
                out["error"] = str(e)
        else:
            trainer = Trainer(TrainConfig(**cfg))
            state = trainer.fit(ShardLoader(shard), max_steps=spec["steps"])
            restored, resumed = Trainer(TrainConfig(**cfg)).restore_or_init()
            out["resumed"] = resumed
            out["restored_step"] = restored.step
            out["restored_equal"] = all(
                torch.equal(a, b) for a, b in zip(
                    restored.model.parameters(), state.model.parameters()))
            eval_shard = {k: v[:1] + rank for k, v in shard.items()}
            out["val_epe"] = trainer.evaluate(
                state, ShardLoader(eval_shard), max_batches=1)
        np.savez(prefix + ".npz", **_flat(state.model))
        with open(prefix + ".json", "w") as f:
            json.dump(out, f)
    finally:
        mesh.shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
