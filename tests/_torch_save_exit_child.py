"""A process that saves a checkpoint asynchronously and exits at once, for
tests/test_torch_async_checkpoint.py.

    python tests/_torch_save_exit_child.py SPEC.json

The spec names the trainer (``config``: ``TrainConfig`` fields) and the
result file. The child trains one step on a seeded batch, writes each
parameter's SHA-256 (JAX layout) to the result file, calls
``Trainer.save(state)`` without waiting and returns from ``main``. Its
writer is held for ``hold_s`` seconds first, so the interpreter is
already on its way out when the write begins.
"""

import hashlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

torch.set_num_threads(1)

from flownet2_tf_tpu_torch.data.loader import SyntheticFlowDataset  # noqa: E402
from flownet2_tf_tpu_torch.training import warmstart  # noqa: E402
from flownet2_tf_tpu_torch.training.loop import TrainConfig, Trainer  # noqa: E402


def batch(n, height, width, seed):
    """A seeded synthetic batch of ``n`` pairs."""
    ds = SyntheticFlowDataset(size=n, height=height, width=width, seed=seed)
    return {k: np.stack([ds[i][k] for i in range(n)])
            for k in ("image_a", "image_b", "flow")}


def digests(model):
    """SHA-256 of each JAX-layout parameter's bytes."""
    return {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in warmstart.flatten(
                warmstart.to_jax_params(model)).items()}


def main(spec_path):
    with open(spec_path) as f:
        spec = json.load(f)
    trainer = Trainer(TrainConfig(**spec["config"]))
    state = trainer.init_state()
    trainer.train_step(state, batch(**spec["batch"]))
    with open(spec["result"], "w") as f:
        json.dump({"step": state.step, "digests": digests(state.model)}, f)
    write = trainer._write_checkpoint

    def held(*args):
        time.sleep(spec["hold_s"])
        write(*args)

    trainer._write_checkpoint = held
    trainer.save(state)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
