"""Reference-compatible facade: ``Mode`` and ``Net``.

Port of ``flownet2_tf_tpu/net.py``: the reference's ``src/net.py``
surface (``Net.train(log_dir, training_schedule, ...)``, ``Net.test(
checkpoint, input_a_path, input_b_path, out_path, save_image,
save_flo)``, a ``Mode`` enum), mapped onto the port's runtime
(``training/loop.py::Trainer``, ``training/infer.py::test_pair``). New
code should use those modules directly. The device is explicit, ``cuda``
unless the caller asks for ``cpu``.
"""

from __future__ import annotations

import enum


class Mode(enum.Enum):
    TRAIN = 1
    TEST = 2


class Net:
    """Compatibility wrapper around the registry, Trainer and infer."""

    def __init__(self, model_name: str, mode: Mode = Mode.TRAIN,
                 debug: bool = False, device: str = "cuda"):
        from flownet2_tf_tpu_torch.models.registry import get_model

        self.model_name = model_name
        self.model = get_model(model_name)
        self.mode = mode
        self.debug = debug
        self.device = device
        if debug:
            # the counterpart of the JAX package's jax_debug_nans: raise
            # where a backward produces a NaN
            import torch

            torch.autograd.set_detect_anomaly(True)

    # -- inference ---------------------------------------------------------

    def test(self, checkpoint, input_a_path, input_b_path, out_path,
             save_image: bool = True, save_flo: bool = False):
        from flownet2_tf_tpu_torch.training.infer import test_pair

        return test_pair(
            self.model_name, checkpoint, input_a_path, input_b_path,
            out_path, save_image=save_image, save_flo=save_flo,
            device=self.device,
        )

    # -- training ----------------------------------------------------------

    def train(self, log_dir, training_schedule, loader, preprocess=None,
              checkpoints=None, max_steps=None):
        """Train; ``loader`` is a BatchLoader (the queue-runner
        replacement for the reference's (input_a, input_b, flow) tensor
        triple); ``checkpoints`` follows the reference warm-start dict
        {path: (src_scope, dst_scope)}."""
        from flownet2_tf_tpu_torch.training.loop import TrainConfig, Trainer

        cfg = TrainConfig(
            model=self.model_name,
            schedule=training_schedule,
            log_dir=log_dir,
            augment=preprocess is not None,
            max_steps=max_steps,
            device=self.device,
        )
        trainer = Trainer(cfg)
        return trainer.fit(
            loader, preprocess=preprocess,
            warm_start_checkpoints=checkpoints,
        )


# Concrete per-model classes, mirroring the reference's exported zoo.

class FlowNetS(Net):
    def __init__(self, mode: Mode = Mode.TRAIN, debug: bool = False,
                 device: str = "cuda"):
        super().__init__("s", mode, debug, device)


class FlowNetC(Net):
    def __init__(self, mode: Mode = Mode.TRAIN, debug: bool = False,
                 device: str = "cuda"):
        super().__init__("c", mode, debug, device)


class FlowNetCS(Net):
    def __init__(self, mode: Mode = Mode.TRAIN, debug: bool = False,
                 device: str = "cuda"):
        super().__init__("cs", mode, debug, device)


class FlowNetCSS(Net):
    def __init__(self, mode: Mode = Mode.TRAIN, debug: bool = False,
                 device: str = "cuda"):
        super().__init__("css", mode, debug, device)


class FlowNetSD(Net):
    def __init__(self, mode: Mode = Mode.TRAIN, debug: bool = False,
                 device: str = "cuda"):
        super().__init__("sd", mode, debug, device)


class FlowNet2(Net):
    def __init__(self, mode: Mode = Mode.TRAIN, debug: bool = False,
                 device: str = "cuda"):
        super().__init__("2", mode, debug, device)
