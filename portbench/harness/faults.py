"""Faults planted in the program underneath a run, for the tests (and
the readings) that show a broken timed path comes out as not correct.

Each is a context manager that patches the port's module attributes
that the drivers look up at run time, and restores them after."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def unchanged_state():
    """A train step that returns its state unchanged: Adam's update is
    skipped."""
    import torch

    step = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.Adam.step = step


@contextlib.contextmanager
def half_batch():
    """Half of each batch left out of the step, the mean taken over the
    rest."""
    from flownet2_tf_tpu_torch.training import loop

    step = loop.Trainer.train_step

    def half(self, state, batch, preprocess=None):
        n = batch["image_a"].shape[0] // 2
        return step(self, state, {k: v[:n] for k, v in batch.items()},
                    preprocess)

    loop.Trainer.train_step = half
    try:
        yield
    finally:
        loop.Trainer.train_step = step


@contextlib.contextmanager
def altered_answer():
    """The first pair's flow of every call halved where it is
    produced."""
    from flownet2_tf_tpu_torch.training import infer

    forward = infer.forward_flow

    def altered(model, a, b, compute_dtype=None):
        flow = forward(model, a, b, compute_dtype).clone()
        flow[0] *= 0.5
        return flow

    infer.forward_flow = altered
    try:
        yield
    finally:
        infer.forward_flow = forward


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer}
