"""Optimizer assembly: Adam + piecewise-constant LR + L2 weight decay +
stage freezing.

Port of ``flownet2_tf_tpu/training/optim.py`` (optax there):

* ``torch.optim.Adam(betas=(momentum, momentum2), eps=1e-8)``, optax's
  ``adam`` update. The trainer sets the rate to ``lr_fn(step)`` at the
  step count before the update, as optax's schedule reads its count.
* L2 goes into the loss as ``weight_decay * sum(0.5 * ||w||^2)`` over the
  ``weights`` of trainable scopes, biases excluded (slim's
  ``weights_regularizer``). Neither Adam's ``weight_decay=`` (which decays
  biases too, and adds inside the moments without the 0.5) nor AdamW
  (decoupled decay) computes this.
* Frozen top-level scopes (``registry.default_frozen``) get no gradient
  at all and stay out of the optimizer, so their parameters stay bitwise
  fixed.

Parameters are named by module path (``FlowNetC.conv1.weights``); a
scope is the first component.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from flownet2_tf_tpu_torch.utils.schedules import get_schedule, make_lr_schedule


def make_optimizer(params, schedule):
    """Adam over ``params`` for ``schedule`` (dict or name); returns
    ``(optimizer, lr_fn)``. The rate starts at ``lr_fn(0)``."""
    if isinstance(schedule, str):
        schedule = get_schedule(schedule)
    lr_fn = make_lr_schedule(schedule)
    opt = torch.optim.Adam(
        params,
        lr=lr_fn(0),
        betas=(schedule.get("momentum", 0.9), schedule.get("momentum2", 0.999)),
        eps=1e-8,
    )
    return opt, lr_fn


def set_lr(optimizer, lr: float):
    for group in optimizer.param_groups:
        group["lr"] = lr


def mask_frozen(named: Dict[str, torch.Tensor], frozen: Sequence[str],
                keep_trainable: bool = True) -> Dict[str, torch.Tensor]:
    """``named`` ({module path: tensor}) with the frozen top-level scopes
    dropped (``keep_trainable``) or kept exclusively (not)."""
    return {
        k: v for k, v in named.items()
        if (k.split(".")[0] not in frozen) == keep_trainable
    }


def l2_regularization(model: nn.Module, frozen: Sequence[str] = ()):
    """weight_decay-ready L2 term: ``sum(0.5 * ||w||^2)`` over the
    ``weights`` of trainable scopes (biases excluded)."""
    trainable = mask_frozen(dict(model.named_parameters()), frozen)
    terms = [0.5 * torch.sum(torch.square(p.float()))
             for k, p in trainable.items() if k.rsplit(".", 1)[-1] == "weights"]
    return torch.stack(terms).sum()


def zero_frozen_grads(model: nn.Module, frozen: Sequence[str]) -> nn.Module:
    """Frozen top-level scopes take no gradient: ``requires_grad`` off, so
    autograd never enters them (the counterpart of the JAX package's
    zeroed grads and ``stop_gradient``), and any stale ``.grad`` dropped.
    A frozen FlowNetC therefore never launches the correlation backward."""
    for name in frozen:
        sub = getattr(model, name, None)
        if sub is None:
            raise KeyError(f"frozen scope {name!r} is not a sub-module of "
                           f"{type(model).__name__}")
        for p in sub.parameters():
            p.requires_grad_(False)
            p.grad = None
    return model
