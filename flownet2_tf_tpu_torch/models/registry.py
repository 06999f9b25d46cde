"""Model registry: CLI names -> model classes, losses and frozen scopes.

Port of ``flownet2_tf_tpu/models/registry.py``, with the same names,
aliases, losses and ``default_frozen`` scopes. ``get_model(name)`` returns
a :class:`ModelSpec`; ``build(device, warp_res=1)`` makes the
``nn.Module`` (weights zero until ``training/warmstart.py`` loads them or
``models/common.py::msra_init_`` draws them); ``warp_res`` is the stack
warps' grid factor of the stacked models (``models/stacks.py``). Every model's forward is
``model(inputs, compute_dtype=None)``, the JAX ``apply(params, inputs,
compute_dtype=...)``: None or ``torch.float32`` runs the f32 path,
``torch.bfloat16`` the bf16 policy of ``models/common.py``.
"""

from __future__ import annotations

import dataclasses

from torch import nn

from typing import Callable

from flownet2_tf_tpu_torch.models import flownet_c, flownet_s, flownet_sd, stacks


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    cls: type
    # loss(flow_gt, predictions) -> scalar data loss
    loss: Callable
    # top-level sub-modules (parameter scopes) frozen in stacked training
    default_frozen: tuple = ()
    # whether the model has stack warps (and so takes a warp_res)
    stack_warps: bool = False

    def build(self, device="cuda", warp_res: int = 1) -> nn.Module:
        """The module on ``device`` (the card by default, like every entry
        point of the port; pass ``"cpu"`` for the CPU) in eval mode.
        ``warp_res``: the stack warps' grid factor (1, 2 or 4); models
        without stack warps take only 1."""
        if self.stack_warps:
            return self.cls(warp_res).to(device).eval()
        if warp_res != 1:
            raise ValueError(f"{self.name} has no stack warps: warp_res "
                             f"must be 1, got {warp_res!r}")
        return self.cls().to(device).eval()

    def warp_res_for(self, warp_res: int) -> int:
        """The ``warp_res`` to build with: ``warp_res`` for a model with
        stack warps, 1 for one without, which a warp flag leaves
        unchanged (as the JAX package's warp knobs leave it)."""
        return int(warp_res) if self.stack_warps else 1


_REGISTRY = {
    "s": ModelSpec("FlowNetS", flownet_s.FlowNetS, flownet_s.loss),
    "c": ModelSpec("FlowNetC", flownet_c.FlowNetC, flownet_c.loss),
    "cs": ModelSpec("FlowNetCS", stacks.FlowNetCS, stacks.loss_cs,
                    default_frozen=("FlowNetC",), stack_warps=True),
    "css": ModelSpec("FlowNetCSS", stacks.FlowNetCSS, stacks.loss_css,
                     default_frozen=("FlowNetCS",), stack_warps=True),
    "sd": ModelSpec("FlowNetSD", flownet_sd.FlowNetSD, flownet_sd.loss),
    "2": ModelSpec("FlowNet2", stacks.FlowNet2, stacks.loss_flownet2,
                   default_frozen=("FlowNetCSS", "FlowNetSD"),
                   stack_warps=True),
}

# aliases matching the reference package names
_ALIASES = {
    "flownet_s": "s",
    "flownet_c": "c",
    "flownet_cs": "cs",
    "flownet_css": "css",
    "flownet_sd": "sd",
    "flownet2": "2",
    "flownet-2": "2",
}

MODEL_NAMES = tuple(_REGISTRY)


def get_model(name: str) -> ModelSpec:
    key = name.lower()
    key = _ALIASES.get(key, key)
    try:
        return _REGISTRY[key]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(_REGISTRY)}"
        ) from None
