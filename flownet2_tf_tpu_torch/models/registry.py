"""Model registry: CLI names -> model classes, losses and frozen scopes.

Port of ``flownet2_tf_tpu/models/registry.py``, with the same names,
aliases, losses and ``default_frozen`` scopes. ``get_model(name)`` returns
a :class:`ModelSpec`; ``build(device, warp_res=1, fusion_res=1,
bf16_interconv=False, f32_features="highest")`` makes the ``nn.Module``
(weights zero until ``training/warmstart.py`` loads them or
``models/common.py::msra_init_`` draws them). The knobs, which the JAX
package reads from thread-local and environment state at trace time, are
build arguments here: ``warp_res`` is the stack warps' grid factor of the
stacked models (``models/stacks.py``), ``fusion_res`` FlowNet2's fusion
grid, ``bf16_interconv`` whether the interconvs (FlowNetSD's and
FlowNet2's) follow the bf16 compute dtype, ``f32_features`` the feature
layers' precision on the f32 path (``models/common.py::
set_f32_features``). :meth:`ModelSpec.build_for` leaves each knob a
model does not read at its default, as the JAX package's knobs leave
such a model. Every model's forward is
``model(inputs, compute_dtype=None)``, the JAX ``apply(params, inputs,
compute_dtype=...)``: None or ``torch.float32`` runs the f32 path,
``torch.bfloat16`` the bf16 policy of ``models/common.py``.
"""

from __future__ import annotations

import dataclasses

from torch import nn

from typing import Callable

from flownet2_tf_tpu_torch.models import (
    common,
    flownet_c,
    flownet_s,
    flownet_sd,
    stacks,
)


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
    # whether the model has the fusion net (and so takes a fusion_res)
    fusion: bool = False
    # whether the model has interconvs (and so takes a bf16_interconv)
    interconvs: bool = False

    def build(self, device="cuda", warp_res: int = 1, fusion_res: int = 1,
              bf16_interconv: bool = False,
              f32_features: str = "highest") -> nn.Module:
        """The module on ``device`` (the card by default, like every entry
        point of the port; pass ``"cpu"`` for the CPU) in eval mode.
        ``warp_res``: the stack warps' grid factor (1, 2 or 4);
        ``fusion_res``: FlowNet2's fusion grid factor (1 or 2); models
        without stack warps or without a fusion net take only 1.
        ``bf16_interconv``: the interconvs follow the bf16 compute dtype
        (models without interconvs have nothing to change);
        ``f32_features``: ``"highest"`` or ``"default"`` (TF32 feature
        layers on the f32 path)."""
        kwargs = {}
        for knob, value, takes, part in (
                ("warp_res", warp_res, self.stack_warps, "stack warps"),
                ("fusion_res", fusion_res, self.fusion, "fusion net")):
            if takes:
                kwargs[knob] = int(value)
            elif value != 1:
                raise ValueError(f"{self.name} has no {part}: {knob} must "
                                 f"be 1, got {value!r}")
        if self.interconvs:
            kwargs["bf16_interconv"] = bool(bf16_interconv)
        model = self.cls(**kwargs)
        common.set_f32_features(model, f32_features)
        return model.to(device).eval()

    def build_for(self, device="cuda", warp_res: int = 1,
                  fusion_res: int = 1, bf16_interconv: bool = False,
                  f32_features: str = "highest") -> nn.Module:
        """:meth:`build` with the knobs a flag asked for, each knob this
        model does not read left at its default (``warp_res_for``,
        ``fusion_res_for``)."""
        return self.build(device, warp_res=self.warp_res_for(warp_res),
                          fusion_res=self.fusion_res_for(fusion_res),
                          bf16_interconv=bf16_interconv,
                          f32_features=f32_features)

    def warp_res_for(self, warp_res: int) -> int:
        """The ``warp_res`` to build with: ``warp_res`` for a model with
        stack warps, 1 for one without, which a warp flag leaves
        unchanged (as the JAX package's warp knobs leave it)."""
        return int(warp_res) if self.stack_warps else 1

    def fusion_res_for(self, fusion_res: int) -> int:
        """The ``fusion_res`` to build with: ``fusion_res`` for FlowNet2,
        1 for the models without a fusion net, which the JAX package's
        knob leaves unchanged (only ``apply_flownet2`` reads it)."""
        return int(fusion_res) if self.fusion else 1


_REGISTRY = {
    "s": ModelSpec("FlowNetS", flownet_s.FlowNetS, flownet_s.loss),
    "c": ModelSpec("FlowNetC", flownet_c.FlowNetC, flownet_c.loss),
    "cs": ModelSpec("FlowNetCS", stacks.FlowNetCS, stacks.loss_cs,
                    default_frozen=("FlowNetC",), stack_warps=True),
    "css": ModelSpec("FlowNetCSS", stacks.FlowNetCSS, stacks.loss_css,
                     default_frozen=("FlowNetCS",), stack_warps=True),
    "sd": ModelSpec("FlowNetSD", flownet_sd.FlowNetSD, flownet_sd.loss,
                    interconvs=True),
    "2": ModelSpec("FlowNet2", stacks.FlowNet2, stacks.loss_flownet2,
                   default_frozen=("FlowNetCSS", "FlowNetSD"),
                   stack_warps=True, fusion=True, interconvs=True),
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
