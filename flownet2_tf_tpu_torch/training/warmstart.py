"""Weights across the two packages: JAX-layout parameter trees <-> modules.

Port of the ``.npz`` half of ``flownet2_tf_tpu/training/warmstart.py``
(``flatten``, ``unflatten``, ``load_params_tree``) plus the bridge
:func:`load_jax_params`. A tree is the JAX package's nested dict of numpy
arrays, keyed by slim scope paths
(``FlowNetCSS/FlowNetCS/FlowNetC/conv1/weights``); the port's module
paths mirror those scopes (``FlowNetCSS.FlowNetCS.FlowNetC.conv1``), so the
mapping is by name, plus a layout change per layer kind:

* conv weights HWIO -> OIHW;
* deconv weights, stored in forward-conv HWIO for an input-dilated conv
  with pad 2 -> the spatially flipped ``conv_transpose2d`` layout
  (in, out, kh, kw) (ROADMAP trap C2).

Orbax run directories are not read yet.
"""

from __future__ import annotations

import math
import os
from typing import Dict

import numpy as np
import torch
from torch import nn

from flownet2_tf_tpu_torch.models.common import Conv, Deconv

_LAYERS = (Conv, Deconv)


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten(flat: Dict[str, np.ndarray]):
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def load_params_tree(path):
    """Load a parameter tree from a ``.npz`` of flattened '/'-joined paths
    (what the JAX package's converter and ``export`` write)."""
    path = os.fspath(path)
    if not path.endswith(".npz"):
        raise ValueError(
            f"{path}: only .npz parameter files are supported by the torch "
            "port (orbax run directories: export them to .npz with the JAX "
            "package's `cli export`)"
        )
    with np.load(path) as data:
        return unflatten({k: data[k] for k in data.files})


def _layers(module: nn.Module):
    """(scope path, layer) for every Conv/Deconv of ``module``; raises if
    any parameter lives outside those layers."""
    layers = [
        (name.replace(".", "/"), m)
        for name, m in module.named_modules()
        if isinstance(m, _LAYERS)
    ]
    covered = sum(p.numel() for _, m in layers for p in m.parameters())
    total = sum(p.numel() for p in module.parameters())
    if covered != total:
        raise TypeError(
            f"{type(module).__name__} has parameters outside Conv/Deconv "
            "layers; the JAX bridge cannot map them"
        )
    return layers


def _key(scope, leaf):
    return f"{scope}/{leaf}" if scope else leaf


def jax_param_shapes(module: nn.Module) -> Dict[str, tuple]:
    """The flat JAX-layout key -> shape spec of ``module``'s parameters,
    i.e. what ``flatten(model.init(key))`` holds in the JAX package."""
    shapes = {}
    for scope, layer in _layers(module):
        shapes[_key(scope, "weights")] = layer.jax_shape(
            tuple(layer.weights.shape))
        shapes[_key(scope, "biases")] = tuple(layer.biases.shape)
    return shapes


def random_jax_params(module: nn.Module, seed: int = 0):
    """A seeded JAX-layout tree for ``module``: MSRA-scaled normal weights
    (std sqrt(2 / fan_in)) and zero biases, from ``numpy.random``. For
    runs that need realistic random weights without the JAX package."""
    rng = np.random.RandomState(seed)
    flat = {}
    for key, shape in sorted(jax_param_shapes(module).items()):
        if len(shape) == 1:  # biases
            flat[key] = np.zeros(shape, np.float32)
        else:
            kh, kw, cin, _ = shape
            std = math.sqrt(2.0 / (kh * kw * cin))
            flat[key] = (rng.standard_normal(shape) * std).astype(np.float32)
    return unflatten(flat)


def load_jax_params(module: nn.Module, tree) -> nn.Module:
    """Fill ``module`` from a JAX-layout parameter tree (nested or flat).

    Raises on any missing key, extra key or shape mismatch, like the JAX
    package's ``_check_compatible``. Returns ``module``.
    """
    flat = flatten(tree)  # a flat '/'-keyed dict passes through unchanged
    want = jax_param_shapes(module)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(
            f"parameter tree mismatch for {type(module).__name__}: missing "
            f"{missing[:5]} extra {extra[:5]} (of {len(missing)}/{len(extra)})"
        )
    for k, shape in want.items():
        if tuple(flat[k].shape) != tuple(shape):
            raise ValueError(
                f"parameter shape mismatch at {k}: {tuple(flat[k].shape)} "
                f"vs expected {tuple(shape)}"
            )
    with torch.no_grad():
        for scope, layer in _layers(module):
            w = layer.from_jax(flat[_key(scope, "weights")])
            layer.weights.copy_(torch.from_numpy(np.ascontiguousarray(w)))
            layer.biases.copy_(torch.from_numpy(
                np.asarray(flat[_key(scope, "biases")])))
    return module
