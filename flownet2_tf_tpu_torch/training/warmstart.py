"""Weights across the two packages: JAX-layout parameter trees <-> modules,
and stage warm-starting.

Port of ``flownet2_tf_tpu/training/warmstart.py`` (``flatten``,
``unflatten``, ``load_params_tree``, ``get_scope``, ``set_scope``,
``apply_warm_starts``) plus the two-way bridge :func:`load_jax_params` /
:func:`to_jax_params`. A tree is the JAX package's nested dict of numpy
arrays, keyed by slim scope paths
(``FlowNetCSS/FlowNetCS/FlowNetC/conv1/weights``); the port's module
paths mirror those scopes (``FlowNetCSS.FlowNetCS.FlowNetC.conv1``), so the
mapping is by name, plus a layout change per layer kind:

* conv weights HWIO -> OIHW;
* deconv weights, stored in forward-conv HWIO for an input-dilated conv
  with pad 2 -> the spatially flipped ``conv_transpose2d`` layout
  (in, out, kh, kw) (ROADMAP trap C2).

Sources are a ``.npz`` of flat '/'-joined paths (the JAX package's
converter and ``export``, and the port's own checkpoints), or a port run
directory (``training/loop.py``), whose newest checkpoint is read. The
JAX package's orbax run directories are not read.
"""

from __future__ import annotations

import copy
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


PARAMS_FILE = "params.npz"


def latest_checkpoint(path):
    """The newest ``<step>/`` directory under a port run directory (or its
    ``checkpoints/``), or None."""
    path = os.fspath(path)
    if os.path.isdir(os.path.join(path, "checkpoints")):
        path = os.path.join(path, "checkpoints")
    if not os.path.isdir(path):
        return None
    steps = [int(e) for e in os.listdir(path)
             if e.isdigit()
             and os.path.isfile(os.path.join(path, e, PARAMS_FILE))]
    return os.path.join(path, str(max(steps))) if steps else None


def load_params_tree(path):
    """Load a parameter tree from a ``.npz`` of flattened '/'-joined paths,
    or from a port run directory (its newest ``<step>/params.npz``)."""
    path = os.fspath(path)
    if os.path.isfile(os.path.join(path, PARAMS_FILE)):
        path = os.path.join(path, PARAMS_FILE)
    elif not path.endswith(".npz"):
        step_dir = latest_checkpoint(path)
        if step_dir is None:
            raise ValueError(
                f"{path}: only .npz parameter files and run directories of "
                "the torch port are supported (orbax run directories: "
                "export them to .npz with the JAX package's `cli export`)"
            )
        path = os.path.join(step_dir, PARAMS_FILE)
    with np.load(path) as data:
        return unflatten({k: data[k] for k in data.files})


def get_scope(tree, scope: str):
    """'' -> whole tree; 'A/B' -> tree['A']['B']."""
    if not scope:
        return tree
    node = tree
    for part in scope.split("/"):
        node = node[part]
    return node


def set_scope(tree, scope: str, value):
    if not scope:
        return value
    parts = scope.split("/")
    node = tree
    for part in parts[:-1]:
        node = node[part]
    node[parts[-1]] = value
    return tree


def _check_compatible(dst, src, scope):
    dst_flat = flatten(dst)
    src_flat = flatten(src)
    missing = sorted(set(dst_flat) - set(src_flat))
    extra = sorted(set(src_flat) - set(dst_flat))
    if missing or extra:
        raise ValueError(
            f"warm-start scope {scope!r} mismatch: missing {missing[:5]} "
            f"extra {extra[:5]} (of {len(missing)}/{len(extra)})"
        )
    for k in dst_flat:
        if tuple(dst_flat[k].shape) != tuple(src_flat[k].shape):
            raise ValueError(
                f"warm-start shape mismatch at {scope}/{k}: "
                f"{src_flat[k].shape} vs expected {dst_flat[k].shape}"
            )


def apply_warm_starts(params, checkpoints):
    """Splice prior-stage checkpoints into a parameter tree.

    ``checkpoints``: the reference-style dict {path: (src_scope,
    dst_scope)}, or an iterable of (path, src_scope, dst_scope) tuples,
    which can splice several sub-scopes out of one checkpoint. Key sets
    and shapes are checked. Returns a new tree.
    """
    if isinstance(checkpoints, dict):
        entries = [(p, s, d) for p, (s, d) in checkpoints.items()]
    else:
        entries = [tuple(e) for e in checkpoints]
    params = copy.deepcopy(params)
    for path, src_scope, dst_scope in entries:
        sub = get_scope(load_params_tree(path), src_scope)
        _check_compatible(get_scope(params, dst_scope), sub, dst_scope)
        params = set_scope(params, dst_scope, sub)
    return params


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


def layer_params(module: nn.Module):
    """``[(scope, to_jax, weights, biases)]``: each Conv/Deconv layer's
    live f32 parameters (detached, on their device) and the function that
    relays its weights out to the JAX layout."""
    return [(scope, layer.to_jax, layer.weights.detach().float(),
             layer.biases.detach().float())
            for scope, layer in _layers(module)]


def jax_layout(params):
    """:func:`layer_params`' parameters (or host copies of them) as a flat
    JAX-layout dict of new numpy arrays: conv weights OIHW -> HWIO, deconv
    weights unflipped back to forward-conv HWIO (trap C2)."""
    flat = {}
    for scope, to_jax, weights, biases in params:
        # copies: on the CPU .numpy() would alias the tensors given
        flat[_key(scope, "weights")] = np.array(
            to_jax(weights.cpu().numpy()), order="C")
        flat[_key(scope, "biases")] = np.array(biases.cpu().numpy())
    return flat


def to_jax_params(module: nn.Module):
    """``module``'s parameters as a JAX-layout tree of f32 numpy arrays
    (the inverse of :func:`load_jax_params`)."""
    return unflatten(jax_layout(layer_params(module)))
