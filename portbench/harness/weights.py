"""Seeded weights, made on the device in a few large calls and handed
to both the program and the reference."""

from __future__ import annotations

import torch

BIAS_STD = 0.01
_U63 = (1 << 63) - 1


def generator(seed, stream, device):
    """A generator on ``device`` for one use (``stream``) of ``seed``;
    any whole number is a seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) & _U63)
    return g


def make_params(specs, seed, device):
    """``{name: f32 tensor}`` for ``[(name, shape, fan_in)]``: weights
    MSRA (std sqrt(2 / fan_in), a normal cut at +-2 std), biases normal
    with std ``BIAS_STD``. One flat buffer, drawn in one call; the
    tensors are views of it."""
    sizes = [torch.Size(shape).numel() for _, shape, _ in specs]
    stds = torch.tensor(
        [(2.0 / fan_in) ** 0.5 if name.endswith(".weights") else BIAS_STD
         for name, _, fan_in in specs], dtype=torch.float32, device=device)
    flat = torch.randn(sum(sizes), generator=generator(seed, 1, device),
                       device=device)
    flat.clamp_(-2.0, 2.0).mul_(torch.repeat_interleave(
        stds, torch.tensor(sizes, device=device)))
    out, at = {}, 0
    for (name, shape, _), n in zip(specs, sizes):
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out
