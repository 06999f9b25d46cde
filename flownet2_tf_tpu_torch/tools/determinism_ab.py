"""A/B of cuDNN's deterministic algorithms on the port's cells, on a card.

    python -m flownet2_tf_tpu_torch.tools.determinism_ab [--out FILE]
        [--cells SUBSTRING ...]

Every forward and train step of the port runs inside
``utils/precision.py::f32_policy``, which turns TF32 off and picks
cuDNN's deterministic algorithms under both policies; the f32 path's
deconvs run as sub-pixel convs (``models/common.py::deconv_subpixel``)
because cuDNN's deterministic f32 transposed conv is slow. This script
measures what those choices cost, in turns within one process, under
four settings:

* ``default``: TF32 off, cuDNN's default algorithms, the f32 deconvs as
  cuDNN's transposed conv (the port before its entry points were made
  repeatable);
* ``deterministic_transposed``: the deterministic algorithms with cuDNN's
  transposed conv for the f32 deconvs;
* ``port``: the port as it runs;
* ``bf16_default``: the port with cuDNN's default algorithms under the
  bf16 policy (deterministic on the f32 path only).

Cells: ``cli bench``'s FlowNet2 448x1024 forward (``tools/bench.py``),
f32 and bf16 at b1 and b8; ``benchlib.train_step_ms`` of FlowNetC (f32,
bf16) and FlowNetCSS (bf16) at b8 320x448. Then the price split by
layer: the device time of each conv and deconv of the f32 b1 FlowNet2
forward (f32 settings), of the bf16 b1 and b8 FlowNet2 forwards and of
the bf16 FlowNetC b8 320x448 train step (forward and backward of each
layer on its own input; ``port`` against ``bf16_default``). The settings are
applied by swapping the package's ``f32_policy`` and ``Deconv.forward``
for the run of one cell, and put back after it. ``--cells`` keeps the
cells whose name holds one of the substrings. It needs a CUDA card and
prints one JSON line per measurement, then a summary line.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

SETTINGS = ("default", "deterministic_transposed", "port", "bf16_default")
_POLICY_MODULES = (
    "flownet2_tf_tpu_torch.models.common",
    "flownet2_tf_tpu_torch.ops.downsample",
    "flownet2_tf_tpu_torch.data.augmentation",
    "flownet2_tf_tpu_torch.training.loop",
    "flownet2_tf_tpu_torch.tools.aot",
)


@contextlib.contextmanager
def _tf32_off_only(compute_dtype=None):
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def _transposed_forward(self, x, compute_dtype=None):
    from flownet2_tf_tpu_torch.models import common

    return common._layer_forward(self, x, compute_dtype, F.conv_transpose2d,
                                 stride=2, padding=1)


@contextlib.contextmanager
def setting(name):
    """Run the block under one of ``SETTINGS``; restores the package."""
    from flownet2_tf_tpu_torch.models import common
    from flownet2_tf_tpu_torch.utils import precision

    if name not in SETTINGS:
        raise ValueError(f"setting {name!r}: one of {SETTINGS}")
    # every module that binds f32_policy by name, imported now, so that
    # none binds a stand-in by being imported inside the block
    for module in _POLICY_MODULES:
        importlib.import_module(module)
    real_policy, real_forward = precision.f32_policy, common.Deconv.forward

    @contextlib.contextmanager
    def bf16_default(compute_dtype=None):
        prev = torch.backends.cudnn.deterministic
        with real_policy(compute_dtype):
            if compute_dtype not in (None, torch.float32):
                torch.backends.cudnn.deterministic = prev
            yield

    stand_in = {"default": _tf32_off_only,
                "bf16_default": bf16_default}.get(name)

    def modules_holding(policy):
        return [m for key, m in list(sys.modules.items())
                if key.startswith("flownet2_tf_tpu_torch.")
                and getattr(m, "f32_policy", None) is policy]

    try:
        if stand_in is not None:
            for m in modules_holding(real_policy):
                m.f32_policy = stand_in
        if name in ("default", "deterministic_transposed"):
            common.Deconv.forward = _transposed_forward
        yield
    finally:
        if stand_in is not None:
            for m in modules_holding(stand_in):
                m.f32_policy = real_policy
        common.Deconv.forward = real_forward


def _layer_device_ms(model_name, dtype, batch, height, width, settings,
                     backward=False, launches=10, reps=3):
    """{setting: (total ms, {layer: ms})}: the device time of each conv
    and deconv of one ``model_name`` forward at ``dtype``, on its own
    input, with ``backward`` the gradients that a train step takes there
    too (the parameters' and, where the step needs it, the input's).
    Launches are queued behind a sleep kernel so that the host's launch
    cost is hidden."""
    from flownet2_tf_tpu_torch.models import common
    from flownet2_tf_tpu_torch.models.registry import get_model

    cd = common.compute_dtype_of(dtype)
    net = get_model(model_name).build("cuda")
    common.msra_init_(net, torch.Generator().manual_seed(0))
    inputs = {}

    def keep(name):
        def hook(module, args):
            x = args[0]
            inputs.setdefault(name, (x.detach().clone(), x.requires_grad))
        return hook

    hooks = [m.register_forward_pre_hook(keep(n))
             for n, m in net.named_modules()
             if isinstance(m, (common.Conv, common.Deconv))]
    gen = torch.Generator(device="cuda").manual_seed(0)
    a, b = (torch.rand((batch, height, width, 3), generator=gen,
                       device="cuda") for _ in range(2))
    with torch.set_grad_enabled(backward), common.f32_policy(cd):
        net({"input_a": a, "input_b": b}, cd)
    for h in hooks:
        h.remove()
    modules = dict(net.named_modules())
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def run(mod, x, wants_dx, g):
        if not backward:
            return mod(x, cd)
        x = x.detach().requires_grad_(wants_dx)
        y = mod(x, cd)
        leaves = [*mod.parameters(), *([x] if wants_dx else [])]
        return torch.autograd.grad(y, leaves, g)

    out = {}
    for name in settings:
        layers = {}
        with setting(name), torch.set_grad_enabled(backward), \
                common.f32_policy(cd):
            for layer, (x, wants_dx) in inputs.items():
                mod = modules[layer]
                g = None
                if backward:
                    with torch.no_grad():
                        g = torch.randn_like(mod(x, cd))
                for _ in range(2):
                    run(mod, x, wants_dx, g)
                times = []
                for _ in range(reps):
                    torch.cuda._sleep(20_000_000)
                    start.record()
                    for _ in range(launches):
                        run(mod, x, wants_dx, g)
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end) / launches)
                layers[layer] = statistics.median(times)
        out[name] = (sum(layers.values()), layers)
    return out


def main(argv=None):
    from flownet2_tf_tpu_torch.tools import bench, benchlib

    parser = argparse.ArgumentParser(
        prog="python -m flownet2_tf_tpu_torch.tools.determinism_ab")
    parser.add_argument("--out", default=None,
                        help="also write the results here as JSON")
    parser.add_argument("--cells", nargs="*", default=None,
                        help="run only the cells whose name holds one of "
                             "these substrings (default: all)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("determinism_ab: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()

    def fwd(dtype, batch, iters):
        return lambda: bench.run_bench(compute_dtype=dtype, batch=batch,
                                       iters=iters, repeats=5,
                                       validate=False)["ms_per_pair"]

    def step(model, dtype):
        return lambda: benchlib.train_step_ms(model, 8, 320, 448, dtype,
                                              iters=8)[0]

    def layers(model, dtype, batch, hw, settings, backward=False):
        def run():
            split = _layer_device_ms(model, dtype, batch, *hw, settings,
                                     backward=backward)
            base = split[settings[0]][1]
            return {name: {
                "total": total,
                # the layers whose time moved most against the first
                # setting, with both times
                "top": sorted(((k, v, base[k]) for k, v in ms.items()),
                              key=lambda kv: -abs(kv[1] - kv[2]))[:6]}
                for name, (total, ms) in split.items()}
        return run

    f32_turns = ("default", "port", "port", "default",
                 "deterministic_transposed")
    bf16_turns = ("bf16_default", "port", "port", "bf16_default") * 3
    cells = (
        ("bench f32 b1 ms/pair", fwd("float32", 1, 10), f32_turns),
        ("bench f32 b8 ms/pair", fwd("float32", 8, 4), f32_turns),
        # 40 forwards a sample at b1: its launch-bound spread must fall
        # under the difference it measures
        ("bench bf16 b1 ms/pair", fwd("bfloat16", 1, 40), bf16_turns),
        ("bench bf16 b8 ms/pair", fwd("bfloat16", 8, 4), bf16_turns[:8]),
        ("step c f32 ms", step("c", "float32"), f32_turns),
        ("step c bf16 ms", step("c", "bfloat16"), bf16_turns[:8]),
        ("step css bf16 ms", step("css", "bfloat16"), bf16_turns[:8]),
    )
    splits = (
        ("layers f32 b1 forward device ms",
         layers("2", "float32", 1, (448, 1024), SETTINGS[:3])),
        # b1's device time apart from its launch-bound host noise
        ("layers bf16 b1 forward device ms",
         layers("2", "bfloat16", 1, (448, 1024), ("bf16_default", "port"))),
        ("layers bf16 b8 forward device ms",
         layers("2", "bfloat16", 8, (448, 1024), ("bf16_default", "port"))),
        ("layers c bf16 b8 step device ms",
         layers("c", "bfloat16", 8, (320, 448), ("bf16_default", "port"),
                backward=True)),
    )

    def wanted(cell):
        return args.cells is None or any(c in cell for c in args.cells)

    results = {"card": card, "torch": torch.__version__,
               "cudnn": torch.backends.cudnn.version(), "cells": {}}
    for cell, run, turns in cells:
        if not wanted(cell):
            continue
        runs = {}
        for name in turns:
            with setting(name):
                ms = run()
            runs.setdefault(name, []).append(ms)
            print(json.dumps({"cell": cell, "setting": name, "ms": ms}),
                  flush=True)
        results["cells"][cell] = {
            name: {"runs": v, "median": statistics.median(v)}
            for name, v in runs.items()}
    for cell, run in splits:
        if wanted(cell):
            results[cell] = run()
            print(json.dumps({cell: results[cell]}), flush=True)
    print(json.dumps(results), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
