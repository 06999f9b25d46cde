"""Profile a model forward: a trace, and its time per kernel and per layer.

Port of ``trace_model`` and ``print_summary`` of
``flownet2_tf_tpu/tools/profiler.py`` (``cli profile``). The JAX package
reads its TPU xplane; here ``torch.profiler`` records ``iters`` forwards
after the warm-ups, :func:`trace_model` writes the Chrome trace
(``trace.json``) and a ``summary.json`` beside it, and
:func:`print_summary` prints the top rows of that summary.

The layer scopes are the JAX package's ``jax.named_scope`` names
(``models/common.py::scope``: ``FlowNetCSS``, ``FlowNetSD``, ``fusion``,
``correlation``, ``refine2``, ...), recorded only while a profiler runs.
A scope's time is the device time of the kernels launched inside it,
nested scopes included; scopes of one name (``conv1`` in each FlowNetS)
add up. On a card every time is device time (``device_ms``); on the CPU
there are no kernels, only ops, and every time is host CPU time
(``cpu_ms``), never a device time.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

SUMMARY_FILE = "summary.json"
TRACE_FILE = "trace.json"
WARMUP_FORWARDS = 2


def trace_model(model_name="2", height=448, width=1024, batch=1, iters=3,
                compute_dtype="bfloat16", trace_dir=None, warp_mode=None,
                device="cuda", warp_res=None, fusion_res=1,
                bf16_interconv=False, f32_features="highest"):
    """Run and trace ``iters`` forwards; returns the trace directory
    (default: ``flownet2_trace`` in the temporary directory).

    ``warp_mode="half"`` profiles the serving preset (half-res stack
    warps), ``"full"`` pins exact warps; ``None`` (default) follows
    ``warp_res`` (``cli profile --warp_res K``), exact if that is None
    too. ``fusion_res``, ``bf16_interconv``, ``f32_features``: the model's
    other knobs (``ModelSpec.build_for``), recorded in ``summary.json``.
    Weights are the seeded init (pre-cast for bf16, as served)."""
    from flownet2_tf_tpu_torch.models.common import (
        cast_params_for_inference,
        compute_dtype_of,
        msra_init_,
    )
    from flownet2_tf_tpu_torch.models.registry import get_model
    from flownet2_tf_tpu_torch.training.infer import resolve_device

    if warp_mode is not None and warp_mode not in ("full", "half"):
        raise ValueError(f"warp_mode {warp_mode!r}: 'full', 'half' or None")
    k = {"full": 1, "half": 2}.get(warp_mode, warp_res or 1)
    trace_dir = trace_dir or os.path.join(tempfile.gettempdir(),
                                          "flownet2_trace")
    device = resolve_device(device)
    spec = get_model(model_name)
    cd = compute_dtype_of(compute_dtype)
    net = spec.build_for(device, warp_res=k, fusion_res=fusion_res,
                         bf16_interconv=bf16_interconv,
                         f32_features=f32_features)
    msra_init_(net, torch.Generator().manual_seed(0))
    if cd == torch.bfloat16:
        cast_params_for_inference(net, cd)
    rng = np.random.RandomState(0)
    a, b = (torch.from_numpy(rng.rand(batch, height, width, 3)
                             .astype(np.float32)).to(device)
            for _ in range(2))
    on_card = device.type == "cuda"
    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)

    def forward():
        return net({"input_a": a, "input_b": b}, cd)["flow"]

    with torch.no_grad():
        for _ in range(WARMUP_FORWARDS):  # outside the trace
            forward()
        if on_card:
            torch.cuda.synchronize(device)
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(iters):
                forward()
            if on_card:
                torch.cuda.synchronize(device)
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
    summary = {
        "model": model_name, "batch": batch, "height": height,
        "width": width, "compute_dtype": compute_dtype,
        "warp_res": spec.warp_res_for(k),
        "fusion_res": spec.fusion_res_for(fusion_res),
        "bf16_interconv": bool(bf16_interconv) and spec.interconvs,
        "f32_features": f32_features, "iters": iters,
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        **summarize(prof.key_averages(), iters, on_card),
    }
    with open(os.path.join(trace_dir, SUMMARY_FILE), "w") as f:
        json.dump(summary, f, indent=1)
    return trace_dir


def summarize(averages, iters, on_card):
    """Per-forward times from ``key_averages()`` rows, largest first.

    On a card: ``kernels`` (each kernel's own device time) and
    ``scopes`` (each layer scope's kernels), as ``device_ms``. On the
    CPU: ``ops`` (each op's own CPU time) and ``scopes``, as
    ``cpu_ms``."""
    unit = "device_ms" if on_card else "cpu_ms"
    kernels, scopes = {}, {}
    for e in averages:
        note = bool(getattr(e, "is_user_annotation", False))
        on_device = e.device_type != torch.autograd.DeviceType.CPU
        if note and not on_device:
            # the CPU side of a scope: its kernels' device time, or its
            # own CPU time
            us = e.device_time_total if on_card else e.cpu_time_total
            table = scopes
        elif not note and on_device == on_card:
            us = e.self_device_time_total if on_card else e.self_cpu_time_total
            table = kernels
        else:  # a scope's span on the card's timeline: not summed
            continue
        row = table.setdefault(e.key, {"name": e.key, unit: 0.0, "calls": 0})
        row[unit] += us / 1000.0 / iters
        row["calls"] += e.count / iters
    order = (lambda rows: sorted(rows.values(), key=lambda r: -r[unit]))
    return {"clock": "device" if on_card else "cpu",
            "kernels" if on_card else "ops": order(kernels),
            "scopes": order(scopes)}


def print_summary(trace_dir, top=20):
    """Print the top ``top`` kernels (or CPU ops) and layer scopes of
    ``trace_dir``'s ``summary.json``; returns the summary."""
    with open(os.path.join(trace_dir, SUMMARY_FILE)) as f:
        summary = json.load(f)
    on_card = summary["clock"] == "device"
    unit = "device_ms" if on_card else "cpu_ms"
    label = "device ms" if on_card else "CPU ms (host clock, not device time)"
    print(f"== {summary['model']} {summary['batch']}x{summary['height']}x"
          f"{summary['width']} {summary['compute_dtype']} warp_res "
          f"{summary['warp_res']} on {summary['device']}: per forward, "
          f"{label}, over {summary['iters']} forwards")
    for section in ("kernels" if on_card else "ops", "scopes"):
        rows = summary[section][:top]
        # scopes nest (FlowNetCSS holds FlowNetC): only the kernels sum
        total = ("" if section == "scopes" else
                 f"; all {len(summary[section])} sum to "
                 f"{sum(r[unit] for r in summary[section]):.3f} ms")
        print(f"-- {section} (top-{len(rows)}{total})")
        for r in rows:
            print(f"   {r[unit]:9.3f} ms x{r['calls']:<7.1f} {r['name'][:90]}")
    return summary
