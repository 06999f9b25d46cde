"""Closed-loop inference: one client sends a batch of image pairs, waits
for the flow on the host, and sends the next.

Each call is the port's inference path as a user runs it: the pairs'
f32 NHWC frames uploaded from pageable host memory,
``training/infer.py::forward_flow`` (edge pad to a multiple of 64, the
model, crop back) and the flow copied back with ``.cpu()``. The model is
built as ``training/infer.py::inference_model`` builds it
(``ModelSpec.build_for`` with the mix's knobs, the bf16 layers pre-cast
by ``cast_params_for_inference``), filled with the harness's weights.

Traffic keys: ``dtype``, ``batch``, ``height``, ``width`` (the frame,
before padding), ``pool`` (pairs drawn in set-up; call ``i`` takes the
``batch`` pairs from ``(i * batch) % pool``), ``warp_res``,
``fusion_res``, ``bf16_interconv``, ``f32_features``,
``warmup_requests``, ``sample_requests`` (calls whose flows are compared
with the reference, drawn uniformly from the window's calls),
``trace_requests`` (the traced stretch of a ``--trace 1`` run),
``max_flow`` (px, of the synthetic motion).

Quantities: ``pairs_per_s`` (pairs over the window: from its start to
the last call's flow on the host), ``request_ms_p95`` (over every call
of the window, each from the call to its flow on the host).
"""

from __future__ import annotations

import time

from portbench.harness import arith, compare, inputs, weights
from portbench.harness.runctx import Reservoir, load_params, percentile, sync
from portbench.harness.trace import Tracer
from portbench.reference import flownet as ref


def _build(run, cd, knobs):
    import torch

    from flownet2_tf_tpu_torch.models.common import cast_params_for_inference
    from flownet2_tf_tpu_torch.models.registry import get_model

    model = get_model(run.config["model"]).build_for(run.device, **knobs)
    params = weights.make_params(ref.param_specs(run.config["reference"]),
                                 run.seed, run.device)
    load_params(model, params)
    del params
    if cd == torch.bfloat16:
        cast_params_for_inference(model, cd)
    return model


def run(run):
    import torch

    from flownet2_tf_tpu_torch.models.common import compute_dtype_of
    from flownet2_tf_tpu_torch.training import infer

    tr = run.traffic
    batch, pool = int(tr["batch"]), int(tr["pool"])
    if pool % batch:
        raise ValueError("pool must be a multiple of batch")
    cd = compute_dtype_of(tr["dtype"])
    knobs = {k: tr[k] for k in ("warp_res", "fusion_res", "bf16_interconv",
                                "f32_features")}
    control = run.cell.limits.get("control", {})
    by_reference = run.variant == "control" and control.get("kind") == \
        "reference"
    if run.variant == "control" and control.get("kind") == "program":
        knobs.update(control["knobs"])
    run.mark("driver_imports")
    device = torch.device(run.device)
    if by_reference:
        params = weights.make_params(
            ref.param_specs(run.config["reference"]), run.seed, device)
        quant = compare.QUANT[control["quant"]]
    else:
        model = _build(run, cd, knobs)
    run.mark("model_and_weights")
    pool_a, pool_b, _ = inputs.make_pairs(run.seed, pool, tr["height"],
                                          tr["width"], device,
                                          float(tr["max_flow"]))
    run.mark("inputs")

    def call(i):
        lo = (i * batch) % pool
        a = pool_a[lo:lo + batch].to(device)
        b = pool_b[lo:lo + batch].to(device)
        if by_reference:
            with torch.no_grad(), ref.exact():
                return ref.infer(run.config["reference"], params, a, b,
                                 tr["warp_res"], quant).cpu()
        return infer.forward_flow(model, a, b, cd).cpu()

    for i in range(int(tr["warmup_requests"])):
        call(i)
    sync(device)
    run.mark("warmup")
    setup_s = run.setup_s()

    sample = Reservoir(int(tr["sample_requests"]), run.seed)
    latencies, failed, errors = [], 0, []
    tracer = Tracer(device) if run.trace else None
    trace_from = 0.3 * run.seconds
    t_start = time.perf_counter()
    deadline = t_start + run.seconds
    t_last, i = t_start, 0
    while True:
        t0 = time.perf_counter()
        if tracer is not None and tracer.prof is None and (
                t0 - t_start >= trace_from or t0 >= deadline):
            with tracer:
                for _ in range(int(tr["trace_requests"])):
                    call(i)
                    i += 1
            traced = (i - int(tr["trace_requests"]), i)
            t_last = time.perf_counter()
            continue
        if t0 >= deadline:
            break
        try:
            flow = call(i)
        except Exception as e:  # counted; the first few are reported
            failed += 1
            if len(errors) < 3:
                errors.append(repr(e))
            flow = None
        t_last = time.perf_counter()
        latencies.append(t_last - t0)
        if flow is not None:
            sample.offer((i, flow))
        i += 1
    window_s = t_last - t_start
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    out = {
        "attempted": i, "failed": failed, "errors": errors,
        "setup_s": setup_s, "memory_peak_bytes": memory_peak,
        "quantities": {
            "pairs_per_s": i * batch / window_s,
            "request_ms_p95": 1e3 * percentile(latencies, 95)
            if latencies else None,
        },
    }
    if tracer is not None:
        summary = tracer.summary()
        n_pairs = (traced[1] - traced[0]) * batch
        h64, w64 = -(-tr["height"] // 64) * 64, -(-tr["width"] // 64) * 64
        feat = (batch, h64 // 8, w64 // 8, 256)
        dtype = "bfloat16" if cd == torch.bfloat16 else "float32"
        peaks = arith.peaks_for(torch.cuda.get_device_name(device)
                                if device.type == "cuda" else None)
        summary.update(
            items=n_pairs, calls_traced=traced[1] - traced[0],
            flops_per_item=arith.reference_flops(
                run.config["reference"], 1, h64, w64,
                warp_res=tr["warp_res"]),
            peak_flops=peaks[dtype] if peaks else None,
            corr_fwd_bound_s=(arith.corr_bound(feat, ref.CORR_D, ref.CORR_S2,
                                               dtype, peaks=peaks)[0]
                              if peaks else None))
        out["summary"] = summary

    # the check, once the window has closed and the program is freed
    if not by_reference:
        del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    params = weights.make_params(ref.param_specs(run.config["reference"]),
                                 run.seed, device)
    rel, px = [], []
    with torch.no_grad(), ref.exact():
        for index, flow in sorted(sample.items, key=lambda x: x[0]):
            lo = (index * batch) % pool
            want = ref.infer(run.config["reference"], params,
                             pool_a[lo:lo + batch].to(device),
                             pool_b[lo:lo + batch].to(device),
                             tr["warp_res"])
            r, p = compare.flow_rel_epe(flow.to(device), want)
            rel += r
            px += p
    finite = all(v == v and v != float("inf") for v in rel)
    out["checks"] = {"flow_rel_epe": max(rel) if rel and finite
                     else float("inf")}
    out["info"] = {"pairs_compared": len(rel),
                   "flow_epe_px_max": max(px) if px else None}
    return out
