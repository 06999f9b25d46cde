"""Benchmark harness of the torch port: frame pairs/s on one device.

    python -m flownet2_tf_tpu_torch.tools.bench [--device cuda|cpu]
        [--fullres] [--no_companion]

Port of ``flownet2_tf_tpu/tools/bench.py`` (``cli bench`` calls
:func:`run_bench`). Headline metric: FlowNet2 frame pairs/s at 448x1024
(Sintel padded), bf16 with the half-res stack warps (the serving preset)
unless asked otherwise. ``vs_baseline`` is against the reference method's
published runtime, FlowNet2 at ~123 ms/pair on a GTX 1080 (8.13 pairs/s;
BASELINE.md).

Methodology: seeded random weights (pre-cast for bf16, as served), two
input images uploaded once, forwards under ``torch.no_grad()``. A sample
is the CUDA-event time of ``iters`` forwards over ``iters x batch``
pairs: enqueue and device work together, what a user waits for when the
forward is launch-bound. On the CPU the host clock stands in and
``backend`` says so.

Publish gates (the JAX package's):
  * the published value is the MEDIAN of ``repeats`` (>= 5 by default)
    samples, with the spread ((max - min) / median) disclosed;
  * a median below ``FLOOR_SAFETY`` x the analytic FLOPs floor
    (``benchlib.count_flops`` of the model timed, its knobs included,
    each FLOP over the card's peak for the precision it runs at:
    ``peak_tflops`` in the result) or a spread above
    ``MAX_SPREAD`` is re-measured, up to ``MEASURE_ATTEMPTS`` times. A
    result that never clears the floor RAISES; one whose spread never
    settles is published with ``suspect`` naming the failed attempts.

Prints ONE JSON line; :func:`main` adds a full-res (exact warps)
companion time when the headline uses the half-res warps.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

REFERENCE_PAIRS_PER_SEC = 1000.0 / 123.0  # FlowNet2 paper, GTX 1080

# Publish gates. FLOOR_SAFETY x the analytic-FLOPs floor is the lowest
# credible per-pair time: the floor counts the convs and the correlation
# only, so anything under 1.5x it is a measurement artifact, not a result.
FLOOR_SAFETY = 1.5
MAX_SPREAD = 0.15
MEASURE_ATTEMPTS = 3
# forwards run before the samples (cuDNN's algorithm choice, the
# allocator's pools)
WARMUP_FORWARDS = 3

_WARP_MODES = {"full": 1, "half": 2}


def check_samples(samples, floor_ms=None):
    """Gate a sorted list of per-pair seconds: returns (median_s,
    spread_frac, reject_reason_or_None).

    Rejections: median below FLOOR_SAFETY x the analytic FLOPs floor
    (physically implausible), or inter-repeat spread above MAX_SPREAD
    (unstable: something else is probably using the device). Pure
    function so the gates are unit-testable without hardware."""
    samples = sorted(samples)
    median = statistics.median(samples)
    spread = ((samples[-1] - samples[0]) / median
              if len(samples) > 1 and median > 0 else 0.0)
    reason = None
    if floor_ms is not None and median * 1000.0 < FLOOR_SAFETY * floor_ms:
        reason = (f"median {median * 1000.0:.3f} ms/pair below "
                  f"{FLOOR_SAFETY}x analytic FLOPs floor "
                  f"({floor_ms:.3f} ms) — physically implausible")
    elif len(samples) >= 3 and spread > MAX_SPREAD:
        reason = (f"spread {spread * 100.0:.1f}% over {len(samples)} "
                  f"repeats exceeds {MAX_SPREAD * 100.0:.0f}%")
    return median, spread, reason


def resolve_warp_mode(compute_dtype, warp_mode=None, warp_res=None):
    """(label, stack-warp grid factor) of a bench run.

    ``warp_mode`` ``"half"`` or ``"full"`` pins the half-res or exact
    warps (and wins over ``warp_res``); else an explicit ``warp_res``
    (``cli bench --warp_res K``) is labelled ``f"k{K}"``; else the JAX
    package's default: the half-res serving preset for bf16, exact warps
    for f32."""
    if warp_mode is None:
        if warp_res is not None:
            return f"k{int(warp_res)}", int(warp_res)
        warp_mode = "half" if compute_dtype == "bfloat16" else "full"
    if warp_mode not in _WARP_MODES:
        raise ValueError(f"warp_mode {warp_mode!r}: one of "
                         f"{sorted(_WARP_MODES)} or None")
    return warp_mode, _WARP_MODES[warp_mode]


def run_bench(model="2", height=448, width=1024, batch=1, iters=16,
              compute_dtype="bfloat16", repeats=5, warp_mode=None,
              validate=True, device="cuda", warp_res=None, fusion_res=1,
              bf16_interconv=False, f32_features="highest"):
    """Measure ``model``'s forward on ``device``; returns the result dict
    (the JAX package's keys, less its XLA-only
    ``hbm_gb_xla_opsum_bound``, plus ``device``: the card's name, or
    ``cpu``). ``warp_mode``/``warp_res``: see
    :func:`resolve_warp_mode`. ``fusion_res`` (FlowNet2's fusion grid),
    ``bf16_interconv`` and ``f32_features``: the model's other knobs
    (``ModelSpec.build_for``); the result names each one that is not at
    its default (``fusion_res``, ``bf16_interconv``, ``f32_features``)."""
    from flownet2_tf_tpu_torch.training.infer import resolve_device

    label, k = resolve_warp_mode(compute_dtype, warp_mode, warp_res)
    knobs = {"warp_res": k, "fusion_res": int(fusion_res),
             "bf16_interconv": bool(bf16_interconv),
             "f32_features": f32_features}
    return _measure(model, height, width, batch, iters, compute_dtype,
                    repeats, label, validate, resolve_device(device), knobs)


def _measure(model, height, width, batch, iters, compute_dtype, repeats,
             warp_mode, validate, device, knobs):
    from flownet2_tf_tpu_torch.models.common import (
        cast_params_for_inference,
        compute_dtype_of,
        msra_init_,
    )
    from flownet2_tf_tpu_torch.models.registry import get_model
    from flownet2_tf_tpu_torch.tools import benchlib

    spec = get_model(model)
    cd = compute_dtype_of(compute_dtype)
    net = spec.build_for(device, **knobs)
    msra_init_(net, torch.Generator().manual_seed(0))
    if cd == torch.bfloat16:
        # serving-mode params: the feature layers' weights cast once, a
        # bitwise-identical bf16 forward
        cast_params_for_inference(net, cd)

    rng = np.random.RandomState(0)
    a, b = (torch.from_numpy(rng.rand(batch, height, width, 3)
                             .astype(np.float32)).to(device)
            for _ in range(2))

    # the analytic floor first, so the timing can gate its own output:
    # each counted FLOP over the peak of the precision it runs at (the
    # TF32 feature layers of f32_features='default' at the TF32 peak)
    flops_by = benchlib.count_flops(model, batch, height, width,
                                    compute_dtype, by_precision=True,
                                    **knobs)
    flops = sum(flops_by.values())
    peaks = {p: benchlib.device_peaks(device, p)[0] for p in flops_by}
    _, peak_bw = benchlib.device_peaks(device, compute_dtype)
    floor_ms = None
    if flops and all(peaks.values()):
        floor_ms = sum(f / peaks[p] for p, f in flops_by.items()
                       ) / batch * 1000.0

    def forward():
        return net({"input_a": a, "input_b": b}, cd)["flow"]

    on_card = device.type == "cuda"

    def sample_once():
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                forward()
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1000.0
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                forward()
            seconds = time.perf_counter() - t0
        return seconds / iters / batch

    reject_reasons = []
    with torch.no_grad():
        for _ in range(WARMUP_FORWARDS):
            flow = forward()
        if not bool(torch.isfinite(flow).all()):
            raise FloatingPointError("bench: the forward's flow is not "
                                     "finite")
        for attempt in range(MEASURE_ATTEMPTS):
            samples = sorted(sample_once() for _ in range(max(repeats, 1)))
            per_pair, spread, reason = check_samples(samples, floor_ms)
            if not validate or reason is None:
                break
            reject_reasons.append(f"attempt {attempt + 1}: {reason}")
            print(json.dumps({"bench_retry": reject_reasons[-1]}),
                  flush=True)
        else:
            if any("floor" in r for r in reject_reasons):
                raise RuntimeError(
                    "bench refused to publish: " + "; ".join(reject_reasons)
                )
            # the spread never settled: publish the median and disclose it

    pairs_per_sec = 1.0 / per_pair
    result = {
        "metric": f"flownet{model}_pairs_per_sec_{height}x{width}_b{batch}"
                  f"_{compute_dtype}",
        "value": round(pairs_per_sec, 3),
        "unit": "frame_pairs/sec/chip",
        "vs_baseline": round(pairs_per_sec / REFERENCE_PAIRS_PER_SEC, 3),
        "ms_per_pair": round(1000.0 * per_pair, 3),
        # "cuda": CUDA-event times; "cpu": host-clock CPU times
        "backend": device.type,
        "device": (torch.cuda.get_device_name(device) if on_card
                   else "cpu"),
        # exact warps, the half-res serving preset, or k{K}
        "warp_mode": warp_mode,
        "repeats": len(samples),
        "spread_pct": round(spread * 100.0, 1),
    }
    # the approximations the time was taken with, when not the exact path
    if spec.fusion_res_for(knobs["fusion_res"]) != 1:
        result["fusion_res"] = knobs["fusion_res"]
    if knobs["bf16_interconv"] and spec.interconvs:
        result["bf16_interconv"] = True
    if knobs["f32_features"] != "highest":
        result["f32_features"] = knobs["f32_features"]
    if reject_reasons:
        result["suspect"] = "; ".join(reject_reasons)
    if floor_ms is not None:
        result["floor_ms_analytic"] = round(floor_ms, 3)
        result["peak_tflops"] = {p: peaks[p] / 1e12 for p in flops_by}
    # roofline accounting: the counted FLOPs of one pair against the
    # card's peaks (mfu: the time they take at the peaks over the time
    # measured), and the most bytes HBM could have moved in the time taken
    if flops:
        result["model_tflops_per_pair"] = round(flops / batch / 1e12, 4)
        if floor_ms is not None:
            result["mfu"] = round(floor_ms / 1000.0 / per_pair, 4)
    if peak_bw:
        result["hbm_gb_physical_ceiling"] = round(per_pair * peak_bw / 1e9,
                                                  3)
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m flownet2_tf_tpu_torch.tools.bench",
        description="FlowNet2 448x1024 bf16 headline bench (half-res "
                    "warps) with a full-res companion time")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda without a GPU raises)")
    parser.add_argument("--fullres", action="store_true",
                        help="exact warps for the headline, no companion")
    parser.add_argument("--no_companion", action="store_true",
                        help="skip the full-res (exact warps) companion")
    args = parser.parse_args(argv)

    result = run_bench(warp_mode="full" if args.fullres else None,
                       device=args.device)
    line = {k: result[k] for k in ("metric", "value", "unit", "vs_baseline")}
    for k in ("mfu", "ms_per_pair", "warp_mode", "spread_pct", "suspect",
              "device"):
        if k in result:
            line[k] = result[k]
    # the headline uses the half-res warps: the exact-warp time goes
    # beside it, and a failure there fails the run
    if result["warp_mode"] != "full" and not args.no_companion:
        full = run_bench(warp_mode="full", iters=8, repeats=3,
                         device=args.device)
        line["fullres_ms_per_pair"] = full["ms_per_pair"]
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
