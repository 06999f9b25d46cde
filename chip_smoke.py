#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``flownet2_tf_tpu_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA device. It
builds the port's CUDA kernels from ``flownet2_tf_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card, and drives the port's
two paths through its CLI at full published widths from seeded random
weights:

* phases 1-3, inference: the correlation forward kernel against its plain
  version on the path shapes and the tiling's edge cases, two launches
  bitwise equal, timed beside its bound; FlowNet2 f32 through ``cli test``
  on the bundled sample pair, held against the plain CPU path; FlowNet2
  timed at 448x1024;
* phases 4-6, training: the correlation backward kernels (da and db)
  against autograd of the plain version on the path shape and the
  tiling's edge cases in f32 and bf16, two launches bitwise equal, timed
  beside their bound with da and db apart; FlowNetC trained 20 steps in
  f32 through ``cli train`` at the FlyingChairs crop 320x448, batch 8,
  then resumed, then a FlowNetCS warm-started from it with FlowNetC
  frozen; the FlowNetC f32 train step timed;
* phases 7-9, the bf16 policy: FlowNet2 through ``cli test --compute_dtype
  bfloat16``, held against the plain CPU path; FlowNet2 bf16 timed at
  448x1024, batch 1 and 8; phase 5's training path again at ``cli
  train``'s bf16 default, and the bf16 FlowNetC train step timed. The
  correlation kernels take bf16 features there; a profile of the b8
  forward and of the train step gives their device time in the model;
* phase 10, dataset evaluation: a Sintel layout (4 pairs at 436x1024) and
  a KITTI layout (3 pairs near 375x1242, 16-bit PNG GT about half valid)
  written from the seed; ``cli eval --model 2`` on both in f32 and bf16
  from phase 2's checkpoint, held against ``cli eval --device cpu --limit
  1``, its own ``--save_outputs`` pass and a numpy AEE of the written
  flows; pairs/s, host decode and device forward times;
* phase 11, training from disk: ``cli train --model c --dataset
  flying_chairs`` on a 40-pair 384x512 raw layout (bf16, b8, the config's
  320x448 crop), then 4 TFRecords written by ``cli make-tfrecords`` (the
  pure-Python CRC32C timed) and 3 steps at b4 through
  ``--tfrecords_train``, whose images cross to the card as uint8.
* phase 12, serving: FlowNet2 exported at 448x1024 b1 through ``cli
  export --aot`` on the card (f32 exact warps, f32 and bf16 half-res
  warps), a bundle of 448x1024, 384x1280 and 448x1024x8 (bf16 half), and
  a 192x256 f32 artifact, each traced in a child process of its own, all
  at once (with phases 17 and 19's exports in the full run); loaded in
  fresh processes started beside them that import no model module, the
  card's artifacts served one process at a time once all have loaded,
  one correlation launch per served call counted there;
  the f32 artifact held against the eager forward (with TF32 allowed by
  the caller, too), the half-res artifacts against the same exports
  served on the CPU, ``cli serve`` against ``cli test``; export, load and
  served against eager ms/pair timed. No caller sets a cuDNN flag:
  ``f32_policy`` picks cuDNN's deterministic algorithms under both
  policies, and two served calls of each artifact (f32 and bf16, each
  bundle entry), and two f32 ``cli test`` runs (phases 2 and 12), are
  bitwise equal.
* phase 13, the measurement entry points: ``cli bench --model 2`` at
  448x1024 (f32 exact warps b1, f32 ``--warp_res 2`` b1, bf16 half-res
  b1 and b8), each gated as the bench gates itself;
  ``benchlib.train_step_ms`` for FlowNetC b8 320x448 in bf16 and f32 and
  for FlowNetCSS b8 bf16 with its default frozen scopes; ``cli profile
  --model 2`` (f32 b1, bf16 b8): device ms per layer scope.
* phase 14, the training input path: (a) the native IO runtime built
  with ``g++`` from the checkout, its CRC32C against ``crc32c_py`` on a
  64 MiB buffer, ``cli make-tfrecords`` of phase 11's 40-pair layout, and
  the native ``TFRecordFlowDataset`` bitwise against the pure one on
  every record in both ``raw_uint8`` modes (host ms per b8 batch); (b)
  ``cli train --model c --tfrecords_train --remat --image_summary_every
  2`` (bf16, b8, 6 steps, threaded device prefetch, then inline): every
  decode native, correlation forward launches 2 per step + 1 per
  summary, backward 1 per step, 4 PNG images per summary, examples/s;
  (c) one FlowNetC f32 and one FlowNetCSS bf16 step with remat bitwise
  the step without, peak memory and ``train_step_ms`` both ways; (d) two
  bf16 ``cli test`` runs and two 3-step bf16 ``cli train`` runs bitwise
  equal, with no cuDNN flag set here. ``python3 chip_smoke.py
  --phase14`` runs phases 0 and 14 alone on their own inputs and prints
  no result line.
* phase 15, data parallelism and spatial tiling: (a) ``cli train --model
  c --multihost`` (bf16 b8 320x448, 3 steps) at world size 1 on NCCL in a
  child process, its checkpoint bitwise the run without ``--multihost``;
  (b) two gloo ranks on the card (FlowNetC f32, b4 shards of one b8
  batch), bitwise equal to each other and within a stated tolerance of
  one process on the b8 batch; (c) ``cli test --model 2 --spatial_tiles
  2`` at 448x1024 in f32 and bf16 at overlap 64 (real bands) and 128
  (each window the padded frame), against the CPU's spatial flow and the
  untiled flows, tiled against untiled ms/pair; (d) ``cli export --aot
  --spatial_tiles 2`` of FlowNet2 f32 served in a fresh process against
  (c)'s flow; (e) the warp and resize gradients and two 3-step bf16
  FlowNetCS runs with nothing frozen bitwise repeatable, and the
  repair's price on the FlowNetCSS step. (a) also trains FlowNetC 2
  bf16 steps with the FlyingChairs augmentation under DDP at world size
  1 and without, bitwise equal (each rank seeds its augmentation from its
  rank; rank 0 keeps the single-process seed). ``--phase15`` runs phases
  0 and 15 alone.
* phase 16, ``cli convert``: (a) phase 2's seeded FlowNet2 weights
  written as a TF1 checkpoint (a V2 bundle of about 650 MB in 2 shards, by
  ``tests/_torch_tf1_writer.py``, with an Adam slot and ``global_step``),
  read back by ``tools/tf1_bundle.py`` (MB/s), ``cli convert --model 2
  --no_canary`` on the card (the .npz bitwise the written weights), then
  the semantic canary on the card, which must reject these random weights
  (their mean flow is far outside its band) after one correlation launch,
  its flow bitwise ``cli test``'s on the .npz; (b) phase 5's trained
  FlowNetC converted the same way with the canary on: one correlation
  launch, its flow bitwise ``cli test --model c``'s. ``--phase16`` runs
  phases 0 and 16 alone (FlowNetC trained there as phase 5's first run).
* phase 17, the last serving and approximation levers, FlowNet2 at
  448x1024 from phase 2's weights: (a) ``cli export --aot --platforms
  cuda,cpu`` (f32, exact warps): one artifact, a graph per platform,
  each served alone in a fresh process (``load_serving(device=)``), the
  CUDA graph bitwise ``cli test`` with one correlation launch per call,
  the CPU graph with none and within 1e-2 px mean EPE of it; artifact MB,
  load s and served against eager ms/pair; (b) ``cli bench`` A/Bs, each
  knob against its exact counterpart run just before it (exact, knobs):
  ``--fusion_res 2`` and ``--f32_features default`` at f32 b1,
  ``--fusion_res 2`` and ``FLOWNET2_TPU_BF16_INTERCONV=1`` at bf16 b8,
  each floored at the peaks of the precisions it runs, and each knob's
  flow delta (mean EPE) on the same random weights; (c)
  ``export_serving(..., fusion_res=2)`` served bitwise its eager model;
  (d) two ``cli train --model 2 --fusion_res 2`` bf16 runs of 2 steps,
  checkpoints bitwise equal. ``--phase17`` runs phases 0 and 17 alone.
* phase 18, asynchronous checkpoint saving (``Trainer.save``): (a)
  FlowNetC and FlowNetCSS (FlowNetCS frozen) bf16 b8 320x448 on one
  uploaded batch, in turns: the training thread's stall in
  ``save(wait=True)`` against ``save()``, the background write's wall
  time, and the CUDA-event step ms while a write is in flight against
  with none; each asynchronous checkpoint bitwise the synchronous one of
  the same step, written while later steps ran; (b) ``cli train --model
  c --checkpoint_every 2``, 4 steps straight against 2 then resumed to 4,
  the checkpoints bitwise equal, one forward and one backward correlation
  launch per step; (c) a child that trains a step, calls ``save()`` and
  exits at once leaves a complete checkpoint, which ``restore_or_init``
  resumes bitwise. Its checkpoints are deleted at its end.
  ``--phase18`` runs phases 0 and 18 alone.
* phase 19, multi-device serving on the one card, FlowNet2 f32 with exact
  warps at 448x1024 from phase 2's weights: (a) ``cli export --aot
  --data_parallel 2 --batch 2`` loaded with ``devices=["cuda:0",
  "cuda:0"]``, each replica's rows bitwise those of the batch-1 artifact
  (phase 12's; else within 1e-2 px mean EPE, the reason printed); (b)
  ``load_serving`` of it with the default devices refuses on one card
  (on two or more it places the replicas on ``cuda:0`` and ``cuda:1``);
  (c) ``infer_flow_spatial`` with 2 bands at overlap 64 on
  ``["cuda:0", "cuda:0"]`` against the bands as one batch, and phase
  15's spatial artifact loaded on those devices (its band graph) against
  its one-graph load, each within 1e-2 px mean EPE; (d) served ms/pair
  of (a) against the single-device b2 artifact (CUDA events, median of
  5). The correlation launches of (a) and (c) are counted exactly.
  ``--phase19`` runs phases 0 and 19 alone (its artifacts exported
  there, in child processes at once).

Every child process (phase 12's and phase 15's workers, the DDP ranks,
``nvidia-smi``, the compilers) starts in its own session with its output
in a file, has a hard timeout and has its process group killed when it
ends; before the last line the script checks that none is left.

Each path's kernel launch counts are set to 0 just before it and read just
after, the bf16 paths' by the dtype of the features the kernels took.
Every phase raises on failure; the exit code is then non-zero and no
result line is printed.

A kernel's time is its device time: the launches are queued behind a
``torch.cuda._sleep`` so the host's launch cost is hidden. Its bound is
the least time the card could take for the same work: the larger of the
bytes (each input read once, each output written once) over HBM and the
in-frame multiply-adds over the peak rate for the inputs' type.

The last two lines of stdout are one JSON object with each kernel's
numbers, then ``{"ok": true, "device": {...}}``. It exits non-zero without
a CUDA device, and outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SAMPLES = os.path.join(ROOT, "data", "samples")
SEED = 0

# tolerance of the kernel against its plain version: f32 sums of the
# same values in another order
KERNEL_RTOL = KERNEL_ATOL = 1e-5
# bf16 gradients: both sides sum in f32 (agreeing to 1e-5) and round the
# result to bf16 once, so they may differ by one bf16 step (8 bits)
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5
# the CUDA and CPU FlowNet2 flows: tests/test_golden.py:96-99
FLOW_RTOL, FLOW_ATOL = 1e-3, 5e-3
# the bf16 card flow's mean EPE to the f32 CPU flow, against the bf16 CPU
# flow's: the card rounds in other places (cuDNN's sums, fused biases)
BF16_EPE_RATIO = 1.5

# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM
# bytes/s, and FLOP/s for f32 without tensor cores and for dense bf16
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

CORR_SOURCE = "flownet2_tf_tpu_torch/csrc/correlation.cu"
CORR_REPLACES = "flownet2_tf_tpu/ops/pallas/correlation_kernel.py:53"
CORR_BWD_REPLACES = "flownet2_tf_tpu/ops/pallas/correlation_kernel.py:147"

# FlowNetC at the FlyingChairs crop (data/dataset_configs.py): conv3 is
# (8, 40, 56, 256) there
TRAIN_H, TRAIN_W, TRAIN_BATCH = 320, 448, 8
TRAIN_STEPS, RESUME_STEPS = 20, 25

# the datasets' published frame sizes: Sintel 436x1024 (2 sequences of 3
# frames), KITTI 2012's sizes around 375x1242, FlyingChairs 384x512
SINTEL_HW = (436, 1024)
KITTI_HWS = ((375, 1242), (370, 1224), (376, 1241))
CHAIRS_HW, CHAIRS_PAIRS = (384, 512), 40
EVAL_BATCH = 2
# the card's f32 AEE against the CPU's on one pair (BASELINE.md's budget)
AEE_ATOL = 1e-2
# the on-device AEE against the --save_outputs pass and a numpy AEE of the
# written flows (f32; sums in other orders, the 1e-12 eps)
AEE_RTOL = 1e-4
# wall-time budgets of phases 10 and 11 (s), to keep the run inside its
# time limit
PHASE10_BUDGET_S, PHASE11_BUDGET_S = 420.0, 180.0
# phase 12: the served f32 flow against the eager one on the card (the
# same graph, the same kernels: sums in the same order), and its budget
SERVE_EPE = 1e-4
PHASE12_BUDGET_S = 240.0
SERVE_HW = (448, 1024)
# phase 13: forwards per bench sample, the train steps' timed run, and the
# phase's wall-time budget (s)
BENCH_ITERS, STEP_ITERS = 10, 8
PHASE13_BUDGET_S = 150.0


def log(msg):
    print(msg, flush=True)


# correlation launches over every path run (phases 2, 5, 7, 9-15), by
# direction and input dtype
PATH_LAUNCHES = {"fwd": {"float32": 0, "bfloat16": 0},
                 "bwd": {"float32": 0, "bfloat16": 0}}


def path_counts():
    """The launch counts since the last reset, added to PATH_LAUNCHES;
    returns them."""
    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel as ck

    counts = {"fwd": dict(ck.LAUNCHES_BY_DTYPE),
              "bwd": dict(ck.BWD_LAUNCHES_BY_DTYPE)}
    for way, by_dtype in counts.items():
        for dtype, n in by_dtype.items():
            PATH_LAUNCHES[way][dtype] += n
    return counts


def cuda_time_ms(fn, runs, warmup=3):
    """Per-run device times (ms) of ``fn`` with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def device_ms(fn, launches=20, reps=5, warmup=3):
    """Device time (ms) of one call of ``fn``: median over ``reps`` runs of
    ``launches`` calls queued behind a sleep kernel, timed with CUDA
    events, so that the host's launch cost is hidden."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 50_000_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    sleep_s = start.elapsed_time(end) / 1000.0
    times = []
    for _ in range(reps):
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        if time.perf_counter() - t0 > sleep_s:
            raise AssertionError("the host took longer to queue the launches "
                                 "than the card slept: not a device time")
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return times


def corr_bound(shape, d, s2, dtype, backward=False):
    """(ms, "bytes" or "operations"): the least time the card could take
    for one correlation call (forward, or the da and db backward) at
    ``shape``: bytes over HBM_BPS, in-frame multiply-adds over
    PEAK_FLOPS[dtype], whichever is larger."""
    n, h, w, c = shape
    r = d // s2
    item = 4 if dtype == "float32" else 2
    # in-frame (pixel, displacement) pairs: the axes are independent
    rows = sum(max(0, h - abs(k) * s2) for k in range(-r, r + 1))
    cols = sum(max(0, w - abs(k) * s2) for k in range(-r, r + 1))
    macs = n * c * rows * cols
    feat = n * h * w * c * item
    cost_volume = n * h * w * (2 * r + 1) ** 2 * 4
    if backward:  # read g, a, b; write da, db; each gradient takes the MACs
        nbytes, flops = cost_volume + 4 * feat, 4 * macs
    else:  # read a, b; write the f32 cost volume
        nbytes, flops = 2 * feat + cost_volume, 2 * macs
    t_bytes, t_ops = nbytes / HBM_BPS, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def profile_ms(fn):
    """Device ms per kernel name over one call of ``fn``, from
    ``torch.profiler``; the sum of them all is the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            out[e.key] = out.get(e.key, 0.0) + us / 1000.0
    return out


def corr_profile_ms(fn):
    """(busy ms, {forward, backward da, backward db: ms}) of one call."""
    kernels = profile_ms(fn)
    names = {"forward": "correlation_fwd", "da": "correlation_bwd_da",
             "db": "correlation_bwd_db"}
    return sum(kernels.values()), {
        k: sum(ms for key, ms in kernels.items() if v in key)
        for k, v in names.items()}


def _smi():
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    from flownet2_tf_tpu_torch.utils import procs

    rc, smi = procs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"], timeout=60)
    if rc != 0:
        raise AssertionError(f"nvidia-smi failed ({rc}): {smi}")
    return smi.strip()


def phase0_device_and_build():
    import torch

    from flownet2_tf_tpu_torch.ops.cuda import _build, correlation_kernel

    smi = _smi()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    t0 = time.perf_counter()
    correlation_kernel.build()
    log(f"phase 0: built correlation kernel for sm_90a in "
        f"{time.perf_counter() - t0:.2f} s")
    log(_build.build_log("correlation").strip())
    return smi


def phase1_kernel_vs_plain():
    """The correlation forward kernel against its plain version, on the
    card: every case within KERNEL_RTOL/ATOL and two launches bitwise
    equal; the path shapes timed beside their bound."""
    import torch

    from flownet2_tf_tpu_torch.ops.correlation import _correlation_oracle
    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel

    f32, bf16 = torch.float32, torch.bfloat16
    fnet2 = (1, 56, 128, 256)  # FlowNetC in FlowNet2 at 448x1024 (Sintel)
    kitti = (1, 48, 160, 256)  # at KITTI's 384x1280 bucket
    conv3 = (TRAIN_BATCH, TRAIN_H // 8, TRAIN_W // 8, 256)  # chairs crop
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [
        (fnet2, 20, 2, f32, True),
        (fnet2, 20, 2, bf16, True),
        (kitti, 20, 2, f32, True),
        (kitti, 20, 2, bf16, True),
        (conv3, 20, 2, f32, True),
        (conv3, 20, 2, bf16, True),
        ((8, *fnet2[1:]), 20, 2, bf16, True),  # FlowNet2 bf16 b8 serving
        # off the TPU tiling (W % 8, C % 128)
        ((2, 8, 12, 64), 4, 1, f32, False),
        ((2, 8, 12, 64), 4, 2, f32, False),
        ((1, 12, 20, 96), 4, 1, f32, False),
        ((1, 12, 20, 96), 4, 2, f32, False),
        # the kernel's tiling: W not a multiple of the x tile (s2 * 32
        # pixels), C = 40; s2 = 1 and 3 with N = 2 and an odd H (C = 33:
        # bf16 rows not 16-byte aligned); D = 37
        ((1, 12, 100, 40), 20, 2, f32, False),
        ((1, 12, 100, 40), 20, 2, bf16, False),
        ((2, 7, 40, 64), 8, 1, f32, False),
        ((2, 7, 40, 64), 8, 1, bf16, False),
        ((2, 9, 50, 33), 6, 3, f32, False),
        ((2, 9, 50, 33), 6, 3, bf16, False),
        ((1, 4, 6, 40), 36, 2, f32, False),
    ]
    timings = {}
    worst = 0.0
    for shape, d, s2, dtype, timed in cases:
        name = str(dtype).split(".")[-1]
        a = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        b = torch.randn(shape, generator=gen, device="cuda").to(dtype)

        def kernel():
            return correlation_kernel.correlation_cuda(a, b, d, s2)

        def plain():
            # the same bf16-rounded values, promoted to f32 inside
            return _correlation_oracle(a, b, 1, d, 1, s2, d)

        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        same = torch.equal(got, again)
        log(f"phase 1: correlation {tuple(shape)} d={d} s2={s2} {name}: "
            f"max_abs_err {err:.3e} (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}); "
            f"two launches bitwise equal: {same}")
        if not ok or not torch.isfinite(got).all():
            raise AssertionError(
                f"correlation kernel disagrees with its plain version at "
                f"{shape} d={d} s2={s2} {dtype}: max abs err {err}")
        if not same:
            raise AssertionError(
                f"correlation kernel is not bitwise repeatable at {shape} "
                f"d={d} s2={s2} {dtype}")
        worst = max(worst, err)
        if timed:
            # in turns, so clocks and neighbours hit both alike
            k_ms, c_ms, p_ms = [], [], []
            for _ in range(2):
                p_ms += cuda_time_ms(plain, 6)
                k_ms += device_ms(kernel)
                c_ms += cuda_time_ms(kernel, 12)
            bound, by = corr_bound(shape, d, s2, name)
            med = statistics.median(k_ms)
            timings[tuple(shape), name] = {
                "ms": med, "plain_ms": statistics.median(p_ms),
                "bound_ms": bound, "bound_by": by,
                "bound_share": bound / med}
            log(f"phase 1: {tuple(shape)} {name}: kernel device time median "
                f"{med:.4f} ms over {len(k_ms)} runs (min {min(k_ms):.4f}, "
                f"max {max(k_ms):.4f}); per call with the host's launch "
                f"{statistics.median(c_ms):.4f} ms; plain "
                f"{statistics.median(p_ms):.4f} ms (min {min(p_ms):.4f}, "
                f"max {max(p_ms):.4f}); bound {bound:.4f} ms ({by}), "
                f"{100.0 * bound / med:.1f}% of it")
    return worst, timings


def _jax_layout_npz(model, path):
    """Seeded random FlowNet2 weights as a JAX-layout .npz, made with
    numpy.random so that no JAX is needed; returns their tree."""
    import numpy as np

    from flownet2_tf_tpu_torch.training import warmstart

    tree = warmstart.random_jax_params(model, SEED)
    np.savez(path, **warmstart.flatten(tree))
    return tree


def _cli_test(ckpt, out_dir, dtype, model="2"):
    """``cli test --model 2`` (or ``model``) on the card at ``dtype`` on
    the bundled pair, between a reset and a read of the launch counts;
    returns the .flo."""
    import numpy as np

    from flownet2_tf_tpu_torch import cli
    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel
    from flownet2_tf_tpu_torch.utils import flowlib

    correlation_kernel.reset_launch_counts()
    rc = cli.main(["test", "--model", model, "--device", "cuda",
                   "--compute_dtype", dtype, "--ckpt", ckpt,
                   "--input_a", os.path.join(SAMPLES, "0img0.ppm"),
                   "--input_b", os.path.join(SAMPLES, "0img1.ppm"),
                   "--out", out_dir])
    counts = path_counts()
    if rc != 0:
        raise AssertionError(f"cli test --compute_dtype {dtype} returned {rc}")
    flow = flowlib.read_flow(os.path.join(out_dir, "0img0_flow.flo"))
    if flow.shape != (192, 256, 2) or not np.isfinite(flow).all():
        raise AssertionError(f"bad .flo: shape {flow.shape}")
    return flow, counts


def _check_counts(counts, fwd, bwd, dtype, what):
    """Exactly ``fwd`` forward and ``bwd`` backward launches, all of them
    on ``dtype`` features."""
    want = {"fwd": fwd, "bwd": bwd}
    for way, n in want.items():
        if counts[way][dtype] != n or sum(counts[way].values()) != n:
            raise AssertionError(
                f"{what}: expected {fwd} forward and {bwd} backward "
                f"correlation launches on {dtype} features, got {counts}")


def _epe(a, b):
    import numpy as np

    return float(np.sqrt(((a - b) ** 2).sum(-1)).mean())


def phase2_main_path(tmp):
    """FlowNet2 through the port's CLI on the card, held against the same
    weights run plain on the CPU. Returns the weights, their .npz and the
    CPU flow."""
    import numpy as np
    import torch

    from flownet2_tf_tpu_torch.models.registry import get_model
    from flownet2_tf_tpu_torch.training import infer
    from flownet2_tf_tpu_torch.utils.image_io import load_image_pair

    ckpt = os.path.join(tmp, "flownet2_seed0.npz")
    tree = _jax_layout_npz(get_model("2").build("cpu"), ckpt)
    flow_cuda, counts = _cli_test(ckpt, os.path.join(tmp, "out"), "float32")
    log(f"phase 2: cli test --model 2 --device cuda: correlation launches "
        f"in one FlowNet2 forward {counts}")
    _check_counts(counts, 1, 0, "float32", "phase 2")

    a, b = load_image_pair(os.path.join(SAMPLES, "0img0.ppm"),
                           os.path.join(SAMPLES, "0img1.ppm"))
    flow_cpu = infer.infer_flow("2", tree, a, b, device="cpu")
    scale = max(1.0, float(np.abs(flow_cpu).mean()))
    err = float(np.abs(flow_cuda - flow_cpu).max())
    log(f"phase 2: CUDA vs CPU flow: mean EPE {_epe(flow_cuda, flow_cpu):.3e} "
        f"px, max abs err {err:.3e}, mean |flow| "
        f"{float(np.abs(flow_cpu).mean()):.3f} (rtol {FLOW_RTOL}, atol "
        f"{FLOW_ATOL} x {scale:.3f})")
    np.testing.assert_allclose(flow_cuda, flow_cpu, rtol=FLOW_RTOL,
                               atol=FLOW_ATOL * scale)
    torch.cuda.synchronize()
    return tree, ckpt, flow_cpu, flow_cuda


def inference_numbers(phase, tree, dtype, batches):
    """FlowNet2 448x1024 on the card at ``dtype`` (f32: TF32 off; bf16:
    the feature layers pre-cast, as ``cli test`` runs it), timed per
    batch size; returns the median ms/pair by batch size."""
    import torch

    from flownet2_tf_tpu_torch.models import common
    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel
    from flownet2_tf_tpu_torch.training import infer

    cd = common.compute_dtype_of(dtype)
    model = infer.load_model("2", tree, "cuda")
    if cd == torch.bfloat16:
        common.cast_params_for_inference(model)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    note = " (TF32 off)" if cd == torch.float32 else ""
    per_pair = {}
    for batch in batches:
        inputs = {k: torch.rand((batch, 448, 1024, 3), generator=gen,
                                device="cuda")
                  for k in ("input_a", "input_b")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = correlation_kernel.LAUNCHES_BY_DTYPE[dtype]
        with torch.inference_mode():
            times = cuda_time_ms(lambda: model(inputs, cd), runs=10,
                                 warmup=3)
            flow = model(inputs, cd)["flow"]
        torch.cuda.synchronize()
        if (flow.shape != (batch, 448, 1024, 2) or flow.dtype != torch.float32
                or not torch.isfinite(flow).all()):
            raise AssertionError(f"bad 448x1024 flow {tuple(flow.shape)} "
                                 f"{flow.dtype}")
        if correlation_kernel.LAUNCHES_BY_DTYPE[dtype] - before != 14:
            raise AssertionError(
                f"448x1024 forwards did not all launch the kernel on "
                f"{dtype} features")
        peak = torch.cuda.max_memory_allocated()
        med = statistics.median(times)
        if batch > 1:
            with torch.inference_mode():
                busy, corr = corr_profile_ms(lambda: model(inputs, cd))
            log(f"phase {phase}: profile of one b{batch} forward: "
                f"{busy:.3f} ms of device time, correlation forward "
                f"{corr['forward']:.3f} ms")
            if not corr["forward"] > 0:
                raise AssertionError("the profile shows no correlation kernel")
        log(f"phase {phase}: FlowNet2 448x1024 b{batch} {dtype}{note}: "
            f"median {med:.3f} ms per batch, {med / batch:.3f} ms/pair over "
            f"{len(times)} runs (min {min(times):.3f}, max "
            f"{max(times):.3f}), {1000.0 * batch / med:.2f} pairs/s, peak "
            f"memory {peak / 2**20:.1f} MiB")
        per_pair[batch] = med / batch
    return per_pair


def phase4_backward_vs_plain():
    """The correlation backward kernels against autograd of their plain
    version (what the JAX package's _bwd differentiates), on the card: the
    path shape and the tiling's edge cases in f32 and bf16, two launches
    bitwise equal; the path shape timed beside its bound, with da's and
    db's device time apart from the profiler."""
    import torch

    from flownet2_tf_tpu_torch.ops.correlation import _correlation_oracle
    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    f32, bf16 = torch.float32, torch.bfloat16
    conv3 = (TRAIN_BATCH, TRAIN_H // 8, TRAIN_W // 8, 256)
    cases = [
        (conv3, 20, 2, f32, True),
        (conv3, 20, 2, bf16, True),
        # off the TPU tiling (W % 8, C % 128)
        ((2, 8, 12, 64), 4, 1, f32, False),
        ((2, 8, 12, 64), 4, 2, f32, False),
        ((1, 12, 20, 96), 4, 1, f32, False),
        ((1, 12, 20, 96), 4, 2, f32, False),
    ] + [
        # the kernels' tiling, in both dtypes: W not a multiple of the x
        # tile (s2 * 32 pixels), C = 40; s2 = 1 and 3 with N = 2 and an odd
        # H (C = 33: rows not 16-byte aligned); H = 1; D = 37 with C > 2
        # channel chunks; D*D = 2025
        (shape, d, s2, dtype, False)
        for shape, d, s2 in [((1, 12, 100, 40), 20, 2), ((2, 7, 40, 64), 8, 1),
                             ((2, 9, 50, 33), 6, 3), ((1, 1, 9, 16), 4, 2),
                             ((1, 4, 6, 300), 36, 2), ((1, 9, 9, 40), 22, 1)]
        for dtype in (f32, bf16)
    ]
    timings = {}
    worst = 0.0
    for shape, d, s2, dtype, timed in cases:
        a = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        b = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        dd = (2 * (d // s2) + 1) ** 2
        g = torch.randn(shape[:3] + (dd,), generator=gen, device="cuda")

        def kernel():
            return correlation_kernel.correlation_cuda_backward(g, a, b, d, s2)

        def plain():
            x = a.detach().requires_grad_()
            y = b.detach().requires_grad_()
            out = _correlation_oracle(x, y, 1, d, 1, s2, d)
            return torch.autograd.grad(out, (x, y), g)

        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        rtol, atol = ((KERNEL_RTOL, KERNEL_ATOL) if dtype == f32
                      else (BF16_RTOL, BF16_ATOL))
        name = str(dtype).split(".")[-1]
        errs = []
        for which, k, p in zip(("da", "db"), got, want):
            err = float((k.float() - p.float()).abs().max())
            errs.append(err)
            if (k.dtype != dtype or k.shape != p.shape
                    or not torch.isfinite(k).all()
                    or not torch.allclose(k.float(), p.float(), rtol=rtol,
                                          atol=atol)):
                raise AssertionError(
                    f"correlation backward {which} disagrees with its plain "
                    f"version at {shape} d={d} s2={s2} {name}: max abs err "
                    f"{err} (rtol {rtol}, atol {atol})")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(
                f"correlation backward is not bitwise deterministic at "
                f"{shape} d={d} s2={s2} {name}")
        log(f"phase 4: correlation backward {tuple(shape)} d={d} s2={s2} "
            f"{name}: max_abs_err da {errs[0]:.3e} db {errs[1]:.3e} (rtol "
            f"{rtol}, atol {atol}); two runs bitwise equal")
        if dtype == f32:
            worst = max(worst, *errs)
        if timed:
            k_ms, p_ms = [], []
            for _ in range(2):  # in turns
                p_ms += cuda_time_ms(plain, 6, warmup=1)
                k_ms += device_ms(kernel, launches=5)
            calls = 5
            _, split = corr_profile_ms(lambda: [kernel() for _ in range(calls)])
            bound, by = corr_bound(shape, d, s2, name, backward=True)
            med = statistics.median(k_ms)
            timings[name] = {
                "ms": med, "plain_ms": statistics.median(p_ms),
                "bound_ms": bound, "bound_by": by, "bound_share": bound / med,
                "da_ms": split["da"] / calls, "db_ms": split["db"] / calls}
            log(f"phase 4: kernels' device time median {med:.4f} ms over "
                f"{len(k_ms)} runs (min {min(k_ms):.4f}, max {max(k_ms):.4f});"
                f" profiler: da {split['da'] / calls:.4f} ms, db "
                f"{split['db'] / calls:.4f} ms per call; plain "
                f"{statistics.median(p_ms):.4f} ms (min {min(p_ms):.4f}, "
                f"max {max(p_ms):.4f}); bound of da and db {bound:.4f} ms "
                f"({by}), {100.0 * bound / med:.1f}% of it")
            if not (split["da"] > 0 and split["db"] > 0):
                raise AssertionError("the profile misses a backward kernel")
    return worst, timings


def _train(argv):
    """``cli train`` in-process (so the kernel counters are visible);
    returns the logged JSON records. Its output is echoed."""
    from flownet2_tf_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["train", *argv])
    out = buf.getvalue()
    sys.stdout.write(out)
    if rc != 0:
        raise AssertionError(f"cli train {argv} returned {rc}")
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def training_path(phase, tmp, dtype):
    """FlowNetC trained through the port's CLI on the card at ``dtype``
    (bf16 by leaving ``--compute_dtype`` at its default); resumed; then a
    FlowNetCS warm-started from it with FlowNetC frozen."""
    import numpy as np

    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel
    from flownet2_tf_tpu_torch.training import warmstart

    c_dir = os.path.join(tmp, "flownet_c")
    common = ["--synthetic", "--synthetic_height", str(TRAIN_H),
              "--synthetic_width", str(TRAIN_W), "--batch_size",
              str(TRAIN_BATCH), "--schedule", "short", "--log_every", "1",
              "--checkpoint_every", "10", "--device", "cuda"]
    if dtype == "float32":
        common += ["--compute_dtype", "float32"]

    correlation_kernel.reset_launch_counts()
    recs = _train(["--model", "c", "--log_dir", c_dir,
                   "--max_steps", str(TRAIN_STEPS), *common])
    counts = path_counts()
    losses = [r["loss"] for r in recs]
    log(f"phase {phase}: cli train --model c ({dtype}), {len(recs)} steps: "
        f"correlation launches {counts}; loss first 4 "
        f"{[round(x, 4) for x in losses[:4]]}, last 4 "
        f"{[round(x, 4) for x in losses[-4:]]}")
    if [r["step"] for r in recs] != list(range(1, TRAIN_STEPS + 1)):
        raise AssertionError(f"logged steps {[r['step'] for r in recs]}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss in {losses}")
    if not np.mean(losses[-4:]) < np.mean(losses[:4]):
        raise AssertionError(f"loss did not decrease: {losses}")
    _check_counts(counts, TRAIN_STEPS, TRAIN_STEPS, dtype,
                  f"phase {phase} C training")

    correlation_kernel.reset_launch_counts()
    more = _train(["--model", "c", "--log_dir", c_dir,
                   "--max_steps", str(RESUME_STEPS), *common])
    counts = path_counts()
    resumed = [r["step"] for r in more]
    log(f"phase {phase}: resumed run logged steps {resumed}, correlation "
        f"launches {counts}")
    if resumed != list(range(TRAIN_STEPS + 1, RESUME_STEPS + 1)):
        raise AssertionError(f"resume did not start at step {TRAIN_STEPS}")
    _check_counts(counts, RESUME_STEPS - TRAIN_STEPS,
                  RESUME_STEPS - TRAIN_STEPS, dtype, f"phase {phase} resume")

    cs_dir = os.path.join(tmp, "flownet_cs")
    correlation_kernel.reset_launch_counts()
    cs = _train(["--model", "cs", "--log_dir", cs_dir, "--max_steps", "2",
                 "--warm_start", f"{c_dir}::FlowNetC", *common])
    counts = path_counts()
    c_tree = warmstart.flatten(warmstart.load_params_tree(c_dir))
    cs_tree = warmstart.flatten(warmstart.load_params_tree(cs_dir))
    frozen = {k: v for k, v in cs_tree.items() if k.startswith("FlowNetC/")}
    same = all(np.array_equal(v, c_tree[k[len("FlowNetC/"):]])
               for k, v in frozen.items())
    f32_leaves = all(v.dtype == np.float32 for v in cs_tree.values())
    log(f"phase {phase}: cli train --model cs ({dtype}) --warm_start "
        f"{c_dir}::FlowNetC, {len(cs)} steps: correlation launches {counts}; "
        f"{len(frozen)} FlowNetC leaves bitwise equal to the C checkpoint: "
        f"{same}; checkpoint leaves all f32: {f32_leaves}")
    if not all(math.isfinite(r["loss"]) for r in cs) or len(cs) != 2:
        raise AssertionError(f"bad CS run {cs}")
    _check_counts(counts, 2, 0, dtype, f"phase {phase} CS with C frozen")
    if len(frozen) != len(c_tree) or not same:
        raise AssertionError("the frozen FlowNetC moved")
    if not f32_leaves:
        raise AssertionError("checkpoint leaves are not all f32")


def train_step_numbers(phase, dtype, bwd_ms):
    """FlowNetC train step at b8 320x448 on the card at ``dtype`` (f32:
    TF32 off); returns its median ms."""
    import torch

    from flownet2_tf_tpu_torch.data.loader import (
        BatchLoader,
        SyntheticFlowDataset,
    )
    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel
    from flownet2_tf_tpu_torch.training.loop import TrainConfig, Trainer

    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(TrainConfig(
            model="c", schedule="short", log_dir=tmp, device="cuda",
            tensorboard=False, checkpoint_every=0, compute_dtype=dtype))
        state = trainer.init_state()
    loader = BatchLoader(SyntheticFlowDataset(
        size=64, height=TRAIN_H, width=TRAIN_W, seed=SEED),
        batch_size=TRAIN_BATCH)
    batches = loader.batches()
    t0 = time.perf_counter()
    host = [next(batches) for _ in range(6)]
    host_ms = (time.perf_counter() - t0) * 1000.0 / len(host)
    batches.close()
    preprocess = {"crop_height": TRAIN_H, "crop_width": TRAIN_W,
                  "image_a": {}, "image_b": {}}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    i = iter(range(10**9))

    def step():
        return trainer.train_step(state, host[next(i) % len(host)],
                                  preprocess)

    before = correlation_kernel.BWD_LAUNCHES_BY_DTYPE[dtype]
    times = cuda_time_ms(step, runs=12, warmup=3)
    metrics = {k: float(v) for k, v in step().items()}
    torch.cuda.synchronize()
    if correlation_kernel.BWD_LAUNCHES_BY_DTYPE[dtype] - before != 16:
        raise AssertionError(f"timed steps did not launch the backward on "
                             f"{dtype} features")
    busy, corr = corr_profile_ms(step)
    log(f"phase {phase}: profile of one {dtype} train step: {busy:.3f} ms of "
        f"device time, correlation forward {corr['forward']:.3f} ms, backward "
        f"da {corr['da']:.3f} + db {corr['db']:.3f} ms")
    if not min(corr.values()) > 0:
        raise AssertionError("the profile misses a correlation kernel")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite train metrics {metrics}")
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times)
    note = " (TF32 off)" if dtype == "float32" else ""
    log(f"phase {phase}: FlowNetC train step b{TRAIN_BATCH} {TRAIN_H}x"
        f"{TRAIN_W} {dtype}{note}: median {med:.3f} ms over {len(times)} "
        f"steps (min {min(times):.3f}, max {max(times):.3f}), "
        f"{TRAIN_BATCH * 1000.0 / med:.2f} examples/s, peak memory "
        f"{peak / 2**20:.1f} MiB; correlation backward {bwd_ms:.4f} ms "
        f"(phase 4, {dtype} inputs) = {100.0 * bwd_ms / med:.2f}% of the "
        f"step; host synthetic batch {host_ms:.1f} ms (BatchLoader, 4 "
        f"threads)")
    return med


def phase7_bf16_main_path(tmp, ckpt, tree, flow_cpu):
    """FlowNet2 through ``cli test --compute_dtype bfloat16`` on the card:
    one forward launch on bf16 features, and a flow as far from the f32
    CPU flow as the bf16 CPU path's, within BF16_EPE_RATIO."""
    from flownet2_tf_tpu_torch.training import infer
    from flownet2_tf_tpu_torch.utils.image_io import load_image_pair

    flow_card, counts = _cli_test(ckpt, os.path.join(tmp, "out_bf16"),
                                  "bfloat16")
    log(f"phase 7: cli test --model 2 --compute_dtype bfloat16 --device "
        f"cuda: correlation launches {counts}")
    _check_counts(counts, 1, 0, "bfloat16", "phase 7")
    a, b = load_image_pair(os.path.join(SAMPLES, "0img0.ppm"),
                           os.path.join(SAMPLES, "0img1.ppm"))
    flow_cpu_bf16 = infer.infer_flow("2", tree, a, b, device="cpu",
                                     compute_dtype="bfloat16")
    card, cpu = _epe(flow_card, flow_cpu), _epe(flow_cpu_bf16, flow_cpu)
    log(f"phase 7: mean EPE to the f32 CPU flow: bf16 card {card:.4e} px, "
        f"bf16 CPU {cpu:.4e} px (limit {BF16_EPE_RATIO} x the CPU's); "
        f"bf16 card to bf16 CPU {_epe(flow_card, flow_cpu_bf16):.4e} px")
    if not card <= BF16_EPE_RATIO * cpu:
        raise AssertionError(f"bf16 card flow {card} px from the f32 flow, "
                             f"CPU bf16 {cpu} px")


def _smooth_field(rng, h, w, channels, cell):
    """Uniform noise on a grid of ``cell``-pixel cells, bilinearly
    upsampled to (h, w, channels) in [0, 1)."""
    from flownet2_tf_tpu_torch.data.loader import _bilinear_upsample

    small = rng.rand(h // cell + 2, w // cell + 2, channels)
    return _bilinear_upsample(small.astype("float32"), h, w)


def _render_pair(rng, h, w, max_flow=12.0):
    """A smooth random texture A, a smooth random flow and B = A moved by
    it (``flow_warp(B, flow) ~= A``, as the synthetic dataset draws them):
    uint8 images, f32 flow."""
    import numpy as np

    from flownet2_tf_tpu_torch.data.loader import _backward_resample

    a = _smooth_field(rng, h, w, 3, 8)
    flow = (_smooth_field(rng, h, w, 2, 128) * 2 - 1) * max_flow
    b = _backward_resample(a, -flow)
    to_u8 = lambda x: (np.clip(x, 0, 1) * 255 + 0.5).astype(np.uint8)  # noqa: E731
    return to_u8(a), to_u8(b), flow.astype(np.float32)


def _write_sintel(root, rng):
    """MPI-Sintel training layout: 2 sequences x 3 frames, 4 pairs."""
    from flownet2_tf_tpu_torch.utils import flowlib
    from flownet2_tf_tpu_torch.utils.image_io import write_image

    h, w = SINTEL_HW
    for seq in ("alley_1", "market_2"):
        img = os.path.join(root, "training", "clean", seq)
        flo = os.path.join(root, "training", "flow", seq)
        os.makedirs(img)
        os.makedirs(flo)
        a, b, flow = _render_pair(rng, h, w)
        _, c, flow2 = _render_pair(rng, h, w)
        for i, frame in enumerate((a, b, c), start=1):
            write_image(frame, os.path.join(img, f"frame_{i:04d}.png"))
        for i, f in enumerate((flow, flow2), start=1):
            flowlib.write_flow(f, os.path.join(flo, f"frame_{i:04d}.flo"))
    return root


def _write_kitti(root, rng):
    """KITTI 2012 layout: colored_0/ pairs and flow_occ/ 16-bit PNG GT,
    about half its pixels valid (a smooth random mask)."""
    from flownet2_tf_tpu_torch.utils import flowlib
    from flownet2_tf_tpu_torch.utils.image_io import write_image

    base = os.path.join(root, "training")
    os.makedirs(os.path.join(base, "colored_0"))
    os.makedirs(os.path.join(base, "flow_occ"))
    for i, (h, w) in enumerate(KITTI_HWS):
        a, b, flow = _render_pair(rng, h, w)
        valid = _smooth_field(rng, h, w, 1, 32)[..., 0] > 0.5
        write_image(a, os.path.join(base, "colored_0", f"{i:06d}_10.png"))
        write_image(b, os.path.join(base, "colored_0", f"{i:06d}_11.png"))
        flowlib.write_kitti_png_flow(
            flow, os.path.join(base, "flow_occ", f"{i:06d}_10.png"),
            valid=valid.astype("uint16"))
    return root


@contextlib.contextmanager
def _recording_launches():
    """Record (shape, dtype) of every correlation forward launch, the
    device time (CUDA events) and batch size of every on-device AEE call,
    and when the model was loaded, while the block runs."""
    import torch

    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel as ck
    from flownet2_tf_tpu_torch.training import infer

    rec = {"shapes": [], "aee": [], "loaded": None}
    launch, aee, load = ck._launch, infer._aee_on_device, infer.inference_model

    def load_timed(*args, **knobs):
        model = load(*args, **knobs)
        rec["loaded"] = time.perf_counter()
        return model

    def launch_spy(a, b, max_displacement, stride_2):
        rec["shapes"].append((tuple(a.shape), str(a.dtype).split(".")[-1]))
        return launch(a, b, max_displacement, stride_2)

    def aee_timed(model, batch, compute_dtype):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = aee(model, batch, compute_dtype)
        end.record()
        rec["aee"].append((start, end, batch["input_a"].shape[0]))
        return out

    ck._launch, infer._aee_on_device = launch_spy, aee_timed
    infer.inference_model = load_timed
    try:
        yield rec
    finally:
        ck._launch, infer._aee_on_device = launch, aee
        infer.inference_model = load


def _cli_eval(argv):
    """``cli eval`` in-process between a reset and a read of the launch
    counts; returns (JSON line, counts, launch record, wall s). The
    record's ``loop_s`` is the wall time after the model was loaded."""
    from flownet2_tf_tpu_torch import cli
    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel

    buf = io.StringIO()
    correlation_kernel.reset_launch_counts()
    t0 = time.perf_counter()
    with _recording_launches() as rec, contextlib.redirect_stdout(buf):
        rc = cli.main(["eval", *argv])
    end = time.perf_counter()
    wall = end - t0
    rec["loop_s"] = end - rec["loaded"]
    counts = path_counts()
    if rc != 0:
        raise AssertionError(f"cli eval {argv} returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1]), counts, rec, wall


def _bucket(hw):
    return tuple(-(-x // 64) * 64 for x in hw)


def _host_aee(out_dir, dataset, n):
    """Mean per-pair AEE in numpy from the written NNNNNN_flow.flo files
    and the dataset's GT (KITTI: its valid mask)."""
    import numpy as np

    from flownet2_tf_tpu_torch.utils import flowlib

    total = 0.0
    for i in range(n):
        flow = flowlib.read_flow(os.path.join(out_dir, f"{i:06d}_flow.flo"))
        gt = dataset[i]["flow"]
        valid = gt[..., 2] if gt.shape[-1] == 3 else np.ones(gt.shape[:2])
        epe = np.sqrt(((flow.astype(np.float64) - gt[..., :2]) ** 2).sum(-1))
        total += float((epe * valid).sum()) / max(float(valid.sum()), 1.0)
    return total / n


def _eval_one_dataset(tmp, ckpt, name, root, dataset):
    """Phase 10 on one layout: see phase10_eval."""
    import numpy as np

    from flownet2_tf_tpu_torch.training import infer
    from flownet2_tf_tpu_torch.utils import flowlib

    n = len(dataset)
    sizes = [dataset[i]["image_a"].shape[:2] for i in range(n)]
    per_bucket = {}
    for hw in sizes:
        per_bucket[_bucket(hw)] = per_bucket.get(_bucket(hw), 0) + 1
    eval_batches = sum(-(-k // EVAL_BATCH) for k in per_bucket.values())
    base = ["--model", "2", "--ckpt", ckpt, "--dataset", name,
            "--data_root", root]
    card = base + ["--device", "cuda"]

    # host decode and %64 padding per pair, as evaluate_dataset does it
    t0 = time.perf_counter()
    for i in range(n):
        infer._bucket_batch(dataset[i])
    decode_ms = (time.perf_counter() - t0) * 1000.0 / n

    aee = {}
    # each run twice: the second finds the shapes' first forwards done
    for dtype, run in itertools.product(("float32", "bfloat16"),
                                        ("first", "second")):
        line, counts, rec, wall = _cli_eval(
            card + ["--compute_dtype", dtype, "--eval_batch", str(EVAL_BATCH)])
        _check_counts(counts, eval_batches, 0, dtype, f"phase 10 {name} {dtype}")
        if line["pairs"] != n or not math.isfinite(line["aee"]):
            raise AssertionError(f"phase 10 {name} {dtype}: {line}")
        aee[dtype] = line["aee"]
        fwd_ms = sum(s.elapsed_time(e) for s, e, _ in rec["aee"])
        log(f"phase 10: cli eval --model 2 --dataset {name} --compute_dtype "
            f"{dtype} --eval_batch {EVAL_BATCH} --device cuda ({run} run): AEE "
            f"{line['aee']:.6f} px over {n} pairs; correlation launches "
            f"{counts['fwd'][dtype]} at {sorted(set(rec['shapes']))}; wall "
            f"{wall:.2f} s with the checkpoint load ({n / wall:.2f} "
            f"pairs/s), {rec['loop_s']:.3f} s after it ({n / rec['loop_s']:.2f} "
            f"pairs/s); forward + AEE {fwd_ms / n:.3f} ms/pair between CUDA "
            f"events around each of the {len(rec['aee'])} batches; host "
            f"decode + pad {decode_ms:.1f} ms/pair")

    # --save_outputs batches consecutive pairs of one frame size
    forwards, i = 0, 0
    while i < n:
        j = i + 1
        while j < n and j - i < EVAL_BATCH and sizes[j] == sizes[i]:
            j += 1
        forwards, i = forwards + 1, j
    out = os.path.join(tmp, f"{name}_f32_outputs")
    line, counts, rec, _ = _cli_eval(
        card + ["--eval_batch", str(EVAL_BATCH), "--save_outputs", out])
    _check_counts(counts, forwards, 0, "float32", f"phase 10 {name} outputs")
    numpy_aee = _host_aee(out, dataset, n)
    log(f"phase 10: {name} f32 --save_outputs AEE {line['aee']:.6f} px, numpy "
        f"AEE of the written .flo files {numpy_aee:.6f} px, on-device "
        f"{aee['float32']:.6f} px (rtol {AEE_RTOL}); correlation launches "
        f"{counts['fwd']['float32']}")
    for what, x in (("--save_outputs", line["aee"]), ("numpy", numpy_aee)):
        if not abs(x - aee["float32"]) <= AEE_RTOL * abs(aee["float32"]):
            raise AssertionError(f"phase 10 {name}: {what} AEE {x} vs the "
                                 f"on-device AEE {aee['float32']}")
    if name == "kitti":
        kitti = flowlib.read_flow(os.path.join(out, "000000_flow_kitti.png"))
        flo = flowlib.read_flow(os.path.join(out, "000000_flow.flo"))
        if kitti.shape != flo.shape[:2] + (3,) or not (
                np.abs(kitti[..., :2] - np.clip(flo, -512, 32767 / 64)).max()
                <= 1 / 64):
            raise AssertionError("phase 10: the KITTI PNG does not read back")

    # one pair on the card and on the CPU: f32 AEE, and the flows of both
    # dtypes for the bf16 check
    one = ["--limit", "1", "--eval_batch", "1"]
    card_f32, counts, rec, _ = _cli_eval(card + one)
    card_bf16, _, rec_bf16, _ = _cli_eval(
        card + one + ["--compute_dtype", "bfloat16", "--save_outputs",
                      os.path.join(tmp, f"{name}_card_bf16")])
    t0 = time.perf_counter()
    cpu = {}
    for dtype in ("float32", "bfloat16"):
        cpu[dtype], _, _, _ = _cli_eval(
            base + one + ["--device", "cpu", "--compute_dtype", dtype,
                          "--save_outputs",
                          os.path.join(tmp, f"{name}_cpu_{dtype}")])
    cpu_s = time.perf_counter() - t0
    flows = {k: flowlib.read_flow(os.path.join(tmp, f"{name}_{k}",
                                               "000000_flow.flo"))
             for k in ("card_bf16", "cpu_float32", "cpu_bfloat16")}
    shape0 = (1,) + tuple(x // 8 for x in _bucket(sizes[0])) + (256,)
    if (rec["shapes"] != [(shape0, "float32")]
            or rec_bf16["shapes"] != [(shape0, "bfloat16")]):
        raise AssertionError(f"phase 10 {name}: one-pair launches "
                             f"{rec['shapes']} {rec_bf16['shapes']}")
    err = abs(card_f32["aee"] - cpu["float32"]["aee"])
    card_gap = _epe(flows["card_bf16"], flows["cpu_float32"])
    cpu_gap = _epe(flows["cpu_bfloat16"], flows["cpu_float32"])
    log(f"phase 10: {name} pair 0: f32 AEE card {card_f32['aee']:.6f} px, CPU "
        f"{cpu['float32']['aee']:.6f} px, |diff| {err:.3e} (limit "
        f"{AEE_ATOL}); bf16 AEE card {card_bf16['aee']:.6f}, CPU "
        f"{cpu['bfloat16']['aee']:.6f}; mean EPE to the CPU f32 flow: bf16 "
        f"card {card_gap:.4e} px, bf16 CPU {cpu_gap:.4e} px (limit "
        f"{BF16_EPE_RATIO} x the CPU's); correlation at {shape0}; the two "
        f"CPU runs took {cpu_s:.1f} s")
    if not err <= AEE_ATOL:
        raise AssertionError(f"phase 10 {name}: card f32 AEE "
                             f"{card_f32['aee']} vs CPU {cpu['float32']}")
    if not card_gap <= BF16_EPE_RATIO * cpu_gap:
        raise AssertionError(f"phase 10 {name}: bf16 card flow {card_gap} px "
                             f"from the f32 flow, CPU bf16 {cpu_gap} px")


def phase10_eval(tmp, ckpt):
    """``cli eval --model 2`` at full width on the card, on a Sintel and a
    KITTI layout written from the seed, in f32 and bf16: one correlation
    forward launch per batch on the features' dtype; the f32 AEE held
    against the CPU's on one pair (AEE_ATOL), against the ``--save_outputs``
    pass and a numpy AEE of the written flows (AEE_RTOL); the bf16 flow as
    far from the CPU's f32 flow as the CPU's bf16 flow, within
    BF16_EPE_RATIO (that distance bounds the bf16-vs-f32 AEE gap)."""
    import numpy as np

    from flownet2_tf_tpu_torch.data import loader

    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED)
    sintel = _write_sintel(os.path.join(tmp, "sintel"), rng)
    kitti = _write_kitti(os.path.join(tmp, "kitti"), rng)
    log(f"phase 10: wrote the Sintel and KITTI layouts in "
        f"{time.perf_counter() - t0:.1f} s")
    _eval_one_dataset(tmp, ckpt, "sintel", sintel,
                      loader.SintelDataset(sintel))
    _eval_one_dataset(tmp, ckpt, "kitti", kitti, loader.KittiDataset(kitti))
    wall = time.perf_counter() - t0
    log(f"phase 10: wall time {wall:.1f} s (budget {PHASE10_BUDGET_S} s)")
    if wall > PHASE10_BUDGET_S:
        raise AssertionError("phase 10 overran its time budget")


@contextlib.contextmanager
def _recording_image_feed():
    """Record the dtype and device of every image batch the trainer
    converts (``training/loop.py::_images_to_float``)."""
    from flownet2_tf_tpu_torch.training import loop

    seen, real = [], loop._images_to_float

    def spy(x):
        seen.append((str(x.dtype).split(".")[-1], x.device.type))
        return real(x)

    loop._images_to_float = spy
    try:
        yield seen
    finally:
        loop._images_to_float = real


def _write_chairs(tmp):
    """A FlyingChairs raw layout of CHAIRS_PAIRS pairs written from the
    seed under ``tmp``, and a copy of its first 4 pairs; returns both
    directories."""
    import numpy as np

    from flownet2_tf_tpu_torch.utils import flowlib
    from flownet2_tf_tpu_torch.utils.image_io import write_image

    rng = np.random.RandomState(SEED + 11)
    chairs = os.path.join(tmp, "chairs")
    first4 = os.path.join(tmp, "chairs4")
    os.makedirs(chairs)
    os.makedirs(first4)
    for i in range(CHAIRS_PAIRS):
        a, b, flow = _render_pair(rng, *CHAIRS_HW)
        for d in (chairs, first4) if i < 4 else (chairs,):
            stem = os.path.join(d, f"{i:05d}")
            write_image(a, stem + "_img1.ppm")
            write_image(b, stem + "_img2.ppm")
            flowlib.write_flow(flow, stem + "_flow.flo")
    return chairs, first4


def phase11_train_from_disk(tmp):
    """``cli train --model c --dataset flying_chairs`` on the card from a
    raw layout written from the seed (bf16, b8, the config's crop), then
    from TFRecords written by ``cli make-tfrecords`` (b4, uint8 images):
    one forward and one backward launch per step, finite losses. Returns
    the layout's directory and the pure-Python CRC32C's MB/s."""
    from flownet2_tf_tpu_torch import cli
    from flownet2_tf_tpu_torch.data import tfrecord
    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel

    t0 = time.perf_counter()
    chairs, first4 = _write_chairs(tmp)
    log(f"phase 11: wrote {CHAIRS_PAIRS} FlyingChairs pairs at "
        f"{CHAIRS_HW[0]}x{CHAIRS_HW[1]} in {time.perf_counter() - t0:.1f} s")

    common = ["--model", "c", "--dataset", "flying_chairs", "--data_root",
              chairs, "--device", "cuda", "--schedule", "short",
              "--log_every", "1"]
    runs = (("raw layout", 10, 8, [], "float32"),
            ("TFRecords", 3, 4, ["--tfrecords_train",
                                 os.path.join(tmp, "train.tfrecords")],
             "uint8"))
    for what, steps, batch, extra, wire in runs:
        if extra:
            t1 = time.perf_counter()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["make-tfrecords", "--data_root", first4,
                               "--out", extra[1]])
            made = time.perf_counter() - t1
            payload = next(tfrecord.read_records(extra[1], verify_crc=False))
            t1 = time.perf_counter()
            tfrecord.crc32c_py(payload)
            crc_s = time.perf_counter() - t1
            crc_py_mb_s = len(payload) / 1e6 / crc_s
            size = os.path.getsize(extra[1])
            log(f"phase 11: cli make-tfrecords: {buf.getvalue().strip()}, "
                f"{size / 1e6:.2f} MB in {made:.2f} s (native CRC32C); the "
                f"pure-Python CRC32C of one {len(payload) / 1e6:.2f} MB "
                f"record took {crc_s:.2f} s ({crc_py_mb_s:.2f} MB/s)")
            if rc != 0 or json.loads(buf.getvalue())["train"] != 4:
                raise AssertionError("cli make-tfrecords failed")
        correlation_kernel.reset_launch_counts()
        t1 = time.perf_counter()
        with _recording_image_feed() as seen:
            recs = _train([*common, *extra, "--batch_size", str(batch),
                           "--max_steps", str(steps), "--log_dir",
                           os.path.join(tmp, f"run_{wire}")])
        counts = path_counts()
        losses = [r["loss"] for r in recs]
        log(f"phase 11: cli train --model c --dataset flying_chairs from the "
            f"{what}, b{batch}, bf16: {len(recs)} steps in "
            f"{time.perf_counter() - t1:.1f} s, correlation launches "
            f"{counts}; losses {[round(x, 4) for x in losses]}; examples/s "
            f"{[round(r['examples_per_sec'], 1) for r in recs]}; images "
            f"crossed as {sorted(set(seen))}")
        if [r["step"] for r in recs] != list(range(1, steps + 1)):
            raise AssertionError(f"logged steps {[r['step'] for r in recs]}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite loss in {losses}")
        _check_counts(counts, steps, steps, "bfloat16", f"phase 11 {what}")
        if seen != [(wire, "cuda")] * (2 * steps):
            raise AssertionError(f"phase 11 {what}: the images crossed as "
                                 f"{seen}, not {wire}")
    wall = time.perf_counter() - t0
    log(f"phase 11: wall time {wall:.1f} s (budget {PHASE11_BUDGET_S} s)")
    if wall > PHASE11_BUDGET_S:
        raise AssertionError("phase 11 overran its time budget")
    return chairs, crc_py_mb_s


def _cli_export(argv):
    """``cli export --aot`` in-process; returns (metadata, wall s)."""
    from flownet2_tf_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["export", "--aot", *argv])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli export --aot {argv} returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1]), wall


def serve_worker(spec_path):
    """Phase 12's fresh process: load each artifact of the spec with
    ``tools/aot.py::load_serving`` and serve it; write loads, flows,
    times, launch counts and the modules it imported to the spec's
    result file. Imports no model module itself."""
    import numpy as np
    import torch

    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel as ck
    from flownet2_tf_tpu_torch.tools.aot import load_serving

    with open(spec_path) as f:
        spec = json.load(f)
    if spec.get("threads"):
        torch.set_num_threads(spec["threads"])
    if spec.get("wait_for"):
        # started ahead: the card ready, then wait for the artifacts
        if torch.cuda.is_available():
            torch.cuda.init()
        for path in spec["wait_for"]:
            _wait_for_file(path)
    ck.reset_launch_counts()
    # every artifact loaded first; a gated worker then waits for its go,
    # so that its timed calls never meet another process's work
    loads = []
    for task in spec["tasks"]:
        t0 = time.perf_counter()
        loads.append(None if task["kind"] == "cli_serve" else (
            load_serving(task["artifact"], device=task.get("device")),
            time.perf_counter() - t0))
    if spec.get("go"):
        _go(spec["ready"])
        _wait_for_file(spec["go"])
    calls, results = 0, []
    for task, loaded in zip(spec["tasks"], loads):
        t0 = time.perf_counter()
        if task["kind"] == "cli_serve":
            from flownet2_tf_tpu_torch import cli

            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["serve", "--artifact", task["artifact"],
                               "--input_a", task["input_a"], "--input_b",
                               task["input_b"], "--out", task["out"]])
            calls += 1
            results.append({"rc": rc, "line": buf.getvalue().strip(),
                            "wall_s": time.perf_counter() - t0})
            continue
        # a task may name the platform to serve (a multi-platform
        # artifact); else the artifact's one platform
        sm, load_s = loaded
        res = {"load_s": load_s}
        device = torch.device(task.get("device")
                              or sm.meta["platforms"][0])
        gen = torch.Generator(device=device).manual_seed(SEED)

        def timed(fn, n):
            times = cuda_time_ms(fn, runs=10, warmup=3)
            return {"ms_per_pair": statistics.median(times) / n,
                    "min": min(times) / n, "max": max(times) / n,
                    "runs": len(times)}

        if task["kind"] == "single":
            with np.load(task["pair"]) as pair:
                a, b = (torch.from_numpy(pair[k]).to(device)
                        for k in ("a", "b"))
            # no cuDNN flag set here: the served call sets its own
            flow = sm(a, b)
            calls += 1
            if task.get("tf32_check"):
                # the caller's TF32 flags must not reach the graph
                torch.backends.cudnn.allow_tf32 = True
                torch.backends.cuda.matmul.allow_tf32 = True
                res["tf32_same"] = bool(torch.equal(flow, sm(a, b)))
                calls += 1
            np.save(task["flow_out"], flow.cpu().numpy())
            if device.type == "cuda":
                # a second call: bitwise the first under both policies
                # (cuDNN's deterministic algorithms)
                again = sm(a, b)
                res["same"] = bool(torch.equal(again, flow))
                res["spread_px"] = float(
                    torch.sqrt(((again - flow) ** 2).sum(-1)).mean())
                calls += 1
                if task.get("timed", True):
                    res.update(timed(lambda: sm(a, b), 1))
                    calls += 13
        elif task["kind"] == "bundle":
            res["shapes"] = []
            for bhw in task["shapes"]:
                a, b = (torch.rand((*bhw, 3), generator=gen, device=device)
                        for _ in range(2))
                flow = sm(a, b)
                calls += 2
                res["shapes"].append({
                    "shape": list(flow.shape),
                    "finite": bool(torch.isfinite(flow).all()),
                    "same": bool(torch.equal(sm(a, b), flow))})
                if bhw == task["time_shape"] and device.type == "cuda":
                    res.update(timed(lambda: sm(a, b), bhw[0]))
                    calls += 13
            h, w = task["pair_hw"]
            rng = np.random.RandomState(SEED)
            flow = sm.infer_pair(rng.rand(h, w, 3), rng.rand(h, w, 3))
            calls += 1
            res["pair_flow"] = list(flow.shape)
        res["wall_s"] = time.perf_counter() - t0
        results.append(res)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    out = {"results": results, "calls": calls,
           "launches": dict(ck.LAUNCHES_BY_DTYPE),
           "bwd_launches": dict(ck.BWD_LAUNCHES_BY_DTYPE),
           "imported": sorted(
               m for m in sys.modules
               if m.startswith("flownet2_tf_tpu_torch.models")
               or m.split(".")[0] in ("jax", "flownet2_tf_tpu"))}
    with open(spec["result"], "w") as f:
        json.dump(out, f)
    return 0


def _start_worker(tmp, name, tasks, threads=None, wait_for=(), gated=False):
    """Start a fresh ``serve_worker`` process on ``tasks`` (once every file
    of ``wait_for`` exists). A ``gated`` worker loads its artifacts and
    then waits for its go (:func:`_wait_ready`)."""
    spec = os.path.join(tmp, f"serve_{name}.json")
    result = os.path.join(tmp, f"serve_{name}_result.json")
    gate = {"ready": spec + ".ready", "go": spec + ".go"} if gated else {}
    with open(spec, "w") as f:
        json.dump({"tasks": tasks, "result": result, "threads": threads,
                   "wait_for": list(wait_for), **gate}, f)
    log_path = os.path.join(tmp, f"serve_{name}.log")
    proc = _start_child("serve_worker", spec, log_path)
    return {"name": name, "proc": proc, "result": result, "log": log_path,
            "t0": time.perf_counter(), **gate}


def _wait_ready(worker):
    """Wait until a gated worker has loaded its artifacts (or has exited:
    its failure then shows in _finish_worker). ``_go(worker["go"])``
    then lets it serve."""
    t0 = time.perf_counter()
    while not os.path.exists(worker["ready"]):
        if (worker["proc"].poll() is not None
                or time.perf_counter() - t0 > CHILD_TIMEOUT_S):
            return
        time.sleep(0.05)


def _start_export(tmp, key, job, nice=0):
    """Start an export into ``<tmp>/<key>.flowpak`` in a child process
    (at niceness ``nice``): ``cli export --aot`` of ``job``'s arguments
    (a list), or ``export_serving`` of FlowNet2 at 448x1024 with
    ``job``'s keyword arguments and its ``ckpt`` (a dict). Its result
    file appears once the artifact is whole: a worker started ahead waits
    for it (``done``)."""
    path = os.path.join(tmp, f"{key}.flowpak")
    spec = os.path.join(tmp, f"export_{key}.json")
    with open(spec, "w") as f:
        json.dump({"result": spec + ".out", "nice": nice, **(
            {"argv": [*job, "--out", path]} if isinstance(job, list) else
            {"api": dict(job, out_path=path)})}, f)
    log_path = os.path.join(tmp, f"export_{key}.log")
    return {"key": key, "path": path, "done": spec + ".out", "log": log_path,
            "proc": _start_child("export_worker", spec, log_path)}


def _export_done(started):
    """Wait for an export's child; returns (metadata, its export's wall
    s)."""
    _wait_child(started["proc"], started["log"],
                f"export {started['key']}")
    with open(started["done"]) as f:
        out = json.load(f)
    return out["meta"], out["wall_s"]


def _exported(tmp, jobs, ahead=None):
    """{key: (path, metadata, export wall s)} of the exports ``jobs``
    ({key: job of _start_export}): those in ``ahead`` (traced in phase
    12's children), the others traced now, each in a child of its own,
    all at once."""
    got = {k: ahead[k] for k in jobs if k in (ahead or {})}
    started = {k: _start_export(tmp, k, job) for k, job in jobs.items()
               if k not in got}
    for k, job in started.items():
        got[k] = (job["path"], *_export_done(job))
    return got


def _f2_export_argv(ckpt, *argv):
    """``cli export --aot`` arguments of FlowNet2 f32 with exact warps at
    448x1024 from ``ckpt``, then ``argv``."""
    h, w = SERVE_HW
    return ["--model", "2", "--ckpt", ckpt, "--height", str(h), "--width",
            str(w), "--compute_dtype", "float32", "--warp_mode", "full",
            *argv]


def _finish_worker(worker, dtype):
    """Wait for a worker; check it imported no model module and launched
    the correlation forward exactly once per served call on ``dtype``
    features (none for a CPU artifact); add its launches to
    PATH_LAUNCHES. Returns its results, call count and wall time."""
    name = worker["name"]
    _wait_child(worker["proc"], worker["log"], f"serving process {name}",
                timeout=900)
    wall = time.perf_counter() - worker["t0"]
    with open(worker["result"]) as f:
        out = json.load(f)
    if out["imported"]:
        raise AssertionError(f"phase 12 {name}: loading the artifact "
                             f"imported {out['imported']}")
    want = out["calls"] if dtype else 0
    if (out["launches"].get(dtype, 0) != want
            or sum(out["launches"].values()) != want
            or sum(out["bwd_launches"].values())):
        raise AssertionError(
            f"phase 12 {name}: {out['calls']} served calls, correlation "
            f"launches {out['launches']} (backward {out['bwd_launches']})")
    for k, n in out["launches"].items():
        PATH_LAUNCHES["fwd"][k] += n
    return out["results"], out["calls"], wall


def _eager_ms(model, batch, cd, inputs):
    """(median, min) CUDA-event ms per pair of the eager forward, 10 runs
    after 3 warm-ups."""
    import torch

    with torch.inference_mode():
        times = cuda_time_ms(lambda: model(inputs, cd), runs=10, warmup=3)
    return statistics.median(times) / batch, min(times) / batch


def phase12_serving(tmp, tree, ckpt, phase2_flo, extra_exports=None):
    """FlowNet2 serving artifacts through ``cli export --aot`` and ``cli
    serve``, each loaded in a fresh process (see the module docstring).
    ``extra_exports`` ({key: job of _start_export}) are later phases'
    exports, traced in this phase's children beside its own; returns
    {key: (path, metadata, export wall s)} of them."""
    import numpy as np
    import torch

    from flownet2_tf_tpu_torch.models import common
    from flownet2_tf_tpu_torch.models.registry import get_model
    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel
    from flownet2_tf_tpu_torch.training import infer, warmstart
    from flownet2_tf_tpu_torch.utils import flowlib

    t0 = time.perf_counter()
    h, w = SERVE_HW
    rng = np.random.RandomState(SEED + 12)
    a_np, b_np = (rng.rand(1, h, w, 3).astype(np.float32) for _ in range(2))
    pair = os.path.join(tmp, "serve_pair.npz")
    np.savez(pair, a=a_np, b=b_np)
    shape = ["--height", str(h), "--width", str(w)]
    configs = {"f32_full": ("float32", "full"), "f32_half": ("float32", "half"),
               "bf16_half": ("bfloat16", "half")}
    card = ["--model", "2", "--ckpt", ckpt, "--device", "cuda"]
    jobs = {f"cpu_{key}": ["--model", "2", "--ckpt", ckpt, "--device", "cpu",
                           "--compute_dtype", configs[key][0], "--warp_mode",
                           configs[key][1], *shape]
            for key in ("f32_half", "bf16_half")}
    for key, (dtype, mode) in configs.items():
        jobs[key] = card + ["--compute_dtype", dtype, "--warp_mode", mode,
                            *shape]
    jobs["bundle"] = card + ["--shapes", "448x1024,384x1280,448x1024x8"]
    jobs["serve_192"] = card + ["--compute_dtype", "float32", "--warp_mode",
                                "full", "--height", "192", "--width", "256"]
    # every export traces in a child of its own at once (tracing is host
    # work on one core), the later phases' at a lower priority; each
    # serving process starts beside them, waits for its artifacts and
    # loads them: the CPU artifacts and cli serve then serve at once, the
    # card artifacts once released, one process at a time
    own = {key: _start_export(tmp, key, argv) for key, argv in jobs.items()}
    later = {key: _start_export(tmp, key, job, nice=10)
             for key, job in (extra_exports or {}).items()}
    started = {**own, **later}
    paths = {key: job["path"] for key, job in started.items()}
    done = {key: job["done"] for key, job in started.items()}
    flows = {key: os.path.join(tmp, f"{key}_flow.npy") for key in configs}
    cpu_worker = _start_worker(tmp, "cpu", [{
        "kind": "single", "artifact": paths[f"cpu_{key}"], "pair": pair,
        "flow_out": os.path.join(tmp, f"cpu_{key}_flow.npy")}
        for key in ("f32_half", "bf16_half")], threads=4,
        wait_for=[done["cpu_f32_half"], done["cpu_bf16_half"]])
    out_dir = os.path.join(tmp, "serve_out")
    cli_worker = _start_worker(tmp, "cli_serve", [{
        "kind": "cli_serve", "artifact": paths["serve_192"],
        "input_a": os.path.join(SAMPLES, "0img0.ppm"),
        "input_b": os.path.join(SAMPLES, "0img1.ppm"), "out": out_dir}],
        wait_for=[done["serve_192"]])
    # f32_full last: its TF32 check leaves the caller's TF32 flags on
    workers = {"float32": _start_worker(tmp, "f32", [{
        "kind": "single", "artifact": paths[key], "pair": pair,
        "flow_out": flows[key], "tf32_check": key == "f32_full"}
        for key in ("f32_half", "f32_full")],
        wait_for=[done["f32_half"], done["f32_full"]], gated=True),
        "bfloat16": _start_worker(tmp, "bf16", [{
            "kind": "single", "artifact": paths["bf16_half"], "pair": pair,
            "flow_out": flows["bf16_half"]}, {
            "kind": "bundle", "artifact": paths["bundle"],
            "shapes": [[1, 448, 1024], [1, 384, 1280], [8, 448, 1024]],
            "time_shape": [8, 448, 1024], "pair_hw": list(SINTEL_HW)}],
            wait_for=[done["bf16_half"], done["bundle"]], gated=True)}
    metas, walls = {}, {}

    def wait_exports(jobs):
        for key, job in jobs.items():
            metas[key], walls[key] = _export_done(job)
            log(f"phase 12: export {key} (a child of its own): "
                f"{walls[key]:.2f} s, "
                f"{os.path.getsize(paths[key]) / 1e6:.1f} MB")
        log(f"phase 12: {len(jobs)} exports done at "
            f"{time.perf_counter() - t0:.1f} s")

    wait_exports(own)
    bundle_meta = metas["bundle"]
    if (bundle_meta["compute_dtype"], bundle_meta["warp_mode"]) != (
            "bfloat16", "half"):
        raise AssertionError(f"export defaults: {bundle_meta}")
    _, _, wall = _finish_worker(cpu_worker, None)
    log(f"phase 12: the CPU artifacts served in a fresh process ({wall:.1f} "
        f"s from its start; phase at {time.perf_counter() - t0:.1f} s)")
    results, _, wall = _finish_worker(cli_worker, "float32")
    line = json.loads(results[0]["line"].splitlines()[-1])
    if results[0]["rc"] != 0:
        raise AssertionError(f"phase 12: cli serve {results[0]}")
    log(f"phase 12: cli serve (fresh process, {wall:.1f} s): {line}")

    # the card artifacts served in two fresh processes, one at a time once
    # both have loaded
    for worker in workers.values():
        _wait_ready(worker)
    served = {}
    for dtype, worker in workers.items():
        waited = time.perf_counter() - worker["t0"]
        _go(worker["go"])
        results, calls, wall = _finish_worker(worker, dtype)
        log(f"phase 12: the {dtype} card artifacts served in a fresh process "
            f"({wall:.1f} s from its start, {waited:.1f} s of it until its "
            f"release): {calls} calls, one correlation launch each on "
            f"{dtype} features")
        keys = (["f32_half", "f32_full"] if dtype == "float32"
                else ["bf16_half", "bundle_b8"])
        served.update(zip(keys, results))
    for key in configs:
        res = served[key]
        log(f"phase 12: {key} served: load {res['load_s']:.2f} s; two "
            f"served calls bitwise equal: {res['same']} (mean EPE "
            f"{res['spread_px']:.3e} px apart)")
        if not res["same"]:
            raise AssertionError(f"phase 12 {key}: two served calls differ")
    bundle = served["bundle_b8"]
    log(f"phase 12: bundle served: load {bundle['load_s']:.2f} s; entries "
        f"{bundle['shapes']}; infer_pair at {SINTEL_HW} -> "
        f"{bundle['pair_flow']}")
    if (not all(x["finite"] and x["same"] for x in bundle["shapes"])
            or [x["shape"] for x in bundle["shapes"]]
            != [[1, 448, 1024, 2], [1, 384, 1280, 2], [8, 448, 1024, 2]]
            or bundle["pair_flow"] != [*SINTEL_HW, 2]):
        raise AssertionError(f"phase 12: bundle dispatch {bundle}")

    # the eager forward on the card: cli test, flows, times
    test_flo, counts = _cli_test(ckpt, os.path.join(tmp, "out_again"),
                                 "float32")
    _check_counts(counts, 1, 0, "float32", "phase 12 cli test")
    repeat = bool(np.array_equal(test_flo, phase2_flo))
    log(f"phase 12: cli test f32 again: .flo bitwise phase 2's: {repeat}")
    if not repeat:
        raise AssertionError("phase 12: two f32 cli test runs differ")
    served_flo = flowlib.read_flow(os.path.join(out_dir, "0img0_flow.flo"))
    serve_epe = _epe(served_flo, test_flo)
    log(f"phase 12: cli serve's .flo against cli test's: mean EPE "
        f"{serve_epe:.3e} px (limit {SERVE_EPE}), max abs "
        f"{float(np.abs(served_flo - test_flo).max()):.3e}")
    correlation_kernel.reset_launch_counts()
    inputs = {"input_a": torch.from_numpy(a_np).cuda(),
              "input_b": torch.from_numpy(b_np).cuda()}
    eager = {}
    f32 = torch.float32
    model = infer.load_model("2", tree, "cuda")
    want = infer.forward_flow(model, inputs["input_a"],
                              inputs["input_b"], f32).cpu().numpy()
    eager["f32_full"] = _eager_ms(model, 1, f32, inputs)
    del model
    model = warmstart.load_jax_params(
        get_model("2").build("cuda", warp_res=2), tree)
    eager["f32_half"] = _eager_ms(model, 1, f32, inputs)
    eager_half = infer.forward_flow(model, inputs["input_a"],
                                    inputs["input_b"], f32).cpu().numpy()
    common.cast_params_for_inference(model)
    eager["bf16_half"] = _eager_ms(model, 1, torch.bfloat16, inputs)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    inputs8 = {k: torch.rand((8, h, w, 3), generator=gen, device="cuda")
               for k in inputs}
    eager["bundle_b8"] = _eager_ms(model, 8, torch.bfloat16, inputs8)
    del model, inputs8
    path_counts()

    got = {k: np.load(flows[k]) for k in configs}
    cpu = {k: np.load(os.path.join(tmp, f"cpu_{k}_flow.npy"))
           for k in ("f32_half", "bf16_half")}
    full_epe = _epe(got["f32_full"][0], want[0])
    half_epe = _epe(got["f32_half"][0], cpu["f32_half"][0])
    card_gap = _epe(got["bf16_half"][0], cpu["f32_half"][0])
    cpu_gap = _epe(cpu["bf16_half"][0], cpu["f32_half"][0])
    log(f"phase 12: f32 full artifact vs eager on the card: mean EPE "
        f"{full_epe:.3e} px "
        f"(limit {SERVE_EPE}); with TF32 allowed by the caller the same "
        f"flow: {served['f32_full']['tf32_same']}")
    log(f"phase 12: f32 half artifact, card vs CPU: mean EPE {half_epe:.3e} "
        f"px (limit {AEE_ATOL}); vs the eager half-res forward on the card "
        f"{_epe(got['f32_half'][0], eager_half[0]):.3e} px; half vs full "
        f"flow {_epe(got['f32_half'][0], got['f32_full'][0]):.4f} px")
    log(f"phase 12: bf16 half artifact: mean EPE to the CPU f32-half flow "
        f"{card_gap:.4e} px on the card, {cpu_gap:.4e} px on the CPU (limit "
        f"{BF16_EPE_RATIO} x the CPU's)")
    for key, (ms, lo) in eager.items():
        s = served[key]
        log(f"phase 12: {key} ({'b8' if key == 'bundle_b8' else 'b1'}) "
            f"served {s['ms_per_pair']:.3f} ms/pair (min {s['min']:.3f}, "
            f"max {s['max']:.3f}, {s['runs']} runs) against eager "
            f"{ms:.3f} ms/pair (min {lo:.3f}); served load "
            f"{s['load_s']:.2f} s")
    if not serve_epe <= SERVE_EPE:
        raise AssertionError(f"phase 12: cli serve {serve_epe} px from cli "
                             "test")
    if not full_epe <= SERVE_EPE or not served["f32_full"]["tf32_same"]:
        raise AssertionError("phase 12: the f32 artifact is not the eager "
                             "forward, or the caller's TF32 reached it")
    if not half_epe <= AEE_ATOL:
        raise AssertionError(f"phase 12: f32 half card vs CPU {half_epe} px")
    if not card_gap <= BF16_EPE_RATIO * cpu_gap:
        raise AssertionError(f"phase 12: bf16 card flow {card_gap} px from "
                             f"the CPU f32-half flow, CPU bf16 {cpu_gap} px")
    for key in ("cpu_f32_half", "cpu_bf16_half", "f32_half", "bf16_half",
                "bundle", "serve_192"):
        os.remove(paths[key])
    # the later phases' exports, traced beside this phase's work
    wait_exports(later)
    # printed, not enforced: the hosts behind the card differ (the phase
    # took 184-256 s with its exports one after another, 86-162 s with
    # them in parallel), and the script's limit is what binds
    wall = time.perf_counter() - t0
    log(f"phase 12: wall time {wall:.1f} s (budget {PHASE12_BUDGET_S} s"
        f"{', over it' if wall > PHASE12_BUDGET_S else ''})")
    return {key: (paths[key], metas[key], walls[key])
            for key in extra_exports or {}}


def _cli_lines(argv):
    """``cli`` in-process (the kernel counters stay visible); echoes its
    output and returns its JSON lines."""
    from flownet2_tf_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    sys.stdout.write(buf.getvalue())
    if rc != 0:
        raise AssertionError(f"cli {argv} returned {rc}")
    return [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]


def _bench_attempts(result):
    """The measuring attempts a bench result took: one more than those
    its ``suspect`` names, unless all of them failed."""
    from flownet2_tf_tpu_torch.tools import bench

    failed = result.get("suspect", "").count("attempt ")
    return failed if failed == bench.MEASURE_ATTEMPTS else failed + 1


def phase13_measurement(tmp, earlier):
    """The port's measurement entry points on the card: ``cli bench``,
    ``benchlib.train_step_ms`` and ``cli profile``, each between a reset
    and a read of the correlation's launch counts. ``earlier``: the
    phases' own times of the same shapes, printed beside."""
    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel
    from flownet2_tf_tpu_torch.tools import bench, benchlib, profiler

    t0 = time.perf_counter()
    h, w = SERVE_HW
    shape = ["--model", "2", "--height", str(h), "--width", str(w),
             "--device", "cuda", "--iters", str(BENCH_ITERS)]
    # (what, flags, dtype, warp_mode, the earlier phase's time beside;
    # phases 3 and 8 run exact warps)
    benches = (
        ("f32 b1", ["--compute_dtype", "float32"], "float32", "full",
         "phase 3 f32 b1"),
        ("f32 k2 b1", ["--compute_dtype", "float32", "--warp_res", "2"],
         "float32", "k2", "phase 3 f32 b1"),
        ("bf16 b1", [], "bfloat16", "half", "phase 8 bf16 b1"),
        ("bf16 b8", ["--batch", "8"], "bfloat16", "half", "phase 8 bf16 b8"),
    )
    results = {}
    for what, flags, dtype, mode, beside in benches:
        correlation_kernel.reset_launch_counts()
        out = _cli_lines(["bench", *shape, *flags])[-1]
        counts = path_counts()
        forwards = (bench.WARMUP_FORWARDS
                    + _bench_attempts(out) * out["repeats"] * BENCH_ITERS)
        log(f"phase 13: cli bench {what}: {out['ms_per_pair']:.3f} ms/pair "
            f"(spread {out['spread_pct']}%, mfu {out.get('mfu')}, floor "
            f"{out.get('floor_ms_analytic')} ms) against {beside}: "
            f"{earlier[beside]:.3f} ms/pair; correlation launches {counts} "
            f"for {forwards} forwards")
        _check_counts(counts, forwards, 0, dtype, f"phase 13 bench {what}")
        missing = ({"device", "mfu", "floor_ms_analytic", "spread_pct"}
                   - set(out))
        if missing or out["warp_mode"] != mode or out["backend"] != "cuda":
            raise AssertionError(f"phase 13 bench {what}: {out}")
        results[what] = out

    # marginal_ms: runs of 1 and 1 + STEP_ITERS steps, as warm-ups, then timed
    steps = 2 * (2 + STEP_ITERS)
    for model, dtype, beside in (("c", "bfloat16", "phase 9 C bf16 step"),
                                 ("c", "float32", "phase 6 C f32 step"),
                                 ("css", "bfloat16", None)):
        correlation_kernel.reset_launch_counts()
        ms, per_s = benchlib.train_step_ms(model, TRAIN_BATCH, TRAIN_H,
                                           TRAIN_W, dtype, iters=STEP_ITERS,
                                           device="cuda")
        counts = path_counts()
        note = (f" against {beside}: {earlier[beside]:.3f} ms" if beside
                else " (FlowNetCS frozen: no correlation backward)")
        log(f"phase 13: train_step_ms {model} b{TRAIN_BATCH} {TRAIN_H}x"
            f"{TRAIN_W} {dtype}: {ms:.3f} ms/step, {per_s:.2f} examples/s"
            f"{note}; correlation launches {counts} for {steps} steps")
        _check_counts(counts, steps, steps if model == "c" else 0, dtype,
                      f"phase 13 train_step_ms {model} {dtype}")
        results[f"step {model} {dtype}"] = ms

    scopes = ("FlowNetCSS", "FlowNetSD", "fusion", "correlation")
    for dtype, batch, iters in (("float32", 1, 3), ("bfloat16", 8, 2)):
        trace_dir = os.path.join(tmp, f"trace_{dtype}_b{batch}")
        correlation_kernel.reset_launch_counts()
        last = _cli_lines(["profile", "--model", "2", "--device", "cuda",
                           "--compute_dtype", dtype, "--batch", str(batch),
                           "--iters", str(iters), "--top", "12",
                           "--trace_dir", trace_dir])[-1]
        counts = path_counts()
        _check_counts(counts, profiler.WARMUP_FORWARDS + iters, 0, dtype,
                      f"phase 13 profile {dtype}")
        with open(os.path.join(last["trace_dir"], "summary.json")) as f:
            summary = json.load(f)
        got = {r["name"]: r["device_ms"] for r in summary["scopes"]}
        kernel = sum(r["device_ms"] for r in summary["kernels"]
                     if "correlation_fwd" in r["name"])
        busy = sum(r["device_ms"] for r in summary["kernels"])
        conv3 = (batch, SERVE_HW[0] // 8, SERVE_HW[1] // 8, 256)
        bound, by = corr_bound(conv3, 20, 2, dtype)
        log(f"phase 13: cli profile --model 2 {dtype} b{batch} (per forward, "
            f"{summary['clock']} ms): "
            + ", ".join(f"{k} {got.get(k, float('nan')):.3f}" for k in scopes)
            + f"; correlation_fwd kernel {kernel:.4f} at {conv3} (bound "
            f"{bound:.4f} ms, {by}, {100.0 * bound / kernel:.1f}% of it); "
            f"all kernels {busy:.3f}")
        if summary["clock"] != "device" or not all(got.get(k, 0) > 0
                                                   for k in scopes):
            raise AssertionError(f"phase 13 profile {dtype}: scopes {got}")
        if not 0 < kernel < got["correlation"]:
            raise AssertionError(f"phase 13 profile {dtype}: correlation "
                                 f"kernel {kernel} ms, scope {got}")
        results[f"profile {dtype} b{batch}"] = {k: got[k] for k in scopes}

    wall = time.perf_counter() - t0
    log(f"phase 13: wall time {wall:.1f} s (budget {PHASE13_BUDGET_S} s)")
    if wall > PHASE13_BUDGET_S:
        raise AssertionError("phase 13 overran its time budget")
    return results


# phase 14: the training input path's wall-time budget (s), its cli train
# run (steps, image summary period), the repeat runs' steps and the CRC
# buffer (MiB)
PHASE14_BUDGET_S = 150.0
P14_STEPS, P14_SUMMARY_EVERY, P14_REPEAT_STEPS = 6, 2, 3
CRC_BUFFER_MIB = 64
SUMMARY_TAGS = ("input_a", "input_b", "pred_flow", "gt_flow")


def _png_hw(png):
    """(height, width) of an 8-bit RGB PNG, after checking its signature
    and chunk CRCs and decompressing its rows."""
    import zlib

    if png[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    pos, chunks = 8, {}
    while pos < len(png):
        n = int.from_bytes(png[pos:pos + 4], "big")
        tag, data = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        if int.from_bytes(png[pos + 8 + n:pos + 12 + n], "big") != (
                zlib.crc32(tag + data) & 0xFFFFFFFF):
            raise AssertionError(f"PNG chunk {tag} fails its CRC")
        chunks[tag] = chunks.get(tag, b"") + data
        pos += 12 + n
    w, h = (int.from_bytes(chunks[b"IHDR"][i:i + 4], "big") for i in (0, 4))
    if len(zlib.decompress(chunks[b"IDAT"])) != h * (1 + 3 * w):
        raise AssertionError("PNG rows do not fill the image")
    return h, w


def _event_images(log_dir):
    """[(step, tag, png)] of every image in the run's TensorBoard events
    (records read with their CRCs checked)."""
    from flownet2_tf_tpu_torch.data import tfrecord

    files = [f for f in os.listdir(log_dir) if "tfevents" in f]
    if len(files) != 1:
        raise AssertionError(f"{log_dir}: events files {files}")

    def fields(buf):
        return [(f, v) for f, v, _ in tfrecord._iter_fields(buf)]

    out = []
    for rec in tfrecord.read_records(os.path.join(log_dir, files[0])):
        event = dict(fields(rec))
        for field, value in fields(event.get(5, b"")):
            val = dict(fields(value))
            if field == 1 and 4 in val:
                out.append((event[2], val[1].decode(),
                            dict(fields(val[4]))[4]))
    return out


@contextlib.contextmanager
def _prefetch_mode(mode):
    """Run the trainers built inside with ``device_prefetch=mode``."""
    from flownet2_tf_tpu_torch.training import loop

    real = loop._use_threaded_prefetch
    loop._use_threaded_prefetch = lambda _: real(mode)
    try:
        yield
    finally:
        loop._use_threaded_prefetch = real


@contextlib.contextmanager
def _recording_decodes():
    """Record, for every batch a TFRecordFlowDataset decodes, whether it
    went through the native runtime."""
    from flownet2_tf_tpu_torch.data import loader

    seen, real = [], loader.TFRecordFlowDataset.fetch_batch

    def spy(self, idxs, num_workers=4):
        seen.append(self.native)
        return real(self, idxs, num_workers)

    loader.TFRecordFlowDataset.fetch_batch = spy
    try:
        yield seen
    finally:
        loader.TFRecordFlowDataset.fetch_batch = real


def _peak_step(trainer, batch):
    """One ``train_step`` from the trainer's seeded init on ``batch``:
    (loss, updated parameters, peak allocated bytes above the state over
    the forward and backward, and over the whole step). The first ends
    where the optimizer update starts: its moments and temporaries are
    parameter-sized, whatever remat does."""
    import torch

    state = trainer.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    peaks, update = [], state.optimizer.step

    def step(*args, **kwargs):
        peaks.append(torch.cuda.max_memory_allocated() - base)
        return update(*args, **kwargs)

    state.optimizer.step = step
    loss = trainer.train_step(state, batch)["loss"]
    torch.cuda.synchronize()
    peaks.append(torch.cuda.max_memory_allocated() - base)
    return (loss, [p.detach().clone() for p in state.model.parameters()],
            *peaks)


def phase14_input_path(tmp, chairs, ckpt, crc_py_mb_s=None):
    """The training input path on the card's host and the rest of the
    trainer (see the module docstring): (a) the native IO runtime, (b)
    ``cli train --remat --image_summary_every`` from its TFRecords, (c)
    remat against no remat, (d) bf16 run-to-run repeatability."""
    import numpy as np
    import torch

    from flownet2_tf_tpu_torch import cli
    from flownet2_tf_tpu_torch.data import loader, tfrecord
    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel
    from flownet2_tf_tpu_torch.runtime import native
    from flownet2_tf_tpu_torch.tools import benchlib
    from flownet2_tf_tpu_torch.training.loop import TrainConfig, Trainer
    from flownet2_tf_tpu_torch.training.warmstart import PARAMS_FILE

    t0 = time.perf_counter()
    # (a) the native runtime, built here from the checkout
    if not native.build_library() or native.get_native_io() is None:
        raise AssertionError("phase 14: the native IO runtime did not build")
    lib = native.get_native_io()
    log(f"phase 14: g++ built {os.path.relpath(native._LIB_PATH, ROOT)} in "
        f"{native.last_build_s:.2f} s")
    buf = np.random.RandomState(SEED + 14).bytes(CRC_BUFFER_MIB << 20)
    t1 = time.perf_counter()
    crc = lib.crc32c(buf)
    native_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    crc_py = tfrecord.crc32c_py(buf)
    py_s = time.perf_counter() - t1
    mb = len(buf) / 1e6
    log(f"phase 14: CRC32C of {mb:.1f} MB: native {mb / native_s:.1f} MB/s "
        f"({native_s * 1e3:.2f} ms), crc32c_py {mb / py_s:.2f} MB/s "
        f"({py_s:.2f} s); equal: {crc == crc_py}")
    if crc != crc_py:
        raise AssertionError("phase 14: native and pure CRC32C differ")

    records = os.path.join(tmp, "p14_train.tfrecords")
    out = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["make-tfrecords", "--data_root", chairs, "--out",
                       records])
    made = time.perf_counter() - t1
    n_rec = json.loads(out.getvalue())["train"] if rc == 0 else 0
    size = os.path.getsize(records) / 1e6
    beside = (f"; at phase 11's pure-Python rate the CRCs alone would take "
              f"{size / crc_py_mb_s:.1f} s" if crc_py_mb_s else "")
    log(f"phase 14: cli make-tfrecords of the {CHAIRS_PAIRS}-pair layout: "
        f"{n_rec} records, {size:.1f} MB in {made:.2f} s (native "
        f"CRC32C){beside}")
    if n_rec < 16:
        raise AssertionError(f"phase 14: make-tfrecords wrote {n_rec}")
    h, w = CHAIRS_HW
    for raw in (False, True):
        fast = loader.TFRecordFlowDataset(records, h, w, raw_uint8=raw)
        pure = loader.TFRecordFlowDataset(records, h, w, use_native=False,
                                          raw_uint8=raw)
        if not fast.native or len(fast) != n_rec or len(pure) != n_rec:
            raise AssertionError(f"phase 14: native {fast.native}, records "
                                 f"{len(fast)} and {len(pure)}")
        ms = {"native": [], "pure": []}
        for start in range(0, n_rec, 8):
            idxs = list(range(start, min(start + 8, n_rec)))
            got = {}
            for name, ds in (("native", fast), ("pure", pure)):
                t1 = time.perf_counter()
                got[name] = ds.fetch_batch(idxs)
                if len(idxs) == 8:
                    ms[name].append((time.perf_counter() - t1) * 1e3)
            for k, v in got["native"].items():
                if (v.dtype != got["pure"][k].dtype
                        or v.tobytes() != got["pure"][k].tobytes()):
                    raise AssertionError(f"phase 14: native {k} of records "
                                         f"{idxs} (raw_uint8={raw}) differs")
        log(f"phase 14: TFRecordFlowDataset raw_uint8={raw}: all {n_rec} "
            f"records bitwise equal native/pure; host ms per b8 batch: "
            f"native {statistics.median(ms['native']):.2f}, pure "
            f"{statistics.median(ms['pure']):.2f}")

    # (b) the slice's path: FlowNetC bf16 from the TFRecords, remat, image
    # summaries, threaded prefetch ('auto'), then the same run inline
    # the flying_chairs config's frame and crop, spelled out
    train = ["--model", "c", "--dataset", "flying_chairs", "--tfrecords_train",
             records, "--image_height", str(h), "--image_width", str(w),
             "--crop_height", str(TRAIN_H), "--crop_width", str(TRAIN_W),
             "--batch_size", str(TRAIN_BATCH), "--device", "cuda",
             "--schedule", "short", "--log_every", "1", "--checkpoint_every",
             "0"]
    summaries = P14_STEPS // P14_SUMMARY_EVERY
    rates = {}
    for mode in ("auto", "inline"):
        log_dir = os.path.join(tmp, f"p14_{mode}")
        correlation_kernel.reset_launch_counts()
        t1 = time.perf_counter()
        with _prefetch_mode(mode), _recording_decodes() as decodes:
            recs = _train([*train, "--remat", "--image_summary_every",
                           str(P14_SUMMARY_EVERY), "--max_steps",
                           str(P14_STEPS), "--log_dir", log_dir])
        wall = time.perf_counter() - t1
        counts = path_counts()
        _check_counts(counts, 2 * P14_STEPS + summaries, P14_STEPS,
                      "bfloat16", f"phase 14 cli train --remat ({mode})")
        if not decodes or not all(decodes):
            raise AssertionError(f"phase 14: decodes took the native path: "
                                 f"{decodes}")
        if [r["step"] for r in recs] != list(range(1, P14_STEPS + 1)) or \
                not all(math.isfinite(r["loss"]) for r in recs):
            raise AssertionError(f"phase 14: logged {recs}")
        images = _event_images(log_dir)
        want = [(s, t) for s in range(P14_SUMMARY_EVERY, P14_STEPS + 1,
                                      P14_SUMMARY_EVERY)
                for t in SUMMARY_TAGS]
        if [(s, t) for s, t, _ in images] != want or any(
                _png_hw(png) != (TRAIN_H, TRAIN_W) for _, _, png in images):
            raise AssertionError(f"phase 14: images {[i[:2] for i in images]}")
        rates[mode] = [round(r["examples_per_sec"], 1) for r in recs]
        log(f"phase 14: cli train --model c --tfrecords_train (native, "
            f"{len(decodes)} b{TRAIN_BATCH} decodes) --remat "
            f"--image_summary_every {P14_SUMMARY_EVERY}, bf16, device_prefetch "
            f"{mode!r}: {P14_STEPS} steps in {wall:.1f} s, correlation "
            f"launches {counts}; {len(images)} PNG images; examples/s "
            f"{rates[mode]}")
    log(f"phase 14: examples/s over steps 3-{P14_STEPS} (summaries at even "
        f"steps): threaded {statistics.median(rates['auto'][2:]):.1f}, "
        f"inline {statistics.median(rates['inline'][2:]):.1f} (a record, "
        "not a claim)")

    # (c) remat against no remat: one step from the same seed and batch
    ds = loader.SyntheticFlowDataset(size=TRAIN_BATCH, height=TRAIN_H,
                                     width=TRAIN_W, seed=SEED)
    batch = {k: torch.from_numpy(np.stack([ds[i][k] for i in range(
        TRAIN_BATCH)])).cuda() for k in ("image_a", "image_b", "flow")}
    for model, dtype in (("c", "float32"), ("css", "bfloat16")):
        out = {}
        for remat in (False, True):
            correlation_kernel.reset_launch_counts()
            out[remat] = _peak_step(Trainer(TrainConfig(
                model=model, schedule="short", log_dir=tmp, device="cuda",
                compute_dtype=dtype, remat=remat, augment=False,
                tensorboard=False, checkpoint_every=0)), batch)
            fwd = 2 if remat and model == "c" else 1
            _check_counts(path_counts(), fwd, int(model == "c"), dtype,
                          f"phase 14 {model} step remat={remat}")
        same = torch.equal(out[True][0], out[False][0]) and all(
            torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))
        steps = {}
        for remat in (False, True):
            correlation_kernel.reset_launch_counts()
            steps[remat] = benchlib.train_step_ms(
                model, TRAIN_BATCH, TRAIN_H, TRAIN_W, dtype, iters=STEP_ITERS,
                remat=remat, device="cuda")[0]
            n = 2 * (2 + STEP_ITERS)
            _check_counts(path_counts(), n * (2 if remat and model == "c"
                                              else 1),
                          n if model == "c" else 0, dtype,
                          f"phase 14 train_step_ms {model} remat={remat}")
        gib = {k: [x / 2**30 for x in v[2:]] for k, v in out.items()}
        log(f"phase 14: {model} {dtype} b{TRAIN_BATCH} {TRAIN_H}x{TRAIN_W} "
            f"step with remat: loss and every updated parameter bitwise the "
            f"step without: {same}; peak allocated over forward + backward "
            f"{gib[True][0]:.3f} GiB against {gib[False][0]:.3f} GiB "
            f"({100.0 * (gib[True][0] / gib[False][0] - 1):+.1f}%), over the "
            f"step {gib[True][1]:.3f} against {gib[False][1]:.3f} GiB; "
            f"train_step_ms {steps[True]:.3f} ms against {steps[False]:.3f} "
            f"ms ({100.0 * (steps[True] / steps[False] - 1):+.1f}%)")
        if not same:
            raise AssertionError(f"phase 14: the {model} {dtype} remat step "
                                 "differs from the step")
        if not out[True][2] < out[False][2]:  # forward + backward
            raise AssertionError(f"phase 14: remat did not lower the {model} "
                                 "step's peak memory")

    # (d) bf16 repeatability, with no cuDNN flag set here
    if torch.backends.cudnn.deterministic:
        raise AssertionError("phase 14: cudnn.deterministic was set by a "
                             "caller")
    flows = [_cli_test(ckpt, os.path.join(tmp, f"p14_test{i}"), "bfloat16")
             for i in range(2)]
    for flow, counts in flows:
        _check_counts(counts, 1, 0, "bfloat16", "phase 14 cli test bf16")
    same_test = np.array_equal(flows[0][0], flows[1][0])
    params = []
    for i in range(2):
        log_dir = os.path.join(tmp, f"p14_repeat{i}")
        correlation_kernel.reset_launch_counts()
        _train([*train, "--max_steps", str(P14_REPEAT_STEPS), "--log_dir",
                log_dir])
        _check_counts(path_counts(), P14_REPEAT_STEPS, P14_REPEAT_STEPS,
                      "bfloat16", "phase 14 repeat run")
        with np.load(os.path.join(log_dir, "checkpoints",
                                  str(P14_REPEAT_STEPS), PARAMS_FILE)) as z:
            params.append({k: z[k] for k in z.files})
    same_train = params[0].keys() == params[1].keys() and all(
        np.array_equal(v, params[1][k]) for k, v in params[0].items())
    log(f"phase 14: bf16 cli test twice: .flo bitwise equal: {same_test}; "
        f"bf16 cli train --model c twice ({P14_REPEAT_STEPS} steps from the "
        f"TFRecords, augmented, threaded prefetch): checkpoints bitwise "
        f"equal: {same_train}; cudnn.deterministic outside the calls: "
        f"{torch.backends.cudnn.deterministic}")
    if not (same_test and same_train) or torch.backends.cudnn.deterministic:
        raise AssertionError("phase 14: bf16 runs are not repeatable")
    wall = time.perf_counter() - t0
    log(f"phase 14: wall time {wall:.1f} s (budget {PHASE14_BUDGET_S} s)")
    if wall > PHASE14_BUDGET_S:
        raise AssertionError("phase 14 overran its time budget")



# phase 15: data parallelism and spatial tiling. Its wall-time budget (s),
# the steps of each DDP run, a child process's hard limit (s), and the
# spatial cell: FlowNet2 at 448x1024 in 2 bands, at overlap 64 (windows of
# 384 rows at offsets 0 and 128) and at the default 128 (each window the
# whole frame, edge-padded to 512 rows)
PHASE15_BUDGET_S = 150.0
P15_STEPS = 3
# (a)'s augmented train steps at world size 1 under DDP and without
P15_AUG_STEPS = 2
# (a)'s train_step_ms under DDP and without: f32 (device-bound) and bf16
P15_STEP_DTYPES = ("float32", "bfloat16")
CHILD_TIMEOUT_S = 300
SPATIAL_TILES, SPATIAL_OVERLAPS = 2, (64, 128)
# two gloo ranks on b4 shards against one process on the b8 batch (f32,
# the same gradient summed in another order): each logged metric to this
# rtol, each leaf's update from the shared start to this relative L2
# (Adam's first steps move a weight by about the learning rate whatever
# its gradient's size, so a near-zero gradient summed in another order
# may move it the other way)
DDP_RTOL, DDP_UPDATE_L2 = 1e-4, 1e-3
# the bf16 tiled flow at overlap 128 against the bf16 untiled flow of the
# same padded frame (batch 2 against 1: cuDNN may pick other algorithms
# and round in other places): mean EPE over mean |flow|
SPATIAL_BF16_REL_EPE = 1e-2
# kernel names (lower case) of the reads and their backwards in (e)'s
# profile: gathers, index and index_put, scatters, the index sort
READ_KERNELS = ("index", "gather", "scatter", "sort")

# every child process this script starts; before the last line no
# process may be left in their sessions or among this process's children
CHILDREN = []


def _start_child(func, spec, log_path, env=None):
    """Start ``chip_smoke.<func>(spec)`` in a fresh process: its own
    session, its output in ``log_path``, recorded in CHILDREN."""
    from flownet2_tf_tpu_torch.utils import procs

    proc = procs.start(
        [sys.executable, "-c", f"import sys, chip_smoke; "
         f"sys.exit(chip_smoke.{func}(sys.argv[1]))", spec],
        log_path, env=dict(env or os.environ, PYTHONPATH=ROOT), cwd=ROOT)
    CHILDREN.append(proc)
    return proc


def _wait_child(proc, log_path, what, timeout=CHILD_TIMEOUT_S):
    """Wait for a child at most ``timeout`` s, kill its process group
    whatever happens, and raise with its output's tail unless it exited
    0."""
    from flownet2_tf_tpu_torch.utils import procs

    try:
        rc = procs.wait(proc, timeout)
    except subprocess.TimeoutExpired:
        rc = f"killed after {timeout} s"
    if rc != 0:
        with open(log_path, errors="replace") as f:
            raise AssertionError(f"{what}: the child process failed ({rc}):"
                                 f"\n{f.read()[-4000:]}")


def _check_no_child_left():
    """Raise if a child this script started is unreaped, or if any process
    is still in one of their sessions or is a child of this process."""
    me = os.getpid()
    sessions = {p.pid for p in CHILDREN}
    left = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit() or int(entry) == me:
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if int(fields[1]) == me or int(fields[3]) in sessions:
            left.append(stat[:stat.rindex(")") + 1])
    unreaped = [p.pid for p in CHILDREN if p.returncode is None]
    if left or unreaped:
        raise AssertionError(f"child processes outlived their phase: "
                             f"{left}, unreaped {unreaped}")
    log(f"child processes: {len(CHILDREN)} started, every one exited and "
        "reaped, none left in their sessions")


def _wait_for_file(path, timeout=CHILD_TIMEOUT_S):
    """Return once ``path`` exists (a parent's go signal to a child it
    started ahead); raise after ``timeout`` s."""
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.05)


def _go(path):
    with open(path, "w"):
        pass


_PORTS = set()


def _free_port():
    """A port the OS has free on 127.0.0.1, never one this script handed
    out before (a child binds its port only once it has started)."""
    import socket

    while True:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        if port not in _PORTS:
            _PORTS.add(port)
            return port


def _launch_env(rank, world, port):
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")}
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    return env


def train_worker(spec_path):
    """Phase 15 (a)'s child: once the spec's go file exists, ``cli train``
    with the spec's arguments, in the launcher environment it was given;
    then, in a group joined again on the spec's second port,
    ``train_step_ms`` of FlowNetC under DDP at each dtype of
    P15_STEP_DTYPES and :func:`_p15_augmented_steps`. Writes the log
    records, the step times and the correlation launch counts of each to
    the spec's result file, the augmented steps' parameters beside it."""
    import numpy as np
    import torch

    from flownet2_tf_tpu_torch import cli
    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel as ck
    from flownet2_tf_tpu_torch.parallel import mesh
    from flownet2_tf_tpu_torch.tools import benchlib

    def launches():
        torch.cuda.synchronize()
        counts = {"fwd": dict(ck.LAUNCHES_BY_DTYPE),
                  "bwd": dict(ck.BWD_LAUNCHES_BY_DTYPE)}
        ck.reset_launch_counts()
        return counts

    with open(spec_path) as f:
        spec = json.load(f)
    torch.cuda.init()
    _wait_for_file(spec["go"])
    ck.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["train", *spec["argv"]])
    out = {"rc": rc, "launches": launches(), "records": [
        json.loads(line) for line in buf.getvalue().splitlines()
        if line.startswith("{")]}
    os.environ["MASTER_PORT"] = str(spec["step_ms_port"])
    mesh.maybe_initialize_distributed(True, device="cuda")
    try:
        out["step_ms"] = {dtype: benchlib.train_step_ms(
            "c", TRAIN_BATCH, TRAIN_H, TRAIN_W, dtype, iters=STEP_ITERS,
            device="cuda")[0] for dtype in P15_STEP_DTYPES}
        out["step_ms_launches"] = launches()
        params, out["aug_ddp"] = _p15_augmented_steps(spec["aug_log_dir"])
        np.savez(spec["result"] + ".aug.npz", **params)
    finally:
        mesh.shutdown_distributed()
    out["aug_launches"] = launches()
    with open(spec["result"], "w") as f:
        json.dump(out, f)
    return rc


def _p15_trainer(log_dir):
    """Phase 15 (b)'s trainer: FlowNetC f32, seeded init, no
    augmentation."""
    from flownet2_tf_tpu_torch.training.loop import TrainConfig, Trainer

    return Trainer(TrainConfig(
        model="c", schedule="short", log_dir=log_dir, device="cuda",
        compute_dtype="float32", augment=False, tensorboard=False,
        checkpoint_every=0))


def _p15_augmented_steps(log_dir):
    """(a)'s augmented steps: FlowNetC (bf16, its seeded init) trained
    P15_AUG_STEPS ``train_step``s on ``_p15_batch`` with the FlyingChairs
    augmentation spec (translate, rotate, zoom, squeeze, photometric,
    noise; crop 320x448). Returns (its parameters in the JAX layout,
    whether it ran under DDP)."""
    import torch

    from flownet2_tf_tpu_torch.data import dataset_configs
    from flownet2_tf_tpu_torch.training import warmstart
    from flownet2_tf_tpu_torch.training.loop import TrainConfig, Trainer

    trainer = Trainer(TrainConfig(
        model="c", schedule="short", log_dir=log_dir, device="cuda",
        augment=True, tensorboard=False, checkpoint_every=0))
    state = trainer.init_state()
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in _p15_batch().items()}
    pre = dataset_configs.FLYING_CHAIRS_DATASET_CONFIG["PREPROCESS"]
    for _ in range(P15_AUG_STEPS):
        trainer.train_step(state, batch, pre)
    return (warmstart.flatten(warmstart.to_jax_params(state.model)),
            state.ddp is not None)


def _p15_batch():
    """One seeded global b8 batch at the FlyingChairs crop."""
    import numpy as np

    rng = np.random.RandomState(SEED + 15)
    shape = (TRAIN_BATCH, TRAIN_H, TRAIN_W)
    return {"image_a": rng.rand(*shape, 3).astype(np.float32),
            "image_b": rng.rand(*shape, 3).astype(np.float32),
            "flow": (rng.rand(*shape, 2) * 8 - 4).astype(np.float32)}


def _timed_steps(trainer, state, batch, steps):
    """``steps`` train steps: (metrics of each as floats, host ms of each
    from a synchronize to the metrics' read)."""
    import torch

    metrics, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = {k: float(v) for k, v in trainer.train_step(state,
                                                        batch).items()}
        times.append((time.perf_counter() - t0) * 1000.0)
        metrics.append(m)
    return metrics, times


def ddp_worker(spec_path):
    """Phase 15 (b)'s child: one rank of a gloo group on ``cuda:0``; once
    the spec's go file exists, trains its b4 shard of ``_p15_batch`` for
    P15_STEPS steps and writes its metrics, step times, launch counts and
    parameters."""
    import numpy as np

    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel as ck
    from flownet2_tf_tpu_torch.parallel import mesh
    from flownet2_tf_tpu_torch.training import warmstart

    with open(spec_path) as f:
        spec = json.load(f)
    mesh.maybe_initialize_distributed(True, device="cuda", backend="gloo",
                                      timeout_s=spec["timeout_s"])
    try:
        rank, world = mesh.process_index(), mesh.process_count()
        trainer = _p15_trainer(spec["log_dir"])
        state = trainer.init_state()
        local = TRAIN_BATCH // world
        shard = {k: v[rank * local:(rank + 1) * local]
                 for k, v in _p15_batch().items()}
        _wait_for_file(spec["go"])
        ck.reset_launch_counts()
        metrics, times = _timed_steps(trainer, state, shard, P15_STEPS)
        np.savez(f"{spec['result']}.{rank}.npz", **warmstart.flatten(
            warmstart.to_jax_params(state.model)))
        with open(f"{spec['result']}.{rank}.json", "w") as f:
            json.dump({"rank": rank, "world": world,
                       "ddp": state.ddp is not None, "metrics": metrics,
                       "step_ms": times,
                       "launches": {"fwd": dict(ck.LAUNCHES_BY_DTYPE),
                                    "bwd": dict(ck.BWD_LAUNCHES_BY_DTYPE)}},
                      f)
    finally:
        mesh.shutdown_distributed()
    return 0


def export_worker(spec_path):
    """An export in a child: ``cli export --aot`` with the spec's
    ``argv``, or ``tools/aot.py::export_serving`` of FlowNet2 with its
    ``api`` keyword arguments (knobs ``cli export`` has no flag for);
    writes the metadata and the export's wall time."""
    with open(spec_path) as f:
        spec = json.load(f)
    # a later phase's export yields the host to the running phase's work
    os.nice(spec["nice"])
    if "argv" in spec:
        meta, wall = _cli_export(spec["argv"])
    else:
        from flownet2_tf_tpu_torch.tools import aot
        from flownet2_tf_tpu_torch.training.warmstart import load_params_tree

        kwargs = dict(spec["api"])
        tree = load_params_tree(kwargs.pop("ckpt"))
        t0 = time.perf_counter()
        meta = aot.export_serving("2", tree, *SERVE_HW, **kwargs)
        wall = time.perf_counter() - t0
    with open(spec["result"], "w") as f:
        json.dump({"meta": meta, "wall_s": wall}, f)
    return 0


def _add_launches(counts):
    for way, by_dtype in counts.items():
        for dtype, n in by_dtype.items():
            PATH_LAUNCHES[way][dtype] += n


def _checkpoint_params(log_dir, step):
    import numpy as np

    from flownet2_tf_tpu_torch.training.warmstart import PARAMS_FILE

    with np.load(os.path.join(log_dir, "checkpoints", str(step),
                              PARAMS_FILE)) as z:
        return {k: z[k] for k in z.files}


def _bitwise_equal(a, b):
    import numpy as np

    return a.keys() == b.keys() and all(np.array_equal(v, b[k])
                                        for k, v in a.items())


def _step_ms(records):
    """ms per step of logged steps 2 on (``examples_per_sec`` of each
    log line: the first step holds the warm-up)."""
    return [TRAIN_BATCH * 1000.0 / r["examples_per_sec"] for r in records[1:]]


P15A_ARGV = ["--model", "c", "--synthetic", "--synthetic_height",
             str(TRAIN_H), "--synthetic_width", str(TRAIN_W), "--batch_size",
             str(TRAIN_BATCH), "--max_steps", str(P15_STEPS), "--schedule",
             "short", "--log_every", "1", "--checkpoint_every", "0",
             "--device", "cuda"]


def _p15a_start(tmp):
    """(a) start ``cli train --model c --multihost``'s child at world size
    1; it runs once :func:`_p15a_finish` says go."""
    ddp_dir = os.path.join(tmp, "p15_ddp1")
    spec = os.path.join(tmp, "p15_ddp1.json")
    with open(spec, "w") as f:
        json.dump({"argv": [*P15A_ARGV, "--multihost", "--log_dir", ddp_dir],
                   "result": spec + ".out", "step_ms_port": _free_port(),
                   "go": spec + ".go",
                   "aug_log_dir": os.path.join(tmp, "p15_ddp1_aug")}, f)
    log_path = os.path.join(tmp, "p15_ddp1.log")
    proc = _start_child("train_worker", spec, log_path,
                        _launch_env(0, 1, _free_port()))
    return proc, spec, log_path, ddp_dir


def _p15a_finish(tmp, started):
    """(a) the run without ``--multihost`` and ``train_step_ms`` here, then
    the child's run under DDP, and the two compared."""
    import numpy as np

    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel
    from flownet2_tf_tpu_torch.tools import benchlib

    proc, spec, log_path, ddp_dir = started
    plain_dir = os.path.join(tmp, "p15_plain")
    correlation_kernel.reset_launch_counts()
    plain = _train([*P15A_ARGV, "--log_dir", plain_dir])
    _check_counts(path_counts(), P15_STEPS, P15_STEPS, "bfloat16",
                  "phase 15 (a) plain run")
    plain_step = {}
    for dtype in P15_STEP_DTYPES:
        correlation_kernel.reset_launch_counts()
        plain_step[dtype] = benchlib.train_step_ms(
            "c", TRAIN_BATCH, TRAIN_H, TRAIN_W, dtype, iters=STEP_ITERS,
            device="cuda")[0]
        n = 2 * (2 + STEP_ITERS)
        _check_counts(path_counts(), n, n, dtype,
                      f"phase 15 (a) train_step_ms {dtype}")
    correlation_kernel.reset_launch_counts()
    aug_plain, aug_ddp = _p15_augmented_steps(os.path.join(tmp, "p15_aug"))
    _check_counts(path_counts(), P15_AUG_STEPS, P15_AUG_STEPS, "bfloat16",
                  "phase 15 (a) augmented steps")
    t0 = time.perf_counter()
    _go(spec + ".go")
    _wait_child(proc, log_path, "phase 15 (a) cli train --multihost")
    wall = time.perf_counter() - t0
    with open(spec + ".out") as f:
        out = json.load(f)
    _check_counts(out["launches"], P15_STEPS, P15_STEPS, "bfloat16",
                  "phase 15 (a) --multihost run")
    _add_launches(out["launches"])
    n = 2 * (2 + STEP_ITERS)
    want = {way: {d: n for d in P15_STEP_DTYPES} for way in ("fwd", "bwd")}
    if out["step_ms_launches"] != want:
        raise AssertionError(f"phase 15 (a): train_step_ms under DDP "
                             f"launched {out['step_ms_launches']}")
    _add_launches(out["step_ms_launches"])
    _check_counts(out["aug_launches"], P15_AUG_STEPS, P15_AUG_STEPS,
                  "bfloat16", "phase 15 (a) augmented steps under DDP")
    _add_launches(out["aug_launches"])
    with np.load(spec + ".out.aug.npz") as z:
        aug_same = out["aug_ddp"] and not aug_ddp and _bitwise_equal(
            aug_plain, {k: z[k] for k in z.files})
    same = _bitwise_equal(_checkpoint_params(plain_dir, P15_STEPS),
                          _checkpoint_params(ddp_dir, P15_STEPS))
    same_log = [{k: v for k, v in r.items() if k != "examples_per_sec"}
                for r in plain] == [
        {k: v for k, v in r.items() if k != "examples_per_sec"}
        for r in out["records"]]
    ms_plain, ms_ddp = _step_ms(plain), _step_ms(out["records"])
    log(f"phase 15 (a): cli train --model c --multihost (DDP, NCCL, world "
        f"size 1, bf16 b{TRAIN_BATCH} {TRAIN_H}x{TRAIN_W}, {P15_STEPS} "
        f"steps) in a child ({wall:.1f} s from its go): correlation launches "
        f"{out['launches']}; checkpoint bitwise the run without "
        f"--multihost: {same}; logged metrics equal: {same_log}; step ms "
        f"(steps 2-{P15_STEPS}) {[round(x, 2) for x in ms_ddp]} against "
        f"{[round(x, 2) for x in ms_plain]} without "
        f"({100.0 * (np.mean(ms_ddp) / np.mean(ms_plain) - 1):+.1f}%; the "
        f"synthetic render feeds them); train_step_ms (one prefetched "
        f"batch, CUDA events) under DDP against without: " + ", ".join(
            f"{d} {out['step_ms'][d]:.3f} against {plain_step[d]:.3f} ms "
            f"({100.0 * (out['step_ms'][d] / plain_step[d] - 1):+.1f}%)"
            for d in P15_STEP_DTYPES)
        + f"; {P15_AUG_STEPS} bf16 train_steps with the FlyingChairs "
        f"augmentation under DDP at world size 1 bitwise the plain steps: "
        f"{aug_same}")
    if not (same and same_log and aug_same):
        raise AssertionError("phase 15 (a): the world-size-1 DDP run differs "
                             "from the plain run")


def _p15b_start(tmp):
    """(b) start two gloo ranks on ``cuda:0``, each on its b4 shard of one
    b8 batch; they join their group and build their trainers, then step
    once :func:`_p15b_finish` says go."""
    spec = os.path.join(tmp, "p15_ranks.json")
    result = os.path.join(tmp, "p15_rank")
    with open(spec, "w") as f:
        json.dump({"log_dir": os.path.join(tmp, "p15_ranks"),
                   "result": result, "timeout_s": 120,
                   "go": spec + ".go"}, f)
    port = _free_port()
    ranks = [(_start_child("ddp_worker", spec, f"{result}{r}.log",
                           _launch_env(r, 2, port)), f"{result}{r}.log")
             for r in range(2)]
    return ranks, result, spec + ".go"


def _p15b_finish(tmp, started):
    """(b) one process on the b8 batch here, then the two ranks against
    each other and against it."""
    import numpy as np

    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel
    from flownet2_tf_tpu_torch.training import warmstart

    ranks, result, go = started
    t0 = time.perf_counter()
    _go(go)
    trainer = _p15_trainer(os.path.join(tmp, "p15_one"))
    state = trainer.init_state()
    start = warmstart.flatten(warmstart.to_jax_params(state.model))
    correlation_kernel.reset_launch_counts()
    one, one_ms = _timed_steps(trainer, state, _p15_batch(), P15_STEPS)
    _check_counts(path_counts(), P15_STEPS, P15_STEPS, "float32",
                  "phase 15 (b) one process")
    one_params = warmstart.flatten(warmstart.to_jax_params(state.model))
    del trainer, state
    for r, (proc, log_path) in enumerate(ranks):
        _wait_child(proc, log_path, f"phase 15 (b) rank {r}")
    wall = time.perf_counter() - t0
    outs, params = [], []
    for r in range(2):
        with open(f"{result}.{r}.json") as f:
            outs.append(json.load(f))
        with np.load(f"{result}.{r}.npz") as z:
            params.append({k: z[k] for k in z.files})
        _check_counts(outs[r]["launches"], P15_STEPS, P15_STEPS, "float32",
                      f"phase 15 (b) rank {r}")
        _add_launches(outs[r]["launches"])
    same = (outs[0]["metrics"] == outs[1]["metrics"]
            and _bitwise_equal(params[0], params[1]))
    worst_metric = max(abs(outs[0]["metrics"][i][k] / v - 1)
                       for i, m in enumerate(one) for k, v in m.items()
                       if k != "lr" and v)
    worst_update = 0.0
    for k, w0 in start.items():
        dw = np.asarray(one_params[k], np.float64) - w0
        dg = np.asarray(params[0][k], np.float64) - w0
        if np.linalg.norm(dw):
            worst_update = max(worst_update, float(
                np.linalg.norm(dg - dw) / np.linalg.norm(dw)))
    log(f"phase 15 (b): two gloo ranks on cuda:0 (FlowNetC f32, b4 shards "
        f"of one b8 {TRAIN_H}x{TRAIN_W} batch, {P15_STEPS} steps, {wall:.1f} "
        f"s from their go): both under DDP: "
        f"{all(o['ddp'] and o['world'] == 2 for o in outs)}"
        f"; metrics and every parameter bitwise equal across the ranks: "
        f"{same}; against one process on b8: worst metric rel. diff "
        f"{worst_metric:.2e} (rtol {DDP_RTOL}), worst leaf update rel. L2 "
        f"{worst_update:.2e} (<= {DDP_UPDATE_L2}); step ms rank 0 "
        f"{[round(x, 2) for x in outs[0]['step_ms']]}, rank 1 "
        f"{[round(x, 2) for x in outs[1]['step_ms']]}, one process b8 "
        f"{[round(x, 2) for x in one_ms]} (the first step holds the "
        "warm-up; gloo carries the gradients through the host; the ranks "
        "ran beside this one-process run)")
    if not (same and all(o["ddp"] and o["world"] == 2 for o in outs)):
        raise AssertionError("phase 15 (b): the ranks differ")
    if worst_metric > DDP_RTOL or worst_update > DDP_UPDATE_L2:
        raise AssertionError("phase 15 (b): two ranks are not one process")


def _cli_test_spatial(ckpt, paths, out_dir, dtype, overlap):
    """``cli test --model 2 --spatial_tiles 2`` on the card between a reset
    and a read of the launch counts; returns (.flo flow, wall s)."""
    from flownet2_tf_tpu_torch import cli
    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel
    from flownet2_tf_tpu_torch.utils import flowlib

    correlation_kernel.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["test", "--model", "2", "--device", "cuda",
                       "--compute_dtype", dtype, "--ckpt", ckpt,
                       "--input_a", paths[0], "--input_b", paths[1],
                       "--out", out_dir, "--spatial_tiles",
                       str(SPATIAL_TILES), "--spatial_overlap",
                       str(overlap)])
    wall = time.perf_counter() - t0
    _check_counts(path_counts(), 1, 0, dtype,
                  f"phase 15 (c) cli test --spatial_overlap {overlap}")
    if rc != 0:
        raise AssertionError(f"cli test --spatial_tiles returned {rc}")
    stem = os.path.splitext(os.path.basename(paths[0]))[0]
    return flowlib.read_flow(os.path.join(out_dir, f"{stem}_flow.flo")), wall


def _p15c_pair(tmp):
    """(c) a rendered 448x1024 pair: (its PNG paths, the pair as read from
    them in an .npz)."""
    import numpy as np

    from flownet2_tf_tpu_torch.training import infer
    from flownet2_tf_tpu_torch.utils.image_io import write_image

    h, w = SERVE_HW
    a_u8, b_u8, _ = _render_pair(np.random.RandomState(SEED + 15), h, w)
    paths = [os.path.join(tmp, f"p15_{k}.png") for k in ("a", "b")]
    write_image(a_u8, paths[0])
    write_image(b_u8, paths[1])
    a, b = infer.load_image_pair(*paths)
    pair = os.path.join(tmp, "p15_pair.npz")
    np.savez(pair, a=a[None], b=b[None])
    return paths, pair


def _p15c_spatial(tmp, ckpt, tree, paths):
    """(c) ``cli test --model 2 --spatial_tiles 2`` at 448x1024, f32 and
    bf16, at overlap 64 and 128; returns the f32 overlap-64 flow."""
    import numpy as np
    import torch

    from flownet2_tf_tpu_torch.models.common import compute_dtype_of
    from flownet2_tf_tpu_torch.parallel import spatial
    from flownet2_tf_tpu_torch.training import infer

    h, w = SERVE_HW
    a, b = infer.load_image_pair(*paths)
    # the frame the bands tile: edge-padded to 512 rows
    _, padded_h = spatial._tile_plan(h, SPATIAL_TILES, 0)
    rows = torch.arange(padded_h, device="cuda").clamp(max=h - 1)
    frame = [torch.from_numpy(x[None]).to("cuda") for x in (a, b)]
    flows, timed = {}, {}
    for dtype in ("float32", "bfloat16"):
        cd = compute_dtype_of(dtype)
        model = infer.inference_model("2", tree, torch.device("cuda"), cd)
        untiled = infer.forward_flow(model, *frame, cd)[0].cpu().numpy()
        padded = infer.forward_flow(model, *(x[:, rows] for x in frame),
                                    cd)[0, :h].cpu().numpy()
        # ms/pair: the model on the two bands against the whole frame
        tiles = [spatial.extract_tiles(x, SPATIAL_TILES,
                                       min(SPATIAL_OVERLAPS))[0]
                 for x in frame]
        with torch.inference_mode():
            timed[dtype] = [statistics.median(cuda_time_ms(
                lambda: spatial.forward_tiles(model, *t, cd), runs=10))
                for t in (tiles, frame)]
        del model
        for overlap in SPATIAL_OVERLAPS:
            flow, wall = _cli_test_spatial(
                ckpt, paths, os.path.join(tmp, f"p15_{dtype}_{overlap}"),
                dtype, overlap)
            flows[dtype, overlap] = flow
            if flow.shape != (h, w, 2) or not np.isfinite(flow).all():
                raise AssertionError(f"phase 15 (c): bad flow {flow.shape}")
            scale = float(np.abs(padded).mean())
            log(f"phase 15 (c): cli test --spatial_tiles {SPATIAL_TILES} "
                f"--spatial_overlap {overlap} {dtype} at {h}x{w} ({wall:.2f} "
                f"s): 1 correlation launch; mean EPE to the untiled flow "
                f"{_epe(flow, untiled):.4f} px (mean |flow| "
                f"{float(np.abs(untiled).mean()):.2f}), to the untiled flow "
                f"of the padded frame {_epe(flow, padded):.3e} px")
            if overlap == max(SPATIAL_OVERLAPS):
                # each window is the padded frame: the untiled flow of it
                if dtype == "float32":
                    np.testing.assert_allclose(flow, padded, rtol=FLOW_RTOL,
                                               atol=FLOW_ATOL)
                elif _epe(flow, padded) > SPATIAL_BF16_REL_EPE * scale:
                    raise AssertionError("phase 15 (c): bf16 tiled flow off "
                                         "the padded frame's")

    for dtype, (tiled, whole) in timed.items():
        log(f"phase 15 (c): FlowNet2 {dtype} forward on {SPATIAL_TILES} bands "
            f"of {tiles[0].shape[1]} rows (overlap {min(SPATIAL_OVERLAPS)}) "
            f"{tiled:.3f} ms/pair against the {h}x{w} frame {whole:.3f} "
            f"({tiled / whole:.2f}x; CUDA events, median of 10)")
    return flows["float32", min(SPATIAL_OVERLAPS)]


def spatial_cpu_worker(spec_path):
    """Phase 15 (c)'s CPU reference, in a child so that its
    ``f32_policy`` (process-wide flags) never meets the card's work: the
    port's spatial flow of the pair on the CPU (f32, overlap 64)."""
    import numpy as np

    from flownet2_tf_tpu_torch.parallel import spatial
    from flownet2_tf_tpu_torch.training.warmstart import load_params_tree

    with open(spec_path) as f:
        spec = json.load(f)
    with np.load(spec["pair"]) as z:
        a, b = z["a"][0], z["b"][0]
    t0 = time.perf_counter()
    flow = spatial.infer_flow_spatial(
        "2", load_params_tree(spec["ckpt"]), a, b, n_tiles=SPATIAL_TILES,
        overlap=min(SPATIAL_OVERLAPS), device="cpu")
    np.save(spec["flow_out"], flow)
    with open(spec["result"], "w") as f:
        json.dump({"wall_s": time.perf_counter() - t0}, f)
    return 0


def _p15c_cpu_start(tmp, ckpt, pair):
    """(c) start the CPU reference's child."""
    spec = os.path.join(tmp, "p15_cpu.json")
    with open(spec, "w") as f:
        json.dump({"ckpt": ckpt, "pair": pair, "result": spec + ".out",
                   "flow_out": os.path.join(tmp, "p15_cpu_flow.npy")}, f)
    log_path = os.path.join(tmp, "p15_cpu.log")
    return _start_child("spatial_cpu_worker", spec, log_path), spec, log_path


def _p15c_cpu_check(started, card):
    """(c) the card's f32 overlap-64 flow against the CPU reference."""
    import numpy as np

    proc, spec, log_path = started
    _wait_child(proc, log_path, "phase 15 (c) CPU reference")
    with open(spec) as f:
        cpu = np.load(json.load(f)["flow_out"])
    with open(spec + ".out") as f:
        wall = json.load(f)["wall_s"]
    log(f"phase 15 (c): f32 overlap {min(SPATIAL_OVERLAPS)} card against "
        f"the CPU spatial flow ({wall:.1f} s on the CPU in a child, beside "
        f"(b) and (e)): mean EPE {_epe(card, cpu):.3e} px, max |diff| "
        f"{float(np.abs(card - cpu).max()):.3e}")
    np.testing.assert_allclose(card, cpu, rtol=FLOW_RTOL, atol=FLOW_ATOL)


def _p15_exports(ckpt):
    """(d)'s export: ``cli export --aot --spatial_tiles 2
    --spatial_overlap 64`` of FlowNet2 f32 at 448x1024."""
    return {"p15_spatial": _f2_export_argv(
        ckpt, "--device", "cuda", "--spatial_tiles", str(SPATIAL_TILES),
        "--spatial_overlap", str(min(SPATIAL_OVERLAPS)))}


def _p15d_export(tmp, ckpt, ahead=None):
    """(d) the spatial artifact: phase 12's (in ``ahead``), else its
    export started now in a child process."""
    if ahead and "p15_spatial" in ahead:
        path, meta, wall = ahead["p15_spatial"]
        return {"path": path, "done": None, "result": (meta, wall)}
    (key, job), = _p15_exports(ckpt).items()
    return _start_export(tmp, key, job)


def _p15d_serve(tmp, started, pair):
    """(d) start the fresh process that serves the artifact (two calls,
    untimed) once the export is done."""
    flow_out = os.path.join(tmp, "p15_served.npy")
    worker = _start_worker(tmp, "p15_spatial", [{
        "kind": "single", "artifact": started["path"], "pair": pair,
        "flow_out": flow_out, "timed": False}],
        wait_for=[started["done"]] if started["done"] else [])
    return worker, flow_out


def _p15d_check_export(started):
    """(d) wait for the export and check its metadata."""
    meta, wall = started.get("result") or _export_done(started)
    if (meta["spatial_tiles"], meta["spatial_overlap"], meta["batch"]) != (
            SPATIAL_TILES, min(SPATIAL_OVERLAPS), 1):
        raise AssertionError(f"phase 15 (d): metadata {meta}")
    h, w = SERVE_HW
    log(f"phase 15 (d): cli export --aot --spatial_tiles {SPATIAL_TILES} "
        f"--spatial_overlap {min(SPATIAL_OVERLAPS)} FlowNet2 f32 {h}x{w} in "
        f"a child: {wall:.2f} s, "
        f"{os.path.getsize(started['path']) / 1e6:.1f} MB")


def _p15d_finish(started, library_flow):
    import numpy as np

    worker, flow_out = started
    results, calls, wall = _finish_worker(worker, "float32")
    served = np.load(flow_out)[0]
    epe = _epe(served, library_flow)
    log(f"phase 15 (d): the spatial artifact served in a fresh process "
        f"({wall:.1f} s): load {results[0]['load_s']:.2f} s, {calls} calls, "
        f"one correlation launch each; two served calls bitwise equal: "
        f"{results[0]['same']}; mean EPE to (c)'s library flow {epe:.3e} px "
        f"(<= {SERVE_EPE})")
    if not results[0]["same"] or epe > SERVE_EPE:
        raise AssertionError("phase 15 (d): the spatial artifact is off")


@contextlib.contextmanager
def _atomic_reads():
    """The warp and resize reads as they were before the repair, on every
    device: ``gather`` and ``index_select``, whose backwards
    (``scatter_add``, ``index_add_``) sum with atomics on CUDA."""
    import torch

    from flownet2_tf_tpu_torch.ops import resize, sampling

    real = sampling._read, resize._take

    def read(flat, idx):
        table = flat if flat.ndim == 3 else flat.expand(idx.shape[0], -1, -1)
        return torch.gather(table, 1,
                            idx[..., None].expand(-1, -1, flat.shape[-1]))

    sampling._read = read
    resize._take = lambda t, dim, idx: t.index_select(dim, idx)
    try:
        yield
    finally:
        sampling._read, resize._take = real


def _p15e_repair(tmp):
    """(e) the warp and resize backwards sum in a fixed order: their
    gradients twice on the card, and two 3-step bf16 FlowNetCS runs with
    nothing frozen (gradients through FlowNetC's resized flow and the
    warp), bitwise."""
    import torch

    from flownet2_tf_tpu_torch.data.loader import (
        BatchLoader,
        SyntheticFlowDataset,
    )
    from flownet2_tf_tpu_torch.ops import resize, sampling
    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel
    from flownet2_tf_tpu_torch.training.loop import TrainConfig, Trainer

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    img = torch.rand(2, 96, 128, 8, device="cuda", generator=gen)
    # every sample lands in a 6x6 corner: thousands of them per pixel
    x, y = (torch.rand(2, 320, 448, device="cuda", generator=gen) * 5
            for _ in range(2))
    small = torch.rand(8, 40, 56, 2, device="cuda", generator=gen)

    def grads():
        i = img.clone().requires_grad_()
        s = small.clone().requires_grad_()
        (sampling.bilinear_gather(i, x, y).square().sum()
         + resize.resize_bilinear_tf1(s, TRAIN_H, TRAIN_W).square().sum()
         ).backward()
        return i.grad, s.grad

    (g1, r1), (g2, r2) = grads(), grads()
    ops_same = torch.equal(g1, g2) and torch.equal(r1, r2)
    with _atomic_reads():
        (g1, r1), (g2, r2) = grads(), grads()
    before = torch.equal(g1, g2) and torch.equal(r1, r2)

    # the price: device time of one FlowNetCSS bf16 b8 step with nothing
    # frozen (torch.profiler, all kernels), in turns
    trainer = Trainer(TrainConfig(
        model="css", frozen=(), schedule="short",
        log_dir=os.path.join(tmp, "p15_css"), device="cuda", augment=False,
        tensorboard=False, checkpoint_every=0))
    state = trainer.init_state()
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in _p15_batch().items()}
    for _ in range(2):
        trainer.train_step(state, batch)
    busy = {"port": [], "atomics": []}
    reads = {"port": [], "atomics": []}
    for name in ("port", "atomics", "atomics", "port", "port", "atomics"):
        with _atomic_reads() if name == "atomics" else contextlib.nullcontext():
            correlation_kernel.reset_launch_counts()
            kernels = profile_ms(lambda: trainer.train_step(state, batch))
            _check_counts(path_counts(), 1, 1, "bfloat16",
                          f"phase 15 (e) profiled CSS step ({name})")
        busy[name].append(sum(kernels.values()))
        reads[name].append(sum(
            ms for k, ms in kernels.items()
            if any(t in k.lower() for t in READ_KERNELS)))
    del trainer, state

    params = []
    for i in range(2):
        log_dir = os.path.join(tmp, f"p15_cs{i}")
        trainer = Trainer(TrainConfig(
            model="cs", frozen=(), schedule="short", log_dir=log_dir,
            device="cuda", tensorboard=False, checkpoint_every=0,
            log_every=1))
        loader = BatchLoader(SyntheticFlowDataset(
            size=4 * TRAIN_BATCH, height=TRAIN_H, width=TRAIN_W, seed=SEED),
            batch_size=TRAIN_BATCH)
        correlation_kernel.reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            trainer.fit(loader, max_steps=P15_STEPS, preprocess={
                "crop_height": TRAIN_H, "crop_width": TRAIN_W,
                "image_a": {}, "image_b": {}})
        _check_counts(path_counts(), P15_STEPS, P15_STEPS, "bfloat16",
                      "phase 15 (e) FlowNetCS with nothing frozen")
        params.append(_checkpoint_params(log_dir, P15_STEPS))
    same = _bitwise_equal(*params)
    port, atomics = (statistics.mean(busy[k]) for k in ("port", "atomics"))
    log(f"phase 15 (e): the gather and resize gradients ({x.numel()} "
        f"samples into a 6x6 corner, a flow resized 8x) twice bitwise "
        f"equal: {ops_same} (with the reads before the repair: {before}); "
        f"FlowNetCSS bf16 b{TRAIN_BATCH} {TRAIN_H}x{TRAIN_W} step with "
        f"nothing frozen, device ms (torch.profiler, in turns): "
        f"{[round(v, 3) for v in busy['port']]} against "
        f"{[round(v, 3) for v in busy['atomics']]} before the repair "
        f"({100.0 * (port / atomics - 1):+.2f}%), of which index, gather, "
        f"scatter and sort kernels "
        f"{[round(v, 3) for v in reads['port']]} against "
        f"{[round(v, 3) for v in reads['atomics']]}; "
        f"two {P15_STEPS}-step bf16 FlowNetCS runs with nothing frozen "
        f"(Trainer.fit, augmented): checkpoints bitwise equal: {same}")
    if not (ops_same and same):
        raise AssertionError("phase 15 (e): the warp and resize backwards "
                             "are not repeatable")


def phase15_data_parallel_and_spatial(tmp, ckpt, tree, ahead=None):
    """Data parallelism and spatial tiling (see the module docstring).
    The children start first and wait, so that their start-up overlaps
    (c); while (c) runs the card does only (d)'s export beside it (its
    tracing is host work; in the full run phase 12 traced it, in
    ``ahead``, and (d)'s server loads there instead). (e)'s device times
    come from the profiler;
    (a) runs last, with only (d)'s serving process beside it, whose load
    is host work. (b)'s ranks train beside its one-process run."""
    from flownet2_tf_tpu_torch.utils import procs

    t0 = time.perf_counter()
    paths, pair = _p15c_pair(tmp)
    first = len(CHILDREN)
    try:
        # children started ahead: they import, reach the card and build,
        # then wait for their go (or, the server, for the artifact)
        export = _p15d_export(tmp, ckpt, ahead)
        served = _p15d_serve(tmp, export, pair)
        ranks = _p15b_start(tmp)
        ddp1 = _p15a_start(tmp)
        library_flow = _p15c_spatial(tmp, ckpt, tree, paths)
        cpu = _p15c_cpu_start(tmp, ckpt, pair)
        _p15b_finish(tmp, ranks)
        _p15e_repair(tmp)
        _p15c_cpu_check(cpu, library_flow)
        _p15d_check_export(export)
        _p15a_finish(tmp, ddp1)
        _p15d_finish(served, library_flow)
    finally:
        # a phase that failed leaves no child behind
        for proc in CHILDREN[first:]:
            if proc.returncode is None:
                procs.kill_group(proc)
    wall = time.perf_counter() - t0
    log(f"phase 15: wall time {wall:.1f} s (budget {PHASE15_BUDGET_S} s)")
    if wall > PHASE15_BUDGET_S:
        raise AssertionError("phase 15 overran its time budget")


# phase 16: the TF1 checkpoint converter. Its wall-time budget (s) and the
# bundles' shard count
PHASE16_BUDGET_S = 120.0
P16_SHARDS = 2


@contextlib.contextmanager
def _recording_canary():
    """Record the flow of every ``forward_flow`` (the canary's forward)
    and its wall time (synchronized before and after) while the block
    runs."""
    import torch

    from flownet2_tf_tpu_torch.training import infer

    rec = []
    forward = infer.forward_flow

    def spy(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flow = forward(*args, **kwargs)
        torch.cuda.synchronize()
        rec.append((flow.cpu().numpy(), (time.perf_counter() - t0) * 1e3))
        return flow

    infer.forward_flow = spy
    try:
        yield rec
    finally:
        infer.forward_flow = forward


def _tf1_writer():
    """``tests/_torch_tf1_writer.py`` of the checkout: the package ships
    no writer of TF1 checkpoints."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _torch_tf1_writer

    return _torch_tf1_writer


def _p16_convert(root, name, flat, scope, model, canary):
    """Write ``flat`` as a TF1 bundle under ``scope`` (with an Adam slot
    and ``global_step``), then ``cli convert`` it on the card
    (``--no_canary`` unless ``canary``) between a reset and a read of the
    launch counts, and check the .npz bitwise against ``flat``. Returns
    (the prefix, the .npz, the JSON line, the counts, the bundle's bytes,
    write s, convert s)."""
    import numpy as np

    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel

    writer = _tf1_writer()
    t0 = time.perf_counter()
    prefix = writer.write_bundle(os.path.join(root, name),
                                 writer.to_tf_layout(flat, scope),
                                 num_shards=P16_SHARDS)
    write_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(root, f))
               for f in os.listdir(root) if f.startswith(name + "."))
    out = os.path.join(root, f"{name}.npz")
    correlation_kernel.reset_launch_counts()
    t0 = time.perf_counter()
    (line,) = _cli_lines(["convert", "--model", model, "--tf_checkpoint",
                          prefix, "--out", out, "--device", "cuda",
                          "--sample_dir", SAMPLES,
                          *([] if canary else ["--no_canary"])])
    convert_s = time.perf_counter() - t0
    counts = path_counts()
    with np.load(out) as z:
        same = _bitwise_equal({k: z[k] for k in z.files}, flat)
    if line["converted_variables"] != len(flat) or not same:
        raise AssertionError(f"phase 16: cli convert --model {model} wrote "
                             f"other weights ({line})")
    return prefix, out, line, counts, size, write_s, convert_s


def phase16_convert(tmp, tree, c_params):
    """``cli convert`` (see the module docstring): FlowNet2 from ``tree``
    (seeded random weights) and FlowNetC from ``c_params`` (a trained
    checkpoint's .npz), each written as a TF1 bundle and converted on the
    card; the canary's flows against ``cli test``'s."""
    import numpy as np

    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel
    from flownet2_tf_tpu_torch.tools import tf1_bundle
    from flownet2_tf_tpu_torch.tools.convert_tf1_checkpoint import (
        semantic_canary,
    )
    from flownet2_tf_tpu_torch.training import warmstart

    t0 = time.perf_counter()
    root = os.path.join(tmp, "p16")
    os.makedirs(root)
    try:
        # (a) FlowNet2: these random weights predict a mean |flow| of
        # about 556 px on the sample pair (the CPU's f32 flow), outside the
        # canary's band, so the conversion runs with --no_canary and the
        # canary runs apart and must reject them
        flat = warmstart.flatten(tree)
        prefix, out, line, counts, size, write_s, convert_s = _p16_convert(
            root, "flownet-2.ckpt-0", flat, "FlowNet2", "2", canary=False)
        _check_counts(counts, 0, 0, "float32", "phase 16 (a) conversion")
        t1 = time.perf_counter()
        reader = tf1_bundle.load_checkpoint(prefix)
        read = sum(reader.get_tensor(n).nbytes
                   for n in reader.get_variable_to_shape_map())
        read_s = time.perf_counter() - t1
        log(f"phase 16 (a): FlowNet2 as a TF1 bundle ({len(flat)} variables "
            f"with an Adam slot and global_step, {P16_SHARDS} shards, "
            f"{size / 1e6:.1f} MB) written in {write_s:.2f} s; every tensor "
            f"read back and CRC-checked by tools/tf1_bundle.py in "
            f"{read_s:.3f} s ({read / 1e6 / read_s:.1f} MB/s of tensor "
            f"bytes, the page cache warm from the write); cli convert "
            f"--model 2 --no_canary --device cuda {convert_s:.2f} s, "
            f"{line['converted_variables']} leaves, the .npz bitwise the "
            f"written weights")

        with _recording_canary() as rec:
            correlation_kernel.reset_launch_counts()
            try:
                semantic_canary(out, "2", sample_dir=SAMPLES, device="cuda")
                rejected = ""
            except ValueError as e:
                rejected = str(e)
            counts = path_counts()
        _check_counts(counts, 1, 0, "float32", "phase 16 (a) canary")
        (flow, canary_ms), = rec
        flow_test, counts = _cli_test(out, os.path.join(root, "out_2"),
                                      "float32")
        _check_counts(counts, 1, 0, "float32", "phase 16 (a) cli test")
        same = np.array_equal(flow[0], flow_test)
        mean_mag = float(np.sqrt((flow[0] ** 2).sum(-1)).mean())
        log(f"phase 16 (a): the canary's FlowNet2 f32 forward on the card "
            f"({canary_ms:.2f} ms wall, its first call): 1 correlation "
            f"launch, mean |flow| {mean_mag:.3f} px, rejected: "
            f"{rejected!r}; its flow bitwise cli test's on the .npz: {same}")
        if "semantic canary FAILED" not in rejected or not same:
            raise AssertionError("phase 16 (a): the FlowNet2 canary is off")

        # (b) FlowNetC from a trained checkpoint, the canary on
        with np.load(c_params) as z:
            c_flat = {k: z[k] for k in z.files}
        with _recording_canary() as rec:
            _, c_out, line, counts, size, write_s, convert_s = _p16_convert(
                root, "flownet-c.ckpt-0", c_flat, "FlowNetC", "c",
                canary=True)
        _check_counts(counts, 1, 0, "float32", "phase 16 (b) cli convert")
        (flow, canary_ms), = rec
        flow_test, counts = _cli_test(c_out, os.path.join(root, "out_c"),
                                      "float32", model="c")
        _check_counts(counts, 1, 0, "float32", "phase 16 (b) cli test")
        same = np.array_equal(flow[0], flow_test)
        log(f"phase 16 (b): FlowNetC (a trained checkpoint) as a TF1 bundle "
            f"of {size / 1e6:.1f} MB written in {write_s:.2f} s; cli convert "
            f"--model c --device cuda with the canary {convert_s:.2f} s: "
            f"{json.dumps(line['canary'])}; the canary's forward "
            f"{canary_ms:.2f} ms wall (its first call), 1 correlation "
            f"launch; its flow bitwise cli test --model c's: {same}")
        if not same:
            raise AssertionError("phase 16 (b): the canary's flow differs "
                                 "from cli test's")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t0
    log(f"phase 16: wall time {wall:.1f} s (budget {PHASE16_BUDGET_S} s)")
    if wall > PHASE16_BUDGET_S:
        raise AssertionError("phase 16 overran its time budget")


def _p16_flownet_c(tmp):
    """``--phase16``'s FlowNetC checkpoint: phase 5's first run (f32,
    TRAIN_STEPS steps); returns its params.npz."""
    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel
    from flownet2_tf_tpu_torch.training import warmstart

    c_dir = os.path.join(tmp, "flownet_c")
    correlation_kernel.reset_launch_counts()
    _train(["--model", "c", "--log_dir", c_dir, "--max_steps",
            str(TRAIN_STEPS), "--synthetic", "--synthetic_height",
            str(TRAIN_H), "--synthetic_width", str(TRAIN_W), "--batch_size",
            str(TRAIN_BATCH), "--schedule", "short", "--log_every", "5",
            "--device", "cuda", "--compute_dtype", "float32"])
    _check_counts(path_counts(), TRAIN_STEPS, TRAIN_STEPS, "float32",
                  "phase 16 FlowNetC training")
    return os.path.join(warmstart.latest_checkpoint(c_dir),
                        warmstart.PARAMS_FILE)


# phase 17: the serving and approximation levers' wall-time budget (s,
# printed), its train runs and the bench A/Bs' forwards per sample
PHASE17_BUDGET_S = 180.0
P17_TRAIN_HW, P17_TRAIN_BATCH, P17_STEPS = (384, 512), 4, 2
INTERCONV_ENV = "FLOWNET2_TPU_BF16_INTERCONV"


def _p17_exports(ckpt):
    """Phase 17's exports: (a) a graph per platform, (c) the half-res
    fusion on the card."""
    return {"p17_cuda_cpu": _f2_export_argv(ckpt, "--platforms", "cuda,cpu"),
            "p17_fusion2": {"ckpt": ckpt, "compute_dtype": "float32",
                            "warp_mode": "full", "fusion_res": 2,
                            "device": "cuda"}}


def _p17_pair(tmp):
    """A seeded 448x1024 pair written as PNGs (``cli test``'s input) and
    as the float arrays ``load_image_pair`` reads back from them (the
    served calls' input): the same numbers on both paths."""
    import numpy as np

    from flownet2_tf_tpu_torch.utils.image_io import (
        load_image_pair,
        write_image,
    )

    rng = np.random.RandomState(SEED + 17)
    h, w = SERVE_HW
    paths = [os.path.join(tmp, f"p17_{k}.png") for k in "ab"]
    for path in paths:
        write_image(rng.randint(0, 256, (h, w, 3), dtype=np.uint8), path)
    a, b = load_image_pair(*paths)
    npz = os.path.join(tmp, "p17_pair.npz")
    np.savez(npz, a=a[None], b=b[None])
    return paths, npz, a[None], b[None]


def _p17_bench(flags, env=None):
    """``cli bench --model 2`` at 448x1024 with ``flags`` (and ``env`` set
    around it); checks its launches, returns its result."""
    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel
    from flownet2_tf_tpu_torch.tools import bench

    h, w = SERVE_HW
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        correlation_kernel.reset_launch_counts()
        out = _cli_lines(["bench", "--model", "2", "--height", str(h),
                          "--width", str(w), "--device", "cuda", "--iters",
                          str(BENCH_ITERS), *flags])[-1]
        counts = path_counts()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    dtype = "float32" if "float32" in flags else "bfloat16"
    batch = int(flags[flags.index("--batch") + 1]) if "--batch" in flags else 1
    forwards = (bench.WARMUP_FORWARDS
                + _bench_attempts(out) * out["repeats"] * BENCH_ITERS)
    _check_counts(counts, forwards, 0, dtype, f"phase 17 bench {flags}")
    if out["backend"] != "cuda" or "floor_ms_analytic" not in out:
        raise AssertionError(f"phase 17 bench {flags}: {out}")
    out["batch"] = batch
    return out


def phase17_serving_levers(tmp, tree, ckpt, ahead=None):
    """The last serving and approximation levers on the card (FlowNet2 at
    448x1024, phase 2's weights): (a) one ``cli export --aot --platforms
    cuda,cpu`` artifact served per platform in fresh processes, the CUDA
    graph bitwise ``cli test`` with one correlation launch per call, the
    CPU graph with none and within AEE_ATOL of it; (b) ``cli bench`` A/Bs
    of each knob against its exact counterpart, with each
    knob's flow delta on the same weights; (c) a ``fusion_res=2``
    artifact served bitwise its eager model; (d) two ``cli train --model
    2 --fusion_res 2`` runs bitwise equal."""
    import zipfile

    import numpy as np
    import torch

    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel
    from flownet2_tf_tpu_torch.tools import aot, profiler
    from flownet2_tf_tpu_torch.training import infer
    from flownet2_tf_tpu_torch.utils import flowlib

    t0 = time.perf_counter()
    before = json.loads(json.dumps(PATH_LAUNCHES))
    h, w = SERVE_HW
    (png_a, png_b), pair, a_np, b_np = _p17_pair(tmp)

    # (a) one artifact, a graph per platform; (c)'s fusion_res=2 artifact
    exports = _exported(tmp, _p17_exports(ckpt), ahead)
    both, meta, export_s = exports["p17_cuda_cpu"]
    with zipfile.ZipFile(both) as z:
        sizes = {i.filename: i.file_size for i in z.infolist()}
    if (meta["platforms"] != ["cuda", "cpu"] or sorted(sizes) != [
            "exported-cpu.pt2", "exported-cuda.pt2", "meta.json",
            "params.npz"]):
        raise AssertionError(f"phase 17: artifact {meta['platforms']} "
                             f"{sorted(sizes)}")
    total_mb = os.path.getsize(both) / 1e6
    single_mb = total_mb - sizes["exported-cpu.pt2"] / 1e6
    log(f"phase 17: cli export --aot --platforms cuda,cpu f32 full "
        f"{h}x{w}: {export_s:.2f} s, {total_mb:.1f} MB (graphs: cuda "
        f"{sizes['exported-cuda.pt2'] / 1e6:.2f} MB, cpu "
        f"{sizes['exported-cpu.pt2'] / 1e6:.2f} MB; without the cpu graph, "
        f"as a cuda-only export holds: {single_mb:.1f} MB)")
    flo = {p: os.path.join(tmp, f"p17_served_{p}.npy") for p in ("cuda",
                                                                 "cpu")}
    # the CPU graph serves in the background while (c) and (d) run; the
    # CUDA graph's process loads beside them and serves once released
    cpu_worker = _start_worker(tmp, "p17_cpu", [{
        "kind": "single", "artifact": both, "device": "cpu", "pair": pair,
        "flow_out": flo["cpu"]}], threads=6)
    cuda_worker = _start_worker(tmp, "p17_cuda", [{
        "kind": "single", "artifact": both, "device": "cuda", "pair": pair,
        "flow_out": flo["cuda"]}], gated=True)

    # (c) the half-res fusion artifact against its eager model
    f2, meta2, export2_s = exports["p17_fusion2"]
    correlation_kernel.reset_launch_counts()
    a_t, b_t = (torch.from_numpy(x).cuda() for x in (a_np, b_np))
    served = aot.load_serving(f2)(a_t, b_t)
    model = infer.load_model("2", tree, "cuda", fusion_res=2)
    eager = infer.forward_flow(model, a_t, b_t, torch.float32)
    del model
    counts = path_counts()
    _check_counts(counts, 2, 0, "float32", "phase 17 (c)")
    same = bool(torch.equal(served, eager))
    log(f"phase 17 (c): export_serving(fusion_res=2) f32 full {h}x{w}: "
        f"{export2_s:.2f} s, meta fusion_res {meta2['fusion_res']}; served "
        f"flow bitwise the eager half-res model's: {same}; one correlation "
        f"launch each {counts['fwd']}")
    if meta2["fusion_res"] != 2 or not same:
        raise AssertionError("phase 17 (c): the fusion_res=2 artifact")
    os.remove(f2)

    # (d) two bf16 training runs of the half-res fusion, bitwise equal
    th, tw = P17_TRAIN_HW
    runs = []
    correlation_kernel.reset_launch_counts()
    for i in range(2):
        log_dir = os.path.join(tmp, f"p17_train_{i}")
        t1 = time.perf_counter()
        recs = _train(["--model", "2", "--fusion_res", "2", "--synthetic",
                       "--synthetic_height", str(th), "--synthetic_width",
                       str(tw), "--batch_size", str(P17_TRAIN_BATCH),
                       "--max_steps", str(P17_STEPS), "--schedule", "short",
                       "--log_every", "1", "--checkpoint_every", "0",
                       "--device", "cuda", "--log_dir", log_dir])
        runs.append((recs, _checkpoint_params(log_dir, P17_STEPS),
                     time.perf_counter() - t1))
        shutil.rmtree(log_dir)
    counts = path_counts()
    # CSS and SD frozen: the correlation runs forward only
    _check_counts(counts, 2 * P17_STEPS, 0, "bfloat16", "phase 17 (d)")
    repeat = _bitwise_equal(runs[0][1], runs[1][1])
    losses = [[r["loss"] for r in recs] for recs, _, _ in runs]
    log(f"phase 17 (d): cli train --model 2 --fusion_res 2 bf16 b"
        f"{P17_TRAIN_BATCH} {th}x{tw}, {P17_STEPS} steps twice "
        f"({runs[0][2]:.1f} s, {runs[1][2]:.1f} s): losses {losses}, "
        f"checkpoints bitwise equal: {repeat}; launches {counts}")
    if not repeat or losses[0] != losses[1] or not all(
            math.isfinite(x) for x in losses[0]):
        raise AssertionError("phase 17 (d): the two runs differ")

    results, _, cpu_wall = _finish_worker(cpu_worker, None)
    cpu_load = results[0]["load_s"]
    # the CUDA graph, timed with the host quiet
    _wait_ready(cuda_worker)
    _go(cuda_worker["go"])
    results, calls, wall = _finish_worker(cuda_worker, "float32")
    cuda_res = results[0]
    os.remove(both)
    correlation_kernel.reset_launch_counts()
    out_dir = os.path.join(tmp, "p17_cli_test")
    rc = _cli_lines(["test", "--model", "2", "--device", "cuda",
                     "--compute_dtype", "float32", "--ckpt", ckpt,
                     "--input_a", png_a, "--input_b", png_b, "--out",
                     out_dir])
    test_flo = flowlib.read_flow(os.path.join(out_dir, "p17_a_flow.flo"))
    _check_counts(path_counts(), 1, 0, "float32", "phase 17 cli test")
    served = {p: np.load(f)[0] for p, f in flo.items()}
    cuda_same = bool(np.array_equal(served["cuda"], test_flo))
    cpu_epe = _epe(served["cpu"], served["cuda"])
    model = infer.load_model("2", tree, "cuda")
    eager_ms, eager_min = _eager_ms(model, 1, torch.float32,
                                    {"input_a": a_t, "input_b": b_t})
    del model
    path_counts()
    log(f"phase 17 (a): {rc[-1]['flow_shape']} cli test flow; the cuda "
        f"graph (fresh process, {wall:.1f} s: load "
        f"{cuda_res['load_s']:.2f} s, {calls} calls, one correlation launch "
        f"each) bitwise it: {cuda_same}, two served calls bitwise equal: "
        f"{cuda_res['same']}; served {cuda_res['ms_per_pair']:.3f} ms/pair "
        f"(min {cuda_res['min']:.3f}, max {cuda_res['max']:.3f}) against "
        f"eager {eager_ms:.3f} (min {eager_min:.3f}); the cpu graph (fresh "
        f"process, {cpu_wall:.1f} s: load {cpu_load:.2f} s, no launch): "
        f"mean EPE {cpu_epe:.3e} px to the cuda graph's (limit {AEE_ATOL})")
    if not (cuda_same and cuda_res["same"]) or not cpu_epe <= AEE_ATOL:
        raise AssertionError("phase 17 (a): the per-platform graphs")

    # (b) each knob against its exact counterpart, and its flow
    # delta on phase 2's weights at b1 on the pair
    f32 = ["--compute_dtype", "float32"]
    bf16_b8 = ["--batch", "8"]
    interconv = {INTERCONV_ENV: "1"}
    # each exact counterpart runs once, just before its knobs
    order = [("f32 exact", f32, None), ("f32 fusion_res 2",
                                        f32 + ["--fusion_res", "2"], None),
             ("f32 f32_features default",
              f32 + ["--f32_features", "default"], None),
             ("bf16 b8 exact", bf16_b8, None),
             ("bf16 b8 fusion_res 2", bf16_b8 + ["--fusion_res", "2"], None),
             ("bf16 b8 bf16 interconvs", bf16_b8, interconv)]
    benches = {}
    for what, flags, env in order:
        out = benches[what] = _p17_bench(flags, env)
        log(f"phase 17 (b): cli bench {what}: {out['ms_per_pair']:.3f} "
            f"ms/pair (spread {out['spread_pct']}%, floor "
            f"{out['floor_ms_analytic']} ms at {out['peak_tflops']} "
            f"TFLOP/s, mfu {out.get('mfu')}, "
            f"{out['model_tflops_per_pair']} TFLOP/pair) "
            + json.dumps({k: out[k] for k in ("warp_mode", "fusion_res",
                                               "bf16_interconv",
                                               "f32_features") if k in out}))
    for knob in ("fusion_res", "f32_features", "bf16_interconv"):
        if not any(knob in out for out in benches.values()):
            raise AssertionError(f"phase 17 (b): no bench names {knob}")
    # where the f32 b1 knobs' time goes against the exact path's: device
    # ms per forward by scope and the top kernels
    for what, flags in (("exact", []),
                        ("fusion_res 2", ["--fusion_res", "2"]),
                        ("f32_features default",
                         ["--f32_features", "default"])):
        trace_dir = os.path.join(tmp, f"p17_trace_{what.replace(' ', '_')}")
        correlation_kernel.reset_launch_counts()
        last = _cli_lines(["profile", "--model", "2", "--device", "cuda",
                           "--compute_dtype", "float32", "--iters", "3",
                           "--top", "8", "--trace_dir", trace_dir,
                           *flags])[-1]
        _check_counts(path_counts(), profiler.WARMUP_FORWARDS + 3, 0,
                      "float32", f"phase 17 profile {what}")
        with open(os.path.join(last["trace_dir"], "summary.json")) as f:
            summary = json.load(f)
        scopes = {r["name"]: r["device_ms"] for r in summary["scopes"]}
        busy = sum(r["device_ms"] for r in summary["kernels"])
        top = sorted(summary["kernels"], key=lambda r: -r["device_ms"])[:6]
        log(f"phase 17 (b): cli profile f32 b1 {what} (device ms per "
            f"forward): all kernels {busy:.3f}; "
            + ", ".join(f"{k} {scopes.get(k, float('nan')):.3f}" for k in (
                "FlowNetCSS", "FlowNetSD", "fusion")) + "; top kernels "
            + "; ".join(f"{r['name'][:60]} {r['device_ms']:.3f}"
                        for r in top))
        if (summary["fusion_res"], summary["f32_features"]) != (
                2 if "fusion_res" in what else 1,
                "default" if "f32_features" in what else "highest"):
            raise AssertionError(f"phase 17 profile {what}: {summary}")
    correlation_kernel.reset_launch_counts()
    deltas = {}
    for what, dtype, warp, knobs, ref in (
            ("f32 fusion_res 2", "float32", 1, {"fusion_res": 2}, "f32"),
            ("f32 f32_features default", "float32", 1,
             {"f32_features": "default"}, "f32"),
            ("bf16 half", "bfloat16", 2, {}, None),
            ("bf16 half fusion_res 2", "bfloat16", 2, {"fusion_res": 2},
             "bf16 half"),
            ("bf16 half bf16 interconvs", "bfloat16", 2,
             {"bf16_interconv": True}, "bf16 half")):
        flow = infer.infer_flow("2", tree, a_np, b_np, device="cuda",
                                compute_dtype=dtype, warp_res=warp,
                                **knobs)[0]
        deltas[what] = flow
        if ref is not None:
            base = test_flo if ref == "f32" else deltas[ref]
            log(f"phase 17 (b): flow delta of {what} against its exact "
                f"counterpart on phase 2's random weights: mean EPE "
                f"{_epe(flow, base):.4f} px (mean |flow| "
                f"{float(np.sqrt((base ** 2).sum(-1)).mean()):.4f} px)")
    counts = path_counts()
    if (counts["fwd"].get("float32") != 2 or counts["fwd"].get("bfloat16")
            != 3 or sum(counts["bwd"].values())):
        raise AssertionError(f"phase 17 deltas: launches {counts}")
    wall = time.perf_counter() - t0
    log("phase 17: correlation launches on its paths " + json.dumps({
        way: {k: n - before[way][k] for k, n in by_dtype.items()}
        for way, by_dtype in PATH_LAUNCHES.items()}))
    log(f"phase 17: wall time {wall:.1f} s (budget {PHASE17_BUDGET_S} s"
        f"{', over it' if wall > PHASE17_BUDGET_S else ''})")


PHASE18_BUDGET_S = 90.0
# (a): saves per model, each a synchronous then an asynchronous save of the
# same step, after this many warm-up steps
P18_SAVES, P18_WARMUP = 2, 3
# (b): `cli train --checkpoint_every 2`, 4 steps straight and 2 + 2
P18_STEPS, P18_EVERY = 4, 2
# (c): how long the child's write is held, so that its main thread is
# already leaving the interpreter when the write begins
P18_HOLD_S = 1.0


def _p18_trainer(log_dir, model="c"):
    """Phase 18's trainer: ``model`` at the bf16 default, its default
    frozen scopes, the newest checkpoint kept."""
    from flownet2_tf_tpu_torch.training.loop import TrainConfig, Trainer

    return Trainer(TrainConfig(
        model=model, schedule="short", log_dir=log_dir, device="cuda",
        tensorboard=False, checkpoint_every=0, keep_checkpoints=1))


def _p18_read(step_dir):
    """(params.npz as a dict, optimizer.pt as saved) of ``step_dir``."""
    import numpy as np
    import torch

    from flownet2_tf_tpu_torch.training.loop import OPTIMIZER_FILE
    from flownet2_tf_tpu_torch.training.warmstart import PARAMS_FILE

    with np.load(os.path.join(step_dir, PARAMS_FILE)) as z:
        params = {k: z[k] for k in z.files}
    return params, torch.load(os.path.join(step_dir, OPTIMIZER_FILE),
                              weights_only=True)


def _same_tree(a, b):
    """Equal nested containers, tensors bitwise in dtype and shape."""
    import torch

    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (len(a) == len(b)
                and all(_same_tree(x, y) for x, y in zip(a, b)))
    return a == b


def _same_checkpoint(a, b):
    """Two :func:`_p18_read` results bitwise equal."""
    return (_bitwise_equal(a[0], b[0])
            and all(v.dtype == b[0][k].dtype for k, v in a[0].items())
            and _same_tree(a[1], b[1]))


def _p18_digests(model):
    import hashlib

    import numpy as np

    from flownet2_tf_tpu_torch.training import warmstart

    return {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in warmstart.flatten(
                warmstart.to_jax_params(model)).items()}


def _p18_saves(tmp, model):
    """(a) ``model`` bf16 b8 320x448 (its default frozen scopes) on one
    batch uploaded once, as ``benchlib.train_step_ms`` runs it. P18_SAVES
    times: ``save(wait=True)`` of step k, then ``save()`` of the same
    step, with train steps run while its write is in flight, then as many
    with no write, after a first save that allocates the trainer's
    snapshot buffers. Returns the stalls (host ms from a synchronize to the
    call's return), the writes' wall times (s, timed inside the writer),
    the CUDA-event step ms, the checkpoint's MB and whether each
    asynchronous checkpoint is bitwise the synchronous one."""
    import torch

    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel

    log_dir = os.path.join(tmp, f"p18_{model}")
    trainer = _p18_trainer(log_dir, model)
    state = trainer.init_state()
    batch = {k: torch.from_numpy(v).to(trainer.device)
             for k, v in _p15_batch().items()}
    writes = []
    write = trainer._write_checkpoint

    def timed_write(step, *args):
        t0 = time.perf_counter()
        try:
            write(step, *args)
        finally:
            writes.append(time.perf_counter() - t0)

    trainer._write_checkpoint = timed_write

    def step_ms():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.train_step(state, batch)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def stall_ms(wait):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.save(state, wait=wait)
        return (time.perf_counter() - t0) * 1000.0

    for _ in range(P18_WARMUP):
        step_ms()
    correlation_kernel.reset_launch_counts()
    out = {"stall_ms": {"sync": [], "async": []},
           "write_s": {"sync": [], "async": []},
           "step_ms": {"write": [], "idle": []}, "bitwise": []}
    try:
        # the first save allocates the trainer's snapshot buffers
        out["first_save_ms"] = stall_ms(True)
        for _ in range(P18_SAVES):
            out["stall_ms"]["sync"].append(stall_ms(True))
            out["write_s"]["sync"].append(writes[-1])
            step_dir = os.path.join(log_dir, "checkpoints", str(state.step))
            out["mb"] = sum(os.path.getsize(os.path.join(step_dir, f))
                            for f in os.listdir(step_dir)) / 1e6
            sync_files = _p18_read(step_dir)
            n = len(writes)
            out["stall_ms"]["async"].append(stall_ms(False))
            during = [step_ms()]
            while len(writes) == n:
                during.append(step_ms())
            trainer.wait_until_finished()
            out["write_s"]["async"].append(writes[-1])
            out["bitwise"].append(_same_checkpoint(sync_files,
                                                   _p18_read(step_dir)))
            out["step_ms"]["write"] += during
            out["step_ms"]["idle"] += [step_ms() for _ in during]
        counts = path_counts()
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    steps = len(out["step_ms"]["write"]) + len(out["step_ms"]["idle"])
    _check_counts(counts, steps, steps if model == "c" else 0, "bfloat16",
                  f"phase 18 (a) {model}")
    med = {k: {w: statistics.median(v) for w, v in d.items()}
           for k, d in out.items() if k in ("stall_ms", "write_s",
                                            "step_ms")}
    log(f"phase 18 (a): {model} bf16 b{TRAIN_BATCH} {TRAIN_H}x{TRAIN_W}, "
        f"checkpoint {out['mb']:.1f} MB: first save(wait=True) "
        f"{out['first_save_ms']:.1f} ms; stall of save(wait=True) median "
        f"{med['stall_ms']['sync']:.1f} ms, of save() "
        f"{med['stall_ms']['async']:.1f} ms; background write "
        f"{med['write_s']['async']:.3f} s (synchronous writes "
        f"{med['write_s']['sync']:.3f} s); step "
        f"{med['step_ms']['write']:.3f} ms with a write in flight over "
        f"{len(out['step_ms']['write'])} steps, {med['step_ms']['idle']:.3f}"
        f" ms with none; correlation launches {counts}; asynchronous "
        f"checkpoints bitwise the synchronous ones: {out['bitwise']}")
    if not all(out["bitwise"]):
        raise AssertionError(f"phase 18 (a) {model}: an asynchronous "
                             "checkpoint differs from the synchronous one")
    return {**out, "median": med}


def _p18_resume(tmp):
    """(b) ``cli train --model c`` (bf16) with ``--checkpoint_every 2``:
    P18_STEPS steps straight, against P18_STEPS // 2 then resumed; the
    checkpoints bitwise equal, one forward and one backward correlation
    launch per step."""
    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel

    common = ["--model", "c", "--synthetic", "--synthetic_height",
              str(TRAIN_H), "--synthetic_width", str(TRAIN_W),
              "--batch_size", str(TRAIN_BATCH), "--schedule", "short",
              "--log_every", "1", "--checkpoint_every", str(P18_EVERY),
              "--device", "cuda"]
    straight = os.path.join(tmp, "p18_straight")
    resumed = os.path.join(tmp, "p18_resumed")
    half = P18_STEPS // 2
    try:
        correlation_kernel.reset_launch_counts()
        logged = [[r["step"] for r in _train([
            *common, "--log_dir", log_dir, "--max_steps", str(stop)])]
            for log_dir, stop in ((straight, P18_STEPS), (resumed, half),
                                  (resumed, P18_STEPS))]
        counts = path_counts()
        kept = [sorted(os.listdir(os.path.join(d, "checkpoints")), key=int)
                for d in (straight, resumed)]
        same = {step: _same_checkpoint(
            _p18_read(os.path.join(straight, "checkpoints", step)),
            _p18_read(os.path.join(resumed, "checkpoints", step)))
            for step in kept[0]}
    finally:
        shutil.rmtree(straight, ignore_errors=True)
        shutil.rmtree(resumed, ignore_errors=True)
    log(f"phase 18 (b): cli train --model c --checkpoint_every {P18_EVERY} "
        f"(bf16): logged steps {logged}, checkpoints {kept}, straight "
        f"against resumed bitwise {same}; correlation launches {counts}")
    if logged != [list(range(1, P18_STEPS + 1)), list(range(1, half + 1)),
                  list(range(half + 1, P18_STEPS + 1))]:
        raise AssertionError(f"phase 18 (b): logged steps {logged}")
    if kept[0] != kept[1] or kept[0][-1] != str(P18_STEPS):
        raise AssertionError(f"phase 18 (b): checkpoints {kept}")
    if not all(same.values()):
        raise AssertionError(f"phase 18 (b): the resumed checkpoints differ "
                             f"from the straight run's: {same}")
    _check_counts(counts, 2 * P18_STEPS, 2 * P18_STEPS, "bfloat16",
                  "phase 18 (b)")


def save_exit_worker(spec_path):
    """Phase 18 (c)'s child: FlowNetC (bf16) trains one step on the card
    on ``_p15_batch``, writes its parameters' SHA-256 and its launch
    counts to the spec's result file, calls ``Trainer.save(state)`` with
    its write held P18_HOLD_S s, and returns at once."""
    import torch

    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel as ck

    with open(spec_path) as f:
        spec = json.load(f)
    trainer = _p18_trainer(spec["log_dir"])
    state = trainer.init_state()
    ck.reset_launch_counts()
    trainer.train_step(state, _p15_batch())
    torch.cuda.synchronize()
    with open(spec["result"], "w") as f:
        json.dump({"step": state.step, "digests": _p18_digests(state.model),
                   "launches": {"fwd": dict(ck.LAUNCHES_BY_DTYPE),
                                "bwd": dict(ck.BWD_LAUNCHES_BY_DTYPE)}}, f)
    write = trainer._write_checkpoint

    def held(*args):
        time.sleep(P18_HOLD_S)
        write(*args)

    trainer._write_checkpoint = held
    trainer.save(state)
    return 0


def _p18_exit_start(tmp):
    """(c) start the child that saves and exits; it runs beside (b)."""
    spec = os.path.join(tmp, "p18_exit.json")
    log_dir = os.path.join(tmp, "p18_exit")
    with open(spec, "w") as f:
        json.dump({"log_dir": log_dir, "result": spec + ".out"}, f)
    log_path = os.path.join(tmp, "p18_exit.log")
    return (_start_child("save_exit_worker", spec, log_path), spec,
            log_path, log_dir)


def _p18_exit_finish(started):
    """(c) the child exited 0 and left a complete checkpoint of its step,
    which ``restore_or_init`` on the card resumes bitwise."""
    proc, spec, log_path, log_dir = started
    t0 = time.perf_counter()
    _wait_child(proc, log_path, "phase 18 (c)")
    waited = time.perf_counter() - t0
    try:
        with open(spec + ".out") as f:
            child = json.load(f)
        _add_launches(child["launches"])
        step_dir = os.path.join(log_dir, "checkpoints", str(child["step"]))
        entries = sorted(os.listdir(os.path.join(log_dir, "checkpoints")))
        files = sorted(os.listdir(step_dir))
        state, resumed = _p18_trainer(log_dir).restore_or_init()
        same = _p18_digests(state.model) == child["digests"]
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    log(f"phase 18 (c): a child trained step {child['step']}, called save() "
        f"with its write held {P18_HOLD_S} s and returned (waited on "
        f"{waited:.1f} s here after (b)); it left {entries} holding {files}; "
        f"restore_or_init resumed {resumed} at step {state.step}, parameters "
        f"bitwise the child's: {same}; its correlation launches "
        f"{child['launches']}")
    if entries != [str(child["step"])] or not resumed or not same:
        raise AssertionError("phase 18 (c): the child's checkpoint is "
                             "missing, partial or different")
    if state.step != child["step"]:
        raise AssertionError(f"phase 18 (c): resumed at step {state.step}")
    _check_counts(child["launches"], 1, 1, "bfloat16", "phase 18 (c)")


def phase18_async_checkpoints(tmp):
    """Asynchronous checkpoint saving on the card: (a) the stall of
    ``save(wait=True)`` against ``save()``, the background write's wall
    time and the step with a write in flight against with none, for
    FlowNetC and FlowNetCSS (FlowNetCS frozen), each asynchronous
    checkpoint bitwise the synchronous one; (b) ``cli train
    --checkpoint_every 2`` straight against interrupted and resumed,
    bitwise; (c) a process that exits right after ``save()`` leaves a
    complete checkpoint."""
    t0 = time.perf_counter()
    before = json.loads(json.dumps(PATH_LAUNCHES))
    numbers = {model: _p18_saves(tmp, model) for model in ("c", "css")}
    started = _p18_exit_start(tmp)
    try:
        _p18_resume(tmp)
    finally:
        _p18_exit_finish(started)
    wall = time.perf_counter() - t0
    log("phase 18: " + json.dumps(numbers))
    log("phase 18: correlation launches on its paths " + json.dumps({
        way: {k: n - before[way][k] for k, n in by_dtype.items()}
        for way, by_dtype in PATH_LAUNCHES.items()}))
    log(f"phase 18: wall time {wall:.1f} s (budget {PHASE18_BUDGET_S} s"
        f"{', over it' if wall > PHASE18_BUDGET_S else ''})")


# phase 19: multi-device serving on one card. Its wall-time budget (s),
# the replicas and bands (all on cuda:0 here), the limit of a replica's
# rows against the batch-1 artifact when they are not bitwise equal and
# of the bands over devices against the bands as one batch (mean EPE,
# px), and (d)'s timed runs
PHASE19_BUDGET_S = 150.0
P19_DEVICES = 2
P19_EPE = 1e-2
P19_RUNS = 5


def _p19_exports(ckpt, alone=False):
    """Phase 19's exports of FlowNet2 f32 (exact warps) at 448x1024: the
    2-replica artifact and the b2 one; ``alone``, also the b1 and the
    spatial artifacts the full run takes from phases 12 and 15."""
    n = P19_DEVICES
    jobs = {"p19_dp": _f2_export_argv(ckpt, "--device", "cuda", "--batch",
                                      str(n), "--data_parallel", str(n)),
            "p19_b2": _f2_export_argv(ckpt, "--device", "cuda", "--batch",
                                      str(n))}
    if alone:
        jobs["p19_b1"] = _f2_export_argv(ckpt, "--device", "cuda")
        jobs["p19_sp"] = _f2_export_argv(
            ckpt, "--device", "cuda", "--spatial_tiles", str(n),
            "--spatial_overlap", str(min(SPATIAL_OVERLAPS)))
    return jobs


def _p19_replicas(paths, a, b):
    """(a) the DP artifact's replicas on one card against the batch-1
    artifact, row by row; returns the loaded DP model and its flow."""
    import torch

    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel as ck
    from flownet2_tf_tpu_torch.tools import aot

    n = P19_DEVICES
    on_card = [torch.device("cuda", 0)] * n
    t0 = time.perf_counter()
    dp = aot.load_serving(paths["dp"], devices=["cuda:0"] * n)
    one = aot.load_serving(paths["b1"])
    load = time.perf_counter() - t0
    if dp.devices != on_card:
        raise AssertionError(f"phase 19 (a): replicas on {dp.devices}")
    ck.reset_launch_counts()
    flow = dp(a, b)
    rows = [one(a[i:i + 1], b[i:i + 1]) for i in range(n)]
    _check_counts(path_counts(), 2 * n, 0, "float32",
                  "phase 19 (a) the replicas and the b1 artifact")
    if flow.shape != (n, *SERVE_HW, 2) or flow.device != on_card[0]:
        raise AssertionError(f"phase 19 (a): flow {flow.shape} on "
                             f"{flow.device}")
    same = [bool(torch.equal(flow[i:i + 1], row)) for i, row in
            enumerate(rows)]
    epe = [_epe(flow[i].cpu().numpy(), row[0].cpu().numpy())
           for i, row in enumerate(rows)]
    log(f"phase 19 (a): data_parallel {n} loaded on {['cuda:0'] * n} "
        f"(both artifacts {load:.2f} s): {n} correlation launches per call; "
        f"each replica's rows bitwise the b1 artifact's: {same} (mean EPE "
        f"{epe} px)")
    if not all(same):
        worst = max(float((flow[i:i + 1] - row).abs().max())
                    for i, row in enumerate(rows))
        log(f"phase 19 (a): not bitwise: max |diff| {worst:.3e}; the two "
            "artifacts hold graphs traced apart (batch 1 each), and cuDNN "
            "may pick another algorithm for the same shape in another "
            "graph; held to the limit instead")
        if max(epe) > P19_EPE:
            raise AssertionError(f"phase 19 (a): replicas {epe} px from the "
                                 "b1 artifact")
    return dp, flow


def _p19_refusal(paths, a, b, flow):
    """(b) the DP artifact on the default devices: refused on one card;
    on several, one replica per card, bitwise (a)'s flow."""
    import torch

    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel as ck
    from flownet2_tf_tpu_torch.tools import aot

    n, k = P19_DEVICES, torch.cuda.device_count()
    if k >= n:
        spread = aot.load_serving(paths["dp"])
        ck.reset_launch_counts()
        want = [torch.device("cuda", i) for i in range(n)]
        same = bool(torch.equal(spread(a, b), flow))
        path_counts()
        log(f"phase 19 (b): {k} cards: replicas on {spread.devices}, flow "
            f"bitwise (a)'s: {same}")
        if spread.devices != want or not same:
            raise AssertionError("phase 19 (b): replicas misplaced or off")
        return
    want = f"artifact needs {n} devices (data_parallel); only {k} visible"
    try:
        aot.load_serving(paths["dp"])
    except ValueError as e:
        if str(e) != want:
            raise AssertionError(f"phase 19 (b): refused with {e!r}, "
                                 f"expected {want!r}") from None
        log(f"phase 19 (b): load_serving with the default devices on {k} "
            f"card: ValueError {e}")
        return
    raise AssertionError("phase 19 (b): a 2-replica artifact loaded on one "
                         "card")


def _p19_bands(paths, tree, a, b):
    """(c) the bands over two devices (both cuda:0) against the bands as
    one batch: the library and the spatial artifact."""
    import torch

    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel as ck
    from flownet2_tf_tpu_torch.parallel import spatial
    from flownet2_tf_tpu_torch.tools import aot

    n, overlap = P19_DEVICES, min(SPATIAL_OVERLAPS)
    on_card = ["cuda:0"] * n
    a_np, b_np = (x[0].cpu().numpy() for x in (a, b))
    ck.reset_launch_counts()
    spread = spatial.infer_flow_spatial("2", tree, a_np, b_np, n_tiles=n,
                                        overlap=overlap, devices=on_card)
    _check_counts(path_counts(), n, 0, "float32",
                  "phase 19 (c) infer_flow_spatial over 2 devices")
    ck.reset_launch_counts()
    batched = spatial.infer_flow_spatial("2", tree, a_np, b_np, n_tiles=n,
                                         overlap=overlap,
                                         devices=["cuda:0"])
    _check_counts(path_counts(), 1, 0, "float32",
                  "phase 19 (c) infer_flow_spatial as one batch")
    bands = aot.load_serving(paths["sp"], devices=on_card)
    whole = aot.load_serving(paths["sp"])
    ck.reset_launch_counts()
    served = bands(a[:1], b[:1])[0].cpu().numpy()
    served_whole = whole(a[:1], b[:1])[0].cpu().numpy()
    _check_counts(path_counts(), n + 1, 0, "float32",
                  "phase 19 (c) the spatial artifact's band and one graphs")
    lib_epe, art_epe = _epe(spread, batched), _epe(served, served_whole)
    log(f"phase 19 (c): infer_flow_spatial, {n} bands (overlap {overlap}) "
        f"on {on_card}: {n} correlation launches, mean EPE to the bands as "
        f"one batch {lib_epe:.3e} px (limit {P19_EPE}); the spatial "
        f"artifact's band graph on {on_card}: {n} launches per call, mean "
        f"EPE to its one-graph load {art_epe:.3e} px (limit {P19_EPE}), to "
        f"the library's bands {_epe(served, spread):.3e} px")
    if not (lib_epe <= P19_EPE and art_epe <= P19_EPE):
        raise AssertionError("phase 19 (c): the bands over devices are off")


def _p19_timing(paths, dp, a, b, flow, smi):
    """(d) served ms/pair of the replicas against the b2 artifact."""
    import torch

    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel as ck
    from flownet2_tf_tpu_torch.tools import aot

    n = P19_DEVICES
    b2 = aot.load_serving(paths["b2"])
    ck.reset_launch_counts()
    batch_flow = b2(a, b)
    log(f"phase 19 (d): the b{n} artifact's flow against the replicas': "
        f"bitwise {bool(torch.equal(batch_flow, flow))}, mean EPE "
        f"{_epe(batch_flow.cpu().numpy(), flow.cpu().numpy()):.3e} px")
    times = {}
    for key, model in (("replicas", dp), ("b2", b2),
                       ("replicas again", dp)):
        times[key] = [t / n for t in cuda_time_ms(lambda: model(a, b),
                                                  runs=P19_RUNS, warmup=2)]
    # each set: 2 warm-ups and the timed runs; n launches per replicas'
    # call, 1 per b2 call, and b2's first call above
    calls = P19_RUNS + 2
    _check_counts(path_counts(), 1 + calls * (n + 1 + n), 0, "float32",
                  "phase 19 (d) the served calls")
    parts = [f"{key} {statistics.median(t):.3f} ms/pair (min {min(t):.3f}, "
             f"max {max(t):.3f})" for key, t in times.items()]
    log(f"phase 19 (d): FlowNet2 f32 b{n} {SERVE_HW[0]}x{SERVE_HW[1]} "
        f"served, {n} replicas on cuda:0 against the one-device b{n} "
        f"artifact, in turns: {'; '.join(parts)} (CUDA events, median of "
        f"{P19_RUNS}; {smi})")


def phase19_multi_device(tmp, ckpt, tree, b1_path=None, spatial_path=None,
                         ahead=None):
    """Multi-device serving on the one card (see the module docstring).
    ``b1_path``/``spatial_path``: phase 12's f32 b1 and phase 15's
    spatial artifact of the same weights and settings, exported here when
    None; ``ahead``: phase 12's return, holding this phase's exports."""
    import torch

    t0 = time.perf_counter()
    n = P19_DEVICES
    exports = _exported(tmp, _p19_exports(ckpt, alone=b1_path is None),
                        ahead)
    for key, (path, meta, wall) in exports.items():
        log(f"phase 19: cli export --aot {key} (a child process): "
            f"{wall:.2f} s, {os.path.getsize(path) / 1e6:.1f} MB")
    paths = {key[len("p19_"):]: path for key, (path, _, _) in exports.items()}
    paths.setdefault("b1", b1_path)
    paths.setdefault("sp", spatial_path)
    meta = exports["p19_dp"][1]
    if (meta["batch"], meta["data_parallel"]) != (n, n):
        raise AssertionError(f"phase 19: metadata {meta}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    a, b = (torch.rand((n, *SERVE_HW, 3), generator=gen, device="cuda")
            for _ in range(2))
    before = json.loads(json.dumps(PATH_LAUNCHES))
    dp, flow = _p19_replicas(paths, a, b)
    _p19_refusal(paths, a, b, flow)
    _p19_bands(paths, tree, a, b)
    _p19_timing(paths, dp, a, b, flow, _smi())
    log("phase 19: correlation launches on its paths " + json.dumps({
        way: {k: c - before[way][k] for k, c in by_dtype.items()}
        for way, by_dtype in PATH_LAUNCHES.items()}))
    for key in ("dp", "b2"):
        os.remove(paths[key])
    wall = time.perf_counter() - t0
    log(f"phase 19: wall time {wall:.1f} s (budget {PHASE19_BUDGET_S} s)")
    if wall > PHASE19_BUDGET_S:
        raise AssertionError("phase 19 overran its time budget")


def main(argv=None):
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not os.path.isdir(os.path.join(ROOT, "flownet2_tf_tpu_torch")):
        raise SystemExit("chip_smoke.py: run it from a checkout of the "
                         "repository (flownet2_tf_tpu_torch/ not found)")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    sys.path.insert(0, ROOT)
    t0 = time.perf_counter()
    if argv == ["--phase14"]:
        # phases 0 and 14 alone, on their own inputs: a quick check of the
        # training input path; prints no result line
        from flownet2_tf_tpu_torch.models.registry import get_model

        phase0_device_and_build()
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, "flownet2_seed0.npz")
            _jax_layout_npz(get_model("2").build("cpu"), ckpt)
            phase14_input_path(tmp, _write_chairs(tmp)[0], ckpt)
        _check_no_child_left()
        log(f"chip_smoke.py --phase14: passed in "
            f"{time.perf_counter() - t0:.1f} s")
        return 0
    if argv == ["--phase15"]:
        # phases 0 and 15 alone, on their own inputs; no result line
        from flownet2_tf_tpu_torch.models.registry import get_model

        phase0_device_and_build()
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, "flownet2_seed0.npz")
            tree = _jax_layout_npz(get_model("2").build("cpu"), ckpt)
            phase15_data_parallel_and_spatial(tmp, ckpt, tree)
        _check_no_child_left()
        log(f"chip_smoke.py --phase15: passed in "
            f"{time.perf_counter() - t0:.1f} s")
        return 0
    if argv == ["--phase16"]:
        # phases 0 and 16 alone, on their own inputs; no result line
        from flownet2_tf_tpu_torch.models.registry import get_model

        phase0_device_and_build()
        with tempfile.TemporaryDirectory() as tmp:
            tree = _jax_layout_npz(get_model("2").build("cpu"),
                                   os.path.join(tmp, "flownet2_seed0.npz"))
            phase16_convert(tmp, tree, _p16_flownet_c(tmp))
        _check_no_child_left()
        log(f"chip_smoke.py --phase16: passed in "
            f"{time.perf_counter() - t0:.1f} s")
        return 0
    if argv == ["--phase17"]:
        # phases 0 and 17 alone, on their own inputs; no result line
        from flownet2_tf_tpu_torch.models.registry import get_model

        phase0_device_and_build()
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, "flownet2_seed0.npz")
            tree = _jax_layout_npz(get_model("2").build("cpu"), ckpt)
            phase17_serving_levers(tmp, tree, ckpt)
        _check_no_child_left()
        log(f"chip_smoke.py --phase17: passed in "
            f"{time.perf_counter() - t0:.1f} s")
        return 0
    if argv == ["--phase18"]:
        # phases 0 and 18 alone; no result line
        phase0_device_and_build()
        with tempfile.TemporaryDirectory() as tmp:
            phase18_async_checkpoints(tmp)
        _check_no_child_left()
        log(f"chip_smoke.py --phase18: passed in "
            f"{time.perf_counter() - t0:.1f} s")
        return 0
    if argv == ["--phase19"]:
        # phases 0 and 19 alone, its artifacts exported there; no result
        # line
        from flownet2_tf_tpu_torch.models.registry import get_model

        phase0_device_and_build()
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, "flownet2_seed0.npz")
            tree = _jax_layout_npz(get_model("2").build("cpu"), ckpt)
            phase19_multi_device(tmp, ckpt, tree)
        _check_no_child_left()
        log(f"chip_smoke.py --phase19: passed in "
            f"{time.perf_counter() - t0:.1f} s")
        return 0
    if argv:
        raise SystemExit(f"chip_smoke.py: unknown arguments {argv} (none, "
                         "--phase14, --phase15, --phase16, --phase17, "
                         "--phase18 or --phase19)")

    phase0_device_and_build()
    worst, timings = phase1_kernel_vs_plain()
    with tempfile.TemporaryDirectory() as tmp:
        tree, ckpt, flow_cpu, flow_cuda = phase2_main_path(tmp)
        # each phase's own time of a shape phase 13 measures again
        earlier = {}
        f32 = inference_numbers(3, tree, "float32", (1,))
        earlier["phase 3 f32 b1"] = f32[1]
        bwd_worst, bwd_timings = phase4_backward_vs_plain()
        c_params = os.path.join(tmp, "flownet_c_phase5.npz")
        with tempfile.TemporaryDirectory() as train_tmp:
            training_path(5, train_tmp, "float32")
            # phase 16 converts phase 5's trained FlowNetC
            shutil.copy(os.path.join(train_tmp, "flownet_c", "checkpoints",
                                     str(RESUME_STEPS), "params.npz"),
                        c_params)
        earlier["phase 6 C f32 step"] = train_step_numbers(
            6, "float32", bwd_timings["float32"]["ms"])
        phase7_bf16_main_path(tmp, ckpt, tree, flow_cpu)
        bf16 = inference_numbers(8, tree, "bfloat16", (1, 8))
        earlier["phase 8 bf16 b1"], earlier["phase 8 bf16 b8"] = (bf16[1],
                                                                  bf16[8])
        with tempfile.TemporaryDirectory() as train_tmp:
            training_path(9, train_tmp, "bfloat16")
        earlier["phase 9 C bf16 step"] = train_step_numbers(
            9, "bfloat16", bwd_timings["bfloat16"]["ms"])
        phase10_eval(tmp, ckpt)
        with tempfile.TemporaryDirectory() as disk_tmp:
            chairs, crc_py_mb_s = phase11_train_from_disk(disk_tmp)
            # phases 15, 17 and 19 export in phase 12's children
            ahead = phase12_serving(tmp, tree, ckpt, flow_cuda, extra_exports={
                **_p15_exports(ckpt), **_p17_exports(ckpt),
                **_p19_exports(ckpt)})
            phase13_measurement(tmp, earlier)
            phase14_input_path(disk_tmp, chairs, ckpt, crc_py_mb_s)
        phase15_data_parallel_and_spatial(tmp, ckpt, tree, ahead)
        phase16_convert(tmp, tree, c_params)
        phase17_serving_levers(tmp, tree, ckpt, ahead)
        phase18_async_checkpoints(tmp)
        phase19_multi_device(
            tmp, ckpt, tree, b1_path=os.path.join(tmp, "f32_full.flowpak"),
            spatial_path=os.path.join(tmp, "p15_spatial.flowpak"),
            ahead=ahead)

    _check_no_child_left()
    log(f"chip_smoke.py: every phase passed in "
        f"{time.perf_counter() - t0:.1f} s")
    # the headline numbers are the f32 main path's: FlowNet2 (forward) and
    # FlowNetC training (backward); every timed case is listed beside them
    fwd = timings[(1, 56, 128, 256), "float32"]
    bwd = bwd_timings["float32"]
    log(json.dumps({"kernels": [{
        "name": "correlation_fwd",
        "route": "cuda",
        "source": CORR_SOURCE,
        "replaces": CORR_REPLACES,
        "launches": sum(PATH_LAUNCHES["fwd"].values()),
        "launches_by_dtype": PATH_LAUNCHES["fwd"],
        "max_abs_err": worst,
        **fwd,
        "library_ms": None,  # no PyTorch call computes a banded correlation
        "cases": [{"shape": list(shape), "dtype": dtype, **t}
                  for (shape, dtype), t in timings.items()],
    }, {
        "name": "correlation_bwd",
        "route": "cuda",
        "source": CORR_SOURCE,
        "replaces": CORR_BWD_REPLACES,
        "launches": sum(PATH_LAUNCHES["bwd"].values()),
        "launches_by_dtype": PATH_LAUNCHES["bwd"],
        "max_abs_err": bwd_worst,
        **bwd,
        "library_ms": None,
        "cases": [{"shape": [TRAIN_BATCH, TRAIN_H // 8, TRAIN_W // 8, 256],
                   "dtype": dtype, **t} for dtype, t in bwd_timings.items()],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        # a phase that failed leaves no child behind
        if CHILDREN:
            from flownet2_tf_tpu_torch.utils import procs

            for proc in CHILDREN:
                if proc.returncode is None:
                    procs.kill_group(proc)
