#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``flownet2_tf_tpu_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA device. It
builds the port's CUDA kernels from ``flownet2_tf_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card, and drives the port's
two paths through its CLI at full published widths from seeded random
weights:

* phases 1-3, inference: the correlation forward kernel against its plain
  version; FlowNet2 f32 through ``cli test`` on the bundled sample pair,
  held against the plain CPU path; FlowNet2 timed at 448x1024;
* phases 4-6, training: the correlation backward kernel against autograd
  of the plain version; FlowNetC trained 20 steps through ``cli train`` at
  the FlyingChairs crop 320x448, batch 8, then resumed, then a FlowNetCS
  warm-started from it with FlowNetC frozen; the FlowNetC train step timed.

Each path's kernel launch counts are set to 0 just before it and read just
after. Every phase raises on failure; the exit code is then non-zero and
no result line is printed.

The last two lines of stdout are one JSON object with each kernel's
numbers, then ``{"ok": true, "device": {...}}``. It exits non-zero without
a CUDA device, and outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
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

CORR_SOURCE = "flownet2_tf_tpu_torch/csrc/correlation.cu"
CORR_REPLACES = "flownet2_tf_tpu/ops/pallas/correlation_kernel.py:53"
CORR_BWD_REPLACES = "flownet2_tf_tpu/ops/pallas/correlation_kernel.py:147"

# FlowNetC at the FlyingChairs crop (data/dataset_configs.py): conv3 is
# (8, 40, 56, 256) there
TRAIN_H, TRAIN_W, TRAIN_BATCH = 320, 448, 8
TRAIN_STEPS, RESUME_STEPS = 20, 25


def log(msg):
    print(msg, flush=True)


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


def phase0_device_and_build():
    import torch

    from flownet2_tf_tpu_torch.ops.cuda import _build, correlation_kernel

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    t0 = time.perf_counter()
    correlation_kernel.build()
    log(f"phase 0: built correlation kernel for sm_90a in "
        f"{time.perf_counter() - t0:.2f} s")
    log(_build.build_log("correlation").strip())
    return smi


def phase1_kernel_vs_plain():
    """The correlation kernel against its plain version, on the card."""
    import torch

    from flownet2_tf_tpu_torch.ops.correlation import _correlation_oracle
    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [
        # the FlowNetC shape of FlowNet2 at 448x1024
        ((1, 56, 128, 256), 20, 2, torch.float32, True),
        ((1, 56, 128, 256), 20, 2, torch.bfloat16, True),
        # off the TPU tiling (W % 8, C % 128)
        ((2, 8, 12, 64), 4, 1, torch.float32, False),
        ((2, 8, 12, 64), 4, 2, torch.float32, False),
        ((1, 12, 20, 96), 4, 1, torch.float32, False),
        ((1, 12, 20, 96), 4, 2, torch.float32, False),
    ]
    timings = {}
    worst = 0.0
    for shape, d, s2, dtype, timed in cases:
        a = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        b = torch.randn(shape, generator=gen, device="cuda").to(dtype)

        def kernel():
            return correlation_kernel.correlation_cuda(a, b, d, s2)

        def plain():
            # the same bf16-rounded values, promoted to f32 inside
            return _correlation_oracle(a, b, 1, d, 1, s2, d)

        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        log(f"phase 1: correlation {tuple(shape)} d={d} s2={s2} "
            f"{str(dtype).split('.')[-1]}: max_abs_err {err:.3e} "
            f"(rtol {KERNEL_RTOL}, atol {KERNEL_ATOL})")
        if not ok or not torch.isfinite(got).all():
            raise AssertionError(
                f"correlation kernel disagrees with its plain version at "
                f"{shape} d={d} s2={s2} {dtype}: max abs err {err}")
        worst = max(worst, err)
        if timed:
            # in turns, so clocks and neighbours hit both alike
            k_ms, p_ms = [], []
            for _ in range(2):
                p_ms += cuda_time_ms(plain, 12)
                k_ms += cuda_time_ms(kernel, 12)
            timings[str(dtype).split(".")[-1]] = (
                statistics.median(k_ms), statistics.median(p_ms))
            log(f"phase 1: median of {len(k_ms)} runs: kernel "
                f"{statistics.median(k_ms):.4f} ms (min {min(k_ms):.4f}, "
                f"max {max(k_ms):.4f}), plain "
                f"{statistics.median(p_ms):.4f} ms (min {min(p_ms):.4f}, "
                f"max {max(p_ms):.4f})")
    return worst, timings


def _jax_layout_npz(model, path):
    """Seeded random FlowNet2 weights as a JAX-layout .npz, made with
    numpy.random so that no JAX is needed; returns their tree."""
    import numpy as np

    from flownet2_tf_tpu_torch.training import warmstart

    tree = warmstart.random_jax_params(model, SEED)
    np.savez(path, **warmstart.flatten(tree))
    return tree


def phase2_main_path(tmp):
    """FlowNet2 through the port's CLI on the card, held against the same
    weights run plain on the CPU."""
    import numpy as np
    import torch

    from flownet2_tf_tpu_torch import cli
    from flownet2_tf_tpu_torch.models.registry import get_model
    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel
    from flownet2_tf_tpu_torch.training import infer
    from flownet2_tf_tpu_torch.utils import flowlib
    from flownet2_tf_tpu_torch.utils.image_io import load_image_pair

    ckpt = os.path.join(tmp, "flownet2_seed0.npz")
    tree = _jax_layout_npz(get_model("2").build("cpu"), ckpt)
    out_dir = os.path.join(tmp, "out")
    img_a = os.path.join(SAMPLES, "0img0.ppm")
    img_b = os.path.join(SAMPLES, "0img1.ppm")

    correlation_kernel.LAUNCHES = correlation_kernel.BWD_LAUNCHES = 0
    rc = cli.main(["test", "--model", "2", "--device", "cuda",
                   "--ckpt", ckpt, "--input_a", img_a, "--input_b", img_b,
                   "--out", out_dir])
    launches = correlation_kernel.LAUNCHES
    bwd = correlation_kernel.BWD_LAUNCHES
    if rc != 0:
        raise AssertionError(f"cli test returned {rc}")
    log(f"phase 2: cli test --model 2 --device cuda: {launches} correlation "
        f"kernel launch(es) in one FlowNet2 forward, {bwd} backward")
    if launches != 1 or bwd != 0:
        raise AssertionError(
            f"expected 1 correlation launch per FlowNet2 forward and no "
            f"backward, got {launches} / {bwd}")
    flow_cuda = flowlib.read_flow(os.path.join(out_dir, "0img0_flow.flo"))
    if flow_cuda.shape != (192, 256, 2) or not np.isfinite(flow_cuda).all():
        raise AssertionError(f"bad .flo: shape {flow_cuda.shape}")

    a, b = load_image_pair(img_a, img_b)
    flow_cpu = infer.infer_flow("2", tree, a, b, device="cpu")
    scale = max(1.0, float(np.abs(flow_cpu).mean()))
    epe = float(np.sqrt(((flow_cuda - flow_cpu) ** 2).sum(-1)).mean())
    err = float(np.abs(flow_cuda - flow_cpu).max())
    log(f"phase 2: CUDA vs CPU flow: mean EPE {epe:.3e} px, max abs err "
        f"{err:.3e}, mean |flow| {float(np.abs(flow_cpu).mean()):.3f} "
        f"(rtol {FLOW_RTOL}, atol {FLOW_ATOL} x {scale:.3f})")
    np.testing.assert_allclose(flow_cuda, flow_cpu, rtol=FLOW_RTOL,
                               atol=FLOW_ATOL * scale)
    torch.cuda.synchronize()
    return tree, launches


def phase3_card_numbers(tree):
    """FlowNet2 448x1024 b1, f32 exact path, TF32 off, on the card."""
    import torch

    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel
    from flownet2_tf_tpu_torch.training import infer

    model = infer.load_model("2", tree, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    inputs = {k: torch.rand((1, 448, 1024, 3), generator=gen, device="cuda")
              for k in ("input_a", "input_b")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = correlation_kernel.LAUNCHES
    # each model forward runs under models/common.py::f32_policy (no TF32)
    with torch.inference_mode():
        times = cuda_time_ms(lambda: model(inputs), runs=10, warmup=3)
        flow = model(inputs)["flow"]
    torch.cuda.synchronize()
    if flow.shape != (1, 448, 1024, 2) or not torch.isfinite(flow).all():
        raise AssertionError(f"bad 448x1024 flow {tuple(flow.shape)}")
    if correlation_kernel.LAUNCHES - before != 14:
        raise AssertionError("448x1024 forwards did not all launch the kernel")
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times)
    log(f"phase 3: FlowNet2 448x1024 b1 f32 (TF32 off): median "
        f"{med:.3f} ms/pair over {len(times)} runs (min {min(times):.3f}, "
        f"max {max(times):.3f}), {1000.0 / med:.2f} pairs/s, peak memory "
        f"{peak / 2**20:.1f} MiB")


def phase4_backward_vs_plain():
    """The correlation backward kernel against autograd of its plain
    version (what the JAX package's _bwd differentiates), on the card."""
    import torch

    from flownet2_tf_tpu_torch.ops.correlation import _correlation_oracle
    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    conv3 = (TRAIN_BATCH, TRAIN_H // 8, TRAIN_W // 8, 256)
    cases = [
        (conv3, 20, 2, torch.float32, True),
        (conv3, 20, 2, torch.bfloat16, True),
        ((2, 8, 12, 64), 4, 1, torch.float32, False),
        ((2, 8, 12, 64), 4, 2, torch.float32, False),
        ((1, 12, 20, 96), 4, 1, torch.float32, False),
        ((1, 12, 20, 96), 4, 2, torch.float32, False),
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
        rtol, atol = ((KERNEL_RTOL, KERNEL_ATOL) if dtype == torch.float32
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
        if dtype == torch.float32:
            worst = max(worst, *errs)
        if timed:
            k_ms, p_ms = [], []
            for _ in range(2):  # in turns
                p_ms += cuda_time_ms(plain, 6, warmup=1)
                k_ms += cuda_time_ms(kernel, 12)
            timings[name] = (statistics.median(k_ms), statistics.median(p_ms))
            log(f"phase 4: median of {len(k_ms)}/{len(p_ms)} runs: kernel "
                f"{statistics.median(k_ms):.4f} ms (min {min(k_ms):.4f}, "
                f"max {max(k_ms):.4f}), plain "
                f"{statistics.median(p_ms):.4f} ms (min {min(p_ms):.4f}, "
                f"max {max(p_ms):.4f})")
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


def phase5_training_path(tmp):
    """FlowNetC trained through the port's CLI on the card; resumed; then
    a FlowNetCS warm-started from it with FlowNetC frozen."""
    import numpy as np

    from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel
    from flownet2_tf_tpu_torch.training import warmstart

    c_dir = os.path.join(tmp, "flownet_c")
    common = ["--synthetic", "--synthetic_height", str(TRAIN_H),
              "--synthetic_width", str(TRAIN_W), "--batch_size",
              str(TRAIN_BATCH), "--schedule", "short", "--log_every", "1",
              "--checkpoint_every", "10", "--device", "cuda"]

    correlation_kernel.LAUNCHES = correlation_kernel.BWD_LAUNCHES = 0
    recs = _train(["--model", "c", "--log_dir", c_dir,
                   "--max_steps", str(TRAIN_STEPS), *common])
    fwd, bwd = correlation_kernel.LAUNCHES, correlation_kernel.BWD_LAUNCHES
    losses = [r["loss"] for r in recs]
    log(f"phase 5: cli train --model c, {len(recs)} steps: correlation "
        f"forward {fwd}, backward {bwd} launches; loss first 4 "
        f"{[round(x, 4) for x in losses[:4]]}, last 4 "
        f"{[round(x, 4) for x in losses[-4:]]}")
    if [r["step"] for r in recs] != list(range(1, TRAIN_STEPS + 1)):
        raise AssertionError(f"logged steps {[r['step'] for r in recs]}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss in {losses}")
    if not np.mean(losses[-4:]) < np.mean(losses[:4]):
        raise AssertionError(f"loss did not decrease: {losses}")
    if bwd != TRAIN_STEPS or fwd != TRAIN_STEPS:
        raise AssertionError(
            f"expected {TRAIN_STEPS} forward and backward correlation "
            f"launches, got {fwd} / {bwd}")

    correlation_kernel.LAUNCHES = correlation_kernel.BWD_LAUNCHES = 0
    more = _train(["--model", "c", "--log_dir", c_dir,
                   "--max_steps", str(RESUME_STEPS), *common])
    resumed = [r["step"] for r in more]
    log(f"phase 5: resumed run logged steps {resumed}, backward launches "
        f"{correlation_kernel.BWD_LAUNCHES}")
    if resumed != list(range(TRAIN_STEPS + 1, RESUME_STEPS + 1)):
        raise AssertionError(f"resume did not start at step {TRAIN_STEPS}")
    if correlation_kernel.BWD_LAUNCHES != RESUME_STEPS - TRAIN_STEPS:
        raise AssertionError("resumed steps did not launch the backward")

    cs_dir = os.path.join(tmp, "flownet_cs")
    correlation_kernel.LAUNCHES = correlation_kernel.BWD_LAUNCHES = 0
    cs = _train(["--model", "cs", "--log_dir", cs_dir, "--max_steps", "2",
                 "--warm_start", f"{c_dir}::FlowNetC", *common])
    cs_fwd, cs_bwd = (correlation_kernel.LAUNCHES,
                      correlation_kernel.BWD_LAUNCHES)
    c_tree = warmstart.flatten(warmstart.load_params_tree(c_dir))
    cs_tree = warmstart.flatten(warmstart.load_params_tree(cs_dir))
    frozen = {k: v for k, v in cs_tree.items() if k.startswith("FlowNetC/")}
    same = all(np.array_equal(v, c_tree[k[len("FlowNetC/"):]])
               for k, v in frozen.items())
    log(f"phase 5: cli train --model cs --warm_start {c_dir}::FlowNetC, "
        f"{len(cs)} steps: correlation forward {cs_fwd}, backward {cs_bwd} "
        f"launches; {len(frozen)} FlowNetC leaves bitwise equal to the C "
        f"checkpoint: {same}")
    if not all(math.isfinite(r["loss"]) for r in cs) or len(cs) != 2:
        raise AssertionError(f"bad CS run {cs}")
    if cs_bwd != 0 or cs_fwd != 2:
        raise AssertionError("a frozen FlowNetC must launch the forward "
                             "and never the backward")
    if len(frozen) != len(c_tree) or not same:
        raise AssertionError("the frozen FlowNetC moved")
    return bwd


def phase6_train_step_numbers(bwd_ms):
    """FlowNetC train step at b8 320x448 f32, TF32 off, on the card."""
    import torch

    from flownet2_tf_tpu_torch.data.loader import (
        BatchLoader,
        SyntheticFlowDataset,
    )
    from flownet2_tf_tpu_torch.training.loop import TrainConfig, Trainer

    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(TrainConfig(
            model="c", schedule="short", log_dir=tmp, device="cuda",
            tensorboard=False, checkpoint_every=0))
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

    times = cuda_time_ms(step, runs=12, warmup=3)
    metrics = {k: float(v) for k, v in step().items()}
    torch.cuda.synchronize()
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite train metrics {metrics}")
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times)
    log(f"phase 6: FlowNetC train step b{TRAIN_BATCH} {TRAIN_H}x{TRAIN_W} "
        f"f32 (TF32 off): median {med:.3f} ms over {len(times)} steps (min "
        f"{min(times):.3f}, max {max(times):.3f}), "
        f"{TRAIN_BATCH * 1000.0 / med:.2f} examples/s, peak memory "
        f"{peak / 2**20:.1f} MiB; correlation backward {bwd_ms:.4f} ms = "
        f"{100.0 * bwd_ms / med:.2f}% of the step; host synthetic batch "
        f"{host_ms:.1f} ms (BatchLoader, 4 threads)")


def main():
    import torch

    if not os.path.isdir(os.path.join(ROOT, "flownet2_tf_tpu_torch")):
        raise SystemExit("chip_smoke.py: run it from a checkout of the "
                         "repository (flownet2_tf_tpu_torch/ not found)")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    sys.path.insert(0, ROOT)

    phase0_device_and_build()
    worst, timings = phase1_kernel_vs_plain()
    with tempfile.TemporaryDirectory() as tmp:
        tree, launches = phase2_main_path(tmp)
    phase3_card_numbers(tree)
    bwd_worst, bwd_timings = phase4_backward_vs_plain()
    with tempfile.TemporaryDirectory() as tmp:
        bwd_launches = phase5_training_path(tmp)
    phase6_train_step_numbers(bwd_timings["float32"][0])

    k_ms, p_ms = timings["float32"]
    bk_ms, bp_ms = bwd_timings["float32"]
    log(json.dumps({"kernels": [{
        "name": "correlation_fwd",
        "route": "cuda",
        "source": CORR_SOURCE,
        "replaces": CORR_REPLACES,
        "launches": launches,
        "max_abs_err": worst,
        "ms": k_ms,
        "plain_ms": p_ms,
    }, {
        "name": "correlation_bwd",
        "route": "cuda",
        "source": CORR_SOURCE,
        "replaces": CORR_BWD_REPLACES,
        "launches": bwd_launches,
        "max_abs_err": bwd_worst,
        "ms": bk_ms,
        "plain_ms": bp_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
