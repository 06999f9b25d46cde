#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``flownet2_tf_tpu_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA device. It
builds the port's CUDA kernels from ``flownet2_tf_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card, drives the port's main
path (FlowNet2 f32 inference through the ``test`` CLI, full published
widths, seeded random weights) on the bundled sample pair, checks that the
path launched the kernels and that its flow agrees with the plain CPU
path, and times FlowNet2 at 448x1024. Every phase raises on failure; the
exit code is then non-zero and no result line is printed.

The last two lines of stdout are one JSON object with each kernel's
numbers, then ``{"ok": true, "device": {...}}``. It exits non-zero without
a CUDA device, and outside a checkout of the repository.
"""

from __future__ import annotations

import json
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
# the CUDA and CPU FlowNet2 flows: tests/test_golden.py:96-99
FLOW_RTOL, FLOW_ATOL = 1e-3, 5e-3

CORR_SOURCE = "flownet2_tf_tpu_torch/csrc/correlation.cu"
CORR_REPLACES = "flownet2_tf_tpu/ops/pallas/correlation_kernel.py:53"


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

    correlation_kernel.LAUNCHES = 0
    rc = cli.main(["test", "--model", "2", "--device", "cuda",
                   "--ckpt", ckpt, "--input_a", img_a, "--input_b", img_b,
                   "--out", out_dir])
    launches = correlation_kernel.LAUNCHES
    if rc != 0:
        raise AssertionError(f"cli test returned {rc}")
    log(f"phase 2: cli test --model 2 --device cuda: {launches} correlation "
        "kernel launch(es) in one FlowNet2 forward")
    if launches != 1:
        raise AssertionError(
            f"expected 1 correlation launch per FlowNet2 forward, got "
            f"{launches}")
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

    k_ms, p_ms = timings["float32"]
    log(json.dumps({"kernels": [{
        "name": "correlation_fwd",
        "route": "cuda",
        "source": CORR_SOURCE,
        "replaces": CORR_REPLACES,
        "launches": launches,
        "max_abs_err": worst,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
