"""The frozen arithmetic against hand counts, and the trace reduction on
a hand-made timeline."""

from __future__ import annotations

import importlib.util
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import REPO
from portbench.harness import arith, trace
from portbench.reference import flownet as ref


def test_corr_bound_by_hand():
    # FlowNet2's f32 call at 448x1024: conv3 features (1, 56, 128, 256)
    rows = sum(max(0, 56 - 2 * abs(k)) for k in range(-10, 11))
    cols = sum(max(0, 128 - 2 * abs(k)) for k in range(-10, 11))
    # 21 shifts of each axis, less 2 px per step off the frame
    assert (rows, cols) == (56 * 21 - 4 * 55, 128 * 21 - 4 * 55)
    assert 256 * rows * cols == 604_008_448  # PERF.md: 0.604 G
    macs = 256 * rows * cols
    nbytes = 2 * 56 * 128 * 256 * 4 + 56 * 128 * 441 * 4
    want = max(2 * macs / 67e12, nbytes / 3.35e12)
    got, bound = arith.corr_bound((1, 56, 128, 256), 20, 2, "float32")
    assert got == pytest.approx(want, rel=1e-12)
    assert bound == "operations"
    # the bf16 call reads half the feature bytes and is bound by them
    got, bound = arith.corr_bound((1, 56, 128, 256), 20, 2, "bfloat16")
    assert bound == "bytes"
    assert got == pytest.approx(
        (2 * 56 * 128 * 256 * 2 + 56 * 128 * 441 * 4) / 3.35e12)
    back, _ = arith.corr_bound((8, 48, 96, 256), 20, 2, "bfloat16",
                               backward=True)
    fwd, _ = arith.corr_bound((8, 48, 96, 256), 20, 2, "bfloat16")
    assert back > fwd


def test_reference_flops_of_one_conv_and_of_the_correlation():
    params = {"c.weights": torch.zeros(64, 12, 7, 7, device="meta"),
              "c.biases": torch.zeros(64, device="meta")}
    x = torch.zeros(2, 12, 64, 128, device="meta")
    counter = FlopCounterMode(display=False)
    with counter:
        y = ref.conv(x, params, "c", stride=2)
    assert tuple(y.shape) == (2, 64, 32, 64)
    assert counter.get_total_flops() == 2 * 2 * 64 * 32 * 64 * 12 * 7 * 7
    assert arith.correlation_flops((1, 56, 128, 256), 20, 2) == \
        2 * 56 * 128 * 441 * 256


def test_reference_flops_of_the_cells():
    # the correlation comes once per FlowNet2 pair, three times (forward
    # and its two gradients) per FlowNetC training example
    corr = arith.correlation_flops((1, 56, 128, 256), 20, 2)
    f2 = arith.reference_flops("flownet2", 1, 448, 1024)
    assert 400e9 < f2 < 500e9 and f2 > corr
    fc = arith.reference_flops("flownetc", 1, 384, 768, train=True)
    assert 150e9 < fc < 250e9


def _reader(name):
    path = os.path.join(REPO, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_mfu_by_hand():
    s = trace.Summary(window_s=2.0, busy_s=1.5, chains={}, calls={},
                      kernels={}, gaps={}, items=60,
                      flops_per_item=464e9, peak_flops=67e12)
    assert _reader("mfu.infer")(s) == pytest.approx(
        100 * 60 * 464e9 / 2.0 / 67e12)
    assert _reader("device_idle_pct.infer")(s) == pytest.approx(25.0)
    # no peak for the card: no share
    assert _reader("mfu.train")(trace.Summary(s, peak_flops=None)) is None


class _Event:
    """A profiler event as torch's raw kineto events give it."""

    def __init__(self, at, name, start, end, corr=0, linked=0):
        self.at, self.n, self.s, self.e, self.c, self.link = (
            at, name, start, end, corr, linked)

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e

    def start_thread_id(self):
        return 1

    def correlation_id(self):
        return self.c

    def linked_correlation_id(self):
        return self.link

    def device_type(self):
        on_host = self.at in ("cpu_op", "user_annotation", "cuda_runtime")
        return "DeviceType.CPU" if on_host else "DeviceType.CUDA"

    def is_user_annotation(self):
        return self.at in ("user_annotation", "gpu_user_annotation")


class _TypedEvent(_Event):
    """The same, from a torch whose events carry their activity type."""

    def activity_type(self):
        return self.at


@pytest.mark.parametrize("event", [_Event, _TypedEvent])
def test_summarize_ties_kernels_to_their_host_ops(event):
    E = event
    events = [
        E("user_annotation", trace.WINDOW_SCOPE, 0, 1000, corr=1),
        E("user_annotation", "fusion", 100, 400, corr=2),
        E("gpu_user_annotation", "fusion", 190, 460, linked=2),
        E("cpu_op", "aten::convolution", 110, 200, corr=3),
        E("cuda_runtime", "cudaLaunchKernel", 150, 160, corr=7, linked=3),
        E("cpu_op", "flownet2::correlation", 300, 350, corr=4),
        E("cuda_runtime", "cudaLaunchKernel", 310, 320, corr=8, linked=4),
        E("cpu_op", "flownet2::correlation", 500, 550, corr=5),
        E("cuda_runtime", "cudaLaunchKernel", 510, 520, corr=9, linked=5),
        E("kernel", "conv_kernel", 200, 300, corr=7, linked=3),
        E("kernel", "corr_kernel", 350, 450, corr=8, linked=4),
        E("kernel", "corr_kernel", 600, 700, corr=9, linked=5),
        E("gpu_memcpy", "Memcpy HtoD", 900, 1100, corr=10),
    ]
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(1000e-9)
    # kernels 200-300, 350-450 and 600-700, the copy clipped to 900-1000
    assert s["busy_s"] == pytest.approx(400e-9)
    assert s.device_s_under(["fusion"]) == pytest.approx(200e-9)
    assert s.device_s_under(["flownet2::correlation"]) == \
        pytest.approx(200e-9)
    assert s.device_s_under(["aten::convolution", "fusion"]) == \
        pytest.approx(200e-9)
    assert s["calls"]["flownet2::correlation"] == 2
    assert s["kernels"]["corr_kernel"] == pytest.approx(200e-9)
    # idle 0-200, 300-350, 450-600 and 700-900, by the driving thread's
    # innermost op at each gap's start
    assert sum(s["gaps"].values()) == pytest.approx(600e-9)
    assert s["gaps"]["(between ops)"] == pytest.approx(550e-9)
    assert s["gaps"]["flownet2::correlation"] == pytest.approx(50e-9)
    assert s["unlinked"] == 1
