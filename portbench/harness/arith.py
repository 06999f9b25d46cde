"""The yardstick's arithmetic: published peaks, the correlation's least
time, and the FLOPs of the plain reference. Frozen copies: a change to
the program cannot move them.

* ``DEVICE_PEAKS``: a copy of ``flownet2_tf_tpu_torch/tools/benchlib.py::
  DEVICE_PEAKS`` (NVIDIA's H100 SXM data sheet, dense rates, 700 W).
* :func:`corr_bound`: a copy of ``chip_smoke.py::corr_bound`` (bytes at
  the HBM rate against in-frame multiply-adds at the compute peak,
  whichever is larger), taking the peaks from ``DEVICE_PEAKS``.
* :func:`reference_flops`: ``tools/benchlib.py::count_flops``' method
  (``torch.utils.flop_counter`` on the meta device) applied to the
  benchmark's own reference (``portbench/reference``), never to the
  program's modules, plus the correlation's ``2 N H W D^2 C`` (forward)
  that the counter does not see, and twice that for its backward.
"""

from __future__ import annotations

import torch

DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "float32": 67e12,
                              "tf32": 495e12, "hbm": 3.35e12},
}

# the H100's numbers, which corr_bound's copy used as constants
_H100 = DEVICE_PEAKS["NVIDIA H100 80GB HBM3"]


def peaks_for(device_name):
    """The peak table of a card, or None for one not listed."""
    return DEVICE_PEAKS.get(device_name)


def corr_bound(shape, d, s2, dtype, backward=False, peaks=_H100):
    """(seconds, "bytes" or "operations"): the least time the card could
    take for one correlation call (forward, or the da and db backward)
    at NHWC ``shape``: bytes over the HBM rate, in-frame multiply-adds
    over the ``dtype`` peak, whichever is larger."""
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
    t_bytes, t_ops = nbytes / peaks["hbm"], flops / peaks[dtype]
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def correlation_flops(shape, d, s2):
    """2 N H W D^2 C: the full-frame multiply-adds of one forward."""
    n, h, w, c = shape
    return 2 * n * h * w * (2 * (d // s2) + 1) ** 2 * c


def _meta_params(specs, grad):
    return {name: torch.zeros(shape, device="meta", requires_grad=grad)
            for name, shape, _ in specs}


def reference_flops(model, batch, height, width, train=False, warp_res=1):
    """FLOPs of one step of the reference at this shape: the forward
    (inference), or forward, loss and backward (training)."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference import flownet as ref

    params = _meta_params(ref.param_specs(model), train)
    counter = FlopCounterMode(display=False)
    # the conv3 features the correlation runs on: 1/8 of the padded frame
    feat = (batch, height // 8, width // 8, 256)
    corr = correlation_flops(feat, ref.CORR_D, ref.CORR_S2)
    if train:
        a = torch.zeros((batch, height, width, 3), dtype=torch.uint8,
                        device="meta")
        flow = torch.zeros((batch, height, width, 2), device="meta")
        with counter:
            ref.train_loss(model, params, a, a, flow, 4e-4).backward()
        return counter.get_total_flops() + 3 * corr
    img = torch.zeros((batch, height, width, 3), device="meta")
    with counter, torch.no_grad():
        ref.infer(model, params, img, img, warp_res)
    return counter.get_total_flops() + corr
