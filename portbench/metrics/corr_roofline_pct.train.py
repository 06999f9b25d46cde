"""The correlation's share of its roofline in training: the least time
of its forward and backward calls in the traced stretch
(``harness/arith.py::corr_bound`` at the cell's feature shape), over
the device time of every kernel launched under the
``flownet2::correlation`` and ``flownet2::correlation_backward`` ops."""

FWD, BWD = "flownet2::correlation", "flownet2::correlation_backward"


def read(summary):
    device_s = summary.device_s_under((FWD, BWD))
    fwd, bwd = summary["calls"].get(FWD, 0), summary["calls"].get(BWD, 0)
    if (not device_s or not fwd or not bwd
            or not summary.get("corr_fwd_bound_s")):
        return None
    least = fwd * summary["corr_fwd_bound_s"] + bwd * summary["corr_bwd_bound_s"]
    return 100.0 * least / device_s
