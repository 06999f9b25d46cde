"""The correlation's share of its roofline: the least time of its calls
in the traced stretch (``harness/arith.py::corr_bound`` at the cell's
feature shape), over the device time of every kernel launched under
the ``flownet2::correlation`` op, whatever kernel implements it."""

OPS = ("flownet2::correlation",)


def read(summary):
    device_s = summary.device_s_under(OPS)
    bound = summary.get("corr_fwd_bound_s")
    calls = summary["calls"].get(OPS[0], 0)
    if not device_s or not bound or not calls:
        return None
    return 100.0 * calls * bound / device_s
