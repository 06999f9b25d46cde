"""The whole step's share of the card's peak: the FLOPs that the
benchmark counts from its plain reference for the pairs completed in
the traced stretch, over the stretch, over the peak of the cell's
compute dtype (``harness/arith.py``). None on a card with no peak in
the table."""


def read(summary):
    if not summary.get("peak_flops") or summary["window_s"] <= 0:
        return None
    flops = summary["flops_per_item"] * summary["items"]
    return 100.0 * flops / summary["window_s"] / summary["peak_flops"]
