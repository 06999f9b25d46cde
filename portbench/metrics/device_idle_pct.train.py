"""The share of the traced stretch in which no kernel, copy or set ran
on the card (training cells)."""


def read(summary):
    if summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
