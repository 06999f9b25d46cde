"""What a driver gets for one run, and the helpers every driver uses."""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class Run:
    cell: object
    seed: int
    seconds: float
    trace: bool
    device: str
    # None: the program as the configuration states; "control": the
    # cell's control (limits file); a fault's name (harness/faults.py)
    variant: object = None
    t_start: float = dataclasses.field(default_factory=time.perf_counter)

    def __post_init__(self):
        self.breakdown = {}
        self._last = self.t_start

    def mark(self, step):
        """Close set-up step ``step`` (seconds since the last mark)."""
        now = time.perf_counter()
        self.breakdown[step] = self.breakdown.get(step, 0.0) + now - self._last
        self._last = now

    def setup_s(self):
        return time.perf_counter() - self.t_start

    @property
    def config(self):
        return self.cell.config

    @property
    def traffic(self):
        return self.cell.traffic


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def load_params(model, params):
    """Copy ``params`` ({dotted name: tensor}) into ``model``'s parameters
    of the same names; raises unless the names and shapes agree."""
    import torch

    own = dict(model.named_parameters())
    if set(own) != set(params):
        raise ValueError(
            f"parameter names differ: missing {sorted(set(own) - set(params))[:5]}"
            f", extra {sorted(set(params) - set(own))[:5]}")
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(params[name])
    return model


def percentile(values, q):
    """The ``q``-th percentile (0-100), linear between closest ranks;
    None of no values."""
    if not values:
        return None
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from a
    seeded generator: the n-th offer is kept with the chance ``k / n``."""

    def __init__(self, k, seed):
        import random

        self.k = k
        self.rng = random.Random(seed)
        self.items = []
        self.offered = 0

    def offer(self, item):
        self.offered += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.offered)
            if j < self.k:
                self.items[j] = item
