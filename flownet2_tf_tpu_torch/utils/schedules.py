"""Training schedules: S_long, S_fine, S_short and the piecewise LR.

Port of ``flownet2_tf_tpu/utils/schedules.py``: the same dicts (see its
notes on the weight-decay value and the relative S_fine boundaries), and
:func:`make_lr_schedule` as a plain ``step -> lr`` function with the
semantics of optax's ``piecewise_constant_schedule`` (which the JAX
package builds from the same dict): the rate is multiplied by
``rates[i+1] / rates[i]`` once ``step`` reaches boundary ``i``, so
``lr = rates[i]`` while ``step_values[i-1] <= step < step_values[i]``.
"""

from __future__ import annotations

import numpy as np

_WEIGHT_DECAY = 0.0004

LONG_SCHEDULE = {
    "name": "long",
    "step_values": [400000, 600000, 800000, 1000000],
    "learning_rates": [0.0001, 0.00005, 0.000025, 0.0000125, 0.00000625],
    "momentum": 0.9,
    "momentum2": 0.999,
    "weight_decay": _WEIGHT_DECAY,
    "max_iter": 1200000,
}

FINE_SCHEDULE = {
    "name": "fine",
    "step_values": [200000, 300000, 400000],
    "learning_rates": [0.00001, 0.000005, 0.0000025, 0.00000125],
    "momentum": 0.9,
    "momentum2": 0.999,
    "weight_decay": _WEIGHT_DECAY,
    "max_iter": 500000,
}

SHORT_SCHEDULE = {
    "name": "short",
    "step_values": [300, 400],
    "learning_rates": [0.0001, 0.00005, 0.000025],
    "momentum": 0.9,
    "momentum2": 0.999,
    "weight_decay": _WEIGHT_DECAY,
    "max_iter": 500,
}

SCHEDULES = {
    "long": LONG_SCHEDULE,
    "fine": FINE_SCHEDULE,
    "short": SHORT_SCHEDULE,
}


def get_schedule(name):
    try:
        return SCHEDULES[name]
    except KeyError:
        raise KeyError(
            f"unknown schedule {name!r}; available: {sorted(SCHEDULES)}"
        ) from None


def make_lr_schedule(schedule):
    """Schedule dict (or name) -> ``lr(step)``, piecewise constant.

    Like optax's ``piecewise_constant_schedule(rates[0], {b: r[i+1]/r[i]})``,
    evaluated in float32 as optax does: the scales multiply in, in boundary
    order, for every boundary ``b <= step``.
    """
    if isinstance(schedule, str):
        schedule = get_schedule(schedule)
    boundaries = [int(b) for b in schedule["step_values"]]
    rates = schedule["learning_rates"]
    if len(rates) != len(boundaries) + 1:
        raise ValueError("need len(learning_rates) == len(step_values) + 1")
    scales = [np.float32(rates[i + 1] / rates[i])
              for i in range(len(boundaries))]
    init = np.float32(rates[0])

    def lr(step):
        value = init
        for b, scale in zip(boundaries, scales):
            if int(step) >= b:
                value = np.float32(value * scale)
        return float(value)

    return lr
