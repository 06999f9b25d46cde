"""The numbers that decide ``correct``, each worked out from what the
timed path produced and what the plain reference computes again from
the same weights and inputs.

Inference: ``flow_rel_epe``, the worst over the sampled pairs of the
mean endpoint distance between the program's flow and the reference's,
over the mean length of the reference's flow vectors.

Training (the first three steps of the window's own trainer):
``loss_rel``, the worst step's relative gap of the total loss;
``grad_gap``, the worst leaf's gap of first-gradient norms; and
``update_gap``, the worst leaf's gap of the norms of the parameters'
change after three steps. A leaf's gap is ``| |p| - |r| |`` over the
larger of the reference's norm of that leaf and of the median leaf.
``update_gap`` leaves out the leaves whose reference gradient is under
a thousandth of the median leaf's: Adam moves those by round-off.
"""

from __future__ import annotations

import torch


def fp8_quant(x):
    """``x`` rounded to float8 e4m3 with a per-tensor scale (its largest
    magnitude onto e4m3's 448), back in ``x``'s dtype: the control's
    precision for a bfloat16 configuration. The gradient passes straight
    through to ``x`` (the convs' backward then runs on the rounded
    operands that the forward saved), as fp8 training keeps its
    gradients wider than its operands."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


QUANT = {"fp8": fp8_quant}


def flow_rel_epe(flow, ref_flow):
    """Per pair (NHW2 f32 tensors): (relative EPE, mean EPE in px)."""
    epe = torch.linalg.vector_norm(flow.double() - ref_flow.double(), dim=-1)
    size = torch.linalg.vector_norm(ref_flow.double(), dim=-1)
    mean_epe = epe.mean(dim=(1, 2))
    return (mean_epe / size.mean(dim=(1, 2))).tolist(), mean_epe.tolist()


def leaf_gap(prog, ref):
    """Worst-leaf gap of two ``{leaf: norm}`` dicts over ``ref``'s
    leaves."""
    ref_vals = sorted(ref.values())
    median = ref_vals[len(ref_vals) // 2]
    worst, where = 0.0, None
    for k, r in ref.items():
        p = prog.get(k)
        gap = 1.0 if p is None else abs(p - r) / max(r, median, 1e-30)
        if gap > worst:
            worst, where = gap, k
    return worst, where


def moving_leaves(grad_ref):
    """The leaves whose reference gradient norm is at least a thousandth
    of the median leaf's."""
    vals = sorted(grad_ref.values())
    median = vals[len(vals) // 2]
    return {k for k, v in grad_ref.items() if v >= 1e-3 * median}
