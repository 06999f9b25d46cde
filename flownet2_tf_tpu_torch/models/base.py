"""Model-zoo shared pieces: the multi-scale EPE loss and its weights.

Port of ``flownet2_tf_tpu/models/base.py``. The GT flow is scaled by
0.05 (the divide-by-20 convention) and area-downsampled to each
prediction level; the per-level average endpoint errors are combined
with weights 0.32, 0.08, 0.02, 0.01, 0.005 for predict_flow6..2 (trap
C6). L2 weight decay is added by the trainer (``training/optim.py``).
"""

from __future__ import annotations

import torch

from flownet2_tf_tpu_torch.models.common import average_endpoint_error
from flownet2_tf_tpu_torch.ops.downsample import downsample

LOSS_WEIGHTS = {
    "predict_flow6": 0.32,
    "predict_flow5": 0.08,
    "predict_flow4": 0.02,
    "predict_flow3": 0.01,
    "predict_flow2": 0.005,
}

FLOW_SCALE = 0.05  # = 1/20: network-internal flow units


def multiscale_loss(flow_gt, predictions, weights=None):
    """Weighted multi-scale average EPE against downsampled scaled GT."""
    weights = weights or LOSS_WEIGHTS
    gt = flow_gt * FLOW_SCALE
    total = torch.zeros((), dtype=torch.float32, device=flow_gt.device)
    for name, w in weights.items():
        if name not in predictions:
            continue
        pred = predictions[name]
        gt_lvl = downsample(gt, (pred.shape[1], pred.shape[2]))
        total = total + w * average_endpoint_error(gt_lvl, pred)
    return total
