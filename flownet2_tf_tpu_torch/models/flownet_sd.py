"""FlowNetSD — the small-displacement network (all-3x3 encoder,
interconv refinement).

Port of the plain ``conv0``/``conv1`` path of
``flownet2_tf_tpu/models/flownet_sd.py``: encoder conv0 3x3x64 ..
conv6_1 3x3x1024; decoder shaped like FlowNetS with an extra unactivated
3x3 ``interconv{5..2}`` before each ``predict_flow{5..2}`` head; final
flow scaled by 20 and resized to input resolution.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from flownet2_tf_tpu_torch.models import common
from flownet2_tf_tpu_torch.models.base import multiscale_loss
from flownet2_tf_tpu_torch.ops.resize import resize_bilinear_tf1

NAME = "FlowNetSD"

ENCODER = [
    ("conv0", 3, 1, 64),
    ("conv1", 3, 2, 64),
    ("conv1_1", 3, 1, 128),
    ("conv2", 3, 2, 128),
    ("conv2_1", 3, 1, 128),
    ("conv3", 3, 2, 256),
    ("conv3_1", 3, 1, 256),
    ("conv4", 3, 2, 512),
    ("conv4_1", 3, 1, 512),
    ("conv5", 3, 2, 512),
    ("conv5_1", 3, 1, 512),
    ("conv6", 3, 2, 1024),
    ("conv6_1", 3, 1, 1024),
]

DECONV_CH = {5: 512, 4: 256, 3: 128, 2: 64}
INTERCONV_CH = {5: 512, 4: 256, 3: 128, 2: 64}
SKIP = {5: "conv5_1", 4: "conv4_1", 3: "conv3_1", 2: "conv2_1"}


class FlowNetSD(nn.Module):
    """``bf16_interconv``: the interconvs follow the bf16 compute dtype
    instead of running f32 (``models/common.py::Conv``); their flow heads
    stay f32."""

    def __init__(self, input_channels: int = 6, bf16_interconv: bool = False):
        super().__init__()
        cin = input_channels
        for name, k, stride, cout in ENCODER:
            self.add_module(name, common.Conv(k, cin, cout, stride))
            cin = cout
        enc_ch = {n: c for n, _, _, c in ENCODER}
        self.predict_flow6 = common.predict_flow(1024)
        prev_ch = 1024
        for lvl in (5, 4, 3, 2):
            self.add_module(f"deconv{lvl}",
                            common.Deconv(prev_ch, DECONV_CH[lvl]))
            self.add_module(f"upsample_flow{lvl + 1}to{lvl}",
                            common.Deconv(2, 2, act=False))
            concat_ch = enc_ch[SKIP[lvl]] + DECONV_CH[lvl] + 2
            self.add_module(f"interconv{lvl}",
                            common.Conv(3, concat_ch, INTERCONV_CH[lvl],
                                        act=False, interconv=bf16_interconv))
            self.add_module(f"predict_flow{lvl}",
                            common.predict_flow(INTERCONV_CH[lvl]))
            prev_ch = concat_ch

    def forward(self, inputs, compute_dtype=None):
        """``compute_dtype`` as in ``FlowNetS.forward``; the interconvs
        are f32 layers and take the bf16 concat in f32, unless built with
        ``bf16_interconv``."""
        cd = compute_dtype
        if isinstance(inputs, dict):
            x = torch.cat([inputs["input_a"], inputs["input_b"]], dim=-1)
        else:
            x = inputs
        n, in_h, in_w, _ = x.shape
        common.check_divisible_by_64(in_h, in_w)
        with common.f32_policy(cd):
            acts = common.conv_segments(
                self, common.nchw(x, cd), [name for name, _, _, _ in ENCODER],
                (*SKIP.values(), "conv6_1"), cd)
            x = acts["conv6_1"]
            preds = {}
            with common.scope("predict_flow6"):
                flow = self.predict_flow6(x, cd)
            preds["predict_flow6"] = common.nhwc(flow)
            for lvl in (5, 4, 3, 2):
                with common.scope(f"refine{lvl}"):
                    x, flow = common.segment(
                        self, functools.partial(self._refine, lvl, cd), x,
                        flow, acts[SKIP[lvl]])
                preds[f"predict_flow{lvl}"] = common.nhwc(flow)
            with common.scope("upsample_out"):
                preds["flow"] = resize_bilinear_tf1(
                    preds["predict_flow2"] * 20.0, in_h, in_w
                )
            return preds

    def _refine(self, lvl, cd, x, flow, skip):
        """Decoder level ``lvl`` with its interconv; one remat segment."""
        up_feat = getattr(self, f"deconv{lvl}")(x, cd)
        up_flow = getattr(self, f"upsample_flow{lvl + 1}to{lvl}")(flow, cd)
        x = torch.cat([skip, up_feat, up_flow.to(skip.dtype)], dim=1)
        inter = getattr(self, f"interconv{lvl}")(x, cd)
        return x, getattr(self, f"predict_flow{lvl}")(inter, cd)


def loss(flow_gt, predictions):
    """Multi-scale average-EPE loss (the JAX package's ``flownet_sd.loss``)."""
    return multiscale_loss(flow_gt, predictions)
