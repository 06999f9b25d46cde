"""FlowNetS — the 'simple' encoder/decoder flow network.

Port of ``flownet2_tf_tpu/models/flownet_s.py``: 6-channel concat input;
encoder conv1 7x7/2x64 ... conv6_1 3x3x1024 with LeakyReLU(0.1) and Caffe
padding; decoder with 4x4/2 deconvs, per-level ``predict_flowN`` heads and
learned ``upsample_flowNtoM`` flow deconvs; final ``flow = predict_flow2 *
20`` resized (TF1 align_corners=False) to input resolution.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from flownet2_tf_tpu_torch.models import common
from flownet2_tf_tpu_torch.models.base import multiscale_loss
from flownet2_tf_tpu_torch.ops.resize import resize_bilinear_tf1

NAME = "FlowNetS"

# (name, kernel, stride, out_channels)
ENCODER = [
    ("conv1", 7, 2, 64),
    ("conv2", 5, 2, 128),
    ("conv3", 5, 2, 256),
    ("conv3_1", 3, 1, 256),
    ("conv4", 3, 2, 512),
    ("conv4_1", 3, 1, 512),
    ("conv5", 3, 2, 512),
    ("conv5_1", 3, 1, 512),
    ("conv6", 3, 2, 1024),
    ("conv6_1", 3, 1, 1024),
]

# decoder: level -> (deconv out-channels, concat skip source)
DECONV_CH = {5: 512, 4: 256, 3: 128, 2: 64}
SKIP = {5: "conv5_1", 4: "conv4_1", 3: "conv3_1", 2: "conv2"}


def add_decoder(net: nn.Module, enc_ch: dict):
    """Register the shared refinement decoder's layers on ``net``
    (predict_flow6..2, deconv5..2, upsample_flow6to5..3to2)."""
    prev_ch = 1024  # conv6_1
    for lvl in (6, 5, 4, 3, 2):
        net.add_module(f"predict_flow{lvl}", common.predict_flow(prev_ch))
        if lvl == 2:
            break
        down = lvl - 1
        net.add_module(f"deconv{down}", common.Deconv(prev_ch,
                                                      DECONV_CH[down]))
        net.add_module(f"upsample_flow{lvl}to{down}",
                       common.Deconv(2, 2, act=False))
        prev_ch = enc_ch[SKIP[down]] + DECONV_CH[down] + 2


def decoder(net: nn.Module, acts: dict, input_hw, compute_dtype=None,
            top: str = "conv6_1"):
    """Shared FlowNet refinement decoder (also used by FlowNetC).

    Per level L in 5..2: deconv(L), learned upsample of the previous flow,
    concat ``[skip, up_feat, up_flow]`` (trap C3), predict; each level is
    one remat segment (``common.segment``). ``acts`` are NCHW; the
    returned predictions are NHWC and f32 under either policy (the flow
    heads and upsamplers are f32 layers).
    """
    cd = compute_dtype
    preds = {}
    x = acts[top]
    with common.scope("predict_flow6"):
        flow = net.predict_flow6(x, cd)
    preds["predict_flow6"] = common.nhwc(flow)
    for lvl in (5, 4, 3, 2):
        with common.scope(f"refine{lvl}"):
            x, flow = common.segment(
                net, functools.partial(_refine, net, lvl, cd), x, flow,
                acts[SKIP[lvl]])
        preds[f"predict_flow{lvl}"] = common.nhwc(flow)
    with common.scope("upsample_out"):
        preds["flow"] = resize_bilinear_tf1(
            preds["predict_flow2"] * 20.0, input_hw[0], input_hw[1]
        )
    return preds


def _refine(net, lvl, cd, x, flow, skip):
    """Decoder level ``lvl``: (features, flow) of the level above ->
    (concat, flow) of this one; one remat segment."""
    up_feat = getattr(net, f"deconv{lvl}")(x, cd)
    up_flow = getattr(net, f"upsample_flow{lvl + 1}to{lvl}")(flow, cd)
    # the flow stays f32 in preds; only the concat copy takes the skip's
    # dtype, so the feature map is not promoted back to f32
    x = torch.cat([skip, up_feat, up_flow.to(skip.dtype)], dim=1)
    return x, getattr(net, f"predict_flow{lvl}")(x, cd)


# the encoder outputs a later layer reads: each ends a remat segment
KEEP = (*SKIP.values(), "conv6_1")


class FlowNetS(nn.Module):
    """``input_channels`` is 6 for a raw image pair, 12 behind a
    warped-input stage (FlowNetCS/CSS second stages)."""

    def __init__(self, input_channels: int = 6):
        super().__init__()
        cin = input_channels
        for name, k, stride, cout in ENCODER:
            self.add_module(name, common.Conv(k, cin, cout, stride))
            cin = cout
        add_decoder(self, {n: c for n, _, _, c in ENCODER})

    def forward(self, inputs, compute_dtype=None):
        """``inputs``: dict with 'input_a'/'input_b' (NHWC, [0,1] floats)
        or a pre-concatenated NHWC tensor; ``compute_dtype``: None or
        ``torch.float32`` (the f32 path) or ``torch.bfloat16`` (the bf16
        policy, ``models/common.py``). Returns
        {'predict_flow6'..'predict_flow2', 'flow'}, NHWC, f32."""
        if isinstance(inputs, dict):
            x = torch.cat([inputs["input_a"], inputs["input_b"]], dim=-1)
        else:
            x = inputs
        n, in_h, in_w, _ = x.shape
        common.check_divisible_by_64(in_h, in_w)
        with common.f32_policy(compute_dtype):
            acts = common.conv_segments(
                self, common.nchw(x, compute_dtype),
                [name for name, _, _, _ in ENCODER], KEEP, compute_dtype)
            return decoder(self, acts, (in_h, in_w), compute_dtype)


def loss(flow_gt, predictions):
    """Multi-scale average-EPE loss (the JAX package's ``flownet_s.loss``)."""
    return multiscale_loss(flow_gt, predictions)
