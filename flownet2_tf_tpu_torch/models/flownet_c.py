"""FlowNetC — siamese towers + correlation cost volume.

Port of ``flownet2_tf_tpu/models/flownet_c.py``: conv1/conv2/conv3 applied
to input_a and input_b with SHARED weights; the 441-channel cost volume
``correlation(conv3_a, conv3_b, kernel_size=1, max_displacement=20,
stride_1=1, stride_2=2, pad=20)`` followed by LeakyReLU; a 1x1x32
``conv_redir`` on conv3_a; concat ``[redir, corr]`` -> conv3_1 and the
same encoder tail + decoder as FlowNetS (the level-2 skip is tower-A
conv2).
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from flownet2_tf_tpu_torch.models import common, flownet_s
from flownet2_tf_tpu_torch.models.base import multiscale_loss
from flownet2_tf_tpu_torch.ops.correlation import correlation

NAME = "FlowNetC"

TOWER = [
    ("conv1", 7, 2, 64),
    ("conv2", 5, 2, 128),
    ("conv3", 5, 2, 256),
]

TAIL = [
    ("conv3_1", 3, 1, 256),
    ("conv4", 3, 2, 512),
    ("conv4_1", 3, 1, 512),
    ("conv5", 3, 2, 512),
    ("conv5_1", 3, 1, 512),
    ("conv6", 3, 2, 1024),
    ("conv6_1", 3, 1, 1024),
]

CORR_KWARGS = dict(
    kernel_size=1, max_displacement=20, stride_1=1, stride_2=2, pad=20
)
CORR_CHANNELS = 441
REDIR_CHANNELS = 32


class FlowNetC(nn.Module):
    def __init__(self, input_channels: int = 3):
        super().__init__()
        cin = input_channels
        for name, k, stride, cout in TOWER:
            self.add_module(name, common.Conv(k, cin, cout, stride))
            cin = cout
        self.conv_redir = common.Conv(1, 256, REDIR_CHANNELS)
        cin = REDIR_CHANNELS + CORR_CHANNELS
        for name, k, stride, cout in TAIL:
            self.add_module(name, common.Conv(k, cin, cout, stride))
            cin = cout
        enc_ch = {n: c for n, _, _, c in TOWER + TAIL}
        flownet_s.add_decoder(self, enc_ch)

    def forward(self, inputs, compute_dtype=None):
        """``compute_dtype`` as in ``FlowNetS.forward``. Under bf16 the
        towers run bf16 and the correlation takes their bf16 conv3
        features as they are (f32 sums inside, f32 cost volume out)."""
        cd = compute_dtype
        a = inputs["input_a"]
        b = inputs["input_b"]
        n, in_h, in_w, _ = a.shape
        common.check_divisible_by_64(in_h, in_w)
        with common.f32_policy(cd):
            # both towers in one batched pass (shared weights)
            x = common.conv_segments(
                self, common.nchw(torch.cat([a, b], dim=0), cd),
                ("conv1", "conv2"), ("conv2",), cd, "tower_")["conv2"]
            acts = {"conv2": x[:n]}
            acts["conv3_1"] = x = common.segment(
                self, functools.partial(self._cost_volume, n, cd), x)
            acts.update(common.conv_segments(
                self, x, [name for name, _, _, _ in TAIL[1:]],
                flownet_s.KEEP, cd))
            return flownet_s.decoder(self, acts, (in_h, in_w), cd)

    def _cost_volume(self, n, cd, x):
        """Tower conv3, the correlation, conv_redir and conv3_1: one remat
        segment, so a remat step runs the correlation forward twice."""
        with common.scope("tower_conv3"):
            x = self.conv3(x, cd)
        feat_a, feat_b = x[:n], x[n:]
        with common.scope("correlation"):
            # the kernel reads NHWC-contiguous features: one copy each
            # of NCHW (f32) features, none of channels_last (bf16) ones
            cc = correlation(common.nhwc(feat_a).contiguous(),
                             common.nhwc(feat_b).contiguous(),
                             **CORR_KWARGS)
            cc = common.leaky_relu(cc)
        with common.scope("conv_redir"):
            redir = self.conv_redir(feat_a, cd)
        x = torch.cat([redir, common.nchw(cc, cd).to(redir.dtype)], dim=1)
        with common.scope("conv3_1"):
            return self.conv3_1(x, cd)

def loss(flow_gt, predictions):
    """Multi-scale average-EPE loss (the JAX package's ``flownet_c.loss``)."""
    return multiscale_loss(flow_gt, predictions)
