"""Stacked models: FlowNetCS, FlowNetCSS and the full FlowNet2 fusion.

Port of the plain assemblies of ``flownet2_tf_tpu/models/stacks.py``:

* FlowNetCS: FlowNetC -> full-res flow; ``warped = stack_warp(input_b,
  flow)``; ``brightness_error = channel_norm(input_a - warped)``; a
  FlowNetS second stage on the 12-channel concat
  ``[input_a, input_b, warped, flow * 0.05, brightness_error]``.
* FlowNetCSS: the same pattern once more on top of FlowNetCS.
* FlowNet2: CSS branch + SD branch on the same pair; ``input_b`` warped by
  both branch flows at once (``stack_warp_multi``); per-branch brightness
  error and flow magnitude; fusion net on the 11-channel concat
  ``[input_a, flow_css*0.05, flow_sd*0.05, mag_css, mag_sd, err_css,
  err_sd]``; ``flow = resize(predict_flow0 * 20)``.

Sub-module names are the JAX package's parameter scopes
(``FlowNetCSS.FlowNetCS.FlowNetC.conv1`` <-> ``FlowNetCSS/FlowNetCS/
FlowNetC/conv1``). The assemblies run NHWC, like the JAX package; the
nets they feed run NCHW. Under the bf16 policy (``compute_dtype``,
``models/common.py``) the warps, brightness errors, norms and magnitudes
stay f32; only the concats that feed the next net are cast to bf16.

Every stack warp runs at the model's ``warp_res``, set at construction
(``ModelSpec.build(device, warp_res=...)``): 1, the default, is the exact
full-resolution warp; 2 is the JAX package's half-res serving preset
(``ops/flow_warp.py::flow_warp_coarse``), 4 a quarter-res grid.
FlowNet2's ``fusion_res=2`` (the JAX package's ``use_fusion_res(2)``)
runs the whole fusion net on a half-resolution input assembly
(:func:`_fusion_input_halfres`) and resizes only its final flow back up;
``bf16_interconv`` lets its interconvs (and FlowNetSD's) follow the bf16
compute dtype. The S2D assemblies are TPU layout work and are not
ported.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from flownet2_tf_tpu_torch.models import common, flownet_c, flownet_s, flownet_sd
from flownet2_tf_tpu_torch.models.base import FLOW_SCALE, multiscale_loss
from flownet2_tf_tpu_torch.ops.flow_warp import (
    check_warp_res,
    pool2,
    stack_warp,
    stack_warp_multi,
)
from flownet2_tf_tpu_torch.ops.resize import resize_bilinear_tf1


def _second_stage_input(input_a, input_b, flow, compute_dtype=None,
                        warp_res=1):
    """The 12-channel NHWC stage-2 input
    ``[a, b, warped, flow * 0.05, brightness_error]``: the warp (at
    ``warp_res``) and the error in f32, the concat in the compute
    dtype."""
    warped = stack_warp(input_b, flow, warp_res=warp_res)
    brightness_error = common.channel_norm(input_a - warped)
    dt = compute_dtype or input_a.dtype
    return torch.cat(
        [t.to(dt) for t in (input_a, input_b, warped, flow * FLOW_SCALE,
                            brightness_error)],
        dim=-1,
    )


class FlowNetCS(nn.Module):
    def __init__(self, warp_res: int = 1):
        super().__init__()
        check_warp_res(warp_res)
        self.warp_res = warp_res
        self.FlowNetC = flownet_c.FlowNetC()
        self.FlowNetS = flownet_s.FlowNetS(input_channels=12)

    def forward(self, inputs, compute_dtype=None):
        cd = compute_dtype
        with common.scope("FlowNetC"):
            preds_c = self.FlowNetC(inputs, cd)
        with common.scope("FlowNetS_2"):
            with common.scope("stage2_assembly"):
                x = _second_stage_input(inputs["input_a"], inputs["input_b"],
                                        preds_c["flow"], cd, self.warp_res)
            preds = self.FlowNetS(x, cd)
        preds["flow_c"] = preds_c["flow"]
        return preds


def loss_cs(flow_gt, predictions):
    return multiscale_loss(flow_gt, predictions)


class FlowNetCSS(nn.Module):
    def __init__(self, warp_res: int = 1):
        super().__init__()
        self.warp_res = warp_res
        self.FlowNetCS = FlowNetCS(warp_res)
        self.FlowNetS = flownet_s.FlowNetS(input_channels=12)

    def forward(self, inputs, compute_dtype=None):
        cd = compute_dtype
        with common.scope("FlowNetCS"):
            preds_cs = self.FlowNetCS(inputs, cd)
        with common.scope("FlowNetS_3"):
            with common.scope("stage2_assembly"):
                x = _second_stage_input(inputs["input_a"], inputs["input_b"],
                                        preds_cs["flow"], cd, self.warp_res)
            preds = self.FlowNetS(x, cd)
        preds["flow_cs"] = preds_cs["flow"]
        return preds


def loss_css(flow_gt, predictions):
    return multiscale_loss(flow_gt, predictions)


FUSION = [
    # (name, kernel, stride, out_channels, activation)
    ("fuse_conv0", 3, 1, 64, True),
    ("fuse_conv1", 3, 2, 64, True),
    ("fuse_conv1_1", 3, 1, 128, True),
    ("fuse_conv2", 3, 2, 128, True),
    ("fuse_conv2_1", 3, 1, 128, True),
]

FUSION_IN_CHANNELS = 11  # 3 + 2 + 2 + 1 + 1 + 1 + 1


def _double_warp(input_b, flow_a, flow_b, warp_res=1):
    """Warp each sample's input_b by BOTH branch flows (one multi-flow
    warp per sample, at ``warp_res``); returns the two warped batches."""
    pairs = [
        stack_warp_multi(input_b[i:i + 1],
                         torch.cat([flow_a[i:i + 1], flow_b[i:i + 1]]),
                         warp_res=warp_res)
        for i in range(input_b.shape[0])
    ]
    return (torch.cat([p[0:1] for p in pairs]),
            torch.cat([p[1:2] for p in pairs]))


FUSION_RES = (1, 2)


def _brightness_errors(input_a, input_b, flow_css, flow_sd, warp_res):
    """``input_b`` warped by both branch flows (one double warp at
    ``warp_res``) -> each warp's brightness error against ``input_a``."""
    warped_css, warped_sd = _double_warp(input_b, flow_css, flow_sd,
                                         warp_res)
    return (common.channel_norm(input_a - warped_css),
            common.channel_norm(input_a - warped_sd))


def _fusion_input(image, flow_css, flow_sd, err_css, err_sd, dt):
    """The 11-channel NHWC fusion input ``[image, flow_css * 0.05,
    flow_sd * 0.05, |flow_css|, |flow_sd|, err_css, err_sd]`` (the order
    of trap C3), cast to ``dt``."""
    return torch.cat(
        [t.to(dt) for t in (image, flow_css * FLOW_SCALE,
                            flow_sd * FLOW_SCALE,
                            common.channel_norm(flow_css),
                            common.channel_norm(flow_sd), err_css, err_sd)],
        dim=-1,
    )


def _fusion_input_halfres(input_a, input_b, preds_css, preds_sd, dt):
    """The fusion input built at half resolution (``fusion_res=2``, the
    JAX package's ``_fusion_input_halfres``):

    * the images 2x2 area-pooled (``ops/flow_warp.py::pool2``);
    * each branch flow as ``resize(predict_flow2 * 20, h/2, w/2)``, the
      half-res form of its full-res flow, in full-res pixels;
    * one exact double warp of the pooled ``input_b`` on the half grid by
      the flows halved into half-grid pixels, whatever the model's
      ``warp_res`` is;
    * brightness errors and magnitudes on the half grid.

    The pooled images sit at full-res 2j + 0.5 while the resized flows
    sit at 2j: a fixed quarter-pixel registration offset that the JAX
    assembly keeps, and so does this one (the coarse warps' offset
    compensation, ``_coarse_flow``, does not apply here)."""
    n, h, w, _ = input_a.shape
    a_h, b_h = pool2(input_a), pool2(input_b)
    f_css, f_sd = (resize_bilinear_tf1(p["predict_flow2"] * 20.0, h // 2,
                                       w // 2) for p in (preds_css, preds_sd))
    # only the warp's displacement is halved: the concat's flows and
    # magnitudes stay in full-res pixels
    errs = _brightness_errors(a_h, b_h, f_css * 0.5, f_sd * 0.5, 1)
    return _fusion_input(a_h, f_css, f_sd, *errs, dt)


class FlowNet2(nn.Module):
    """``fusion_res``: 1 (exact) or 2 (the fusion net on a half-res input,
    :func:`_fusion_input_halfres`; ``predict_flow0`` comes out at half
    resolution). ``bf16_interconv``: the interconvs of FlowNetSD and of
    the fusion net follow the bf16 compute dtype."""

    def __init__(self, warp_res: int = 1, fusion_res: int = 1,
                 bf16_interconv: bool = False):
        super().__init__()
        if fusion_res not in FUSION_RES:
            raise ValueError(f"fusion_res must be one of {FUSION_RES}, got "
                             f"{fusion_res!r}")
        self.warp_res = warp_res
        self.fusion_res = fusion_res
        self.FlowNetCSS = FlowNetCSS(warp_res)
        self.FlowNetSD = flownet_sd.FlowNetSD(bf16_interconv=bf16_interconv)
        cin = FUSION_IN_CHANNELS
        for name, k, stride, cout, act in FUSION:
            self.add_module(name, common.Conv(k, cin, cout, stride, act))
            cin = cout
        self.predict_flow2 = common.predict_flow(128)
        self.fuse_deconv1 = common.Deconv(128, 32)
        self.fuse_upsample_flow2to1 = common.Deconv(2, 2, act=False)
        concat1_ch = 128 + 32 + 2  # fuse_conv1_1 + fuse_deconv1 + upflow
        self.fuse_interconv1 = common.Conv(3, concat1_ch, 32, act=False,
                                           interconv=bf16_interconv)
        self.predict_flow1 = common.predict_flow(32)
        self.fuse_deconv0 = common.Deconv(concat1_ch, 16)
        self.fuse_upsample_flow1to0 = common.Deconv(2, 2, act=False)
        concat0_ch = 64 + 16 + 2  # fuse_conv0 + fuse_deconv0 + upflow
        self.fuse_interconv0 = common.Conv(3, concat0_ch, 16, act=False,
                                           interconv=bf16_interconv)
        self.predict_flow0 = common.predict_flow(16)

    def forward(self, inputs, compute_dtype=None):
        cd = compute_dtype
        input_a = inputs["input_a"]
        input_b = inputs["input_b"]
        n, in_h, in_w, _ = input_a.shape
        with common.scope("FlowNetCSS"):
            preds_css = self.FlowNetCSS(inputs, cd)
        with common.scope("FlowNetSD"):
            preds_sd = self.FlowNetSD(inputs, cd)
        flow_css = preds_css["flow"]
        flow_sd = preds_sd["flow"]

        dt = cd or input_a.dtype
        if self.fusion_res == 2:
            x = _fusion_input_halfres(input_a, input_b, preds_css, preds_sd,
                                      dt)
        else:
            errs = _brightness_errors(input_a, input_b, flow_css, flow_sd,
                                      self.warp_res)
            x = _fusion_input(input_a, flow_css, flow_sd, *errs, dt)
        with common.f32_policy(cd), common.scope("fusion"):
            preds = self._fusion_head(common.nchw(x, cd), cd)
        preds["flow"] = resize_bilinear_tf1(
            preds["predict_flow0"] * 20.0, in_h, in_w
        )
        preds["flow_css"] = flow_css
        preds["flow_sd"] = flow_sd
        return preds

    def _fusion_head(self, x, cd):
        """Fusion pyramid + refinement (fuse_conv* -> predict_flow2/1/0),
        NCHW in, NHWC predictions out; remat segments as in FlowNetS."""
        acts = common.conv_segments(
            self, x, [name for name, _, _, _, _ in FUSION],
            ("fuse_conv0", "fuse_conv1_1", "fuse_conv2_1"), cd, None)
        preds = {}
        flow2 = self.predict_flow2(acts["fuse_conv2_1"], cd)
        preds["predict_flow2"] = common.nhwc(flow2)
        concat1, flow1 = common.segment(
            self, functools.partial(self._fusion_level, 1, cd),
            acts["fuse_conv2_1"], flow2, acts["fuse_conv1_1"])
        preds["predict_flow1"] = common.nhwc(flow1)
        # level 0 deconvolves level 1's concat, not its interconv
        _, flow0 = common.segment(
            self, functools.partial(self._fusion_level, 0, cd), concat1,
            flow1, acts["fuse_conv0"])
        preds["predict_flow0"] = common.nhwc(flow0)
        return preds

    def _fusion_level(self, lvl, cd, x, flow, skip):
        """Fusion level ``lvl`` (1 or 0): -> (concat, flow)."""
        up_feat = getattr(self, f"fuse_deconv{lvl}")(x, cd)
        up_flow = getattr(self, f"fuse_upsample_flow{lvl + 1}to{lvl}")(flow,
                                                                       cd)
        concat = torch.cat([skip, up_feat, up_flow.to(skip.dtype)], dim=1)
        inter = getattr(self, f"fuse_interconv{lvl}")(concat, cd)
        return concat, getattr(self, f"predict_flow{lvl}")(inter, cd)


# the fusion net's own heads (predict_flow2/1/0 at 1/4, 1/2, 1/1 of the
# input), not the FlowNetS levels
FUSION_LOSS_WEIGHTS = {
    "predict_flow2": 0.32,
    "predict_flow1": 0.08,
    "predict_flow0": 0.02,
}


def loss_flownet2(flow_gt, predictions):
    return multiscale_loss(
        flow_gt,
        {k: predictions[k] for k in FUSION_LOSS_WEIGHTS},
        weights=FUSION_LOSS_WEIGHTS,
    )
