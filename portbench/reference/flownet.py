"""Plain PyTorch FlowNet 2.0: the benchmark's reference.

Written from the published description (Ilg et al., "FlowNet 2.0:
Evolution of Optical Flow Estimation with Deep Networks", CVPR 2017, as
released in flownet2-tf, ``src/flownet_c``, ``src/flownet_s``,
``src/flownet_sd``, ``src/flownet_cs``, ``src/flownet_css`` and
``src/flownet2``), in float32, with no custom kernel, no cache and no
layout tricks. It imports nothing of the program under test.

Conventions (those of flownet2-tf):

* a k x k conv with stride s pads (k - 1) // 2 on each side; every
  feature layer is followed by LeakyReLU(0.1); flow heads, flow
  upsamplers and interconvs are not;
* a deconv is a 4 x 4, stride 2, pad 1 transposed conv (an exact 2x
  upsample), weights in ``conv_transpose2d``'s (in, out, 4, 4) layout;
  conv weights are (out, in, k, k);
* the correlation (FlowNetC) is ``out[n, y, x, dy_i * D + dx_i] =
  mean_c a[n, c, y, x] * b[n, c, y + dy, x + dx]`` over displacements
  ``dy, dx`` in ``range(-20, 21, 2)`` with zero padding, D = 21;
* the final flow is ``predict_flow * 20`` resized with TF1's bilinear
  rule (``align_corners=False``: source ``i * in / out``, clamped);
* a warp samples ``image[y + v, x + u]`` bilinearly, coordinates clamped
  to the frame; ``warp_res`` k > 1 warps the k x k area-pooled image by
  the pooled flow in coarse pixels (less the pooled grid's (k - 1) / 2
  px offset) and resizes the result back: the half-resolution stack
  warp that FlowNet2 servers are exported with;
* the loss is the multi-scale sum of average endpoint errors against
  the ground truth times 0.05, area-pooled to each level, weights 0.32,
  0.08, 0.02, 0.01, 0.005 for levels 6..2, plus ``weight_decay * sum
  0.5 ||w||^2`` over the conv and deconv weights (biases excluded).

Parameter names are dotted scopes (``FlowNetCSS.FlowNetCS.FlowNetC.
conv1.weights``), the names flownet2-tf's variable scopes give.

``quant``, where given, is applied to both operands of every feature
layer and of the correlation: the benchmark's control computes the
reference in a lower precision with it.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

LEAK = 0.1
FLOW_SCALE = 0.05
LOSS_WEIGHTS = (("predict_flow6", 0.32), ("predict_flow5", 0.08),
                ("predict_flow4", 0.02), ("predict_flow3", 0.01),
                ("predict_flow2", 0.005))
CORR_D, CORR_S2 = 20, 2

C_TOWER = (("conv1", 7, 2, 64), ("conv2", 5, 2, 128), ("conv3", 5, 2, 256))
TAIL = (("conv4", 3, 2, 512), ("conv4_1", 3, 1, 512), ("conv5", 3, 2, 512),
        ("conv5_1", 3, 1, 512), ("conv6", 3, 2, 1024),
        ("conv6_1", 3, 1, 1024))
S_ENCODER = (("conv1", 7, 2, 64), ("conv2", 5, 2, 128), ("conv3", 5, 2, 256),
             ("conv3_1", 3, 1, 256)) + TAIL
SD_ENCODER = (("conv0", 3, 1, 64), ("conv1", 3, 2, 64), ("conv1_1", 3, 1, 128),
              ("conv2", 3, 2, 128), ("conv2_1", 3, 1, 128),
              ("conv3", 3, 2, 256), ("conv3_1", 3, 1, 256)) + TAIL
DECONV_CH = {5: 512, 4: 256, 3: 128, 2: 64}
S_SKIP = {5: "conv5_1", 4: "conv4_1", 3: "conv3_1", 2: "conv2"}
SD_SKIP = {5: "conv5_1", 4: "conv4_1", 3: "conv3_1", 2: "conv2_1"}
FUSION = (("fuse_conv0", 3, 1, 64), ("fuse_conv1", 3, 2, 64),
          ("fuse_conv1_1", 3, 1, 128), ("fuse_conv2", 3, 2, 128),
          ("fuse_conv2_1", 3, 1, 128))


# -- parameters -------------------------------------------------------------

def _conv_spec(specs, name, k, cin, cout):
    specs.append((f"{name}.weights", (cout, cin, k, k), k * k * cin))
    specs.append((f"{name}.biases", (cout,), k * k * cin))


def _deconv_spec(specs, name, cin, cout):
    specs.append((f"{name}.weights", (cin, cout, 4, 4), 16 * cin))
    specs.append((f"{name}.biases", (cout,), 16 * cin))


def _decoder_specs(specs, p, enc_ch, skip, interconv):
    prev = enc_ch["conv6_1"]
    _conv_spec(specs, p + "predict_flow6", 3, prev, 2)
    for lvl in (5, 4, 3, 2):
        _deconv_spec(specs, f"{p}deconv{lvl}", prev, DECONV_CH[lvl])
        _deconv_spec(specs, f"{p}upsample_flow{lvl + 1}to{lvl}", 2, 2)
        cat = enc_ch[skip[lvl]] + DECONV_CH[lvl] + 2
        head_in = cat
        if interconv:
            _conv_spec(specs, f"{p}interconv{lvl}", 3, cat, DECONV_CH[lvl])
            head_in = DECONV_CH[lvl]
        _conv_spec(specs, f"{p}predict_flow{lvl}", 3, head_in, 2)
        prev = cat


def _c_specs(specs, p):
    cin = 3
    for name, k, _, cout in C_TOWER:
        _conv_spec(specs, p + name, k, cin, cout)
        cin = cout
    _conv_spec(specs, p + "conv_redir", 1, 256, 32)
    _conv_spec(specs, p + "conv3_1", 3, 32 + (2 * CORR_D // CORR_S2 + 1) ** 2,
               256)
    cin = 256
    for name, k, _, cout in TAIL:
        _conv_spec(specs, p + name, k, cin, cout)
        cin = cout
    enc = {n: c for n, _, _, c in C_TOWER + (("conv3_1", 3, 1, 256),) + TAIL}
    _decoder_specs(specs, p, enc, S_SKIP, False)


def _s_specs(specs, p, cin):
    for name, k, _, cout in S_ENCODER:
        _conv_spec(specs, p + name, k, cin, cout)
        cin = cout
    _decoder_specs(specs, p, {n: c for n, _, _, c in S_ENCODER}, S_SKIP,
                   False)


def _sd_specs(specs, p):
    cin = 6
    for name, k, _, cout in SD_ENCODER:
        _conv_spec(specs, p + name, k, cin, cout)
        cin = cout
    _decoder_specs(specs, p, {n: c for n, _, _, c in SD_ENCODER}, SD_SKIP,
                   True)


def param_specs(model):
    """``[(name, shape, fan_in)]`` of every weight and bias of ``model``
    (``"flownetc"`` or ``"flownet2"``), in a fixed order."""
    specs = []
    if model == "flownetc":
        _c_specs(specs, "")
    elif model == "flownet2":
        _c_specs(specs, "FlowNetCSS.FlowNetCS.FlowNetC.")
        _s_specs(specs, "FlowNetCSS.FlowNetCS.FlowNetS.", 12)
        _s_specs(specs, "FlowNetCSS.FlowNetS.", 12)
        _sd_specs(specs, "FlowNetSD.")
        cin = 11
        for name, k, _, cout in FUSION:
            _conv_spec(specs, name, k, cin, cout)
            cin = cout
        _conv_spec(specs, "predict_flow2", 3, 128, 2)
        _deconv_spec(specs, "fuse_deconv1", 128, 32)
        _deconv_spec(specs, "fuse_upsample_flow2to1", 2, 2)
        _conv_spec(specs, "fuse_interconv1", 3, 162, 32)
        _conv_spec(specs, "predict_flow1", 3, 32, 2)
        _deconv_spec(specs, "fuse_deconv0", 162, 16)
        _deconv_spec(specs, "fuse_upsample_flow1to0", 2, 2)
        _conv_spec(specs, "fuse_interconv0", 3, 82, 16)
        _conv_spec(specs, "predict_flow0", 3, 16, 2)
    else:
        raise ValueError(f"no reference for model {model!r}")
    return specs


@contextlib.contextmanager
def exact():
    """Full float32 on the card: no TF32 in cuDNN's convs or in matmuls
    (the GPU's default would round the operands to TF32)."""
    flags = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, p in zip(flags, prev):
            f.allow_tf32 = p


# -- layers -------------------------------------------------------------------

def _same(x):
    return x


def conv(x, params, name, stride=1, act=True, quant=None):
    w, b = params[name + ".weights"], params[name + ".biases"]
    q = quant if (quant is not None and act) else _same
    y = F.conv2d(q(x), q(w), b, stride=stride, padding=(w.shape[-1] - 1) // 2)
    return F.leaky_relu(y, LEAK) if act else y


def deconv(x, params, name, act=True, quant=None):
    w, b = params[name + ".weights"], params[name + ".biases"]
    q = quant if (quant is not None and act) else _same
    y = F.conv_transpose2d(q(x), q(w), b, stride=2, padding=1)
    return F.leaky_relu(y, LEAK) if act else y


def correlation(a, b, quant=None):
    """The FlowNetC cost volume of NCHW features: (N, 441, H, W), f32,
    LeakyReLU not applied."""
    if quant is not None:
        a, b = quant(a), quant(b)
    n, c, h, w = a.shape
    bp = F.pad(b, (CORR_D,) * 4)
    planes = []
    for dy in range(-CORR_D, CORR_D + 1, CORR_S2):
        for dx in range(-CORR_D, CORR_D + 1, CORR_S2):
            shifted = bp[:, :, CORR_D + dy:CORR_D + dy + h,
                         CORR_D + dx:CORR_D + dx + w]
            planes.append((a * shifted).sum(dim=1) / c)
    return torch.stack(planes, dim=1)


def resize_tf1(x, out_h, out_w):
    """NCHW bilinear resize with TF1's ``align_corners=False`` rule."""
    n, c, h, w = x.shape
    if (h, w) == (out_h, out_w):
        return x

    def axis(size_in, size_out):
        src = torch.arange(size_out, dtype=torch.float64,
                           device=x.device) * (size_in / size_out)
        lo = torch.floor(src)
        frac = (src - lo).to(x.dtype)
        lo = lo.long()
        return lo, torch.clamp(lo + 1, max=size_in - 1), frac

    y0, y1, fy = axis(h, out_h)
    x0, x1, fx = axis(w, out_w)
    top = x.index_select(2, y0)
    bot = x.index_select(2, y1)
    fy = fy[None, None, :, None]
    rows = top + (bot - top) * fy
    left = rows.index_select(3, x0)
    right = rows.index_select(3, x1)
    return left + (right - left) * fx[None, None, None, :]


def warp(image, flow):
    """``image[y + v, x + u]`` (NCHW image, N2HW flow), bilinear, sample
    coordinates clamped to the frame (``grid_sample``'s border mode with
    corner-aligned coordinates clamps them the same way)."""
    n, _, h, w = image.shape
    xs = torch.arange(w, dtype=image.dtype, device=image.device)
    ys = torch.arange(h, dtype=image.dtype, device=image.device)
    gx = (xs[None, None, :] + flow[:, 0]) * (2.0 / (w - 1)) - 1.0
    gy = (ys[None, :, None] + flow[:, 1]) * (2.0 / (h - 1)) - 1.0
    return F.grid_sample(image, torch.stack([gx, gy], dim=-1),
                         mode="bilinear", padding_mode="border",
                         align_corners=True)


def area_pool(x, k):
    return x if k == 1 else F.avg_pool2d(x, k, k)


def stack_warp(image, flow, warp_res):
    """The warp at a stack boundary: exact at ``warp_res`` 1, else on the
    ``warp_res``-pooled grid and resized back."""
    if warp_res == 1:
        return warp(image, flow)
    k = warp_res
    h, w = image.shape[2:]
    coarse = area_pool(flow, k) / k - (k - 1) / (2.0 * k)
    return resize_tf1(warp(area_pool(image, k), coarse), h, w)


def channel_norm(x):
    return torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))


# -- nets -------------------------------------------------------------------

def _decoder(x, params, p, acts, skip, interconv, quant):
    preds = {"predict_flow6": conv(x, params, p + "predict_flow6", act=False)}
    flow = preds["predict_flow6"]
    for lvl in (5, 4, 3, 2):
        up = deconv(x, params, f"{p}deconv{lvl}", quant=quant)
        up_flow = deconv(flow, params, f"{p}upsample_flow{lvl + 1}to{lvl}",
                         act=False)
        x = torch.cat([acts[skip[lvl]], up, up_flow], dim=1)
        head = (conv(x, params, f"{p}interconv{lvl}", act=False)
                if interconv else x)
        flow = conv(head, params, f"{p}predict_flow{lvl}", act=False)
        preds[f"predict_flow{lvl}"] = flow
    return preds


def _encoder(x, params, p, layers, quant):
    acts = {}
    for name, _, stride, _ in layers:
        x = conv(x, params, p + name, stride, quant=quant)
        acts[name] = x
    return acts


def _final_flow(preds, h, w):
    return resize_tf1(preds["predict_flow2"] * 20.0, h, w)


def flownet_c(a, b, params, p="", quant=None):
    """NCHW images -> predictions (NCHW), ``flow`` at input size."""
    n, _, h, w = a.shape
    tower = _encoder(torch.cat([a, b]), params, p, C_TOWER, quant)
    f3 = tower["conv3"]
    corr = F.leaky_relu(correlation(f3[:n], f3[n:], quant), LEAK)
    redir = conv(f3[:n], params, p + "conv_redir", quant=quant)
    x = conv(torch.cat([redir, corr], dim=1), params, p + "conv3_1",
             quant=quant)
    acts = {"conv2": tower["conv2"][:n], "conv3_1": x}
    acts.update(_encoder(x, params, p, TAIL, quant))
    preds = _decoder(acts["conv6_1"], params, p, acts, S_SKIP, False, quant)
    preds["flow"] = _final_flow(preds, h, w)
    return preds


def flownet_s(x, params, p, quant=None):
    h, w = x.shape[2:]
    acts = _encoder(x, params, p, S_ENCODER, quant)
    preds = _decoder(acts["conv6_1"], params, p, acts, S_SKIP, False, quant)
    preds["flow"] = _final_flow(preds, h, w)
    return preds


def flownet_sd(x, params, p, quant=None):
    h, w = x.shape[2:]
    acts = _encoder(x, params, p, SD_ENCODER, quant)
    preds = _decoder(acts["conv6_1"], params, p, acts, SD_SKIP, True, quant)
    preds["flow"] = _final_flow(preds, h, w)
    return preds


def _next_stage(a, b, flow, params, p, warp_res, quant):
    warped = stack_warp(b, flow, warp_res)
    x = torch.cat([a, b, warped, flow * FLOW_SCALE,
                   channel_norm(a - warped)], dim=1)
    return flownet_s(x, params, p, quant)


def flownet2(a, b, params, warp_res=1, quant=None):
    """NCHW images -> the fused flow (N, 2, H, W)."""
    c = flownet_c(a, b, params, "FlowNetCSS.FlowNetCS.FlowNetC.", quant)
    cs = _next_stage(a, b, c["flow"], params,
                     "FlowNetCSS.FlowNetCS.FlowNetS.", warp_res, quant)
    css = _next_stage(a, b, cs["flow"], params, "FlowNetCSS.FlowNetS.",
                      warp_res, quant)
    sd = flownet_sd(torch.cat([a, b], dim=1), params, "FlowNetSD.", quant)
    f_css, f_sd = css["flow"], sd["flow"]
    err_css = channel_norm(a - stack_warp(b, f_css, warp_res))
    err_sd = channel_norm(a - stack_warp(b, f_sd, warp_res))
    x = torch.cat([a, f_css * FLOW_SCALE, f_sd * FLOW_SCALE,
                   channel_norm(f_css), channel_norm(f_sd), err_css, err_sd],
                  dim=1)
    acts = {}
    for name, _, stride, _ in FUSION:
        x = conv(x, params, name, stride, quant=quant)
        acts[name] = x
    flow2 = conv(acts["fuse_conv2_1"], params, "predict_flow2", act=False)
    up = deconv(acts["fuse_conv2_1"], params, "fuse_deconv1", quant=quant)
    up_flow = deconv(flow2, params, "fuse_upsample_flow2to1", act=False)
    cat1 = torch.cat([acts["fuse_conv1_1"], up, up_flow], dim=1)
    flow1 = conv(conv(cat1, params, "fuse_interconv1", act=False), params,
                 "predict_flow1", act=False)
    up = deconv(cat1, params, "fuse_deconv0", quant=quant)
    up_flow = deconv(flow1, params, "fuse_upsample_flow1to0", act=False)
    cat0 = torch.cat([acts["fuse_conv0"], up, up_flow], dim=1)
    flow0 = conv(conv(cat0, params, "fuse_interconv0", act=False), params,
                 "predict_flow0", act=False)
    return resize_tf1(flow0 * 20.0, a.shape[2], a.shape[3])


def nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def infer(model, params, image_a, image_b, warp_res=1, quant=None):
    """NHWC f32 images of any size -> NHWC flow: edge-padded to a
    multiple of 64 on the bottom and right, the flow cropped back."""
    if model != "flownet2":
        raise ValueError(f"no inference reference for {model!r}")
    h, w = image_a.shape[1:3]
    pad = (0, (-w) % 64, 0, (-h) % 64)
    a = F.pad(nchw(image_a), pad, mode="replicate")
    b = F.pad(nchw(image_b), pad, mode="replicate")
    flow = flownet2(a, b, params, warp_res, quant)
    return flow[:, :, :h, :w].permute(0, 2, 3, 1)


# -- training ---------------------------------------------------------------

def multiscale_loss(preds, flow_gt):
    """``flow_gt``: N2HW."""
    gt = flow_gt * FLOW_SCALE
    total = flow_gt.new_zeros(())
    for name, weight in LOSS_WEIGHTS:
        pred = preds[name]
        k = gt.shape[2] // pred.shape[2]
        if (gt.shape[2] != k * pred.shape[2]
                or gt.shape[3] != k * pred.shape[3]):
            raise ValueError("the reference loss takes integer pooling "
                             f"factors, got {tuple(gt.shape)} -> "
                             f"{tuple(pred.shape)}")
        level = area_pool(gt, k)
        epe = torch.sqrt(torch.sum((pred - level) ** 2, dim=1) + 1e-12)
        total = total + weight * epe.sum() / gt.shape[0]
    return total


def train_loss(model, params, images_a, images_b, flow_gt, weight_decay,
               quant=None):
    """The total loss of one batch: NHWC uint8 images (as read from
    disk, scaled by 1/255 here), NHW2 flow."""
    if model != "flownetc":
        raise ValueError(f"no training reference for {model!r}")
    scale = torch.full((), 255.0, device=images_a.device)
    a = nchw(images_a.to(torch.float32) / scale)
    b = nchw(images_b.to(torch.float32) / scale)
    preds = flownet_c(a, b, params, quant=quant)
    reg = sum(0.5 * torch.sum(v * v) for k, v in params.items()
              if k.endswith(".weights"))
    return multiscale_loss(preds, nchw(flow_gt)) + weight_decay * reg


def adam_update(params, grads, state, step, lr, beta1, beta2, eps):
    """One Adam update in place (step counts from 1)."""
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k]
            m, v = state.setdefault(k, (torch.zeros_like(p),
                                        torch.zeros_like(p)))
            m.mul_(beta1).add_(g, alpha=1 - beta1)
            v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
            m_hat = m / (1 - beta1 ** step)
            v_hat = v / (1 - beta2 ** step)
            p.sub_(lr * m_hat / (v_hat.sqrt() + eps))
