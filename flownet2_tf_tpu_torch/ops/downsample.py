"""Area-average downsampling of NHWC tensors (the multi-scale loss's GT).

Port of ``flownet2_tf_tpu/ops/downsample.py``: each output pixel is the
average of its source footprint; values are not rescaled (the models'
losses scale the GT by 0.05 first). Integer factors are an exact f x f
average pool; fractional factors use exact separable area weights, in
f32 with TF32 off (``models/common.py::f32_policy``). A plain torch op:
it runs on the GT path only, where no kernel is planned.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from flownet2_tf_tpu_torch.models.common import f32_policy


def downsample(tensor, size):
    """Resample NHWC ``tensor`` to spatial ``size=(h, w)`` by area average."""
    out_h, out_w = int(size[0]), int(size[1])
    if tensor.ndim != 4:
        raise ValueError(f"downsample expects NHWC, got {tuple(tensor.shape)}")
    n, h, w, c = tensor.shape
    if (h, w) == (out_h, out_w):
        return tensor
    x = tensor.to(torch.promote_types(tensor.dtype, torch.float32))

    if h % out_h == 0 and w % out_w == 0:
        fh, fw = h // out_h, w // out_w
        pooled = F.avg_pool2d(x.permute(0, 3, 1, 2), (fh, fw), (fh, fw))
        return pooled.permute(0, 2, 3, 1)

    wh = torch.from_numpy(_area_weights(h, out_h)).to(x.device, x.dtype)
    ww = torch.from_numpy(_area_weights(w, out_w)).to(x.device, x.dtype)
    # out[n, i, j, c] = sum_{y,x} wh[i,y] ww[j,x] in[n,y,x,c]
    with f32_policy():
        x = torch.einsum("iy,nyxc->nixc", wh, x)
        return torch.einsum("jx,nixc->nijc", ww, x)


def _area_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) matrix of exact fractional-coverage area weights."""
    scale = in_size / out_size
    weights = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        lo, hi = i * scale, (i + 1) * scale
        j0, j1 = int(np.floor(lo)), int(np.ceil(hi))
        for j in range(j0, min(j1, in_size)):
            cover = min(hi, j + 1) - max(lo, j)
            if cover > 0:
                weights[i, j] = cover
        weights[i] /= weights[i].sum()
    return weights.astype(np.float32)
