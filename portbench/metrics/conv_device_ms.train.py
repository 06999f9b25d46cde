"""Device ms per example of the kernels launched under the convolution
ops (forward, transposed and their backward), whatever kernels cuDNN
picks."""

OPS = ("aten::convolution", "aten::_convolution", "aten::conv2d",
       "aten::conv_transpose2d", "aten::convolution_backward")


def read(summary):
    device_s = summary.device_s_under(OPS)
    if not device_s or not summary["items"]:
        return None
    return 1e3 * device_s / summary["items"]
