"""Device ms per pair of the kernels launched under the program's
``fusion`` scope (FlowNet2's fusion net)."""


def read(summary):
    device_s = summary.device_s_under(("fusion",))
    if not device_s or not summary["items"]:
        return None
    return 1e3 * device_s / summary["items"]
