"""Device ms per step of the kernels launched under the optimizer's
``Optimizer.step#Adam.step`` scope, which ``torch.optim`` records."""

SCOPE = "Optimizer.step#Adam.step"


def read(summary):
    device_s = summary.device_s_under((SCOPE,))
    if not device_s or not summary.get("steps"):
        return None
    return 1e3 * device_s / summary["steps"]
