"""The native IO runtime: host C++ for the input path, bound with ctypes."""

from flownet2_tf_tpu_torch.runtime.native import (  # noqa: F401
    NativeIO,
    get_native_io,
    native_available,
)
