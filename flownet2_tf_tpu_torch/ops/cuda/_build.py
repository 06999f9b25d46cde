"""Build the package's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library ``_build/lib<name>.so`` exposing a plain ``extern "C"``
interface: no PyTorch headers, so a build takes seconds. A library is
built again when any file under ``csrc/`` is newer than it. A failed
build raises with nvcc's output; there is no fallback. nvcc runs as a
bounded child (``utils/procs.py``): its own session, a hard timeout,
its process group killed when it ends.

The target is ``sm_90a`` (Hopper). ``nvcc`` is taken from ``$CUDA_HOME``,
else ``/usr/local/cuda``, else ``PATH``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

from flownet2_tf_tpu_torch.utils import procs

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # registers, shared memory and spills of each kernel go to the log
    "-Xptxas", "-v",
)

# an nvcc run that takes longer than this (s) is killed and fails the build
NVCC_TIMEOUT_S = 600

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of flownet2_tf_tpu_torch are "
            "compiled at first use and need the CUDA toolkit"
        )
    return found


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    so = library_path(name)
    if not os.path.exists(so):
        return True
    built = os.path.getmtime(so)
    return any(
        os.path.getmtime(os.path.join(CSRC, f)) > built
        for f in os.listdir(CSRC)
    )


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` if its library is missing or stale.

    Returns the library path. The ptxas report (registers, spills) is
    kept in ``_build/lib<name>.log``.
    """
    src = os.path.join(CSRC, f"{name}.cu")
    if not os.path.isfile(src):
        raise FileNotFoundError(src)
    so = library_path(name)
    if not _stale(name):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    try:
        rc, out = procs.run(cmd, timeout=NVCC_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        rc, out = -1, f"nvcc did not finish in {NVCC_TIMEOUT_S} s"
    if rc != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed ({rc}) building {src}:\n{' '.join(cmd)}\n{out}"
        )
    with open(os.path.join(BUILD_DIR, f"lib{name}.log"), "w") as f:
        f.write(out)
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` once per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _loaded[name] = lib
        return lib


def build_log(name: str) -> str:
    with open(os.path.join(BUILD_DIR, f"lib{name}.log")) as f:
        return f.read()
