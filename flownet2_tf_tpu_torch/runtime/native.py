"""ctypes bindings of the native IO runtime (``libflownet_io.so``).

A port of ``flownet2_tf_tpu/runtime/native.py``: the same ``NativeIO``
interface, ``get_native_io`` and ``native_available``, over the port's
own copy of the C++ source (``runtime/native_io.cc``). The library is
built with ``g++`` into ``flownet2_tf_tpu_torch/_build/libflownet_io.so``
at first use, and again whenever the source is newer than it (as
``ops/cuda/_build.py`` decides for the CUDA kernels). The build writes a
temporary file and renames it into place, so a process that loads the
library while another builds it never sees half a file.

Without a compiler, or when the build or load fails, ``get_native_io()``
returns None and says why once on stderr; the callers then take the
pure-Python path (``data/tfrecord.py::crc32c_py``, the readers of
``data/loader.py``), which gives the same results, only slower.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

from flownet2_tf_tpu_torch.utils import procs

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "native_io.cc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LIB_PATH = os.path.join(BUILD_DIR, "libflownet_io.so")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_native = None
_native_failed = False
# wall seconds of this process's last build (None: it built nothing)
last_build_s = None


def _fall_back(reason: str) -> None:
    print(f"flownet2_tf_tpu_torch: native IO runtime unavailable "
          f"({reason}); the readers take the pure-Python path",
          file=sys.stderr, flush=True)


def _stale() -> bool:
    return (not os.path.exists(_LIB_PATH)
            or os.path.getmtime(SOURCE) > os.path.getmtime(_LIB_PATH))


def build_library() -> bool:
    """Compile ``native_io.cc`` into ``_LIB_PATH``; False (with the reason
    on stderr) if there is no ``g++`` or the build fails."""
    global last_build_s
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        _fall_back("no g++ on PATH")
        return False
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    try:
        rc, out = procs.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                            timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        _fall_back(f"{cxx} failed to run: {e}")
        return False
    if rc != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        _fall_back(f"{cxx} exited {rc}: {out.strip()}")
        return False
    os.replace(tmp, _LIB_PATH)  # atomic: loaders see the old or new file
    last_build_s = time.perf_counter() - t0
    return True


class NativeIO:
    """Thin typed wrapper over libflownet_io."""

    def __init__(self, lib):
        self._lib = lib
        lib.fnio_crc32c.restype = ctypes.c_uint32
        lib.fnio_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.fnio_tfrecord_open.restype = ctypes.c_void_p
        lib.fnio_tfrecord_open.argtypes = [ctypes.c_char_p]
        lib.fnio_tfrecord_count.restype = ctypes.c_int64
        lib.fnio_tfrecord_count.argtypes = [ctypes.c_void_p]
        lib.fnio_tfrecord_size.restype = ctypes.c_int64
        lib.fnio_tfrecord_size.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.fnio_tfrecord_read.restype = ctypes.c_int
        lib.fnio_tfrecord_read.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
        ]
        lib.fnio_tfrecord_close.argtypes = [ctypes.c_void_p]
        lib.fnio_read_flo.restype = ctypes.c_int
        lib.fnio_read_flo.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
        ]
        lib.fnio_write_flo.restype = ctypes.c_int
        lib.fnio_write_flo.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.fnio_read_ppm.restype = ctypes.c_int
        lib.fnio_read_ppm.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
        ]
        lib.fnio_decode_batch.restype = ctypes.c_int
        lib.fnio_decode_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.fnio_decode_batch_u8.restype = ctypes.c_int
        lib.fnio_decode_batch_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]

    # -- scalar helpers ------------------------------------------------------

    def crc32c(self, data) -> int:
        """CRC32C of ``data``: bytes, or a C-contiguous numpy array (its
        bytes, read in place)."""
        if isinstance(data, np.ndarray):
            if not data.flags.c_contiguous:
                raise ValueError("crc32c: the array must be C-contiguous")
            return int(self._lib.fnio_crc32c(
                data.ctypes.data_as(ctypes.c_char_p), data.nbytes))
        return int(self._lib.fnio_crc32c(data, len(data)))

    def read_flo(self, path) -> np.ndarray:
        w = ctypes.c_int32()
        h = ctypes.c_int32()
        rc = self._lib.fnio_read_flo(
            os.fsencode(path), None, ctypes.byref(w), ctypes.byref(h), 0
        )
        if rc != 0:
            raise ValueError(f"fnio_read_flo({path}) dims failed: {rc}")
        out = np.empty((h.value, w.value, 2), np.float32)
        rc = self._lib.fnio_read_flo(
            os.fsencode(path),
            out.ctypes.data_as(ctypes.c_void_p),
            ctypes.byref(w),
            ctypes.byref(h),
            out.size,
        )
        if rc != 0:
            raise ValueError(f"fnio_read_flo({path}) failed: {rc}")
        return out

    def write_flo(self, flow: np.ndarray, path) -> None:
        flow = np.ascontiguousarray(flow, np.float32)
        h, w = flow.shape[:2]
        rc = self._lib.fnio_write_flo(
            os.fsencode(path), flow.ctypes.data_as(ctypes.c_void_p), w, h
        )
        if rc != 0:
            raise ValueError(f"fnio_write_flo({path}) failed: {rc}")

    def read_ppm(self, path) -> np.ndarray:
        w = ctypes.c_int32()
        h = ctypes.c_int32()
        rc = self._lib.fnio_read_ppm(
            os.fsencode(path), None, ctypes.byref(w), ctypes.byref(h), 0
        )
        if rc != 0:
            raise ValueError(f"fnio_read_ppm({path}) dims failed: {rc}")
        out = np.empty((h.value, w.value, 3), np.uint8)
        rc = self._lib.fnio_read_ppm(
            os.fsencode(path),
            out.ctypes.data_as(ctypes.c_void_p),
            ctypes.byref(w),
            ctypes.byref(h),
            out.size,
        )
        if rc != 0:
            raise ValueError(f"fnio_read_ppm({path}) failed: {rc}")
        return out

    # -- TFRecord batch pipeline ---------------------------------------------

    def tfrecord_open(self, path):
        handle = self._lib.fnio_tfrecord_open(os.fsencode(path))
        if not handle:
            raise ValueError(f"fnio_tfrecord_open({path}) failed")
        return handle

    def tfrecord_count(self, handle) -> int:
        return int(self._lib.fnio_tfrecord_count(handle))

    def tfrecord_close(self, handle) -> None:
        self._lib.fnio_tfrecord_close(handle)

    def decode_batch(self, handle, indices, height, width, n_threads=4,
                     raw_uint8=False):
        """Decode the records ``indices`` into (n, H, W, 3) images and
        (n, H, W, 2) float32 flows over ``n_threads`` threads.
        ``raw_uint8`` keeps the images uint8 (the trainer converts them
        on the device); else they are float32 ``u8 / 255``."""
        indices = np.ascontiguousarray(indices, np.int64)
        n = len(indices)
        # more threads than cores only thrash
        n_threads = max(1, min(int(n_threads), os.cpu_count() or 1))
        img_dtype = np.uint8 if raw_uint8 else np.float32
        fn = (self._lib.fnio_decode_batch_u8 if raw_uint8
              else self._lib.fnio_decode_batch)
        image_a = np.empty((n, height, width, 3), img_dtype)
        image_b = np.empty((n, height, width, 3), img_dtype)
        flow = np.empty((n, height, width, 2), np.float32)
        rc = fn(
            handle,
            indices.ctypes.data_as(ctypes.c_void_p),
            n,
            height,
            width,
            image_a.ctypes.data_as(ctypes.c_void_p),
            image_b.ctypes.data_as(ctypes.c_void_p),
            flow.ctypes.data_as(ctypes.c_void_p),
            int(n_threads),
        )
        if rc != 0:
            reasons = {
                -2: "record index out of range",
                -3: "read failed",
                -4: "Example parse failed (missing feature?)",
                -5: f"feature byte-size mismatch for {height}x{width} "
                    "(wrong IMAGE_HEIGHT/IMAGE_WIDTH for these records?)",
            }
            raise ValueError(
                f"fnio_decode_batch failed: {rc} "
                f"({reasons.get(rc, 'unknown')})"
            )
        return {"image_a": image_a, "image_b": image_b, "flow": flow}


def get_native_io(build: bool = True):
    """The loaded library (built first if missing or older than its
    source), or None if it cannot be built or loaded."""
    global _native, _native_failed
    with _lock:
        if _native is not None:
            return _native
        if _native_failed:
            return None
        if _stale() and not (build and build_library()):
            if not build:
                _fall_back(f"{_LIB_PATH} is missing or stale")
            _native_failed = True
            return None
        try:
            _native = NativeIO(ctypes.CDLL(_LIB_PATH))
        except OSError as e:
            _fall_back(f"cannot load {_LIB_PATH}: {e}")
            _native_failed = True
            return None
        except AttributeError:
            # a library that lacks an entry point of this source: rebuild
            # once and retry. dlopen caches by inode, so the old file is
            # unlinked first or the retry would resolve to the same handle
            _native = None
            try:
                os.unlink(_LIB_PATH)
            except OSError:
                pass
            if build and build_library():
                try:
                    _native = NativeIO(ctypes.CDLL(_LIB_PATH))
                except (OSError, AttributeError):
                    _native = None
            if _native is None:
                _fall_back(f"{_LIB_PATH} lacks an entry point of "
                           f"{os.path.basename(SOURCE)}")
                _native_failed = True
                return None
        return _native


def native_available() -> bool:
    return get_native_io() is not None
