"""The port's native IO runtime (``flownet2_tf_tpu_torch/runtime``) on the
CPU: the counterparts of ``tests/test_native_runtime.py``, held against
the port's pure-Python codecs and the JAX package's, and the native
``TFRecordFlowDataset`` bitwise against the pure path and the JAX
package's reader. Every test skips cleanly without ``g++``.
"""

import os
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from flownet2_tf_tpu.data import loader as jloader  # noqa: E402
from flownet2_tf_tpu.data import tfrecord as jtfrecord  # noqa: E402
from flownet2_tf_tpu_torch.data import loader, tfrecord  # noqa: E402
from flownet2_tf_tpu_torch.runtime import native as native_mod  # noqa: E402
from flownet2_tf_tpu_torch.utils import flowlib  # noqa: E402
from flownet2_tf_tpu_torch.utils.image_io import read_image  # noqa: E402

native = native_mod.get_native_io()

pytestmark = pytest.mark.skipif(
    native is None, reason="native IO library unavailable (no g++?)")


def test_the_port_builds_and_loads_its_own_library():
    """The port loads ``flownet2_tf_tpu_torch/_build/libflownet_io.so``,
    built from its own copy of the source, never the JAX package's
    ``build/libflownet_io.so``."""
    pkg = os.path.dirname(os.path.dirname(native_mod.__file__))
    assert native_mod._LIB_PATH == os.path.join(pkg, "_build",
                                                "libflownet_io.so")
    assert native_mod.SOURCE == os.path.join(pkg, "runtime", "native_io.cc")
    assert native._lib._name == native_mod._LIB_PATH
    assert os.path.getmtime(native_mod._LIB_PATH) >= os.path.getmtime(
        native_mod.SOURCE)


def test_crc32c_matches_python():
    for blob in (b"", b"a", b"123456789", b"hello world",
                 bytes(range(256)) * 7):
        want = jtfrecord.crc32c_py(blob)
        assert native.crc32c(blob) == tfrecord.crc32c_py(blob) == want
        assert tfrecord.crc32c(blob) == want  # delegates to the native one
    assert tfrecord.crc32c(b"123456789") == 0xE3069283


def test_flo_roundtrip_native_vs_python(tmp_path, rng):
    flow = rng.randn(31, 47, 2).astype(np.float32)
    p1 = tmp_path / "py.flo"
    p2 = tmp_path / "cc.flo"
    flowlib.write_flow(flow, p1)
    native.write_flo(flow, p2)
    assert p1.read_bytes() == p2.read_bytes()  # byte-identical files
    np.testing.assert_array_equal(native.read_flo(p1), flow)
    np.testing.assert_array_equal(flowlib.read_flow(p2), flow)


def test_flo_bad_magic_native(tmp_path):
    bad = tmp_path / "bad.flo"
    bad.write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError):
        native.read_flo(bad)


def test_ppm_native_vs_python(tmp_path, rng):
    img = rng.randint(0, 255, (21, 33, 3), dtype=np.uint8)
    path = tmp_path / "x.ppm"
    with open(path, "wb") as f:
        f.write(b"P6\n# a comment\n33 21\n255\n")
        f.write(img.tobytes())
    np.testing.assert_array_equal(native.read_ppm(path), img)
    np.testing.assert_array_equal(read_image(path), img)


def _write_tfrecords(tmp_path, rng, n=5, h=12, w=16):
    payloads, truth = [], []
    for _ in range(n):
        a = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        b = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        f = rng.randn(h, w, 2).astype(np.float32)
        truth.append((a, b, f))
        payloads.append(tfrecord.build_example(
            {"image_a": a.tobytes(), "image_b": b.tobytes(),
             "flow": f.tobytes()}))
    path = tmp_path / "x.tfrecords"
    tfrecord.write_records(path, payloads)
    return path, truth


def test_tfrecord_index_and_decode_batch(tmp_path, rng):
    path, truth = _write_tfrecords(tmp_path, rng)
    handle = native.tfrecord_open(path)
    try:
        assert native.tfrecord_count(handle) == 5
        batch = native.decode_batch(handle, [4, 0, 2], 12, 16, n_threads=3)
        raw = native.decode_batch(handle, [4, 0, 2], 12, 16, n_threads=3,
                                  raw_uint8=True)
        for slot, rec in enumerate((4, 0, 2)):
            a, b, f = truth[rec]
            # a true division, as the pure path's astype(float32) / 255.0
            np.testing.assert_array_equal(batch["image_a"][slot],
                                          a.astype(np.float32) / 255.0)
            np.testing.assert_array_equal(batch["image_b"][slot],
                                          b.astype(np.float32) / 255.0)
            np.testing.assert_array_equal(batch["flow"][slot], f)
            np.testing.assert_array_equal(raw["image_a"][slot], a)
            np.testing.assert_array_equal(raw["image_b"][slot], b)
    finally:
        native.tfrecord_close(handle)


def test_corrupt_payload_detected(tmp_path, rng):
    """A flipped payload byte fails the masked payload-CRC check instead
    of decoding garbage; the undamaged records still decode."""
    path, _ = _write_tfrecords(tmp_path, rng, n=3)
    raw = bytearray(path.read_bytes())
    raw[20] ^= 0xFF  # record 0's payload starts at byte 12
    bad = tmp_path / "corrupt.tfrecords"
    bad.write_bytes(bytes(raw))
    handle = native.tfrecord_open(bad)
    try:
        with pytest.raises(ValueError, match="decode_batch"):
            native.decode_batch(handle, [0], 12, 16, n_threads=1)
        batch = native.decode_batch(handle, [1, 2], 12, 16, n_threads=1)
        assert batch["flow"].shape == (2, 12, 16, 2)
    finally:
        native.tfrecord_close(handle)


def test_malformed_example_rejected(tmp_path):
    """A hostile varint length in the Example payload is rejected by the
    bounds-checked parser, not read out of bounds."""
    evil = bytes([0x0A, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0x3F])
    path = tmp_path / "evil.tfrecords"
    tfrecord.write_records(path, [evil])
    handle = native.tfrecord_open(path)
    try:
        with pytest.raises(ValueError, match="decode_batch"):
            native.decode_batch(handle, [0], 12, 16, n_threads=1)
    finally:
        native.tfrecord_close(handle)


def test_ppm_overflow_header_rejected(tmp_path):
    evil = tmp_path / "evil.ppm"
    evil.write_bytes(b"P6\n99999999999999999999 4\n255\n" + b"\x00" * 64)
    with pytest.raises(ValueError):
        native.read_ppm(evil)
    zero = tmp_path / "zero.ppm"
    zero.write_bytes(b"P6\n0 0\n255\n")
    with pytest.raises(ValueError):
        native.read_ppm(zero)


@pytest.mark.parametrize("raw_uint8", [False, True])
def test_dataset_uses_native_fast_path(tmp_path, rng, raw_uint8):
    """``TFRecordFlowDataset(use_native=True)``: the native index and
    decode, bitwise the pure path's and the JAX package's pure reader's on
    every record, through ``fetch_batch`` and ``BatchLoader``."""
    path, truth = _write_tfrecords(tmp_path, rng, n=8)
    ds = loader.TFRecordFlowDataset(path, 12, 16, raw_uint8=raw_uint8)
    py = loader.TFRecordFlowDataset(path, 12, 16, use_native=False,
                                    raw_uint8=raw_uint8)
    ref = jloader.TFRecordFlowDataset(path, 12, 16, use_native=False,
                                      raw_uint8=raw_uint8)
    assert ds.native and not py.native
    assert len(ds) == len(py) == len(ref) == 8
    idxs = [5, 1, 7, 0, 3, 2, 6, 4]
    got = ds.fetch_batch(idxs, num_workers=3)
    want = py.fetch_batch(idxs)
    for k in ("image_a", "image_b", "flow"):
        assert got[k].dtype == want[k].dtype == (
            np.uint8 if raw_uint8 and k != "flow" else np.float32)
        assert got[k].tobytes() == want[k].tobytes(), k
        for slot, i in enumerate(idxs):
            assert got[k][slot].tobytes() == ref[i][k].tobytes(), (k, i)
    np.testing.assert_array_equal(got["flow"][0], truth[5][2])

    bl = loader.BatchLoader(ds, batch_size=4, shuffle=False, num_workers=2)
    out = list(bl.batches(epochs=1))
    assert len(out) == 2 and out[0]["image_a"].shape == (4, 12, 16, 3)
    assert out[1]["flow"].tobytes() == py.fetch_batch([4, 5, 6, 7])[
        "flow"].tobytes()


def test_stale_library_falls_back(monkeypatch, tmp_path, capsys):
    """A library that lacks an entry point (AttributeError in
    ``NativeIO.__init__``) and cannot be rebuilt degrades to the pure
    path (``get_native_io()`` None, said once on stderr), not a crash of
    every TFRecord path."""
    stale = tmp_path / "libstale.so"
    src = tmp_path / "stale.c"
    src.write_text("int not_fnio(void) { return 1; }\n")
    subprocess.run(["gcc", "-shared", "-fPIC", "-o", str(stale), str(src)],
                   check=True, capture_output=True)

    monkeypatch.setattr(native_mod, "_LIB_PATH", str(stale))
    monkeypatch.setattr(native_mod, "_native", None)
    monkeypatch.setattr(native_mod, "_native_failed", False)
    monkeypatch.setattr(native_mod, "build_library", lambda: False)
    assert native_mod.get_native_io() is None
    assert native_mod.native_available() is False
    assert capsys.readouterr().err.count("native IO runtime unavailable") == 1
    # the codec and the reader still work, on the pure-Python path
    assert tfrecord.crc32c(b"hello") == tfrecord.crc32c_py(b"hello")
    path, truth = _write_tfrecords(tmp_path, np.random.RandomState(0), n=2)
    ds = loader.TFRecordFlowDataset(path, 12, 16)
    assert not ds.native
    np.testing.assert_array_equal(ds.fetch_batch([1])["flow"][0],
                                  truth[1][2])
    assert capsys.readouterr().err == ""  # said once


def test_missing_compiler_falls_back_once(monkeypatch, tmp_path, capsys):
    """Without ``g++`` nothing is built: ``get_native_io()`` is None and
    stderr says why, once."""
    monkeypatch.setattr(native_mod, "_LIB_PATH", str(tmp_path / "lib.so"))
    monkeypatch.setattr(native_mod, "_native", None)
    monkeypatch.setattr(native_mod, "_native_failed", False)
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(native_mod.shutil, "which", lambda name: None)
    assert native_mod.get_native_io() is None
    assert native_mod.get_native_io() is None
    err = capsys.readouterr().err
    assert err.count("native IO runtime unavailable (no g++") == 1
    assert not (tmp_path / "lib.so").exists()


def test_build_replaces_the_library_atomically(monkeypatch, tmp_path):
    """A build compiles to a temporary name and renames it into place:
    no temporary file is left, and a source newer than the library makes
    ``get_native_io`` build again."""
    lib = tmp_path / "lib" / "libflownet_io.so"
    monkeypatch.setattr(native_mod, "_LIB_PATH", str(lib))
    monkeypatch.setattr(native_mod, "_native", None)
    monkeypatch.setattr(native_mod, "_native_failed", False)
    assert native_mod._stale()
    got = native_mod.get_native_io()
    assert got is not None and got.crc32c(b"a") == tfrecord.crc32c_py(b"a")
    assert os.listdir(lib.parent) == ["libflownet_io.so"]
    assert not native_mod._stale()
    old = os.path.getmtime(native_mod.SOURCE) - 10
    os.utime(lib, (old, old))
    assert native_mod._stale()
