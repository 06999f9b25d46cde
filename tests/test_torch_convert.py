"""``cli convert`` of the port with no TensorFlow: the TF1 V2 bundle reader
(``tools/tf1_bundle.py``), the converter and its semantic canary
(``tools/convert_tf1_checkpoint.py``) against the JAX package's
``tools/convert_tf1_checkpoint.py``, on the CPU.

Every checkpoint is written here by ``tests/_torch_tf1_writer.py``, with
several data blocks and a restart point every 16 entries. One test
fixture writes a full-width FlowNetS bundle (~155 MB, plus the ~155 MB
``.npz``); it is function-scoped and deleted when its test ends. Every
other bundle is a few KB.
"""

import json
import os
import shutil
import struct
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from flownet2_tf_tpu.models.registry import get_model as jax_model  # noqa: E402
from flownet2_tf_tpu.tools import convert_tf1_checkpoint as jconv  # noqa: E402
from flownet2_tf_tpu.training import warmstart as jwarm  # noqa: E402
from flownet2_tf_tpu_torch import cli  # noqa: E402
from flownet2_tf_tpu_torch.tools import convert_tf1_checkpoint as conv  # noqa: E402
from flownet2_tf_tpu_torch.tools import tf1_bundle as tb  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = os.path.join(REPO, "data", "samples")
sys.path.insert(0, os.path.join(REPO, "tests"))
import _torch_tf1_writer as writer  # noqa: E402


@pytest.fixture(autouse=True)
def _drop_test_files(tmp_path):
    """Tests here write bundles and ``.npz`` files: delete what each test
    wrote when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


# the format, as constants of this file: a reader and a writer that
# shared a misreading would still disagree with these
FOOTER_LEN = 48
MAGIC_LE = bytes.fromhex("57fb808b247547db")  # fixed64 0xdb4775248b80fb57
MASK_DELTA = 0xA282EAD8
CRC32C_CHECK = 0xE3069283  # CRC32C of b"123456789" (RFC 3720 B.4)
MASKED_CHECK = 0xC78AB0E5  # _masked(CRC32C_CHECK)
# the canary's numbers, the port's f32 CPU path against JAX's
CANARY_RTOL = 1e-4


def _masked(crc):
    return (((crc >> 15) | (crc << 17)) + MASK_DELTA) % 2 ** 32


def _tensors(rng):
    """Every dtype the reader takes, a 0-d int64 ``global_step``, and
    enough names for several data blocks of more than 16 entries."""
    out = {f"FlowNetS/conv{i}/weights": rng.randn(3, 3, 2, i + 1).astype(
        np.float32) for i in range(40)}
    out.update({
        "FlowNetS/f64": rng.randn(4, 5),
        "FlowNetS/i32": rng.randint(-2 ** 31, 2 ** 31 - 1, (7,), np.int32),
        "FlowNetS/i64": rng.randint(-2 ** 62, 2 ** 62, (2, 3), np.int64),
        "FlowNetS/half": rng.randn(3, 3).astype(np.float16),
        "FlowNetS/bf16": writer.BFloat16(
            rng.randint(0, 2 ** 16, (4, 4)).astype(np.uint16)),
        "FlowNetS/empty": np.zeros((0, 3), np.float32),
        "global_step": np.array(123456789012, np.int64),
        "FlowNetS/u8": np.arange(5, dtype=np.uint8),  # DT_UINT8: refused
    })
    return out


def _assert_reads_back(reader, tensors):
    for name, want in tensors.items():
        if name == "FlowNetS/u8":
            continue
        got = reader.get_tensor(name)
        if isinstance(want, writer.BFloat16):
            bits = got.view(np.uint32)
            assert got.dtype == np.float32 and got.shape == want.bits.shape
            np.testing.assert_array_equal(bits >> 16, want.bits)
            assert not (bits & 0xFFFF).any()
        else:
            assert got.dtype == want.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)


def _flip(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 0x40]))


CASES = ("round_trip", "directory", "shard_byte", "block_byte",
         "block_type_1", "sliced", "big_endian", "v1", "dtype")


@pytest.mark.parametrize("case", CASES)
def test_bundle_reads_back_and_names_each_fault(case, tmp_path):
    """Round trip of every dtype across 2 shards, bitwise; and each fault
    the reader must name: a flipped byte in a shard (that tensor's CRC)
    or in a data block (the block's CRC), a block of type 1 (snappy), a
    sliced entry, a big-endian header, a V1 checkpoint, an unsupported
    dtype on a tensor that is read."""
    tensors = _tensors(np.random.RandomState(0))
    prefix = str(tmp_path / "flownet-s.ckpt-0")
    kw = {"block_type_1": {"block_type": 1},
          "sliced": {"sliced": ("FlowNetS/conv3/weights",)},
          "big_endian": {"endianness": 1}}.get(case, {})
    writer.write_bundle(prefix, tensors, num_shards=2, block_size=1024,
                        restart_interval=16, **kw)
    if case == "round_trip":
        reader = tb.load_checkpoint(prefix)
        assert reader.num_shards == 2
        shapes = reader.get_variable_to_shape_map()
        assert shapes.keys() == tensors.keys()
        assert shapes["global_step"] == []
        assert reader._entries["FlowNetS/bf16"]["dtype"] == 14  # DT_BFLOAT16
        _assert_reads_back(reader, tensors)
        # several data blocks, each past one restart interval
        index = open(prefix + ".index", "rb").read()
        (_, pos) = tb._block_handle(index[-FOOTER_LEN:])
        top, _ = tb._block_handle(index[-FOOTER_LEN:], pos)
        handles = [tb._block_handle(v)[0] for _, v in tb._block_entries(
            tb._read_block(index, top, "index"), "index")]
        sizes = [len(list(tb._block_entries(
            tb._read_block(index, h, "index"), "index"))) for h in handles]
        assert len(handles) >= 3 and max(sizes) > 16, sizes
        assert sum(sizes) == len(tensors) + 1  # and the header
    elif case == "directory":
        (tmp_path / "checkpoint").write_text(
            'model_checkpoint_path: "flownet-s.ckpt-0"\n'
            'all_model_checkpoint_paths: "flownet-s.ckpt-0"\n')
        reader = tb.load_checkpoint(str(tmp_path))
        assert reader.prefix == prefix
        _assert_reads_back(reader, tensors)
        (tmp_path / "run").mkdir()
        with pytest.raises(FileNotFoundError, match="'checkpoint' file"):
            tb.load_checkpoint(str(tmp_path / "run"))
    elif case == "shard_byte":
        reader = tb.load_checkpoint(prefix)
        entry = reader._entries["FlowNetS/conv7/weights"]
        _flip(reader.shard_path(entry["shard_id"]), entry["offset"] + 5)
        with pytest.raises(tb.TF1CheckpointError,
                           match="conv7/weights: CRC mismatch"):
            reader.get_tensor("FlowNetS/conv7/weights")
        _assert_reads_back(reader, {k: v for k, v in tensors.items()
                                    if k != "FlowNetS/conv7/weights"})
    elif case == "block_byte":
        _flip(prefix + ".index", 20)  # inside the first data block
        with pytest.raises(tb.TF1CheckpointError,
                           match="CRC mismatch in the block at 0"):
            tb.load_checkpoint(prefix)
    elif case == "block_type_1":
        with pytest.raises(tb.TF1CheckpointError, match="no snappy"):
            tb.load_checkpoint(prefix)
    elif case == "sliced":
        reader = tb.load_checkpoint(prefix)
        with pytest.raises(tb.TF1CheckpointError,
                           match=r"sliced \(partitioned\) variable"):
            reader.get_tensor("FlowNetS/conv3/weights")
        reader.get_tensor("FlowNetS/conv4/weights")
    elif case == "big_endian":
        with pytest.raises(tb.TF1CheckpointError, match="big-endian"):
            tb.load_checkpoint(prefix)
    elif case == "v1":
        v1 = tmp_path / "model.ckpt-0"
        v1.write_bytes(b"\0" * 64)
        with pytest.raises(tb.TF1CheckpointError, match="V1 checkpoint"):
            tb.load_checkpoint(str(v1))
        with pytest.raises(FileNotFoundError, match="no such checkpoint"):
            tb.load_checkpoint(str(tmp_path / "missing.ckpt-0"))
    elif case == "dtype":
        reader = tb.load_checkpoint(prefix)
        assert reader.get_variable_to_shape_map()["FlowNetS/u8"] == [5]
        with pytest.raises(tb.TF1CheckpointError, match="unsupported dtype 4"):
            reader.get_tensor("FlowNetS/u8")
        _assert_reads_back(reader, tensors)


def test_format_constants_are_pinned(tmp_path):
    """The footer length, the magic and the masked-CRC formula as this
    file states them; a hand-encoded BundleEntryProto and header."""
    assert tb.FOOTER_LEN == FOOTER_LEN and tb.BLOCK_TRAILER_LEN == 5
    assert struct.pack("<Q", tb.TABLE_MAGIC) == MAGIC_LE
    from flownet2_tf_tpu_torch.data.tfrecord import crc32c, crc32c_py

    check = np.frombuffer(b"123456789", np.uint8).copy()
    for crc in (crc32c, crc32c_py):  # bytes, and an array read in place
        assert crc(b"123456789") == crc(check) == CRC32C_CHECK
    for crc in (0, 1, CRC32C_CHECK, 0xFFFFFFFF, 0x80000000):
        assert tb.mask_crc(crc) == _masked(crc)
    assert tb.mask_crc(CRC32C_CHECK) == MASKED_CHECK

    prefix = writer.write_bundle(tmp_path / "m.ckpt-0",
                                 {"a": np.ones(3, np.float32)})
    index = open(prefix + ".index", "rb").read()
    assert index[-8:] == MAGIC_LE
    # the footer: two BlockHandles zero-padded to 40 bytes, then the magic
    meta, pos = tb._block_handle(index[-FOOTER_LEN:])
    top, end = tb._block_handle(index[-FOOTER_LEN:], pos)
    assert index[-FOOTER_LEN + end:-8] == b"\0" * (40 - end)
    assert top[0] + top[1] + 5 == len(index) - FOOTER_LEN
    assert meta[1] == 8  # an empty block: one restart at 0, count 1
    # each block's trailer: type 0, masked CRC32C of block + type byte
    off, size = top
    assert index[off + size] == 0
    assert struct.unpack("<I", index[off + size + 1:off + size + 5])[0] == (
        _masked(crc32c(index[off:off + size + 1])))

    # BundleEntryProto {dtype: DT_FLOAT, shape {dim {size: 2} dim {size:
    # 3}}, shard_id: 1, offset: 16, size: 24, crc32c: 0x12345678}
    entry = bytes([0x08, 0x01, 0x12, 0x08, 0x12, 0x02, 0x08, 0x02, 0x12,
                   0x02, 0x08, 0x03, 0x18, 0x01, 0x20, 0x10, 0x28, 0x18,
                   0x35, 0x78, 0x56, 0x34, 0x12])
    assert tb.parse_entry(entry) == {
        "dtype": 1, "shape": (2, 3), "shard_id": 1, "offset": 16,
        "size": 24, "crc32c": 0x12345678, "sliced": False}
    assert tb.parse_entry(entry + bytes([0x3A, 0x00]))["sliced"]
    # BundleHeaderProto {num_shards: 2, endianness: BIG, version {}}
    with pytest.raises(tb.TF1CheckpointError, match="big-endian"):
        tb._parse_header(bytes([0x08, 0x02, 0x10, 0x01, 0x1A, 0x00]), "h")
    assert tb._parse_header(bytes([0x08, 0x02, 0x1A, 0x00]), "h") == 2


def test_convert_variables_matches_jax():
    """The port's ``convert_variables`` (and ``convert_tree``'s mapping)
    equals the JAX one bitwise on one random dict: conv, deconv,
    upsample_flow, fuse_deconv and fuse_upsample_flow names under every
    top scope, Adam slots, beta1_power and global_step."""
    rng = np.random.RandomState(1)
    tf_vars = {}
    layers = ("conv1", "conv3_1", "deconv5", "upsample_flow6to5",
              "fuse_deconv1", "fuse_upsample_flow2to1", "predict_flow2")
    for scope in conv._TOP_SCOPES + ("FlowNet2/FlowNetCSS/FlowNetCS",
                                     "FlowNet2/FlowNetSD", ""):
        for layer in layers:
            name = f"{scope}/{layer}" if scope else layer
            w = rng.randn(3, 4, 5, 6).astype(np.float32)
            tf_vars[f"{name}/weights"] = w
            tf_vars[f"{name}/biases"] = rng.randn(6).astype(np.float32)
            tf_vars[f"{name}/weights/Adam"] = w
            tf_vars[f"{name}/weights/Adam_1"] = w
    tf_vars.update({"beta1_power": np.float32(0.9),
                    "beta2_power": np.float32(0.999),
                    "global_step": np.int64(7)})
    want = jconv.convert_variables(tf_vars)
    got = conv.convert_variables(tf_vars)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert "FlowNetCSS/FlowNetCS/deconv5/weights" in got
    assert not any("Adam" in k or "power" in k for k in got)


def _jax_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_jax_shapes(v, key) if isinstance(v, dict)
                   else {key: tuple(v.shape)})
    return out


@pytest.mark.parametrize("model", ["s", "c", "cs", "css", "sd", "2"])
def test_expected_shapes_match_jax(model):
    """The shapes ``convert`` checks against are JAX's init tree's."""
    want = _jax_shapes(jax.eval_shape(jax_model(model).init,
                                      jax.random.PRNGKey(0)))
    got = {k: tuple(v) for k, v in conv.expected_shapes(model).items()}
    assert got == want


@pytest.fixture
def flownet_s_bundle(tmp_path):
    """A full-width FlowNetS TF1 bundle (2 shards) of the JAX package's
    ``init(PRNGKey(0))`` in TF layout, with an Adam slot and
    ``global_step``; deleted at the end."""
    root = tmp_path / "flownet_s"
    root.mkdir()
    try:
        flat = jwarm.flatten(jax.device_get(
            jax_model("s").init(jax.random.PRNGKey(0))))
        prefix = writer.write_bundle(
            root / "flownet-s.ckpt-0", writer.to_tf_layout(flat, "FlowNetS"),
            num_shards=2, restart_interval=16)
        yield prefix, flat, root
    finally:
        shutil.rmtree(root, ignore_errors=True)


def test_full_width_flownet_s_conversion(flownet_s_bundle, monkeypatch,
                                         capsys):
    """``cli convert --model s --device cpu --no_canary`` on the full-width
    bundle prints one JSON line and writes an .npz bitwise equal to JAX
    ``flatten(init)``, reading no Adam slot or ``global_step``; JAX's
    ``convert_variables`` on what the port's reader returns agrees."""
    prefix, flat, root = flownet_s_bundle
    read = []
    real = tb.CheckpointReader.get_tensor

    def spy(self, name):
        read.append(name)
        return real(self, name)

    monkeypatch.setattr(tb.CheckpointReader, "get_tensor", spy)
    out = str(root / "s.npz")
    assert cli.main(["convert", "--model", "s", "--tf_checkpoint", prefix,
                     "--out", out, "--device", "cpu", "--no_canary"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == {"converted_variables": len(flat),
                                    "out": out}
    assert len(read) == len(flat)
    assert not any("Adam" in n or "global_step" in n for n in read)
    with np.load(out) as z:
        assert sorted(z.files) == sorted(flat)
        for k, v in flat.items():
            assert z[k].dtype == v.dtype
            np.testing.assert_array_equal(z[k], v, err_msg=k)
    monkeypatch.undo()
    tf_vars = conv.read_tf_checkpoint(prefix)
    assert "global_step" in tf_vars and tf_vars["global_step"].shape == ()
    jax_flat = jconv.convert_variables(tf_vars)
    assert jax_flat.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(jax_flat[k], v, err_msg=k)


def test_canary_matches_jax(flownet_s_bundle, capsys):
    """``cli convert`` with its canary on the CPU: the converted
    FlowNetS's mean and max flow magnitude and EPE against the sample GT
    agree with JAX ``semantic_canary`` on the same .npz to rtol 1e-4;
    weights x1e4 fail both canaries."""
    prefix, flat, root = flownet_s_bundle
    out = str(root / "s.npz")
    assert cli.main(["convert", "--model", "s", "--tf_checkpoint", prefix,
                     "--out", out, "--device", "cpu",
                     "--sample_dir", SAMPLES]) == 0
    got = json.loads(capsys.readouterr().out.strip())["canary"]
    want = jconv.semantic_canary(out, "s", sample_dir=SAMPLES)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=CANARY_RTOL,
                                   err_msg=k)
    bad = str(root / "bad.npz")
    np.savez(bad, **{k: v * 1e4 for k, v in flat.items()})
    for canary in (jconv.semantic_canary, conv.semantic_canary):
        kw = {} if canary is jconv.semantic_canary else {"device": "cpu"}
        with pytest.raises(ValueError, match="semantic canary FAILED"):
            canary(bad, "s", sample_dir=SAMPLES, **kw)


def _small_bundle(path, flat_shapes, scope="FlowNetS"):
    """A bundle of zeros at the given JAX-layout shapes (each deconv in
    TF layout), a few KB when the shapes are small."""
    flat = {k: np.zeros(s, np.float32) for k, s in flat_shapes.items()}
    return writer.write_bundle(path, writer.to_tf_layout(flat, scope),
                               block_size=512)


def test_cli_convert_names_a_missing_leaf(tmp_path):
    """A checkpoint without every leaf: "conversion incomplete", with
    the JAX message, before any tensor is read."""
    shapes = conv.expected_shapes("s")
    missing = sorted(shapes)[:3]
    kept = {k: v for k, v in shapes.items()
            if k not in missing and k.endswith("/biases")}
    prefix = _small_bundle(tmp_path / "s.ckpt-0", kept)
    n_missing = len(shapes) - len(kept)
    with pytest.raises(ValueError, match=(
            rf"^conversion incomplete: {n_missing} missing leaves, e\.g\. ")):
        cli.main(["convert", "--model", "s", "--tf_checkpoint", prefix,
                  "--out", str(tmp_path / "s.npz"), "--device", "cpu"])
    assert not (tmp_path / "s.npz").exists()


def test_cli_convert_names_a_shape_mismatch(tmp_path):
    """Every leaf present at 1x1 kernel sizes: "shape mismatch at" the
    first leaf, with the JAX message."""
    shapes = conv.expected_shapes("s")
    small = {k: (v if len(v) == 1 else (1, 1) + tuple(v[2:]))
             for k, v in shapes.items()}
    prefix = _small_bundle(tmp_path / "s.ckpt-0", small)
    first = next(iter(shapes))
    assert first == "conv1/weights"
    want = (r"^shape mismatch at conv1/weights: ckpt \(1, 1, 6, 64\) vs "
            r"model \(7, 7, 6, 64\)$")
    with pytest.raises(ValueError, match=want):
        cli.main(["convert", "--model", "s", "--tf_checkpoint", prefix,
                  "--out", str(tmp_path / "s.npz"), "--device", "cpu"])


def test_cli_convert_resolves_a_directory(tmp_path, capsys):
    """``--tf_checkpoint DIR`` reads the prefix that DIR's ``checkpoint``
    file names (the newest of several), as ``tf.train.load_checkpoint``
    does; ``convert_tree`` reads the same weights."""
    shapes = conv.expected_shapes("s")
    tiny = {k: (v if len(v) == 1 else (1, 1) + tuple(v[2:]))
            for k, v in shapes.items()}
    for step in (0, 5):
        _small_bundle(tmp_path / f"flownet-s.ckpt-{step}", tiny)
    (tmp_path / "checkpoint").write_text(
        'model_checkpoint_path: "flownet-s.ckpt-5"\n'
        'all_model_checkpoint_paths: "flownet-s.ckpt-0"\n'
        'all_model_checkpoint_paths: "flownet-s.ckpt-5"\n')
    reader = tb.load_checkpoint(str(tmp_path))
    assert reader.prefix == str(tmp_path / "flownet-s.ckpt-5")
    tree = conv.convert_tree(str(tmp_path))
    assert jwarm.flatten(tree).keys() == shapes.keys()
    with pytest.raises(ValueError, match="shape mismatch at conv1/weights"):
        cli.main(["convert", "--model", "s", "--tf_checkpoint",
                  str(tmp_path), "--out", str(tmp_path / "s.npz"),
                  "--device", "cpu", "--no_canary"])


def test_cli_convert_cuda_without_a_card_raises(tmp_path):
    """``--device cuda`` (the default) without a card raises, as every
    entry point of the port does, before anything is read."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main(["convert", "--model", "s", "--tf_checkpoint",
                  str(tmp_path / "none.ckpt-0"),
                  "--out", str(tmp_path / "s.npz")])
