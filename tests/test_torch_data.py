"""The torch port's dataset readers, flow files and TFRecords, held against
the JAX package's on the same tiny layouts (written into tmp_path)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_layouts as layouts  # noqa: E402

from flownet2_tf_tpu.data import loader as jloader  # noqa: E402
from flownet2_tf_tpu.data import tfrecord as jtfrecord  # noqa: E402
from flownet2_tf_tpu.tools import make_tfrecords as jmake  # noqa: E402
from flownet2_tf_tpu.utils import flowlib as jflowlib  # noqa: E402
from flownet2_tf_tpu_torch.data import loader, tfrecord  # noqa: E402
from flownet2_tf_tpu_torch.tools import make_tfrecords  # noqa: E402
from flownet2_tf_tpu_torch.utils import flowlib, png16  # noqa: E402


def _assert_items_equal(port_ds, jax_ds):
    assert len(port_ds) == len(jax_ds) > 0
    for i in range(len(jax_ds)):
        got, want = port_ds[i], jax_ds[i]
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])


# (layout writer, reader name, reader kwargs)
READER_CASES = {
    "chairs_all": (layouts.chairs, "FlyingChairsRawDataset", {}),
    "chairs_train": (lambda r: layouts.chairs(r, n=40, h=8, w=8),
                     "FlyingChairsRawDataset", {"split": "train"}),
    "chairs_validate": (lambda r: layouts.chairs(r, n=40, h=8, w=8),
                        "FlyingChairsRawDataset", {"split": "validate"}),
    "things_full_train": (layouts.things_full, "FlyingThings3DDataset", {}),
    "things_full_test": (layouts.things_full, "FlyingThings3DDataset",
                         {"split": "TEST"}),
    "things_subset_train": (layouts.things_subset, "FlyingThings3DDataset",
                            {}),
    "things_subset_val": (layouts.things_subset, "FlyingThings3DDataset",
                          {"split": "TEST"}),
    "sdhom_flo": (layouts.sdhom, "ChairsSDHomDataset", {}),
    "sdhom_pfm_test": (lambda r: layouts.sdhom(r, ext=".pfm"),
                       "ChairsSDHomDataset", {"split": "test"}),
    "sintel_clean": (layouts.sintel, "SintelDataset", {}),
    "sintel_final": (layouts.sintel, "SintelDataset", {"render_pass": "final"}),
    "kitti_colored_0": (layouts.kitti, "KittiDataset", {}),
    "kitti_image_2": (lambda r: layouts.kitti(r, img_dir="image_2"),
                      "KittiDataset", {}),
}


@pytest.mark.parametrize("case", sorted(READER_CASES))
def test_reader_items_bitwise_equal_to_jax(tmp_path, case):
    write, name, kwargs = READER_CASES[case]
    root = write(str(tmp_path / "ds"))
    _assert_items_equal(getattr(loader, name)(root, **kwargs),
                        getattr(jloader, name)(root, **kwargs))


def test_reader_shapes_and_splits(tmp_path):
    root = layouts.chairs(str(tmp_path / "chairs"), n=40, h=8, w=8)
    train = loader.FlyingChairsRawDataset(root, split="train")
    val = loader.FlyingChairsRawDataset(root, split="validate")
    every = loader.FlyingChairsRawDataset(root)
    assert set(train.ids).isdisjoint(val.ids)
    assert sorted(train.ids + val.ids) == every.ids
    assert val.ids == every.ids[::36] and len(val) == 2
    with pytest.raises(ValueError, match="split"):
        loader.FlyingChairsRawDataset(root, split="test")

    kitti = loader.KittiDataset(layouts.kitti(str(tmp_path / "kitti")))
    item = kitti[1]
    assert item["image_a"].shape == (18, 29, 3)
    assert item["flow"].shape == (18, 29, 3)  # [u, v, valid]
    valid = item["flow"][..., 2]
    assert set(np.unique(valid)) == {0.0, 1.0}
    assert not item["flow"][..., :2][valid == 0].any()
    with pytest.raises(FileNotFoundError):
        loader.SintelDataset(str(tmp_path / "kitti"))


@pytest.mark.parametrize("big_endian", [False, True])
def test_pfm_round_trip(tmp_path, rng, big_endian):
    flow = rng.randn(5, 7, 2).astype(np.float32)
    path = tmp_path / "f.pfm"
    layouts.write_pfm(flow, path, big_endian=big_endian)
    got = flowlib.read_flow(path)
    assert got.dtype == np.float32 and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, flow)
    np.testing.assert_array_equal(got, jflowlib.read_flow(path))


def test_grayscale_pfm_raises(tmp_path):
    p = tmp_path / "disp.pfm"
    with open(p, "wb") as f:
        f.write(b"Pf\n4 3\n-1.0\n")
        f.write(np.arange(12, dtype="<f4").tobytes())
    with pytest.raises(ValueError, match="not an optical flow"):
        flowlib.read_flow(p)


def test_kitti_png_round_trip(tmp_path, rng):
    flow = (rng.randn(9, 13, 2) * 20).astype(np.float32)
    valid = (rng.rand(9, 13) < 0.5).astype(np.uint16)
    mine, theirs = tmp_path / "port_10.png", tmp_path / "jax_10.png"
    flowlib.write_kitti_png_flow(flow, mine, valid=valid)
    jflowlib.write_kitti_png_flow(flow, theirs, valid=valid)
    assert mine.read_bytes() == theirs.read_bytes()
    got = flowlib.read_flow(mine)
    np.testing.assert_array_equal(got, jflowlib.read_kitti_png_flow(mine))
    # (u16 - 2^15) / 64, zeroed where invalid
    want = np.round(flow * 64.0) / 64.0 * valid[..., None]
    assert np.abs(got[..., :2] - want).max() <= 1 / 64
    np.testing.assert_array_equal(got[..., 2], valid.astype(np.float32))
    assert png16.read_png16(mine).dtype == np.uint16


def test_png16_reads_every_scanline_filter(tmp_path, rng):
    """A 16-bit PNG whose rows use filters 0-4 (written here by hand)
    decodes to the pixels, in the port and in the JAX package alike."""
    import struct
    import zlib

    from flownet2_tf_tpu.utils import png16 as jpng16

    img = rng.randint(0, 65536, (5, 4, 3)).astype(np.uint16)
    rows = [r.astype(">u2").tobytes() for r in img]
    raw = bytearray()
    for y, row in enumerate(rows):
        ftype, prev = y % 5, rows[y - 1] if y else bytes(len(row))
        raw.append(ftype)
        for i, x in enumerate(row):
            a = row[i - 6] if i >= 6 else 0  # 6 bytes per pixel
            b = prev[i]
            c = prev[i - 6] if i >= 6 else 0
            p = a + b - c
            pred = [0, a, b, (a + b) >> 1,
                    a if abs(p - a) <= min(abs(p - b), abs(p - c))
                    else (b if abs(p - b) <= abs(p - c) else c)][ftype]
            raw.append((x - pred) & 0xFF)

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    path = tmp_path / "filtered.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 5, 16, 2, 0,
                                                  0, 0))
                     + chunk(b"IDAT", zlib.compress(bytes(raw)))
                     + chunk(b"IEND", b""))
    np.testing.assert_array_equal(png16.read_png16(path), img)
    np.testing.assert_array_equal(jpng16.read_png16(path), img)


def test_tfrecords_cross_read_bitwise(tmp_path, rng):
    """Records written by either package are byte-identical, pass the
    other's CRC check, and read bitwise equal in both."""
    items = [{"image_a": rng.randint(0, 256, (6, 10, 3)).astype(np.uint8),
              "image_b": rng.rand(6, 10, 3).astype(np.float32),
              "flow": rng.randn(6, 10, 2).astype(np.float32)}
             for _ in range(3)]
    mine, theirs = tmp_path / "port.tfrecords", tmp_path / "jax.tfrecords"
    make_tfrecords.write_dataset(items, mine, log_every=0)
    jmake.write_dataset(items, theirs, log_every=0)
    assert mine.read_bytes() == theirs.read_bytes()
    assert list(jtfrecord.read_records(mine)) == list(
        tfrecord.read_records(theirs))
    for raw in (False, True):
        _assert_items_equal(
            loader.TFRecordFlowDataset(theirs, 6, 10, raw_uint8=raw),
            jloader.TFRecordFlowDataset(mine, 6, 10, use_native=False,
                                        raw_uint8=raw))
    got = loader.TFRecordFlowDataset(mine, 6, 10, raw_uint8=True)
    assert got[0]["image_a"].dtype == np.uint8
    np.testing.assert_array_equal(got[0]["image_a"], items[0]["image_a"])
    batch = got.fetch_batch([2, 0])
    assert batch["image_a"].shape == (2, 6, 10, 3)
    np.testing.assert_array_equal(batch["flow"][1], items[0]["flow"])


def test_crc32c_and_corrupt_record(tmp_path):
    data = os.urandom(1000)
    assert tfrecord.crc32c(b"123456789") == 0xE3069283  # the check value
    assert tfrecord.crc32c(data) == jtfrecord.crc32c_py(data)
    path = tmp_path / "x.tfrecords"
    tfrecord.write_records(path, [b"abc", data])
    assert list(tfrecord.read_records(path)) == [b"abc", data]
    blob = bytearray(path.read_bytes())
    blob[-10] ^= 1
    path.write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="CRC"):
        list(tfrecord.read_records(path))
    assert tfrecord._write_varint(-1) == jtfrecord._write_varint(-1)


def test_make_tfrecords_from_chairs_like_jax(tmp_path):
    root = layouts.chairs(str(tmp_path / "chairs"), n=5, h=8, w=12)
    outs = {}
    for name, module in (("port", make_tfrecords), ("jax", jmake)):
        train, val = tmp_path / f"{name}_t.rec", tmp_path / f"{name}_v.rec"
        counts = module.convert_flying_chairs(root, str(train), str(val),
                                              val_count=2, seed=1)
        assert counts == (3, 2)
        outs[name] = (train.read_bytes(), val.read_bytes())
    assert outs["port"] == outs["jax"]


def _cfg(name, **kw):
    return {"NAME": name, "BATCH_SIZE": 2, "IMAGE_HEIGHT": 8,
            "IMAGE_WIDTH": 8, "PATHS": {}, "PREPROCESS": {"crop_height": 8},
            **kw}


def test_load_batch_rules(tmp_path):
    with pytest.raises(ValueError, match="eval-only"):
        loader.load_batch(_cfg("kitti"), "train")

    chairs = layouts.chairs(str(tmp_path / "chairs"), n=40, h=8, w=8)
    tr, pre = loader.load_batch(_cfg("flying_chairs", RAW_ROOT=chairs))
    va, _ = loader.load_batch(_cfg("flying_chairs", RAW_ROOT=chairs),
                              "validate")
    assert pre == {"crop_height": 8}
    assert len(tr.dataset) == 38 and len(va.dataset) == 2
    assert tr.shuffle and not va.shuffle and tr.batch_size == 2

    things = layouts.things_full(str(tmp_path / "things"))
    va, _ = loader.load_batch(_cfg("flying_things_3d", RAW_ROOT=things),
                              "validate")
    assert all("/TEST/" in a for a, _, _ in va.dataset.pairs)
    sd = layouts.sdhom(str(tmp_path / "sdhom"))
    va, _ = loader.load_batch(_cfg("chairs_sdhom", RAW_ROOT=sd), "validate")
    assert all("/test/" in a for a, _, _ in va.dataset.pairs)
    sintel = layouts.sintel(str(tmp_path / "sintel"))
    tr, _ = loader.load_batch(_cfg("sintel", RAW_ROOT=sintel))
    assert isinstance(tr.dataset, loader.SintelDataset)
    with pytest.raises(ValueError, match="no raw-layout 'validate' split"):
        loader.load_batch(_cfg("sintel", RAW_ROOT=sintel), "validate")

    # an existing TFRecord file wins over RAW_ROOT, read as uint8
    rec = tmp_path / "train.tfrecords"
    make_tfrecords.write_dataset(loader.FlyingChairsRawDataset(chairs), rec,
                                 indices=range(4), log_every=0)
    tr, _ = loader.load_batch(_cfg("flying_chairs", RAW_ROOT=chairs,
                                   PATHS={"train": str(rec)}))
    assert isinstance(tr.dataset, loader.TFRecordFlowDataset)
    assert tr.dataset.raw_uint8 and len(tr.dataset) == 4
    batch = next(tr.batches(epochs=1))
    assert batch["image_a"].dtype == np.uint8
    assert batch["image_a"].shape == (2, 8, 8, 3)
    with pytest.raises(FileNotFoundError, match="no data for"):
        loader.load_batch(_cfg("flying_chairs",
                               RAW_ROOT=str(tmp_path / "missing"),
                               PATHS={"train": str(tmp_path / "none.rec")}))
