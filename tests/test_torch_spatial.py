"""Spatial tiling of the port (``parallel/spatial.py``, ``cli test
--spatial_tiles``, ``cli export --aot --spatial_tiles``) against the JAX
package's (``parallel/spatial.py``, ``tools/aot.py``, ``cli test``), on
the CPU: a counterpart of each test of tests/test_spatial.py, then the
serving export and the CLI.

Tolerances: tiles and stitched frames are row copies, bitwise equal to
the JAX package's; flows against the JAX package's at
tests/test_torch_models.py's full-resolution tolerance (rtol 1e-3, atol
5e-3 x the mean |flow|, at least 1); a port flow against another port
flow of the same bands at atol 1e-5 (f32 sums in another order).
"""

import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flownet2_tf_tpu import cli as jcli  # noqa: E402
from flownet2_tf_tpu.data.loader import SyntheticFlowDataset  # noqa: E402
from flownet2_tf_tpu.models.registry import get_model as jax_model  # noqa: E402
from flownet2_tf_tpu.ops import dispatch  # noqa: E402
from flownet2_tf_tpu.parallel import spatial as jspatial  # noqa: E402
from flownet2_tf_tpu.tools import aot as jaot  # noqa: E402
from flownet2_tf_tpu_torch import cli  # noqa: E402
from flownet2_tf_tpu_torch.models.registry import get_model  # noqa: E402
from flownet2_tf_tpu_torch.parallel import spatial  # noqa: E402
from flownet2_tf_tpu_torch.tools import aot  # noqa: E402
from flownet2_tf_tpu_torch.training import infer, warmstart  # noqa: E402
from flownet2_tf_tpu_torch.utils import flowlib  # noqa: E402
from flownet2_tf_tpu_torch.utils.image_io import write_image  # noqa: E402

T = torch.from_numpy


@pytest.fixture(autouse=True)
def _drop_files(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def params_s():
    """FlowNetS initialised by the JAX package (PRNGKey(0), as
    tests/test_spatial.py), as a host tree both packages read."""
    with dispatch.use_s2d(False):
        return jax.device_get(jax_model("s").init(jax.random.PRNGKey(0)))


def _item(height, width, seed, **kw):
    return SyntheticFlowDataset(size=1, height=height, width=width,
                                seed=seed, **kw)[0]


def _assert_flow_close(got, want):
    """tests/test_torch_models.py's full-resolution flow tolerance."""
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).mean()))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-3 * scale)


# ---------------------------------------------------------------------------
# Tiles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("height,n,overlap", [
    (200, 2, 32),    # tests/test_spatial.py's round trip: %64 bottom pad
    (384, 2, 64),    # real bands, halos clamped inward at both edges
    (128, 2, 64),    # windows taller than the frame: the whole frame
    (448, 2, 64),    # the card's 448x1024 case: bands of 384 at 0, 128
    (448, 2, 128),   # ... and at the default overlap: whole frames
    (436, 3, 32),    # Sintel's height, three bands
    (64, 1, 32),     # one band
    (256, 8, 32),    # eight bands over a padded frame
    (100, 4, 0),     # no halo
])
def test_extract_and_stitch_tiles_match_jax_bitwise(rng, height, n,
                                                    overlap):
    """``extract_tiles`` gives the JAX package's tiles, core, offsets and
    height, bitwise; ``stitch_tiles`` of a band output gives its frame,
    bitwise; and stitching the tiles back gives the input frame."""
    x = rng.rand(1, height, 64, 3).astype(np.float32)
    tiles, core, offsets, h = spatial.extract_tiles(T(x), n, overlap)
    jtiles, jcore, joffsets, jh = jspatial.extract_tiles(jnp.asarray(x), n,
                                                         overlap)
    assert (core, offsets, h) == (jcore, joffsets, jh)
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(jtiles))
    out = rng.rand(*tiles.shape[:3], 2).astype(np.float32)
    np.testing.assert_array_equal(
        spatial.stitch_tiles(T(out), core, offsets, h).numpy(),
        np.asarray(jspatial.stitch_tiles(jnp.asarray(out), core, offsets,
                                         h)))
    np.testing.assert_array_equal(
        spatial.stitch_tiles(tiles, core, offsets, h).numpy(), x)


def test_tile_halos_are_real_rows(rng):
    """Interior-clamped windows: every row of band i is frame row
    ``i*core - offsets[i] + r``, never an edge-replicated one inside the
    frame."""
    x = rng.rand(1, 384, 64, 3).astype(np.float32)
    tiles, core, offsets, _ = spatial.extract_tiles(T(x), 2, 64)
    assert tiles.shape == (2, core + 128, 64, 3)
    for i, off in enumerate(offsets):
        start = i * core - off
        np.testing.assert_array_equal(tiles[i].numpy(),
                                      x[0, start:start + tiles.shape[1]])


def test_overlap_validation():
    with pytest.raises(ValueError, match="multiple of 32"):
        spatial._tile_plan(256, 2, overlap=17)
    with pytest.raises(ValueError, match="multiple of 32"):
        jspatial._tile_plan(256, 2, overlap=17)


def test_width_divisibility_validation(params_s, rng):
    """W not %64 fails with the JAX package's message, naming the
    remedy, before any model is built."""
    a = rng.rand(128, 70, 3).astype(np.float32)
    with pytest.raises(ValueError, match="W % 64") as got:
        spatial.infer_flow_spatial("s", params_s, a, a, n_tiles=1,
                                   overlap=32, device="cpu")
    with pytest.raises(ValueError, match="W % 64") as want:
        jspatial.infer_flow_spatial("s", params_s, a, a, n_tiles=1,
                                    overlap=32)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Tiled inference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,height,overlap", [
    (1, 128, 32), (2, 256, 32), (8, 128, 32)])
def test_infer_flow_spatial_matches_jax(params_s, n, height, overlap):
    """The port's tiled FlowNetS flow against the JAX package's on the
    same pair and weights, at 1, 2 (real bands) and 8 bands (the JAX
    package places them on 8 CPU devices, the port runs them as one
    batch)."""
    item = _item(height, 64, seed=n, max_flow=2.0)
    got = spatial.infer_flow_spatial("s", params_s, item["image_a"],
                                     item["image_b"], n_tiles=n,
                                     overlap=overlap, device="cpu")
    want = jspatial.infer_flow_spatial("s", params_s, item["image_a"],
                                       item["image_b"], n_tiles=n,
                                       overlap=overlap)
    assert got.shape == (height, 64, 2)
    _assert_flow_close(got, np.asarray(want))


def test_single_tile_matches_full_inference(params_s):
    """n=1: the band is the whole frame, so the tiled flow is bitwise the
    untiled one (the same forward at the same shape)."""
    item = _item(128, 64, seed=1)
    full = infer.infer_flow("s", params_s, item["image_a"], item["image_b"],
                            device="cpu")
    tiled = spatial.infer_flow_spatial("s", params_s, item["image_a"],
                                       item["image_b"], n_tiles=1,
                                       overlap=32, device="cpu")
    np.testing.assert_array_equal(tiled, full)


def test_two_tiles_shape_and_band_interior(params_s):
    """Two real bands: a finite flow of the frame's shape whose band
    interior tracks untiled inference (mean |delta| < 1 px, as
    tests/test_spatial.py); the seam differs by design."""
    item = _item(256, 64, seed=2, max_flow=2.0)
    tiled = spatial.infer_flow_spatial("s", params_s, item["image_a"],
                                       item["image_b"], n_tiles=2,
                                       overlap=64, device="cpu")
    assert tiled.shape == (256, 64, 2) and np.isfinite(tiled).all()
    full = infer.infer_flow("s", params_s, item["image_a"], item["image_b"],
                            device="cpu")
    assert np.abs(tiled[32:96] - full[32:96]).mean() < 1.0


def test_large_overlap_converges_to_untiled(params_s):
    """Windows that span the whole frame (core + 2 x overlap > H) make
    the tiled flow the untiled one: each band is the frame itself, run
    as a batch of 2 (atol 1e-5: the batch may sum in another order)."""
    item = _item(128, 64, seed=3)
    full = infer.infer_flow("s", params_s, item["image_a"], item["image_b"],
                            device="cpu")
    tiled = spatial.infer_flow_spatial("s", params_s, item["image_a"],
                                       item["image_b"], n_tiles=2,
                                       overlap=64, device="cpu")
    np.testing.assert_allclose(tiled, full, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# `cli test --spatial_tiles`
# ---------------------------------------------------------------------------

def test_cli_test_spatial_tiles(tmp_path, params_s, capsys):
    """``cli test --spatial_tiles 2`` on a 200x120 pair (edge-padded to
    256x128 on the host, cropped back) writes the port library's flow
    (atol 1e-5) and the JAX package's ``cli test --spatial_tiles 2``
    flow (the models' tolerance); its flags and defaults are the JAX
    package's."""
    ckpt = tmp_path / "s.npz"
    np.savez(ckpt, **warmstart.flatten(params_s))
    rng = np.random.RandomState(4)
    paths = [tmp_path / "a.png", tmp_path / "b.png"]
    for p in paths:
        write_image(rng.randint(0, 255, (200, 120, 3), np.uint8), p)
    argv = ["test", "--model", "s", "--ckpt", str(ckpt), "--input_a",
            str(paths[0]), "--input_b", str(paths[1]), "--spatial_tiles",
            "2", "--spatial_overlap", "32"]
    assert cli.main([*argv, "--out", str(tmp_path / "t"),
                     "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["flow_shape"] == [200, 120, 2]
    got = flowlib.read_flow(tmp_path / "t" / "a_flow.flo")

    a, b = (np.pad(np.asarray(x, np.float32),
                   ((0, 56), (0, 8), (0, 0)), mode="edge")
            for x in infer.load_image_pair(*paths))
    lib = spatial.infer_flow_spatial("s", params_s, a, b, n_tiles=2,
                                     overlap=32, device="cpu")[:200, :120]
    np.testing.assert_allclose(got, lib, rtol=0, atol=1e-5)

    assert jcli.main([*argv, "--out", str(tmp_path / "j")]) == 0
    capsys.readouterr()
    _assert_flow_close(got, flowlib.read_flow(tmp_path / "j" /
                                              "a_flow.flo"))

    ours = cli.build_parser().parse_args(argv[:9])
    theirs = jcli.build_parser().parse_args(argv[:9])
    assert (ours.spatial_tiles, ours.spatial_overlap) == (
        theirs.spatial_tiles, theirs.spatial_overlap) == (0, 128)


# ---------------------------------------------------------------------------
# `cli export --aot --spatial_tiles`
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def spatial_export(tmp_path_factory, params_s):
    """FlowNetS exported by both packages at 256x64 f32, exact warps, 2
    bands at overlap 32 (real bands at rows 0 and 64), and the pair."""
    tmp = tmp_path_factory.mktemp("spatial_export")
    item = _item(256, 64, seed=5, max_flow=2.0)
    out = {"pair": item, "tmp": tmp}
    kw = dict(batch=1, compute_dtype="float32", warp_mode="full",
              spatial_tiles=2, spatial_overlap=32)
    out["meta"] = aot.export_serving("s", params_s, 256, 64,
                                     tmp / "port.flowpak", device="cpu",
                                     **kw)
    out["jmeta"] = jaot.export_serving("s", params_s, 256, 64,
                                       tmp / "jax.flowpak", **kw)
    yield out
    shutil.rmtree(tmp, ignore_errors=True)


def test_spatial_export_matches_library_and_jax(spatial_export, params_s):
    """The served flow equals the port's tiled library flow (atol 1e-5:
    the same bands through the exported graph) and the JAX package's
    served spatial artifact (the models' tolerance); two served calls
    are bitwise equal; the metadata has the JAX artifact's keys and
    values but the platform."""
    t = spatial_export
    a, b = (t["pair"][k][None] for k in ("image_a", "image_b"))
    sm = aot.load_serving(t["tmp"] / "port.flowpak")
    got = sm(a, b)
    assert got.shape == (1, 256, 64, 2)
    np.testing.assert_array_equal(sm(a, b), got)
    lib = spatial.infer_flow_spatial("s", params_s, a[0], b[0], n_tiles=2,
                                     overlap=32, device="cpu")
    np.testing.assert_allclose(got[0], lib, rtol=0, atol=1e-5)
    want = np.asarray(jaot.load_serving(t["tmp"] / "jax.flowpak")(a, b))
    _assert_flow_close(got, want)
    meta, jmeta = t["meta"], t["jmeta"]
    assert sorted(meta) == sorted(jmeta)
    for k in jmeta:
        if k != "platforms":
            assert meta[k] == jmeta[k], k
    assert (meta["spatial_tiles"], meta["spatial_overlap"]) == (2, 32)


def test_spatial_export_of_a_correlation_model_keeps_one_node(tmp_path):
    """FlowNetC's spatial graph runs the two bands as one batch: one
    ``flownet2::correlation`` node per forward, no weight in the graph."""
    import io
    import zipfile

    tree = warmstart.random_jax_params(get_model("c").build("cpu"), 0)
    path = tmp_path / "c.flowpak"
    aot.export_serving("c", tree, 256, 64, path, device="cpu",
                       compute_dtype="float32", spatial_tiles=2,
                       spatial_overlap=32)
    with zipfile.ZipFile(path) as z:
        program = torch.export.load(io.BytesIO(z.read("exported.pt2")))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("flownet2.correlation.default") == 1
    assert not program.state_dict


@pytest.mark.parametrize("kw,err,match", [
    ({"spatial_tiles": 2, "data_parallel": 2}, ValueError, "exclusive"),
    ({"spatial_tiles": 2, "batch": 2}, ValueError, "single-pair"),
    ({"spatial_tiles": 2, "spatial_overlap": 48}, ValueError,
     "multiple of 32"),
    ({"spatial_tiles": 2, "width": 96}, ValueError, "multiples of 64"),
    ({"data_parallel": 2}, ValueError, "batch % 2 == 0"),
])
def test_spatial_export_refusals(params_s, tmp_path, kw, err, match):
    """The JAX package's refusals (exclusive with data parallelism,
    batch 1 only, overlap %32, W %64, a batch that ``data_parallel``
    does not divide), each before anything is traced."""
    kw = dict(kw)
    width = kw.pop("width", 64)
    with pytest.raises(err, match=match):
        aot.export_serving("s", params_s, 256, width,
                           tmp_path / "x.flowpak", device="cpu", **kw)
    if err is ValueError:
        with pytest.raises(ValueError, match=match):
            jaot.export_serving("s", params_s, 256, width,
                                tmp_path / "j.flowpak", **kw)


def test_cli_export_spatial_tiles(tmp_path, params_s, capsys):
    """``cli export --aot --spatial_tiles 2`` writes a single-pair
    artifact that ``cli serve`` runs (a smaller pair padded up and
    cropped back); ``--spatial_tiles`` with ``--data_parallel`` exits
    naming the conflict."""
    ckpt = tmp_path / "s.npz"
    np.savez(ckpt, **warmstart.flatten(params_s))
    out = tmp_path / "s_sp.flowpak"
    base = ["export", "--aot", "--ckpt", str(ckpt), "--model", "s",
            "--height", "256", "--width", "64", "--device", "cpu"]
    assert cli.main([*base, "--out", str(out), "--spatial_tiles", "2",
                     "--spatial_overlap", "32", "--compute_dtype",
                     "float32", "--warp_mode", "full"]) == 0
    meta = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (meta["spatial_tiles"], meta["spatial_overlap"]) == (2, 32)
    rng = np.random.RandomState(6)
    pair = [tmp_path / "a.png", tmp_path / "b.png"]
    for p in pair:
        write_image(rng.randint(0, 255, (240, 60, 3), np.uint8), p)
    assert cli.main(["serve", "--artifact", str(out), "--input_a",
                     str(pair[0]), "--input_b", str(pair[1]), "--out",
                     str(tmp_path / "served")]) == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["flow_shape"] == [240, 60, 2]
    with pytest.raises(SystemExit, match="exclusive"):
        cli.main([*base, "--out", str(tmp_path / "x.flowpak"),
                  "--spatial_tiles", "2", "--data_parallel", "2"])
