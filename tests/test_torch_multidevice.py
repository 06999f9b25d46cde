"""Multi-device inference of the port on the CPU: ``export --aot
--data_parallel N`` replicas (``tools/aot.py``), the device lists
(``parallel/mesh.py::serving_devices``), a graph moved to another device
(``tools/aot.py::move_graph``), spatial bands spread over devices
(``parallel/spatial.py``) and the spatial artifact's band graph, each
held against the JAX package's runs on the 8 virtual CPU devices of
tests/conftest.py (tests/test_export_aot.py:114-142, :239-262).

The port's devices here are repeats of the one CPU device: the replicas
and bands run one after another through the same code that places them
one per card.

Tolerances: a served or tiled flow against the JAX package's at atol
1e-4, as tests/test_export_aot.py:132 holds the JAX DP artifact against
``infer_flow`` (FlowNetS flows of ~26 px mean here); a port flow
against another port flow of the same bands or pairs, batched
differently, at rtol 1e-5 and atol 1e-5 (f32 sums in another order,
relative to flows of tens of px); the same graph on the same inputs
bitwise.
"""

import io
import json
import shutil
import warnings
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from flownet2_tf_tpu import cli as jcli  # noqa: E402
from flownet2_tf_tpu.parallel import mesh as jmesh  # noqa: E402
from flownet2_tf_tpu.parallel import spatial as jspatial  # noqa: E402
from flownet2_tf_tpu.tools import aot as jaot  # noqa: E402
from flownet2_tf_tpu.training.infer import infer_flow as jinfer_flow  # noqa: E402
from flownet2_tf_tpu_torch import cli  # noqa: E402
from flownet2_tf_tpu_torch.models.registry import get_model  # noqa: E402
from flownet2_tf_tpu_torch.parallel import mesh, spatial  # noqa: E402
from flownet2_tf_tpu_torch.tools import aot  # noqa: E402
from flownet2_tf_tpu_torch.training import warmstart  # noqa: E402
from flownet2_tf_tpu_torch.utils import flowlib  # noqa: E402
from flownet2_tf_tpu_torch.utils.image_io import write_image  # noqa: E402

CPU = torch.device("cpu")
DP = 8
FLOW_ATOL = 1e-4    # against the JAX package
PORT_TOL = dict(rtol=1e-5, atol=1e-5)  # port against port, batched
                                       # differently
EXPORT = dict(compute_dtype="float32", warp_mode="full")


@pytest.fixture(autouse=True)
def _drop_files(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def tree():
    """A numpy-seeded JAX-layout FlowNetS tree both packages read."""
    return warmstart.random_jax_params(get_model("s").build("cpu"), 1)


@pytest.fixture(scope="module")
def dp_artifacts(tmp_path_factory, tree):
    """FlowNetS at 64x64, batch 8, ``data_parallel=8`` from both
    packages (the JAX one sharded over the 8 virtual CPU devices), and
    the batch both serve."""
    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.RandomState(5)
    out = {k: rng.rand(DP, 64, 64, 3).astype(np.float32) for k in "ab"}
    kw = dict(batch=DP, data_parallel=DP, **EXPORT)
    out["meta"] = aot.export_serving("s", tree, 64, 64, tmp / "port.flowpak",
                                     device="cpu", **kw)
    out["jmeta"] = jaot.export_serving("s", tree, 64, 64, tmp / "jax.flowpak",
                                       **kw)
    out["port"] = aot.load_serving(tmp / "port.flowpak", device="cpu")
    out["flow"] = out["port"](out["a"], out["b"])
    out["tmp"] = tmp
    yield out
    shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# --data_parallel artifacts
# ---------------------------------------------------------------------------

def test_dp_artifact_matches_jax_dp8_and_infer_flow(dp_artifacts, tree):
    """The port's 8 replicas against the JAX package's DP=8 artifact on 8
    virtual devices and against its ``infer_flow`` (atol 1e-4); the
    metadata is the JAX artifact's, key for key."""
    t = dp_artifacts
    assert t["port"].devices == [CPU] * DP
    assert t["flow"].shape == (DP, 64, 64, 2)
    served = np.asarray(jaot.load_serving(t["tmp"] / "jax.flowpak")(
        t["a"], t["b"]))
    np.testing.assert_allclose(t["flow"], served, rtol=0, atol=FLOW_ATOL)
    want = np.asarray(jinfer_flow("s", tree, t["a"], t["b"],
                                  compute_dtype="float32"))
    np.testing.assert_allclose(t["flow"], want, rtol=0, atol=FLOW_ATOL)
    assert t["meta"] == t["jmeta"]
    assert t["meta"]["data_parallel"] == DP


def test_dp_artifact_holds_one_replica_graph(dp_artifacts):
    """The artifact holds one graph at the per-replica batch (8 / 8 = 1),
    and each replica's rows are bitwise that graph on its shard."""
    t = dp_artifacts
    with zipfile.ZipFile(t["tmp"] / "port.flowpak") as z:
        assert sorted(n for n in z.namelist() if n.endswith(".pt2")) == [
            "exported.pt2"]
        program = torch.export.load(io.BytesIO(z.read("exported.pt2")))
    shapes = [tuple(n.meta["val"].shape) for n in program.graph.nodes
              if n.op == "placeholder" and n.name.startswith("image")]
    assert shapes == [(1, 64, 64, 3)] * 2
    graph, params, device = t["port"]._replicas[3]
    with torch.no_grad():
        row = graph(params, *(torch.from_numpy(t[k][3:4]) for k in "ab"))
    np.testing.assert_array_equal(row.numpy(), t["flow"][3:4])


def test_dp_tensor_inputs_gather_on_the_first_device(dp_artifacts):
    """Tensor inputs give a tensor on the first replica's device, bitwise
    the numpy call's flow."""
    t = dp_artifacts
    flow = t["port"](*(torch.from_numpy(t[k]) for k in "ab"))
    assert isinstance(flow, torch.Tensor) and flow.device == CPU
    np.testing.assert_array_equal(flow.numpy(), t["flow"])


def test_dp_infer_pair_is_row_zero_and_silent(dp_artifacts, monkeypatch):
    """``infer_pair`` on a DP artifact with one pair per replica: row 0
    of the batch call on the broadcast pair, and no warning (JAX
    ``aot.py:419-431``); with 4 pairs per replica it warns."""
    t = dp_artifacts
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        single = t["port"].infer_pair(t["a"][0], t["b"][0])
    broadcast = t["port"](*(np.broadcast_to(t[k][0], t[k].shape)
                            for k in "ab"))
    np.testing.assert_array_equal(single, broadcast[0])
    np.testing.assert_allclose(single, t["flow"][0], **PORT_TOL)
    monkeypatch.setattr(aot.ServingModel, "__call__", lambda self, a, b:
                        np.zeros(a.shape[:3] + (2,), np.float32))
    sm = aot.ServingModel(None, None, dict(t["meta"], data_parallel=2))
    with pytest.warns(UserWarning, match="7 redundant forwards"):
        sm.infer_pair(t["a"][0], t["b"][0])


@pytest.mark.parametrize("batch,dp", [(4, 8), (6, 4)])
def test_dp_refuses_a_batch_it_does_not_divide(tree, tmp_path, batch, dp):
    """``batch % N`` is refused in the JAX package's words, by both
    packages, before anything is traced."""
    match = f"batch % {dp} == 0: got {batch}"
    with pytest.raises(ValueError, match=match):
        aot.export_serving("s", tree, 64, 64, tmp_path / "x.flowpak",
                           batch=batch, data_parallel=dp, device="cpu")
    with pytest.raises(ValueError, match=match):
        jaot.export_serving("s", tree, 64, 64, tmp_path / "j.flowpak",
                            batch=batch, data_parallel=dp)
    assert not (tmp_path / "x.flowpak").exists()


def test_dp_load_refuses_another_count(dp_artifacts):
    """An explicit list that is not one device per replica raises."""
    path = dp_artifacts["tmp"] / "port.flowpak"
    with pytest.raises(ValueError, match=r"needs 8 devices \(data_parallel"):
        aot.load_serving(path, devices=["cpu"] * 3)


# ---------------------------------------------------------------------------
# serving_devices
# ---------------------------------------------------------------------------

def test_serving_devices_defaults_and_repeats():
    """The defaults (``cuda:0`` ... ``cuda:{n-1}``; n replicas on the
    one CPU device) and an explicit list taken as given, repeats
    allowed."""
    assert mesh.serving_devices("cuda", 2, visible=4) == [
        torch.device("cuda", 0), torch.device("cuda", 1)]
    assert mesh.serving_devices("cpu", 3) == [CPU] * 3
    assert mesh.serving_devices("cuda", 2, ["cuda:0", "cuda:0"],
                                visible=1) == [torch.device("cuda", 0)] * 2
    assert mesh.serving_devices("cuda", 2, ["cuda:1", "cuda"],
                                visible=2) == [torch.device("cuda", 1),
                                               torch.device("cuda", 0)]
    assert mesh.serving_devices("cpu", 2, ["cpu", "cpu"]) == [CPU] * 2
    assert mesh.visible_devices("cpu") == [CPU]


@pytest.mark.parametrize("n,k,kind", [(2, 1, "data_parallel"),
                                      (8, 4, "spatial_tiles")])
def test_serving_devices_refuses_too_few_cards(n, k, kind):
    """Fewer visible cards than replicas: the JAX package's words, no
    fallback to the CPU or to fewer replicas."""
    want = f"artifact needs {n} devices ({kind}); only {k} visible"
    with pytest.raises(ValueError) as e:
        mesh.serving_devices("cuda", n, kind=kind, visible=k)
    assert str(e.value) == want


@pytest.mark.parametrize("devices,match", [
    (["cpu"], "got a list of 1"),
    (["cpu", "cuda:0"], "not on the platform cpu"),
])
def test_serving_devices_refuses_bad_lists(devices, match):
    with pytest.raises(ValueError, match=match):
        mesh.serving_devices("cpu", 2, devices)
    with pytest.raises(ValueError, match="cuda:3"):
        mesh.serving_devices("cuda", 2, ["cuda:0", "cuda:3"], visible=2)


# ---------------------------------------------------------------------------
# A graph moved to another device
# ---------------------------------------------------------------------------

def test_move_graph_names_no_cpu_node(tmp_path):
    """A FlowNetC graph traced on the CPU, moved to ``meta``: no node's
    device argument or value still names the CPU, and its correlation
    node stays."""
    path = tmp_path / "c.flowpak"
    aot.export_serving("c", warmstart.random_jax_params(
        get_model("c").build("cpu"), 0), 64, 64, path, device="cpu",
        **EXPORT)
    with zipfile.ZipFile(path) as z:
        program = torch.export.load(io.BytesIO(z.read("exported.pt2")))

    def devices(p):
        out = set()
        for node in p.graph.nodes:
            val = node.meta.get("val")
            if isinstance(val, torch.Tensor):
                out.add(str(val.device))
            if "device" in node.kwargs:
                out.add(str(node.kwargs["device"]))
        return out

    assert devices(program) == {"cpu"}
    assert aot.graph_device(program) == CPU
    moved = aot.move_graph(program, "meta")
    assert devices(moved) == {"meta"}
    assert aot.graph_device(moved) == torch.device("meta")
    targets = [str(n.target) for n in moved.graph.nodes
               if n.op == "call_function"]
    assert targets.count("flownet2.correlation.default") == 1


# ---------------------------------------------------------------------------
# Spatial bands over devices
# ---------------------------------------------------------------------------

def _pair(height, seed):
    rng = np.random.RandomState(seed)
    return [rng.rand(height, 64, 3).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("n_tiles,n_devices", [(None, 2), (None, 4),
                                               (3, 2)])
def test_infer_flow_spatial_over_devices_matches_jax(tree, n_tiles,
                                                     n_devices):
    """Bands spread over ``["cpu"] * n`` against the JAX package's over
    a mesh of n virtual devices (atol 1e-4) and against the port's bands
    as one batch (``PORT_TOL``). ``n_tiles=None`` is one band per device;
    3 bands over 2 devices shrink to 1 device (``mesh_for_batch``)."""
    a, b = _pair(256, seed=n_devices)
    got = spatial.infer_flow_spatial("s", tree, a, b, n_tiles=n_tiles,
                                     overlap=32, devices=["cpu"] * n_devices)
    jmesh_n = jmesh.make_mesh(jax.devices()[:n_devices])
    want = np.asarray(jspatial.infer_flow_spatial(
        "s", tree, a, b, n_tiles=n_tiles, overlap=32, mesh=jmesh_n))
    assert got.shape == (256, 64, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOW_ATOL)
    batched = spatial.infer_flow_spatial("s", tree, a, b,
                                         n_tiles=n_tiles or n_devices,
                                         overlap=32, device="cpu")
    np.testing.assert_allclose(got, batched, **PORT_TOL)


@pytest.mark.parametrize("n_tiles,n_devices,groups", [
    (3, 2, [3]), (4, 2, [2, 2]), (2, 4, [1, 1]), (8, 4, [2, 2, 2, 2]),
    (None, 4, [1, 1, 1, 1])])
def test_bands_go_to_devices_in_contiguous_groups(monkeypatch, n_tiles,
                                                  n_devices, groups):
    """The groups follow the JAX package's ``mesh_for_batch`` over a mesh
    of the same size, each device's bands contiguous and in order."""
    seen = []

    def fake_forward(model, tiles_a, tiles_b, compute_dtype):
        seen.append(tiles_a[:, 0, 0, 0].tolist())
        return torch.zeros(tiles_a.shape[:3] + (2,))

    monkeypatch.setattr(spatial, "inference_model", lambda *a, **k: None)
    monkeypatch.setattr(spatial, "forward_tiles", fake_forward)
    n = n_tiles or n_devices
    # each band's first pixel names the band: rows of 64 * band index
    rows = np.arange(n * 64, dtype=np.float32) // 64
    image = np.broadcast_to(rows.reshape(n * 64, 1, 1),
                            (n * 64, 64, 3)).copy()
    spatial.infer_flow_spatial("s", {}, image, image, n_tiles=n_tiles,
                               overlap=0, devices=["cpu"] * n_devices)
    assert [len(g) for g in seen] == groups
    assert sum(seen, []) == [float(i) for i in range(n)]
    jm = jmesh.mesh_for_batch(n, jmesh.make_mesh(jax.devices()[:n_devices]))
    assert int(jm.devices.size) == len(groups)


# ---------------------------------------------------------------------------
# The spatial artifact's band graph
# ---------------------------------------------------------------------------

def test_spatial_artifact_on_two_devices_matches_jax(tree, tmp_path):
    """``spatial_tiles=2`` at 256x64, overlap 32: the band graph (batch
    1, 128 rows) loaded on ``["cpu"] * 2`` against the JAX package's
    spatial artifact (atol 1e-4) and the one-graph load (``PORT_TOL``);
    two calls bitwise equal."""
    kw = dict(spatial_tiles=2, spatial_overlap=32, **EXPORT)
    aot.export_serving("s", tree, 256, 64, tmp_path / "port.flowpak",
                       device="cpu", **kw)
    jaot.export_serving("s", tree, 256, 64, tmp_path / "jax.flowpak", **kw)
    with zipfile.ZipFile(tmp_path / "port.flowpak") as z:
        assert sorted(n for n in z.namelist() if n.endswith(".pt2")) == [
            "band.pt2", "exported.pt2"]
    a, b = (x[None] for x in _pair(256, seed=7))
    bands = aot.load_serving(tmp_path / "port.flowpak",
                             devices=["cpu", "cpu"])
    assert bands.devices == [CPU, CPU]
    got = bands(a, b)
    assert got.shape == (1, 256, 64, 2)
    np.testing.assert_array_equal(bands(a, b), got)
    want = np.asarray(jaot.load_serving(tmp_path / "jax.flowpak")(a, b))
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOW_ATOL)
    one = aot.load_serving(tmp_path / "port.flowpak", device="cpu")
    assert one.devices == [CPU]
    np.testing.assert_allclose(got, one(a, b), **PORT_TOL)
    with pytest.raises(ValueError, match=r"needs 2 devices \(spatial_tiles"):
        aot.load_serving(tmp_path / "port.flowpak", devices=["cpu"] * 3)


def test_devices_refused_on_single_device_artifacts(dp_artifacts, tree,
                                                    tmp_path):
    """A plain artifact and a bundle run on one device: ``devices=``
    raises, naming what it is for."""
    plain = tmp_path / "s.flowpak"
    aot.export_serving("s", tree, 64, 64, plain, device="cpu", **EXPORT)
    bundle = tmp_path / "bundle.flowpak"
    aot.export_serving_bundle("s", tree, [(64, 64, 1)], bundle, device="cpu",
                              **EXPORT)
    for path in (plain, bundle):
        with pytest.raises(ValueError, match="runs on one device"):
            aot.load_serving(path, devices=["cpu"])


# ---------------------------------------------------------------------------
# `cli export --aot --data_parallel` and `cli serve`
# ---------------------------------------------------------------------------

def test_cli_export_data_parallel_then_serve_matches_jax(tree, tmp_path,
                                                         capsys):
    """``cli export --aot --data_parallel 8 --batch 8 --device cpu`` then
    ``cli serve --device cpu`` on a 48x56 pair (padded up, broadcast to
    the 8 replicas, cropped back), against the JAX package's two
    commands on its 8 virtual devices (atol 1e-4)."""
    ckpt = tmp_path / "s.npz"
    np.savez(ckpt, **warmstart.flatten(tree))
    rng = np.random.RandomState(9)
    pair = [tmp_path / "a.png", tmp_path / "b.png"]
    for p in pair:
        write_image(rng.randint(0, 255, (48, 56, 3), np.uint8), p)
    export = ["export", "--aot", "--ckpt", str(ckpt), "--model", "s",
              "--height", "64", "--width", "64", "--batch", "8",
              "--data_parallel", "8", "--compute_dtype", "float32",
              "--warp_mode", "full"]
    serve = ["serve", "--input_a", str(pair[0]), "--input_b", str(pair[1])]
    assert cli.main([*export, "--out", str(tmp_path / "p.flowpak"),
                     "--device", "cpu"]) == 0
    meta = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (meta["batch"], meta["data_parallel"]) == (8, 8)
    assert cli.main([*serve, "--artifact", str(tmp_path / "p.flowpak"),
                     "--device", "cpu", "--out", str(tmp_path / "p")]) == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["flow_shape"] == [48, 56, 2]
    assert jcli.main([*export, "--out", str(tmp_path / "j.flowpak")]) == 0
    assert jcli.main([*serve, "--artifact", str(tmp_path / "j.flowpak"),
                      "--out", str(tmp_path / "j")]) == 0
    capsys.readouterr()
    got = flowlib.read_flow(tmp_path / "p" / "a_flow.flo")
    want = flowlib.read_flow(tmp_path / "j" / "a_flow.flo")
    assert got.shape == want.shape == (48, 56, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOW_ATOL)
