"""The torch port's serving path on the CPU, held against the JAX
package's: the coarse stack warps, the stacks at ``warp_res=2``, the
registered correlation ops, the ``.flowpak`` export and loader
(``tools/aot.py``), ``cli export``/``serve``/``info`` and the ``Net``
facade.

Weights are one numpy-seeded JAX-layout tree per model
(``warmstart.random_jax_params``), fed to both packages. Tolerances: the
coarse warps at atol 1e-5 (f32 sums in another order); the models and
f32 artifacts at tests/test_torch_models.py's (``predict_flow*`` rtol
1e-4 and atol 1e-4 * scale, full-resolution flows those of
tests/test_golden.py:96-99); a port artifact against the port's eager
forward at atol 1e-5; bf16 artifacts within the JAX package's own
bf16-against-f32 distance, as tests/test_torch_bf16.py holds bf16.
"""

import io
import json
import os
import subprocess
import shutil
import sys
import warnings
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from flownet2_tf_tpu import cli as jcli  # noqa: E402
from flownet2_tf_tpu.models import stacks as jstacks  # noqa: E402
from flownet2_tf_tpu.ops import dispatch  # noqa: E402
from flownet2_tf_tpu.ops.flow_warp import (  # noqa: E402
    flow_warp_coarse as jflow_warp_coarse,
    flow_warp_multi_coarse as jflow_warp_multi_coarse,
)
from flownet2_tf_tpu.tools import aot as jaot  # noqa: E402
from flownet2_tf_tpu_torch import cli, net  # noqa: E402
from flownet2_tf_tpu_torch.models import stacks  # noqa: E402
from flownet2_tf_tpu_torch.models.common import cast_params_for_inference  # noqa: E402
from flownet2_tf_tpu_torch.models.registry import get_model  # noqa: E402
from flownet2_tf_tpu_torch.ops import flow_warp  # noqa: E402
from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel as ck  # noqa: E402
from flownet2_tf_tpu_torch.tools import aot  # noqa: E402
from flownet2_tf_tpu_torch.training import infer, warmstart  # noqa: E402
from flownet2_tf_tpu_torch.utils import flowlib  # noqa: E402
from flownet2_tf_tpu_torch.utils.image_io import write_image  # noqa: E402

T = torch.from_numpy
ROOT = os.path.join(os.path.dirname(__file__), "..")
SAMPLES = os.path.join(ROOT, "data", "samples")
H = W = 64
FULL_RES = ("flow", "flow_css", "flow_sd")
# (model, compute dtype, warp mode) of the artifacts held against JAX's
EXPORTS = [("s", "float32", "full"), ("cs", "float32", "half"),
           ("2", "bfloat16", "half")]

@pytest.fixture(autouse=True)
def _drop_test_files(tmp_path):
    """FlowNet2 checkpoints and artifacts here are 330-650 MB each: delete what each test wrote when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)



def _mean_epe(got, want):
    return float(np.sqrt(((got - want) ** 2).sum(-1)).mean())


def _assert_match(got, want, keys=None):
    """tests/test_torch_models.py's tolerances."""
    for k in keys or want:
        assert got[k].shape == want[k].shape, k
        scale = max(1.0, float(np.abs(want[k]).mean()))
        if k in FULL_RES:
            rtol, atol = 1e-3, 5e-3 * scale
        else:
            rtol, atol = 1e-4, 1e-4 * scale
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.fixture(scope="module")
def trees():
    """A numpy-seeded JAX-layout tree per model: FlowNetS and FlowNet2
    (CS is FlowNet2's sub-tree)."""
    t2 = warmstart.random_jax_params(get_model("2").build("cpu"), 0)
    return {
        "s": warmstart.random_jax_params(get_model("s").build("cpu"), 1),
        "cs": t2["FlowNetCSS"]["FlowNetCS"],
        "2": t2,
    }


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(3)
    return {k: rng.rand(1, H, W, 3).astype(np.float32)
            for k in ("input_a", "input_b")}


# ---------------------------------------------------------------------------
# Coarse stack warps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("border", ["clamp", "zero"])
def test_coarse_warps_match_jax(k, border):
    rng = np.random.RandomState(k)
    image = rng.rand(2, 16, 24, 3).astype(np.float32)
    flow = (rng.randn(2, 16, 24, 2) * 4).astype(np.float32)
    got = flow_warp.flow_warp_coarse(T(image), T(flow), k, border).numpy()
    want = np.asarray(jflow_warp_coarse(image, flow, k, border))
    assert got.shape == image.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    flows = (rng.randn(2, 16, 24, 2) * 4).astype(np.float32)
    got = flow_warp.flow_warp_multi_coarse(T(image[:1]), T(flows), k,
                                           border).numpy()
    want = np.asarray(jflow_warp_multi_coarse(image[:1], flows, k,
                                                        border))
    assert got.shape == (2, 16, 24, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if k == 2:
        np.testing.assert_array_equal(
            flow_warp.flow_warp_half(T(image), T(flow), border).numpy(),
            flow_warp.flow_warp_coarse(T(image), T(flow), 2, border).numpy())


def test_stack_warp_takes_warp_res_as_an_argument():
    rng = np.random.RandomState(0)
    image = T(rng.rand(1, 16, 16, 3).astype(np.float32))
    flow = T((rng.randn(1, 16, 16, 2) * 3).astype(np.float32))
    assert torch.equal(flow_warp.stack_warp(image, flow),
                       flow_warp.flow_warp(image, flow))
    assert torch.equal(flow_warp.stack_warp(image, flow, warp_res=4),
                       flow_warp.flow_warp_coarse(image, flow, 4))
    assert torch.equal(
        flow_warp.stack_warp_multi(image, torch.cat([flow, flow]),
                                   warp_res=2),
        flow_warp.flow_warp_multi_half(image, torch.cat([flow, flow])))
    with pytest.raises(ValueError, match="warp_res"):
        flow_warp.stack_warp(image, flow, warp_res=3)
    for name in ("s", "c", "sd"):
        assert get_model(name).build("cpu", warp_res=1) is not None
        with pytest.raises(ValueError, match="no stack warps"):
            get_model(name).build("cpu", warp_res=2)
    with pytest.raises(ValueError, match="warp_res"):
        stacks.FlowNetCS(warp_res=3)
    model = get_model("2").build("cpu", warp_res=2)
    assert {m.warp_res for m in model.modules()
            if hasattr(m, "warp_res")} == {2}


# ---------------------------------------------------------------------------
# The stacks at warp_res=2
# ---------------------------------------------------------------------------

JAX_APPLY = {"cs": jstacks.apply_cs, "2": jstacks.apply_flownet2}


@pytest.fixture(scope="module")
def jax_half(trees, images):
    """The JAX package's f32 forwards under ``use_warp_res(2)`` (plain
    path), per model."""
    out = {}
    for name, apply in JAX_APPLY.items():
        with dispatch.use_s2d(False), dispatch.use_warp_res(2):
            preds = jax.jit(apply)(trees[name], images)
        out[name] = {k: np.asarray(v) for k, v in preds.items()}
    return out


def _eager(name, tree, images, warp_res=1, compute_dtype=None):
    model = infer.load_model(name, tree, "cpu") if warp_res == 1 else (
        warmstart.load_jax_params(
            get_model(name).build("cpu", warp_res=warp_res), tree))
    if compute_dtype == torch.bfloat16:
        cast_params_for_inference(model)
    with torch.inference_mode():
        preds = model({k: T(v) for k, v in images.items()}, compute_dtype)
    return {k: v.numpy() for k, v in preds.items()}


@pytest.mark.parametrize("name", ["cs", "2"])
def test_stacks_at_half_res_warps_match_jax(trees, images, jax_half, name):
    got = _eager(name, trees[name], images, warp_res=2)
    want = jax_half[name]
    assert sorted(got) == sorted(want)
    _assert_match(got, want)
    # and the half-res grid is a different forward from the exact one
    exact = _eager(name, trees[name], images)
    assert np.abs(exact["flow"] - got["flow"]).max() > 1e-4


# ---------------------------------------------------------------------------
# The registered correlation ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_correlation_ops_pass_opcheck(dtype):
    rng = np.random.RandomState(0)
    a, b = (T(rng.randn(2, 5, 7, 8).astype(np.float32)).to(dtype)
            .requires_grad_() for _ in range(2))
    g = T(rng.randn(2, 5, 7, 25).astype(np.float32))
    for op, args in ((ck.correlation_op, (a, b, 4, 2)),
                     (ck.correlation_backward_op,
                      (g, a.detach(), b.detach(), 4, 2))):
        result = torch.library.opcheck(op, args)
        assert set(result.values()) == {"SUCCESS"}, result


def test_correlation_op_flop_formula():
    from torch.utils.flop_counter import FlopCounterMode

    a = torch.zeros(2, 5, 7, 8)
    with FlopCounterMode(display=False) as counter:
        ck.correlation_cuda(a, a, 4, 2)
    assert counter.get_total_flops() == 2 * 2 * 5 * 7 * 25 * 8


# ---------------------------------------------------------------------------
# .flowpak export against eager and against the JAX package's artifact
# ---------------------------------------------------------------------------

def _read(path):
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        with np.load(io.BytesIO(z.read("params.npz"))) as npz:
            flat = {k: npz[k] for k in npz.files}
        names = z.namelist()
    return meta, flat, names


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory, trees):
    """Each of EXPORTS written by both packages, on the CPU."""
    d = tmp_path_factory.mktemp("flowpak")
    out = {}
    for name, cd, wm in EXPORTS:
        ours, theirs = d / f"{name}.flowpak", d / f"{name}_jax.flowpak"
        aot.export_serving(name, trees[name], H, W, ours, compute_dtype=cd,
                           warp_mode=wm, device="cpu")
        jaot.export_serving(name, trees[name], H, W, theirs,
                            compute_dtype=cd, warp_mode=wm)
        out[name] = (ours, theirs)
    yield out
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def served(artifacts, images):
    """Each artifact of both packages, loaded and run on ``images``."""
    a, b = images["input_a"], images["input_b"]
    return {name: (aot.load_serving(ours)(a, b),
                   np.asarray(jaot.load_serving(theirs)(a, b)))
            for name, (ours, theirs) in artifacts.items()}


@pytest.mark.parametrize("name,cd,wm", EXPORTS)
def test_artifact_serves_like_eager(trees, images, served, name, cd, wm):
    bf16 = cd == "bfloat16"
    want = _eager(name, trees[name], images, warp_res=aot.warp_res_of(wm),
                  compute_dtype=torch.bfloat16 if bf16 else None)["flow"]
    got = served[name][0]
    assert got.shape == (1, H, W, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,cd,wm", EXPORTS)
def test_artifact_matches_jax_artifact(served, jax_half, name, cd, wm):
    ours, theirs = served[name]
    if cd == "float32":
        _assert_match({"flow": ours}, {"flow": theirs})
        return
    # bf16: as close to JAX's bf16 flow as that is to JAX's f32 flow at
    # the same warp grid
    ref = jax_half[name]["flow"]
    assert _mean_epe(ours, theirs) <= _mean_epe(theirs, ref), (
        _mean_epe(ours, theirs), _mean_epe(theirs, ref))


@pytest.mark.parametrize("name,cd,wm", EXPORTS)
def test_params_npz_is_the_jax_artifacts(artifacts, name, cd, wm):
    ours, theirs = artifacts[name]
    meta, flat, names = _read(ours)
    jmeta, jflat, jnames = _read(theirs)
    assert sorted(flat) == sorted(jflat)
    for k in jflat:
        assert flat[k].dtype == jflat[k].dtype, k
        np.testing.assert_array_equal(flat[k], jflat[k], err_msg=k)
    assert meta["bf16_leaves"] == jmeta["bf16_leaves"]
    assert bool(meta["bf16_leaves"]) == (cd == "bfloat16")
    assert all(flat[k].dtype == np.uint16 for k in meta["bf16_leaves"])
    assert sorted(meta) == sorted(jmeta)
    for k in jmeta:
        if k != "platforms":
            assert meta[k] == jmeta[k], k
    assert meta["platforms"] == ["cpu"]
    assert sorted(names) == ["exported.pt2", "meta.json", "params.npz"]


@pytest.mark.parametrize("name,nodes", [("s", 0), ("cs", 1), ("2", 1)])
def test_exported_graph_holds_one_correlation_node(artifacts, name, nodes):
    with zipfile.ZipFile(artifacts[name][0]) as z:
        program = torch.export.load(io.BytesIO(z.read("exported.pt2")))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("flownet2.correlation.default") == nodes
    # the weights are graph inputs, stored once, in params.npz
    assert not program.state_dict


def test_served_call_counts_no_kernel_launch_on_the_cpu(artifacts, images):
    sm = aot.load_serving(artifacts["cs"][0])
    before = ck.LAUNCHES
    flow = sm(T(images["input_a"]), T(images["input_b"]))
    assert isinstance(flow, torch.Tensor) and flow.shape == (1, H, W, 2)
    assert ck.LAUNCHES == before


def test_load_serving_imports_no_model_code(artifacts):
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from flownet2_tf_tpu_torch.tools.aot import load_serving\n"
        f"sm = load_serving({str(artifacts['cs'][0])!r})\n"
        "flow = sm(np.zeros((1, 64, 64, 3), np.float32),\n"
        "          np.zeros((1, 64, 64, 3), np.float32))\n"
        "assert flow.shape == (1, 64, 64, 2) and np.isfinite(flow).all()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.startswith('flownet2_tf_tpu_torch.models')\n"
        "             or m.split('.')[0] in ('jax', 'flownet2_tf_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cuda_artifact_refuses_a_machine_without_a_card(tmp_path,
                                                        artifacts):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    bad = tmp_path / "cuda.flowpak"
    _rewrite_meta(artifacts["s"][0], bad, platforms=["cuda"])
    with pytest.raises(RuntimeError, match="exported for cuda"):
        aot.load_serving(bad)


def _rewrite_meta(src, dst, **changes):
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for name in zin.namelist():
            data = zin.read(name)
            if name == "meta.json":
                data = json.dumps(dict(json.loads(data), **changes))
            zout.writestr(name, data)


# ---------------------------------------------------------------------------
# The JAX package's export checks (tests/test_export_aot.py), ported
# ---------------------------------------------------------------------------

def test_shape_specialized_artifact_refuses_other_shapes(artifacts):
    sm = aot.load_serving(artifacts["s"][0])
    with pytest.raises(ValueError, match="specialized"):
        sm(np.zeros((1, 128, 64, 3), np.float32),
           np.zeros((1, 128, 64, 3), np.float32))


def test_export_validates_mod64(tmp_path, trees):
    with pytest.raises(ValueError, match="multiples of 64"):
        aot.export_serving("s", trees["s"], 60, 64, tmp_path / "x.flowpak",
                           device="cpu")


def test_load_rejects_unknown_format_version(tmp_path, artifacts):
    bad = tmp_path / "bad.flowpak"
    _rewrite_meta(artifacts["s"][0], bad, format_version=999)
    with pytest.raises(ValueError, match="version"):
        aot.load_serving(bad)


def test_warp_mode_and_unported_options():
    assert [aot.warp_res_of(m) for m in ("full", "half", "quarter")] == [
        1, 2, 4]
    with pytest.raises(ValueError, match="warp_mode"):
        aot.warp_res_of("eighth")
    # multi-platform artifacts, half-res fusion and replicas are ported
    # (tests/test_torch_platforms.py, tests/test_torch_knobs.py,
    # tests/test_torch_multidevice.py); data_parallel=8 at batch 1 is
    # refused in the JAX package's words before anything is built
    with pytest.raises(ValueError, match="batch % 8 == 0: got 1"):
        aot.export_serving("s", {}, 64, 64, "x.flowpak", device="cpu",
                           data_parallel=8)


def test_infer_pair_pads_crops_and_warns_once(monkeypatch):
    calls = []

    def fake_call(self, a, b):
        calls.append(np.asarray(a).copy())
        return np.zeros(a.shape[:3] + (2,), np.float32)

    monkeypatch.setattr(aot.ServingModel, "__call__", fake_call)
    rng = np.random.RandomState(0)
    a = rng.rand(48, 56, 3).astype(np.float32)
    meta = {"batch": 1, "height": 64, "width": 64, "platforms": ["cpu"]}
    flow = aot.ServingModel(None, None, meta).infer_pair(a, a)
    assert flow.shape == (48, 56, 2)
    padded = calls[-1][0]
    assert padded.shape == (64, 64, 3)
    np.testing.assert_array_equal(padded[:48, :56], a)
    np.testing.assert_array_equal(padded[48:, :56], np.repeat(
        a[-1:], 16, axis=0))  # edge padding
    with pytest.raises(ValueError, match="exceeds"):
        aot.ServingModel(None, None, meta).infer_pair(
            np.zeros((65, 64, 3)), np.zeros((65, 64, 3)))

    sm = aot.ServingModel(None, None, dict(meta, batch=8))
    with pytest.warns(UserWarning, match="7 redundant forwards"):
        sm.infer_pair(a, a)
    assert calls[-1].shape == (8, 64, 64, 3)
    with warnings.catch_warnings():  # once per artifact, not per call
        warnings.simplefilter("error")
        sm.infer_pair(a, a)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory, trees):
    path = tmp_path_factory.mktemp("bundle") / "s_bundle.flowpak"
    meta = aot.export_serving_bundle(
        "s", trees["s"], [(64, 64, 1), (64, 128, 1), (64, 64, 2)], path,
        compute_dtype="float32", warp_mode="full", device="cpu")
    yield path, meta
    shutil.rmtree(path.parent, ignore_errors=True)


def test_bundle_dispatches_on_shape(bundle, trees):
    path, meta = bundle
    assert meta["format_version"] == aot.BUNDLE_FORMAT_VERSION
    assert len(meta["entries"]) == 3
    assert meta["platforms"] == ["cpu"]
    _, _, names = _read(path)
    assert sorted(names) == ["exported_0.pt2", "exported_1.pt2",
                             "exported_2.pt2", "meta.json", "params.npz"]
    sm = aot.load_serving(path)
    assert sm.shapes == [(1, 64, 64), (1, 64, 128), (2, 64, 64)]
    rng = np.random.RandomState(7)
    for shape in ((1, 64, 64, 3), (1, 64, 128, 3), (2, 64, 64, 3)):
        a = rng.rand(*shape).astype(np.float32)
        b = rng.rand(*shape).astype(np.float32)
        got = sm(a, b)
        want = infer.infer_flow("s", trees["s"], a, b, device="cpu")
        assert got.shape == shape[:3] + (2,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="available"):
        sm(np.zeros((1, 128, 128, 3), np.float32),
           np.zeros((1, 128, 128, 3), np.float32))
    # infer_pair: a 64x100 pair -> the (1, 64, 128) entry, cropped back
    a1 = rng.rand(64, 100, 3).astype(np.float32)
    b1 = rng.rand(64, 100, 3).astype(np.float32)
    flow = sm.infer_pair(a1, b1)
    assert flow.shape == (64, 100, 2) and np.isfinite(flow).all()
    np.testing.assert_array_equal(
        flow, sm._models[(1, 64, 128)].infer_pair(a1, b1))
    with pytest.raises(ValueError, match="no batch-1 bundle entry"):
        sm.infer_pair(np.zeros((128, 64, 3), np.float32),
                      np.zeros((128, 64, 3), np.float32))


def test_bundle_rejects_bad_shapes(tmp_path, trees):
    for shapes, match in (([(60, 64, 1)], "multiples of 64"),
                          ([(64, 64, 1), (64, 64, 1)], "duplicate"),
                          ([], "at least one")):
        with pytest.raises(ValueError, match=match):
            aot.export_serving_bundle("s", trees["s"], shapes,
                                      tmp_path / "x.flowpak", device="cpu")


def _export_args(**kw):
    args = dict(shapes=None, data_parallel=0, spatial_tiles=0)
    args.update(kw)
    return type("Args", (), args)()


@pytest.mark.parametrize("spec,want", [
    ("448x1024", [(448, 1024, 1)]),
    ("448x1024,384x1280x4", [(448, 1024, 1), (384, 1280, 4)]),
    ("64X64x2", [(64, 64, 2)]),
    (None, None),
])
def test_parse_export_shapes(spec, want):
    args = _export_args(shapes=spec)
    assert cli.parse_export_shapes(args) == want
    assert jcli.parse_export_shapes(args) == want


@pytest.mark.parametrize("spec,kw", [
    ("448", {}), ("448x1024x1x1", {}), ("axb", {}), ("0x64", {}),
    ("64x-64", {}), ("64x64", {"data_parallel": 2}),
    ("64x64", {"spatial_tiles": 2}),
])
def test_parse_export_shapes_refuses(spec, kw):
    args = _export_args(shapes=spec, **kw)
    with pytest.raises(SystemExit):
        cli.parse_export_shapes(args)
    with pytest.raises(SystemExit):
        jcli.parse_export_shapes(args)


@pytest.fixture(scope="module")
def ckpt_s(tmp_path_factory, trees):
    path = tmp_path_factory.mktemp("ckpt") / "s.npz"
    np.savez(path, **warmstart.flatten(trees["s"]))
    yield path
    shutil.rmtree(path.parent, ignore_errors=True)


def test_cli_export_aot_then_serve(tmp_path, ckpt_s, trees, capsys):
    out = tmp_path / "s_cli.flowpak"
    rc = cli.main(["export", "--aot", "--ckpt", str(ckpt_s), "--out",
                   str(out), "--model", "s", "--height", "64", "--width",
                   "64", "--compute_dtype", "float32", "--warp_mode",
                   "full", "--device", "cpu"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["out"] == str(out) and line["model"] == "s"

    # serve a pair SMALLER than the artifact: padded up, cropped back
    rng = np.random.RandomState(7)
    a_path, b_path = tmp_path / "a.png", tmp_path / "b.png"
    write_image(rng.randint(0, 255, (48, 56, 3), np.uint8), a_path)
    write_image(rng.randint(0, 255, (48, 56, 3), np.uint8), b_path)
    rc = cli.main(["serve", "--artifact", str(out), "--input_a",
                   str(a_path), "--input_b", str(b_path), "--out",
                   str(tmp_path / "out")])
    assert rc == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(info) == ["artifact", "compute_dtype", "flow_shape",
                            "mean_magnitude", "model", "out_dir",
                            "warp_mode"]
    assert info["flow_shape"] == [48, 56, 2]
    assert (info["model"], info["compute_dtype"], info["warp_mode"]) == (
        "s", "float32", "full")
    flow = flowlib.read_flow(tmp_path / "out" / "a_flow.flo")
    assert (tmp_path / "out" / "a_flow.png").exists()
    # the eager path on the same pair (cli test pads to 64x64 too)
    rc = cli.main(["test", "--model", "s", "--ckpt", str(ckpt_s),
                   "--device", "cpu", "--input_a", str(a_path),
                   "--input_b", str(b_path), "--out", str(tmp_path / "t")])
    assert rc == 0
    want = flowlib.read_flow(tmp_path / "t" / "a_flow.flo")
    np.testing.assert_allclose(flow, want, rtol=0, atol=1e-5)


def test_cli_export_bundle_and_defaults(tmp_path, ckpt_s, capsys):
    out = tmp_path / "bundle.flowpak"
    rc = cli.main(["export", "--aot", "--model", "s", "--ckpt",
                   str(ckpt_s), "--shapes", "64x64,64x128x2", "--out",
                   str(out), "--device", "cpu"])
    assert rc == 0
    meta = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [(e["batch"], e["height"], e["width"])
            for e in meta["entries"]] == [(1, 64, 64), (2, 64, 128)]
    # the JAX package's serving defaults
    assert (meta["compute_dtype"], meta["warp_mode"]) == ("bfloat16", "half")
    sm = aot.load_serving(out)
    a = np.random.RandomState(0).rand(2, 64, 128, 3).astype(np.float32)
    flow = sm(a, a)
    assert flow.shape == (2, 64, 128, 2) and np.isfinite(flow).all()
    args = cli.build_parser().parse_args(
        ["export", "--aot", "--ckpt", "x", "--out", "y"])
    jargs = jcli.build_parser().parse_args(
        ["export", "--aot", "--ckpt", "x", "--out", "y"])
    for k in ("model", "height", "width", "batch", "compute_dtype",
              "warp_mode", "shapes", "platforms", "data_parallel",
              "spatial_tiles", "spatial_overlap"):
        assert getattr(args, k) == getattr(jargs, k), k
    assert args.device == "cuda"


def test_cli_export_npz_and_unported_flags(tmp_path, ckpt_s, trees,
                                           capsys):
    out = tmp_path / "w.npz"
    assert cli.main(["export", "--ckpt", str(ckpt_s), "--out",
                     str(out)]) == 0
    with np.load(out) as got:
        want = warmstart.flatten(trees["s"])
        assert sorted(got.files) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    # --data_parallel: refused where the batch does not split, else one
    # replica's graph that loads as N replicas
    with pytest.raises(SystemExit, match="batch % 8 == 0: got 1"):
        cli.main(["export", "--aot", "--ckpt", str(ckpt_s), "--out",
                  str(tmp_path / "x.flowpak"), "--device", "cpu",
                  "--data_parallel", "8"])
    capsys.readouterr()
    dp = tmp_path / "dp.flowpak"
    assert cli.main(["export", "--aot", "--ckpt", str(ckpt_s), "--out",
                     str(dp), "--device", "cpu", "--model", "s",
                     "--height", "64", "--width",
                     "64", "--batch", "2", "--data_parallel", "2"]) == 0
    meta = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (meta["batch"], meta["data_parallel"]) == (2, 2)
    assert aot.load_serving(dp, device="cpu").devices == [
        torch.device("cpu")] * 2


@pytest.mark.parametrize("name", ["c", "2"])
def test_cli_info_counts_match_jax(name, capsys):
    assert cli.main(["info", "--model", name]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jcli.main(["info", "--model", name]) == 0
    theirs = json.loads(capsys.readouterr().out)
    assert ours == theirs


def test_cli_info_flops(capsys):
    assert cli.main(["info", "--model", "c", "--flops", "--height", "64",
                     "--width", "128", "--batch", "2"]) == 0
    out = json.loads(capsys.readouterr().out)
    corr = 2 * 2 * 8 * 16 * 441 * 256 / 1e9
    assert out["gflops_per_batch"] > corr
    assert out["gflops_per_pair"] == pytest.approx(
        out["gflops_per_batch"] / 2, abs=1e-3)
    assert "correlation" in out["flops_counted"]
    assert out["at"] == "2x64x128 bf16"
    assert "hbm_gb_xla_opsum_bound" not in out


# ---------------------------------------------------------------------------
# The Net facade
# ---------------------------------------------------------------------------

def test_net_test_matches_cli_test(tmp_path, ckpt_s):
    pair = [os.path.join(SAMPLES, f"0img{i}.ppm") for i in (0, 1)]
    flow = net.FlowNetS(net.Mode.TEST, device="cpu").test(
        str(ckpt_s), *pair, str(tmp_path / "net"), save_flo=True)
    assert cli.main(["test", "--model", "s", "--ckpt", str(ckpt_s),
                     "--device", "cpu", "--input_a", pair[0], "--input_b",
                     pair[1], "--out", str(tmp_path / "cli")]) == 0
    want = flowlib.read_flow(tmp_path / "cli" / "0img0_flow.flo")
    assert flow.shape == want.shape == (192, 256, 2)
    np.testing.assert_array_equal(flow, want)
    np.testing.assert_array_equal(
        flowlib.read_flow(tmp_path / "net" / "0img0_flow.flo"), want)
    assert net.Net("2").device == "cuda"
    assert net.FlowNet2().model.name == "FlowNet2"
    try:
        net.Net("s", debug=True)
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
