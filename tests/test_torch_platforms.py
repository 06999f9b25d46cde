"""Multi-platform ``.flowpak`` artifacts of the torch port on the CPU: the
export's platforms (``tools/aot.py::export_serving(..., platforms=)``,
``cli export --aot --platforms``) and the loader's choice of platform
(``load_serving(path, device=)``, ``cli serve --device``).

A torch graph bakes its device in at trace time, so a multi-platform
artifact holds one graph per platform (``exported-{platform}.pt2``) and
one ``params.npz``. This machine has no card: a CUDA graph cannot be
traced here, so an export naming ``cuda`` must raise and write nothing,
and the loader is exercised on artifacts whose CUDA member is a stand-in
that must never be read. ``chip_smoke.py --phase17`` exports and serves
both graphs on the card.

Weights are FlowNetS's from the JAX package's ``model.init(PRNGKey(0))``
(``warmstart.flatten``); the served CPU graph is held against the JAX
package's CPU export of the same weights at tests/test_torch_models.py's
tolerance, and against the single-platform artifact bitwise.
"""

import json
import os
import shutil
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from flownet2_tf_tpu.models.registry import get_model as jget_model  # noqa: E402
from flownet2_tf_tpu.tools import aot as jaot  # noqa: E402
from flownet2_tf_tpu.training import warmstart as jws  # noqa: E402
from flownet2_tf_tpu_torch import cli  # noqa: E402
from flownet2_tf_tpu_torch.tools import aot  # noqa: E402
from flownet2_tf_tpu_torch.utils.image_io import write_image  # noqa: E402

H = W = 64
F32 = {"compute_dtype": "float32", "warp_mode": "full"}
# a stand-in for a CUDA graph: any attempt to deserialize it fails
NOT_A_GRAPH = b"a cuda graph, not to be read on a host without a card"


@pytest.fixture(autouse=True)
def _drop_test_files(tmp_path):
    """FlowNetS artifacts are 155 MB each: delete what each test wrote
    when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def flat():
    params = jget_model("s").init(jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in jws.flatten(params).items()}


@pytest.fixture(scope="module")
def pair():
    rng = np.random.RandomState(4)
    return tuple(rng.rand(1, H, W, 3).astype(np.float32) for _ in range(2))


@pytest.fixture(scope="module")
def single(tmp_path_factory, flat):
    """Today's single-device artifact: exported on the CPU."""
    d = tmp_path_factory.mktemp("single")
    path = d / "s_cpu.flowpak"
    meta = aot.export_serving("s", flat, H, W, path, device="cpu", **F32)
    yield path, meta
    shutil.rmtree(d, ignore_errors=True)


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _rewrite(src, dst, rename=None, add=None, drop=(), **meta_changes):
    """A copy of the artifact ``src`` with members renamed, added or
    dropped and ``meta.json`` changed."""
    members = _members(src)
    meta = json.loads(members.pop("meta.json"))
    meta.update(meta_changes)
    out = {(rename or {}).get(n, n): v for n, v in members.items()}
    out.update(add or {})
    with zipfile.ZipFile(dst, "w") as z:
        for n, v in out.items():
            if n not in drop:
                z.writestr(n, v)
        z.writestr("meta.json", json.dumps(meta, indent=1))
    return dst


def _cuda_cpu(single_path, dst, stems=("exported",)):
    """The layout of a ``cuda,cpu`` artifact built from a CPU export: its
    graph under the CPU name, a stand-in under the CUDA one."""
    return _rewrite(
        single_path, dst,
        rename={f"{s}.pt2": f"{s}-cpu.pt2" for s in stems},
        add={f"{s}-cuda.pt2": NOT_A_GRAPH for s in stems},
        platforms=["cuda", "cpu"])


def test_graph_names_carry_the_platform_only_in_multi_platform_artifacts():
    assert aot._graph_name("exported", "cpu", ["cpu"]) == "exported.pt2"
    assert aot._graph_name("exported_1", "cuda", ["cuda"]) == "exported_1.pt2"
    assert (aot._graph_name("exported", "cpu", ["cuda", "cpu"])
            == "exported-cpu.pt2")
    assert (aot._graph_name("exported_1", "cuda", ["cuda", "cpu"])
            == "exported_1-cuda.pt2")


def test_platforms_cpu_is_todays_artifact(tmp_path, flat, single):
    """``platforms=["cpu"]`` (whatever ``device`` says) writes the
    single-device CPU artifact member for member, byte for byte; so does
    ``cli export --aot --platforms cpu`` with its default ``--device``."""
    path, meta = single
    again = tmp_path / "platforms_cpu.flowpak"
    meta2 = aot.export_serving("s", flat, H, W, again, platforms=["cpu"],
                               device="cuda", **F32)
    assert meta2 == meta and meta["platforms"] == ["cpu"]
    assert _members(again) == _members(path)
    os.remove(again)
    ckpt = tmp_path / "s.npz"
    np.savez(ckpt, **flat)
    out = tmp_path / "cli.flowpak"
    assert cli.main(["export", "--aot", "--model", "s", "--ckpt", str(ckpt),
                     "--out", str(out), "--height", str(H), "--width",
                     str(W), "--compute_dtype", "float32", "--warp_mode",
                     "full", "--platforms", "cpu"]) == 0
    assert _members(out) == _members(path)


def test_bundle_platforms_cpu_is_todays_bundle(tmp_path, flat):
    shapes = [(64, 64, 1), (64, 128, 1)]
    a, b = tmp_path / "a.flowpak", tmp_path / "b.flowpak"
    meta = aot.export_serving_bundle("s", flat, shapes, a, device="cpu",
                                     **F32)
    assert aot.export_serving_bundle("s", flat, shapes, b,
                                     platforms=["cpu"], **F32) == meta
    assert _members(a) == _members(b)
    assert sorted(_members(a)) == ["exported_0.pt2", "exported_1.pt2",
                                   "meta.json", "params.npz"]


def test_cuda_platform_without_a_card_raises_and_writes_nothing(tmp_path,
                                                                flat):
    """``--platforms cuda,cpu`` on a host without a card: a clear error
    before anything is built, and no file (not even a partial one)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "both.flowpak"
    for platforms in (["cuda", "cpu"], ["cpu", "cuda"], ["cuda"]):
        with pytest.raises(RuntimeError, match="cuda.is_available"):
            aot.export_serving("s", flat, H, W, out, platforms=platforms,
                               device="cpu", **F32)
        with pytest.raises(RuntimeError, match="cuda.is_available"):
            aot.export_serving_bundle("s", flat, [(64, 64, 1)], out,
                                      platforms=platforms, **F32)
    ckpt = tmp_path / "s.npz"
    np.savez(ckpt, **flat)
    with pytest.raises(RuntimeError, match="--platforms cpu"):
        cli.main(["export", "--aot", "--model", "s", "--ckpt", str(ckpt),
                  "--out", str(out), "--platforms", "cuda,cpu"])
    assert not out.exists()


@pytest.mark.parametrize("platforms", [["tpu"], ["cpu", "cpu"], []])
def test_unknown_or_repeated_platforms_raise(tmp_path, flat, platforms):
    out = tmp_path / "bad.flowpak"
    with pytest.raises(ValueError, match="at most once"):
        aot.export_serving("s", flat, H, W, out, platforms=platforms,
                           device="cpu", **F32)
    assert not out.exists()


def test_loader_serves_the_cpu_graph_of_a_multi_platform_artifact(
        tmp_path, flat, pair, single):
    """``load_serving(path, device="cpu")`` reads only the CPU graph (the
    CUDA member is never deserialized) and serves bitwise what the
    single-platform artifact serves, and what the JAX package's CPU
    export of the same weights serves at the f32 parity tolerance."""
    path, _ = single
    both = _cuda_cpu(path, tmp_path / "both.flowpak")
    sm = aot.load_serving(both, device="cpu")
    assert sm.device == torch.device("cpu")
    assert sm.meta["platforms"] == ["cuda", "cpu"]
    got = sm(*pair)
    want = aot.load_serving(path)(*pair)
    assert np.array_equal(got, want)

    theirs = tmp_path / "s_jax.flowpak"
    jmeta = jaot.export_serving("s", jws.unflatten(flat), H, W, theirs,
                                platforms=["cpu"], **F32)
    assert set(jmeta) == set(sm.meta)
    jflow = np.asarray(jaot.load_serving(theirs)(*pair))
    scale = max(1.0, float(np.abs(jflow).mean()))
    np.testing.assert_allclose(got, jflow, rtol=1e-3, atol=5e-3 * scale)


def test_loader_default_is_the_card_and_never_falls_back(tmp_path, single):
    """With no ``device`` the loader takes the CUDA graph when the
    artifact has one; on a host without a card that raises, naming the
    CPU graph it could serve instead, and serves nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path, _ = single
    both = _cuda_cpu(path, tmp_path / "both.flowpak")
    with pytest.raises(RuntimeError, match="exported for cuda.*device='cpu'"):
        aot.load_serving(both)
    with pytest.raises(RuntimeError, match="exported for cuda"):
        aot.load_serving(both, device="cuda")
    # a CPU-only artifact defaults to its one platform
    assert aot.load_serving(path).device == torch.device("cpu")


def test_loader_refuses_a_platform_the_artifact_does_not_hold(tmp_path,
                                                              single):
    path, _ = single
    with pytest.raises(ValueError, match=r"platforms \['cpu'\], none for "
                                         "cuda"):
        aot.load_serving(path, device="cuda")
    # meta.json names a platform whose graph is missing
    lying = _rewrite(path, tmp_path / "lying.flowpak",
                     rename={"exported.pt2": "exported-cuda.pt2"},
                     platforms=["cuda", "cpu"])
    with pytest.raises(ValueError, match=r"lacks \['exported-cpu.pt2'\]"):
        aot.load_serving(lying, device="cpu")


def test_multi_platform_bundle_loads_one_platform(tmp_path, flat, pair):
    bundle = tmp_path / "bundle.flowpak"
    aot.export_serving_bundle("s", flat, [(64, 64, 1), (64, 128, 1)],
                              bundle, device="cpu", **F32)
    both = _cuda_cpu(bundle, tmp_path / "both.flowpak",
                     stems=("exported_0", "exported_1"))
    sm = aot.load_serving(both, device="cpu")
    assert sm.shapes == [(1, 64, 64), (1, 64, 128)]
    assert np.array_equal(sm(*pair), aot.load_serving(bundle)(*pair))


def test_cli_serve_device(tmp_path, pair, single, capsys):
    """``cli serve --device cpu`` serves a ``cuda,cpu`` artifact's CPU
    graph; without ``--device`` it asks for the card."""
    path, _ = single
    both = _cuda_cpu(path, tmp_path / "both.flowpak")
    a_path, b_path = tmp_path / "a.png", tmp_path / "b.png"
    for img, p in zip(pair, (a_path, b_path)):
        write_image((img[0] * 255).astype(np.uint8), str(p))
    argv = ["serve", "--artifact", str(both), "--input_a", str(a_path),
            "--input_b", str(b_path), "--out", str(tmp_path / "out")]
    assert cli.main([*argv, "--device", "cpu"]) == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["flow_shape"] == [H, W, 2]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="exported for cuda"):
            cli.main(argv)
