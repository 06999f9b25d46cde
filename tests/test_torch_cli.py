"""The torch port's main path through its CLI, on the CPU, and its
independence from JAX."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_layouts as layouts  # noqa: E402
import jax  # noqa: E402

from flownet2_tf_tpu import cli as jcli  # noqa: E402
from flownet2_tf_tpu.models.registry import get_model as jax_model  # noqa: E402
from flownet2_tf_tpu.utils import flowlib as jflowlib  # noqa: E402
from flownet2_tf_tpu.training import warmstart as jws  # noqa: E402
from flownet2_tf_tpu_torch import cli  # noqa: E402
from flownet2_tf_tpu_torch.models.registry import get_model  # noqa: E402
from flownet2_tf_tpu_torch.training import infer, warmstart  # noqa: E402
from flownet2_tf_tpu_torch.utils import flowlib  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SAMPLES = os.path.join(ROOT, "data", "samples")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

@pytest.fixture(autouse=True)
def _drop_test_files(tmp_path):
    """Checkpoints and training runs here are 150-650 MB each: delete what each test wrote when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)



def _test_args(tmp_path, ckpt, device):
    return [
        "test", "--model", "2", "--ckpt", str(ckpt), "--device", device,
        "--input_a", os.path.join(SAMPLES, "0img0.ppm"),
        "--input_b", os.path.join(SAMPLES, "0img1.ppm"),
        "--out", str(tmp_path),
    ]


def test_cli_flownet2_matches_golden(tmp_path, capsys):
    """FlowNet2(PRNGKey(0)) through the port's CLI on the bundled pair
    reproduces the JAX package's committed golden."""
    params = jax.jit(jax_model("2").init)(jax.random.PRNGKey(0))
    ckpt = tmp_path / "flownet2.npz"
    np.savez(ckpt, **jws.flatten(jax.device_get(params)))
    del params

    rc = cli.main(_test_args(tmp_path, ckpt, "cpu"))
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["model"] == "2" and line["flow_shape"] == [192, 256, 2]

    flow = flowlib.read_flow(tmp_path / "0img0_flow.flo")
    assert (tmp_path / "0img0_flow.png").exists()
    golden = np.load(os.path.join(GOLDEN, "flownet_2_seed0.npz"))["flow"]
    assert flow.shape == golden.shape == (192, 256, 2)
    # tests/test_golden.py:96-99: the stack amplifies at random init
    scale = max(1.0, float(np.abs(golden).mean()))
    np.testing.assert_allclose(flow, golden, rtol=1e-3, atol=5e-3 * scale)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import flownet2_tf_tpu_torch, flownet2_tf_tpu_torch.cli\n"
        "import flownet2_tf_tpu_torch.training.infer\n"
        "import flownet2_tf_tpu_torch.models.stacks\n"
        "import flownet2_tf_tpu_torch.ops.cuda.correlation_kernel\n"
        "import flownet2_tf_tpu_torch.training.loop\n"
        "import flownet2_tf_tpu_torch.data.loader\n"
        "import flownet2_tf_tpu_torch.data.augmentation\n"
        "import flownet2_tf_tpu_torch.data.dataset_configs\n"
        "import flownet2_tf_tpu_torch.utils.tensorboard\n"
        "import flownet2_tf_tpu_torch.data.tfrecord\n"
        "import flownet2_tf_tpu_torch.utils.png16\n"
        "import flownet2_tf_tpu_torch.tools.make_tfrecords\n"
        "import flownet2_tf_tpu_torch.tools.aot, flownet2_tf_tpu_torch.net\n"
        "import flownet2_tf_tpu_torch.tools.bench\n"
        "import flownet2_tf_tpu_torch.tools.benchlib\n"
        "import flownet2_tf_tpu_torch.tools.profiler\n"
        "import flownet2_tf_tpu_torch.tools.determinism_ab\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'flownet2_tf_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_runs_on_the_cpu_without_triton_or_nvcc(tmp_path):
    """On a machine with neither ``triton`` nor ``nvcc``, every port module
    imports and a CPU correlation returns the plain version's result: no
    module imports triton or builds a kernel before a CUDA launch."""
    build_dir = os.path.join(ROOT, "flownet2_tf_tpu_torch", "_build")

    def listing():
        return sorted(os.listdir(build_dir)) if os.path.isdir(build_dir) else None

    before = listing()
    code = (
        "import sys\n"
        "sys.modules['triton'] = None  # import triton raises ImportError\n"
        "import numpy as np, torch\n"
        "import flownet2_tf_tpu_torch, flownet2_tf_tpu_torch.cli\n"
        "import flownet2_tf_tpu_torch.training.infer\n"
        "import flownet2_tf_tpu_torch.models.stacks\n"
        "import flownet2_tf_tpu_torch.ops.cuda.correlation_kernel as ck\n"
        "import flownet2_tf_tpu_torch.training.loop\n"
        "import flownet2_tf_tpu_torch.data.loader\n"
        "import flownet2_tf_tpu_torch.data.augmentation\n"
        "import flownet2_tf_tpu_torch.data.dataset_configs\n"
        "import flownet2_tf_tpu_torch.utils.tensorboard\n"
        "import flownet2_tf_tpu_torch.data.tfrecord\n"
        "import flownet2_tf_tpu_torch.utils.png16\n"
        "import flownet2_tf_tpu_torch.tools.make_tfrecords\n"
        "import flownet2_tf_tpu_torch.tools.aot, flownet2_tf_tpu_torch.net\n"
        "import flownet2_tf_tpu_torch.tools.bench\n"
        "import flownet2_tf_tpu_torch.tools.benchlib\n"
        "import flownet2_tf_tpu_torch.tools.profiler\n"
        "import flownet2_tf_tpu_torch.tools.determinism_ab\n"
        "from flownet2_tf_tpu_torch.ops import correlation as tc\n"
        "from flownet2_tf_tpu_torch.ops.cuda import _build\n"
        "rng = np.random.RandomState(0)\n"
        "a, b = (torch.from_numpy(rng.randn(1, 5, 9, 12).astype(np.float32))\n"
        "        for _ in range(2))\n"
        "got = tc.correlation(a, b, 1, 4, 1, 2, 4)\n"
        "want = tc._correlation_oracle(a, b, 1, 4, 1, 2, 4)\n"
        "assert got.shape == (1, 5, 9, 25) and torch.equal(got, want)\n"
        "assert ck.LAUNCHES == 0 and not _build._loaded, _build._loaded\n"
        "assert sys.modules['triton'] is None\n"
        "print('ok')\n"
    )
    no_tools = tmp_path / "bin"
    no_tools.mkdir()
    env = dict(os.environ, PATH=str(no_tools), CUDA_HOME=str(no_tools))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120, env=env,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    assert listing() == before  # nothing was built


def test_cuda_device_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        cli.main(_test_args(tmp_path, tmp_path / "unused.npz", "cuda"))
    assert not (tmp_path / "0img0_flow.flo").exists()


def test_compute_dtype_other_than_f32_is_refused():
    """Only float32 and bfloat16 run: float16 is refused by the CLI and by
    the runtime. bfloat16 runs (tests/test_torch_bf16.py holds its
    numbers against the JAX package)."""
    with pytest.raises(SystemExit):
        cli.main(["test", "--input_a", "a", "--input_b", "b",
                  "--compute_dtype", "float16"])
    with pytest.raises(ValueError, match="float32"):
        infer.infer_flow("s", {}, np.zeros((64, 64, 3)), np.zeros((64, 64, 3)),
                         device="cpu", compute_dtype="float16")
    model = get_model("s").build("cpu")
    tree = warmstart.random_jax_params(model, seed=0)
    flow = infer.infer_flow("s", tree, np.zeros((64, 64, 3)),
                            np.zeros((64, 64, 3)), device="cpu",
                            compute_dtype="bfloat16")
    assert flow.dtype == np.float32 and flow.shape == (64, 64, 2)
    assert np.isfinite(flow).all()


def test_pad_to_multiple_edge_pads_and_crops(rng):
    x = torch.from_numpy(rng.rand(1, 50, 70, 3).astype(np.float32))
    padded, h, w = infer.pad_to_multiple(x)
    assert (h, w) == (50, 70) and padded.shape == (1, 64, 128, 3)
    want = np.pad(x.numpy(), ((0, 0), (0, 14), (0, 58), (0, 0)), mode="edge")
    np.testing.assert_array_equal(padded.numpy(), want)


@pytest.fixture(scope="module")
def ckpt_s(tmp_path_factory):
    """FlowNetS(PRNGKey(0)) from the JAX package as a JAX-layout .npz, one
    for the module (150 MB)."""
    params = jax.device_get(jax_model("s").init(jax.random.PRNGKey(0)))
    path = tmp_path_factory.mktemp("ckpt") / "ck_s.npz"
    np.savez(path, **jws.flatten(params))
    yield str(path)
    os.remove(path)


@pytest.fixture
def run_dir(tmp_path):
    """A training log dir, removed after the test: FlowNetS checkpoints
    with their Adam state take about 0.5 GB each."""
    yield tmp_path / "run"
    shutil.rmtree(tmp_path / "run", ignore_errors=True)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _eval_both(capsys, argv):
    """``cli eval argv`` through the JAX package's CLI and the port's (on
    the CPU); returns both JSON lines."""
    assert jcli.main(["eval", *argv]) == 0
    theirs = _last_json(capsys)
    assert cli.main(["eval", *argv, "--device", "cpu"]) == 0
    return _last_json(capsys), theirs


def test_cli_eval_synthetic_matches_jax(ckpt_s, capsys):
    mine, theirs = _eval_both(capsys, [
        "--model", "s", "--ckpt", ckpt_s, "--dataset", "synthetic",
        "--limit", "2"])
    assert mine.keys() == theirs.keys() == {"model", "dataset", "pairs", "aee"}
    assert mine["pairs"] == theirs["pairs"] == 2
    assert mine["aee"] == pytest.approx(theirs["aee"], rel=1e-4)


# dataset name -> (layout writer, extra eval flags); mixed frame sizes
# where the layout has them (two %64 buckets, sizes off the grid)
EVAL_LAYOUTS = {
    "sintel": (lambda r: layouts.sintel(r, sizes=((50, 70), (64, 64))),
               ["--eval_batch", "2", "--render_pass", "final"]),
    "kitti": (lambda r: layouts.kitti(r, sizes=((50, 70), (60, 64),
                                                (64, 128))),
              ["--eval_batch", "2"]),
    "chairs": (lambda r: layouts.chairs(r, n=3, h=40, w=56), []),
    "things": (lambda r: layouts.things_full(r, h=40, w=56), []),
    "sdhom": (lambda r: layouts.sdhom(r, h=40, w=56, ext=".pfm"), []),
}


@pytest.mark.parametrize("dataset", sorted(EVAL_LAYOUTS))
def test_cli_eval_datasets_match_jax(tmp_path, ckpt_s, capsys, dataset):
    write, extra = EVAL_LAYOUTS[dataset]
    root = write(str(tmp_path / dataset))
    mine, theirs = _eval_both(capsys, [
        "--model", "s", "--ckpt", ckpt_s, "--dataset", dataset,
        "--data_root", root, *extra])
    assert mine.keys() == theirs.keys()
    assert mine["pairs"] == theirs["pairs"] >= 2
    assert mine["aee"] == pytest.approx(theirs["aee"], rel=1e-4)


def test_cli_eval_save_outputs_like_jax(tmp_path, ckpt_s, capsys):
    """--save_outputs on a KITTI layout: the JAX package's file names, a
    .flo near the JAX one, KITTI PNGs that read back in both packages,
    and the AEE of the on-device path (host-side, no eps)."""
    root = layouts.kitti(str(tmp_path / "kitti"),
                         sizes=((50, 70), (50, 70), (64, 64)))
    base = ["--model", "s", "--ckpt", ckpt_s, "--dataset", "kitti",
            "--data_root", root, "--eval_batch", "2"]
    mine, theirs = _eval_both(capsys, [*base, "--save_outputs",
                                       str(tmp_path / "out")])
    assert mine.keys() == theirs.keys()
    assert mine["outputs"] == theirs["outputs"] == str(tmp_path / "out")
    names = sorted(os.listdir(tmp_path / "out"))
    assert names == sorted(f"{i:06d}_flow{ext}" for i in range(3)
                           for ext in (".flo", ".png", "_kitti.png"))
    assert mine["aee"] == pytest.approx(theirs["aee"], rel=1e-4)
    assert cli.main(["eval", *base, "--device", "cpu"]) == 0
    assert _last_json(capsys)["aee"] == pytest.approx(mine["aee"], rel=1e-4)

    # the port's outputs (written last) against the JAX CLI's flows
    jax_flows = [jflowlib.read_flow(tmp_path / "out" / f"{i:06d}_flow.flo")
                 for i in range(3)]
    assert cli.main(["eval", *base, "--device", "cpu", "--save_outputs",
                     str(tmp_path / "port")]) == 0
    for i, want in enumerate(jax_flows):
        stem = tmp_path / "port" / f"{i:06d}_flow"
        flow = flowlib.read_flow(str(stem) + ".flo")
        scale = max(1.0, float(np.abs(want).mean()))
        np.testing.assert_allclose(flow, want, rtol=1e-3, atol=1e-3 * scale)
        kitti = flowlib.read_flow(str(stem) + "_kitti.png")
        np.testing.assert_array_equal(
            kitti, jflowlib.read_kitti_png_flow(str(stem) + "_kitti.png"))
        assert kitti.shape == flow.shape[:2] + (3,) and kitti[..., 2].all()
        assert np.abs(kitti[..., :2] - flow).max() <= 1 / 64


# dataset -> layout writer; every training dataset's raw layout
TRAIN_LAYOUTS = {
    "flying_chairs": lambda r: layouts.chairs(r, n=40, h=40, w=56),
    "flying_things_3d": lambda r: layouts.things_full(r, h=40, w=56),
    "chairs_sdhom": lambda r: layouts.sdhom(r, h=40, w=56),
    "sintel": lambda r: layouts.sintel(r, sizes=((40, 56),)),
}


def _train_dataset_args(run_dir, dataset, *extra):
    return ["train", "--model", "s", "--dataset", dataset, "--device", "cpu",
            "--batch_size", "2", "--max_steps", "2", "--schedule", "short",
            "--log_every", "1", "--crop_height", "64", "--crop_width", "64",
            "--log_dir", str(run_dir), "--compute_dtype", "float32",
            *extra]


def _train_records(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("dataset", sorted(TRAIN_LAYOUTS))
def test_cli_train_on_a_raw_layout(tmp_path, run_dir, capsys, dataset):
    root = TRAIN_LAYOUTS[dataset](str(tmp_path / "data"))
    rc = cli.main(_train_dataset_args(run_dir, dataset, "--data_root", root,
                                      "--eval_every", "2"))
    assert rc == 0
    out = capsys.readouterr().out
    recs = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    steps = [r for r in recs if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in steps)
    evals = [r for r in recs if "val_epe" in r]
    if dataset == "sintel":  # no raw-layout validate split: no eval
        assert "no validate split" in out and not evals
    else:
        assert [r["step"] for r in evals] == [2]
    assert os.listdir(run_dir / "checkpoints") == ["2"]


def test_cli_train_on_tfrecords_feeds_uint8(tmp_path, run_dir, capsys,
                                           monkeypatch):
    from flownet2_tf_tpu_torch.training import loop

    root = layouts.chairs(str(tmp_path / "chairs"), n=4, h=40, w=56)
    rec = tmp_path / "train.tfrecords"
    assert cli.main(["make-tfrecords", "--data_root", root,
                     "--out", str(rec)]) == 0
    assert json.loads(capsys.readouterr().out) == {
        "train": 4, "val": 0, "out": str(rec)}
    seen = []
    real = loop._images_to_float

    def spy(x):
        seen.append(x.dtype)
        return real(x)

    monkeypatch.setattr(loop, "_images_to_float", spy)
    rc = cli.main(_train_dataset_args(
        run_dir, "flying_chairs", "--tfrecords_train", str(rec),
        "--image_height", "40", "--image_width", "56",
        "--data_root", str(tmp_path / "missing")))
    assert rc == 0
    assert [r["step"] for r in _train_records(capsys)] == [1, 2]
    assert seen == [torch.uint8] * 4  # a and b, two steps


def test_cli_train_without_data_raises(tmp_path, run_dir):
    with pytest.raises(FileNotFoundError, match="no data for flying_chairs"):
        cli.main(_train_dataset_args(
            run_dir, "chairs", "--data_root", str(tmp_path / "missing")))
    with pytest.raises(ValueError, match="eval-only"):
        cli.main(_train_dataset_args(run_dir, "kitti"))


# ---------------------------------------------------------------------------
# The warp flags (--warp_res, --half_res_warp)
# ---------------------------------------------------------------------------

def _jax_tree_npz(tmp_path_factory, name):
    params = jax.device_get(jax.jit(jax_model(name).init)(
        jax.random.PRNGKey(0)))
    path = tmp_path_factory.mktemp("ckpt") / f"ck_{name}.npz"
    np.savez(path, **jws.flatten(params))
    return str(path)


@pytest.fixture(scope="module")
def ckpt_cs(tmp_path_factory):
    """FlowNetCS(PRNGKey(0)) from the JAX package as a .npz (300 MB)."""
    path = _jax_tree_npz(tmp_path_factory, "cs")
    yield path
    os.remove(path)


def _flow_close(got, want):
    """tests/test_golden.py:96-99's full-res flow tolerance: the stack
    amplifies at random init."""
    scale = max(1.0, float(np.abs(want).mean()))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-3 * scale)


def _mean_epe(a, b):
    return float(np.sqrt(((a - b) ** 2).sum(-1)).mean())


def test_cli_test_warp_res_matches_jax(tmp_path, ckpt_cs, capsys,
                                       monkeypatch):
    """``cli test --model cs --warp_res 2`` against the JAX CLI with the
    same flag; ``--half_res_warp`` is ``--warp_res 2``; the flag moves the
    flow."""
    # the JAX CLI applies its flag through os.environ for the rest of the
    # process: set it here first, so that teardown removes it
    monkeypatch.setenv("FLOWNET2_TPU_WARP_RES", "2")
    args = ["test", "--model", "cs", "--ckpt", ckpt_cs, "--no_image",
            "--input_a", os.path.join(SAMPLES, "0img0.ppm"),
            "--input_b", os.path.join(SAMPLES, "0img1.ppm")]
    assert jcli.main([*args, "--out", str(tmp_path / "jax"),
                      "--warp_res", "2"]) == 0
    want = jflowlib.read_flow(tmp_path / "jax" / "0img0_flow.flo")
    flows = {}
    for key, flags in {"k2": ["--warp_res", "2"],
                       "half": ["--half_res_warp"],
                       "k1": ["--warp_res", "1"]}.items():
        out = tmp_path / key
        assert cli.main([*args, "--out", str(out), *flags,
                         "--device", "cpu"]) == 0
        flows[key] = flowlib.read_flow(out / "0img0_flow.flo")
    capsys.readouterr()
    _flow_close(flows["k2"], want)
    np.testing.assert_array_equal(flows["half"], flows["k2"])
    assert _mean_epe(flows["k1"], flows["k2"]) > 1e-2


def test_cli_test_warp_flag_leaves_a_model_without_warps(tmp_path, ckpt_s,
                                                         capsys):
    args = ["test", "--model", "s", "--ckpt", ckpt_s, "--no_image",
            "--device", "cpu",
            "--input_a", os.path.join(SAMPLES, "0img0.ppm"),
            "--input_b", os.path.join(SAMPLES, "0img1.ppm")]
    assert cli.main([*args, "--out", str(tmp_path / "plain")]) == 0
    assert cli.main([*args, "--out", str(tmp_path / "k2"),
                     "--warp_res", "2"]) == 0
    capsys.readouterr()
    np.testing.assert_array_equal(
        flowlib.read_flow(tmp_path / "k2" / "0img0_flow.flo"),
        flowlib.read_flow(tmp_path / "plain" / "0img0_flow.flo"))


@pytest.fixture
def ckpt_2(tmp_path_factory):
    """FlowNet2(PRNGKey(0)) from the JAX package as a .npz (650 MB), for
    one test."""
    path = _jax_tree_npz(tmp_path_factory, "2")
    yield path
    os.remove(path)


def test_cli_eval_warp_res_matches_jax(ckpt_2, capsys, monkeypatch):
    monkeypatch.setenv("FLOWNET2_TPU_WARP_RES", "2")
    argv = ["--model", "2", "--ckpt", ckpt_2, "--dataset", "synthetic",
            "--limit", "2", "--warp_res", "2"]
    mine, theirs = _eval_both(capsys, argv)
    assert mine.keys() == theirs.keys() and mine["pairs"] == 2
    assert mine["aee"] == pytest.approx(theirs["aee"], rel=1e-3)
    assert cli.main(["eval", *argv[:-2], "--device", "cpu"]) == 0
    exact = _last_json(capsys)["aee"]
    assert abs(exact - mine["aee"]) > 1e-4 * abs(exact)


def test_cli_train_warp_res_matches_jax(tmp_path, ckpt_cs, capsys,
                                        monkeypatch):
    """``cli train --model cs --warp_res 2 --synthetic``, 2 steps from the
    same weights (warm-started from one .npz, FlowNetC frozen by
    default, no augmentation): the port logs the JAX CLI's losses."""
    monkeypatch.setenv("FLOWNET2_TPU_WARP_RES", "2")
    argv = ["train", "--model", "cs", "--synthetic", "--synthetic_size", "4",
            "--synthetic_height", "64", "--synthetic_width", "64",
            "--batch_size", "2", "--max_steps", "2", "--schedule", "short",
            "--log_every", "1", "--no_augment", "--compute_dtype",
            "float32", "--warm_start", f"{ckpt_cs}::", "--warp_res", "2"]
    # each run's checkpoint (about 0.5 GB) is removed before the next run
    try:
        assert jcli.main([*argv, "--log_dir", str(tmp_path / "jax")]) == 0
        theirs = _train_records(capsys)
    finally:
        shutil.rmtree(tmp_path / "jax", ignore_errors=True)
    try:
        assert cli.main([*argv, "--log_dir", str(tmp_path / "port"),
                         "--device", "cpu"]) == 0
        mine = _train_records(capsys)
    finally:
        shutil.rmtree(tmp_path / "port", ignore_errors=True)
    theirs = [r for r in theirs if "loss" in r]
    mine = [r for r in mine if "loss" in r]
    assert [r["step"] for r in mine] == [r["step"] for r in theirs] == [1, 2]
    # tests/test_torch_train.py's loss tolerance
    np.testing.assert_allclose([r["loss"] for r in mine],
                               [r["loss"] for r in theirs], rtol=1e-5)

