"""The torch port's main path through its CLI, on the CPU, and its
independence from JAX."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from flownet2_tf_tpu.models.registry import get_model as jax_model  # noqa: E402
from flownet2_tf_tpu.training import warmstart as jws  # noqa: E402
from flownet2_tf_tpu_torch import cli  # noqa: E402
from flownet2_tf_tpu_torch.models.registry import get_model  # noqa: E402
from flownet2_tf_tpu_torch.training import infer, warmstart  # noqa: E402
from flownet2_tf_tpu_torch.utils import flowlib  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SAMPLES = os.path.join(ROOT, "data", "samples")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


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
