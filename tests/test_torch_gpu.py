"""The torch port's CUDA kernels on the card.

Every test here needs a CUDA device, is marked ``gpu`` and skips without
one. The file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

(``--noconftest``: tests/conftest.py sets up JAX for the other files.)
"""

import pytest

torch = pytest.importorskip("torch")

from flownet2_tf_tpu_torch.models import common, flownet_c  # noqa: E402
from flownet2_tf_tpu_torch.ops import correlation as tcorr  # noqa: E402
from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel  # noqa: E402
from flownet2_tf_tpu_torch.training import infer, warmstart  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize(
    "shape,d,s2,dtype",
    [
        ((1, 56, 128, 256), 20, 2, torch.float32),  # FlowNet2 at 448x1024
        ((1, 56, 128, 256), 20, 2, torch.bfloat16),
        ((1, 48, 160, 256), 20, 2, torch.float32),  # at KITTI's 384x1280
        ((1, 48, 160, 256), 20, 2, torch.bfloat16),
        ((2, 8, 12, 64), 4, 1, torch.float32),  # off the TPU tiling
        ((1, 12, 20, 96), 4, 2, torch.float32),
        ((1, 5, 7, 33), 6, 3, torch.float32),  # D=5, C not a warp multiple
        ((1, 4, 6, 40), 36, 2, torch.float32),  # D=37 > 32
        ((8, 40, 56, 256), 20, 2, torch.float32),  # FlowNetC conv3, chairs b8
        ((8, 40, 56, 256), 20, 2, torch.bfloat16),
        # W not a multiple of the x tile (s2 * 32 pixels), C = 40
        ((1, 12, 100, 40), 20, 2, torch.float32),
        ((1, 12, 100, 40), 20, 2, torch.bfloat16),
        # s2 = 1, N = 2 with an odd H (rows tiled in pairs)
        ((2, 7, 40, 64), 8, 1, torch.float32),
        ((2, 7, 40, 64), 8, 1, torch.bfloat16),
        # s2 = 3; C = 33: bf16 rows not 16-byte aligned
        ((2, 9, 50, 33), 6, 3, torch.float32),
        ((2, 9, 50, 33), 6, 3, torch.bfloat16),
        ((1, 1, 9, 16), 4, 2, torch.bfloat16),  # H = 1: one row per block
    ],
)
def test_kernel_matches_plain_version(gen, shape, d, s2, dtype):
    a = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    b = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    before = correlation_kernel.LAUNCHES
    got = tcorr.correlation(a, b, 1, d, 1, s2, d)
    assert correlation_kernel.LAUNCHES == before + 1
    again = tcorr.correlation(a, b, 1, d, 1, s2, d)
    want = tcorr._correlation_oracle(a, b, 1, d, 1, s2, d)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    # the same (bf16-rounded) values summed in another f32 order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # each output element summed in a fixed order and written once
    assert torch.equal(got, again)


def test_out_of_family_raises_on_cuda(gen):
    a = torch.zeros(1, 8, 8, 16, device="cuda")
    with pytest.raises(ValueError, match="CUDA kernel covers"):
        tcorr.correlation(a, a, kernel_size=3, max_displacement=4,
                          stride_1=1, stride_2=2, pad=4)


def test_wrapper_rejects_what_the_kernel_does_not_take(gen):
    a = torch.zeros(1, 8, 8, 16, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        correlation_kernel.correlation_cuda(a.transpose(1, 2), a, 4, 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        correlation_kernel.correlation_cuda(a.half(), a.half(), 4, 2)
    with pytest.raises(ValueError, match="one CUDA device"):
        correlation_kernel.correlation_cuda(a, a.cpu(), 4, 2)


def _plain_grads(a, b, g, d, s2):
    x, y = a.detach().requires_grad_(), b.detach().requires_grad_()
    out = tcorr._correlation_oracle(x, y, 1, d, 1, s2, d)
    return torch.autograd.grad(out, (x, y), g)


@pytest.mark.parametrize(
    "shape,d,s2,dtype",
    [
        ((8, 40, 56, 256), 20, 2, torch.float32),  # FlowNetC conv3, chairs b8
        ((8, 40, 56, 256), 20, 2, torch.bfloat16),
        ((2, 8, 12, 64), 4, 1, torch.float32),  # off the TPU tiling
        ((1, 12, 20, 96), 4, 2, torch.float32),
        ((1, 5, 7, 33), 6, 3, torch.float32),  # C not a warp multiple
        ((1, 4, 6, 300), 36, 2, torch.float32),  # D=37 > 32, C > 256
        ((1, 4, 6, 300), 36, 2, torch.bfloat16),
        ((1, 9, 9, 40), 22, 1, torch.float32),  # D*D=2025
        ((1, 9, 9, 40), 22, 1, torch.bfloat16),
        # W not a multiple of the x tile (s2 * 32 pixels), C = 40
        ((1, 12, 100, 40), 20, 2, torch.float32),
        ((1, 12, 100, 40), 20, 2, torch.bfloat16),
        # s2 = 1, N = 2 with an odd H (rows tiled by four)
        ((2, 7, 40, 64), 8, 1, torch.float32),
        ((2, 7, 40, 64), 8, 1, torch.bfloat16),
        # s2 = 3; C = 33: rows not 16-byte aligned
        ((2, 9, 50, 33), 6, 3, torch.float32),
        ((2, 9, 50, 33), 6, 3, torch.bfloat16),
        # H = 1: one row per block
        ((1, 1, 9, 16), 4, 2, torch.float32),
        ((1, 1, 9, 16), 4, 2, torch.bfloat16),
    ],
)
def test_backward_kernel_matches_plain_version(gen, shape, d, s2, dtype):
    a = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    b = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    dd = (2 * (d // s2) + 1) ** 2
    g = torch.randn(shape[:3] + (dd,), generator=gen, device="cuda")
    x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
    before = correlation_kernel.BWD_LAUNCHES
    tcorr.correlation(x, y, 1, d, 1, s2, d).backward(g)
    assert correlation_kernel.BWD_LAUNCHES == before + 1
    again = correlation_kernel.correlation_cuda_backward(g, a, b, d, s2)
    want = _plain_grads(a, b, g, d, s2)
    torch.cuda.synchronize()
    # f32: sums in another order; bf16: both round an f32 sum once
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2.0 ** -7, atol=1e-5))
    for got, rerun, ref in zip((x.grad, y.grad), again, want):
        assert got.dtype == dtype and got.shape == a.shape
        # each element summed in a fixed order, no atomics: bitwise
        assert torch.equal(got, rerun)
        torch.testing.assert_close(got.float(), ref.float(), **tol)


def test_backward_wrapper_rejects_what_the_kernel_does_not_take(gen):
    a = torch.zeros(1, 8, 8, 16, device="cuda")
    g = torch.zeros(1, 8, 8, 25, device="cuda")
    with pytest.raises(ValueError, match="gradient"):
        correlation_kernel.correlation_cuda_backward(g[..., :24], a, a, 4, 2)
    with pytest.raises(ValueError, match="gradient"):
        correlation_kernel.correlation_cuda_backward(g.cpu(), a, a, 4, 2)
    with pytest.raises(ValueError, match="contiguous"):
        correlation_kernel.correlation_cuda_backward(
            g, a.transpose(1, 2), a, 4, 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        correlation_kernel.correlation_cuda_backward(g, a.half(), a.half(),
                                                     4, 2)


def test_flownet_c_loss_gradient_on_card_matches_cpu(gen):
    """One FlowNetC multi-scale loss gradient, card vs CPU, same weights:
    relative L2 error per leaf <= 1e-3 (f32, TF32 off; cuDNN's backward
    algorithms sum in other orders)."""
    model = flownet_c.FlowNetC()
    tree = warmstart.random_jax_params(model, seed=0)
    images = torch.rand((2, 2, 64, 128, 3), generator=gen, device="cuda")
    flow = torch.randn((2, 64, 128, 2), generator=gen, device="cuda") * 3
    grads = {}
    for device in ("cuda", "cpu"):
        m = infer.load_model("c", tree, device).train()
        inputs = {"input_a": images[0].to(device),
                  "input_b": images[1].to(device)}
        with common.f32_policy():
            flownet_c.loss(flow.to(device), m(inputs)).backward()
        grads[device] = {k: p.grad.cpu() for k, p in m.named_parameters()}
    for k, want in grads["cpu"].items():
        err = float((grads["cuda"][k] - want).norm() / want.norm())
        assert err <= 1e-3, (k, err)


def test_flownet_c_on_card_matches_cpu(gen):
    model = flownet_c.FlowNetC()
    tree = warmstart.random_jax_params(model, seed=0)
    cpu = infer.load_model("c", tree, "cpu")
    card = infer.load_model("c", tree, "cuda")
    images = torch.rand((2, 1, 64, 128, 3), generator=gen, device="cuda")
    before = correlation_kernel.LAUNCHES
    got = infer.forward_flow(card, images[0], images[1])
    assert correlation_kernel.LAUNCHES == before + 1
    want = infer.forward_flow(cpu, images[0].cpu(), images[1].cpu())
    scale = max(1.0, float(want.abs().mean()))
    # tests/test_golden.py:96-99
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=5e-3 * scale)


def _epe(a, b):
    return float(((a - b) ** 2).sum(-1).sqrt().mean())


def test_flownet_c_bf16_on_card_matches_cpu(gen):
    """The bf16 policy on the card: one forward launch on bf16 features,
    f32 flow, as far from the f32 CPU flow as the bf16 CPU path is (within
    1.5x: cuDNN sums and rounds in other places)."""
    model = flownet_c.FlowNetC()
    tree = warmstart.random_jax_params(model, seed=0)
    card = common.cast_params_for_inference(infer.load_model("c", tree, "cuda"))
    cpu = infer.load_model("c", tree, "cpu")
    images = torch.rand((2, 2, 64, 128, 3), generator=gen, device="cuda")
    before = dict(correlation_kernel.LAUNCHES_BY_DTYPE)
    got = infer.forward_flow(card, images[0], images[1], torch.bfloat16)
    assert correlation_kernel.LAUNCHES_BY_DTYPE["bfloat16"] == \
        before["bfloat16"] + 1
    assert correlation_kernel.LAUNCHES_BY_DTYPE["float32"] == before["float32"]
    a, b = images[0].cpu(), images[1].cpu()
    want = infer.forward_flow(cpu, a, b)
    cpu_bf16 = infer.forward_flow(cpu, a, b, torch.bfloat16)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _epe(got.cpu(), want) <= 1.5 * _epe(cpu_bf16, want)


def test_flownet_c_bf16_loss_gradient_on_card(gen):
    """A bf16 FlowNetC loss gradient on the card: one backward launch on
    bf16 features, f32 gradients on the f32 masters, all finite, and
    their distance to the f32 CPU gradients within 1.5x the bf16 CPU
    gradients' (relative L2 over all leaves)."""
    model = flownet_c.FlowNetC()
    tree = warmstart.random_jax_params(model, seed=0)
    images = torch.rand((2, 2, 64, 128, 3), generator=gen, device="cuda")
    flow = torch.randn((2, 64, 128, 2), generator=gen, device="cuda") * 3
    grads = {}
    for device, cd in (("cuda", torch.bfloat16), ("cpu", torch.bfloat16),
                       ("cpu", torch.float32)):
        m = infer.load_model("c", tree, device).train()
        inputs = {"input_a": images[0].to(device),
                  "input_b": images[1].to(device)}
        before = correlation_kernel.BWD_LAUNCHES_BY_DTYPE["bfloat16"]
        with common.f32_policy():
            flownet_c.loss(flow.to(device), m(inputs, cd)).backward()
        if device == "cuda":
            assert correlation_kernel.BWD_LAUNCHES_BY_DTYPE["bfloat16"] == \
                before + 1
        assert all(p.grad.dtype == torch.float32 for p in m.parameters())
        grads[device, cd] = torch.cat([p.grad.cpu().ravel()
                                       for p in m.parameters()])
    ref = grads["cpu", torch.float32]
    card = grads["cuda", torch.bfloat16]
    assert torch.isfinite(card).all()
    rel = lambda g: float((g - ref).norm() / ref.norm())  # noqa: E731
    assert rel(card) <= 1.5 * rel(grads["cpu", torch.bfloat16])


def test_images_to_float_on_card_is_a_true_division(gen):
    """uint8 images become x / 255 on the card by a true division, bitwise
    what the host readers compute (not a multiply by 1/255)."""
    import numpy as np

    from flownet2_tf_tpu_torch.training.loop import _images_to_float

    got = _images_to_float(torch.arange(256, dtype=torch.uint8,
                                        device="cuda"))
    want = np.arange(256, dtype=np.float32) / 255.0
    assert got.dtype == torch.float32
    assert np.array_equal(got.cpu().numpy(), want)


def test_cli_eval_on_card_matches_cpu(gen, tmp_path, capsys):
    """``cli eval --model c`` on a tiny Sintel layout (two %64 buckets, one
    size off the grid): one forward launch per batch, and the card's AEE
    within 1e-2 px of the CPU path's."""
    import json

    import _torch_layouts as layouts
    import numpy as np

    from flownet2_tf_tpu_torch import cli

    root = layouts.sintel(str(tmp_path / "sintel"),
                          sizes=((50, 70), (64, 64)))
    tree = warmstart.random_jax_params(flownet_c.FlowNetC(), seed=0)
    ckpt = tmp_path / "c.npz"
    np.savez(ckpt, **warmstart.flatten(tree))
    argv = ["eval", "--model", "c", "--ckpt", str(ckpt), "--dataset",
            "sintel", "--data_root", root, "--eval_batch", "2"]
    aee = {}
    for device in ("cuda", "cpu"):
        before = correlation_kernel.LAUNCHES
        assert cli.main([*argv, "--device", device]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["pairs"] == 4
        aee[device] = line["aee"]
        launches = correlation_kernel.LAUNCHES - before
        assert launches == (2 if device == "cuda" else 0)
    assert np.isfinite(aee["cuda"])
    assert abs(aee["cuda"] - aee["cpu"]) <= 1e-2


@pytest.mark.parametrize("name,warp_mode", [("c", "full"), ("2", "full"),
                                            ("2", "half")])
def test_f32_artifact_on_card_matches_eager(gen, tmp_path, name, warp_mode):
    """An f32 ``.flowpak`` exported and served on the card gives the eager
    forward's flow (mean EPE <= 1e-4 px) even with TF32 allowed by the
    caller, and launches the correlation forward once per served call.

    Both sides run cuDNN's deterministic algorithms with no flag set by
    the caller: ``f32_policy`` sets them (its default deconv algorithms
    sum with atomics, so two runs of one forward would differ in the
    last bits)."""
    import numpy as np

    from flownet2_tf_tpu_torch.models.registry import get_model
    from flownet2_tf_tpu_torch.tools import aot

    spec = get_model(name)
    tree = warmstart.random_jax_params(spec.build("cpu"), seed=0)
    path = tmp_path / f"{name}.flowpak"
    meta = aot.export_serving(name, tree, 128, 192, path,
                              compute_dtype="float32", warp_mode=warp_mode,
                              device="cuda")
    assert meta["platforms"] == ["cuda"]
    sm = aot.load_serving(path)
    a, b = (torch.rand((1, 128, 192, 3), generator=gen, device="cuda")
            for _ in range(2))
    model = warmstart.load_jax_params(
        spec.build("cuda", warp_res=aot.warp_res_of(warp_mode)), tree)
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic)
    try:
        want = infer.forward_flow(model, a, b, torch.float32)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        before = dict(correlation_kernel.LAUNCHES_BY_DTYPE)
        flows = [sm(a, b) for _ in range(3)]
        launches = {k: correlation_kernel.LAUNCHES_BY_DTYPE[k] - before[k]
                    for k in before}
        host = sm(a.cpu().numpy(), b.cpu().numpy())
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = prev
    assert launches == {"float32": 3, "bfloat16": 0}
    for flow in flows:
        assert flow.device.type == "cuda" and flow.shape == (1, 128, 192, 2)
        epe = torch.sqrt(((flow - want) ** 2).sum(-1)).mean()
        assert float(epe) <= 1e-4
    assert isinstance(host, np.ndarray)
    np.testing.assert_array_equal(host, flows[0].cpu().numpy())


# ---------------------------------------------------------------------------
# Repeatable f32 entry points (ROADMAP Queue 3 F1) and the bench
# ---------------------------------------------------------------------------

def _flownet2_npz(tmp_path):
    import numpy as np

    from flownet2_tf_tpu_torch.models.registry import get_model

    tree = warmstart.random_jax_params(get_model("2").build("cpu"), seed=0)
    ckpt = tmp_path / "flownet2.npz"
    np.savez(ckpt, **warmstart.flatten(tree))
    return tree, ckpt


def test_f32_cli_test_is_repeatable_on_card(gen, tmp_path, capsys):
    """Two f32 ``cli test --model 2`` runs on the card write bitwise-equal
    ``.flo`` files, with no flag set by the caller; the caller's cuDNN
    flag is as it was afterwards."""
    import os

    import numpy as np

    from flownet2_tf_tpu_torch import cli
    from flownet2_tf_tpu_torch.utils import flowlib

    _, ckpt = _flownet2_npz(tmp_path)
    samples = os.path.join(os.path.dirname(__file__), "..", "data",
                           "samples")
    before = torch.backends.cudnn.deterministic
    flows = []
    for run in range(2):
        out = tmp_path / f"run{run}"
        assert cli.main(["test", "--model", "2", "--device", "cuda",
                         "--ckpt", str(ckpt), "--no_image", "--out", str(out),
                         "--input_a", os.path.join(samples, "0img0.ppm"),
                         "--input_b", os.path.join(samples, "0img1.ppm")]) == 0
        flows.append(flowlib.read_flow(out / "0img0_flow.flo"))
    assert np.isfinite(flows[0]).all()
    assert np.array_equal(flows[0], flows[1])
    assert torch.backends.cudnn.deterministic == before


@pytest.mark.parametrize("warp_mode", ["full", "half"])
def test_f32_served_calls_are_repeatable(gen, tmp_path, warp_mode):
    """Two served calls of one f32 FlowNet2 artifact are bitwise equal
    without any flag set by the caller."""
    from flownet2_tf_tpu_torch.tools import aot

    tree, _ = _flownet2_npz(tmp_path)
    path = tmp_path / "f2.flowpak"
    aot.export_serving("2", tree, 128, 192, path, compute_dtype="float32",
                       warp_mode=warp_mode, device="cuda")
    sm = aot.load_serving(path)
    a, b = (torch.rand((1, 128, 192, 3), generator=gen, device="cuda")
            for _ in range(2))
    first, second = sm(a, b), sm(a, b)
    assert torch.isfinite(first).all()
    assert torch.equal(first, second)


@pytest.mark.parametrize("bundle", [False, True])
def test_bf16_served_calls_are_repeatable(gen, tmp_path, bundle):
    """Two served calls of a bf16 half-res FlowNet2 artifact (one shape,
    and a bundle) are bitwise equal without any flag set by the
    caller."""
    from flownet2_tf_tpu_torch.tools import aot

    tree, _ = _flownet2_npz(tmp_path)
    path = tmp_path / "f2.flowpak"
    if bundle:
        aot.export_serving_bundle("2", tree, [(128, 192, 1), (128, 192, 2)],
                                  path, device="cuda")
        todo = [(1, 128, 192), (2, 128, 192)]
    else:
        aot.export_serving("2", tree, 128, 192, path, device="cuda")
        todo = [(1, 128, 192)]
    sm = aot.load_serving(path)
    assert sm.meta["compute_dtype"] == "bfloat16"
    for bhw in todo:
        a, b = (torch.rand((*bhw, 3), generator=gen, device="cuda")
                for _ in range(2))
        first, second = sm(a, b), sm(a, b)
        assert torch.isfinite(first).all()
        assert torch.equal(first, second)


def test_cli_bench_on_card_counts_its_launches(gen, capsys):
    """``cli bench --model c`` at 192x256 on the card: one correlation
    forward launch on bf16 features per forward (warm-ups, then repeats
    x iters per attempt), CUDA-event times, the card's name."""
    import json

    from flownet2_tf_tpu_torch import cli
    from flownet2_tf_tpu_torch.tools import bench, benchlib

    before = dict(correlation_kernel.LAUNCHES_BY_DTYPE)
    assert cli.main(["bench", "--device", "cuda", "--model", "c",
                     "--height", "192", "--width", "256", "--iters",
                     "4"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    launches = {k: correlation_kernel.LAUNCHES_BY_DTYPE[k] - before[k]
                for k in before}
    failed = out.get("suspect", "").count("attempt ")
    attempts = failed if failed == bench.MEASURE_ATTEMPTS else failed + 1
    assert launches == {"float32": 0, "bfloat16": bench.WARMUP_FORWARDS
                        + attempts * out["repeats"] * 4}
    assert out["backend"] == "cuda" and out["warp_mode"] == "half"
    assert out["device"] == torch.cuda.get_device_name(0)
    assert out["ms_per_pair"] > 0
    if out["device"] in benchlib.DEVICE_PEAKS:
        assert out["floor_ms_analytic"] > 0 and 0 < out["mfu"] < 1


def test_bf16_cli_test_is_repeatable_on_card(gen, tmp_path, capsys):
    """Two bf16 ``cli test --model 2`` runs on the card write
    bitwise-equal ``.flo`` files with no flag set by the caller:
    ``f32_policy`` picks cuDNN's deterministic algorithms under the bf16
    policy too."""
    import os

    import numpy as np

    from flownet2_tf_tpu_torch import cli
    from flownet2_tf_tpu_torch.utils import flowlib

    _, ckpt = _flownet2_npz(tmp_path)
    samples = os.path.join(os.path.dirname(__file__), "..", "data",
                           "samples")
    before = torch.backends.cudnn.deterministic
    flows = []
    for run in range(2):
        out = tmp_path / f"run{run}"
        assert cli.main(["test", "--model", "2", "--device", "cuda",
                         "--compute_dtype", "bfloat16", "--ckpt", str(ckpt),
                         "--no_image", "--out", str(out),
                         "--input_a", os.path.join(samples, "0img0.ppm"),
                         "--input_b", os.path.join(samples, "0img1.ppm")]) == 0
        flows.append(flowlib.read_flow(out / "0img0_flow.flo"))
    assert np.isfinite(flows[0]).all()
    assert np.array_equal(flows[0], flows[1])
    assert torch.backends.cudnn.deterministic == before


def _train_batch(n, h, w, seed=0):
    import numpy as np

    from flownet2_tf_tpu_torch.data.loader import SyntheticFlowDataset

    ds = SyntheticFlowDataset(size=n, height=h, width=w, seed=seed)
    return {k: torch.from_numpy(np.stack([ds[i][k] for i in range(n)]))
            .cuda() for k in ("image_a", "image_b", "flow")}


def _trainer(tmp_path, name, **kw):
    from flownet2_tf_tpu_torch.training.loop import TrainConfig, Trainer

    base = dict(model="c", schedule="short", log_dir=str(tmp_path / name),
                device="cuda", tensorboard=False, checkpoint_every=0,
                augment=False)
    base.update(kw)
    return Trainer(TrainConfig(**base))


@pytest.mark.parametrize("model,dtype", [("c", "float32"),
                                         ("c", "bfloat16"),
                                         ("css", "bfloat16")])
def test_remat_step_is_bitwise_the_step_on_card(gen, tmp_path, model, dtype):
    """One b8 320x448 train step with remat and one without, from the same
    seed and batch, on the card: loss and every updated parameter bitwise
    equal, and a lower peak of allocated memory over the forward and
    backward with remat."""
    batch = _train_batch(8, 320, 448)
    out = {}
    for remat in (False, True):
        trainer = _trainer(tmp_path, f"r{remat}", model=model,
                           compute_dtype=dtype, remat=remat)
        state = trainer.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        peaks, update = [], state.optimizer.step

        def step(*args, **kwargs):
            # the forward + backward's peak: the update's moments and
            # temporaries are parameter-sized either way
            peaks.append(torch.cuda.max_memory_allocated() - base)
            return update(*args, **kwargs)

        state.optimizer.step = step
        loss = trainer.train_step(state, batch)["loss"]
        out[remat] = (loss, [p.detach().clone()
                             for p in state.model.parameters()], peaks[0])
        del trainer, state
    assert torch.isfinite(out[False][0])
    assert torch.equal(out[True][0], out[False][0])
    for got, want in zip(out[True][1], out[False][1]):
        assert torch.equal(got, want)
    assert out[True][2] < out[False][2], (out[True][2], out[False][2])


def test_bf16_train_steps_are_repeatable_on_card(gen, tmp_path):
    """Two bf16 FlowNetC runs of two augmented steps from the same seed and
    batches are bitwise equal, with no flag set by the caller."""
    from flownet2_tf_tpu_torch.data import dataset_configs

    pre = dict(dataset_configs.FLYING_CHAIRS_DATASET_CONFIG["PREPROCESS"])
    pre["crop_height"], pre["crop_width"] = 128, 192
    batches = [_train_batch(4, 160, 224, seed=s) for s in range(2)]
    params = []
    for run in range(2):
        trainer = _trainer(tmp_path, f"run{run}", augment=True)
        state = trainer.init_state()
        for batch in batches:
            trainer.train_step(state, batch, pre)
        params.append([p.detach().clone() for p in state.model.parameters()])
    for got, want in zip(*params):
        assert torch.equal(got, want)


def test_cli_train_remat_image_summaries_launch_counts(gen, tmp_path,
                                                       capsys):
    """``cli train --remat --image_summary_every 1`` (FlowNetC, bf16, 2
    steps, threaded prefetch): correlation forward launches 2 per step
    (forward and recompute) + 1 per summary, backward 1 per step, and four
    PNG images per summary."""
    import os

    from flownet2_tf_tpu_torch import cli

    correlation_kernel.reset_launch_counts()
    assert cli.main(["train", "--model", "c", "--synthetic",
                     "--synthetic_size", "4", "--synthetic_height", "128",
                     "--synthetic_width", "192", "--batch_size", "2",
                     "--schedule", "short", "--log_every", "1",
                     "--max_steps", "2", "--device", "cuda", "--remat",
                     "--image_summary_every", "1", "--checkpoint_every",
                     "0", "--log_dir", str(tmp_path / "run")]) == 0
    assert dict(correlation_kernel.LAUNCHES_BY_DTYPE) == {
        "float32": 0, "bfloat16": 2 * 2 + 2}
    assert dict(correlation_kernel.BWD_LAUNCHES_BY_DTYPE) == {
        "float32": 0, "bfloat16": 2}
    events = [f for f in os.listdir(tmp_path / "run") if "tfevents" in f]
    with open(tmp_path / "run" / events[0], "rb") as f:
        assert f.read().count(b"\x89PNG\r\n\x1a\n") == 8


def test_native_decode_matches_pure_on_the_card_host(gen, tmp_path):
    """On the card's host the native IO runtime builds, and its
    TFRecordFlowDataset decode is bitwise the pure path's in both
    ``raw_uint8`` modes."""
    import numpy as np

    from flownet2_tf_tpu_torch.data import loader, tfrecord
    from flownet2_tf_tpu_torch.runtime import native

    assert native.get_native_io() is not None
    rng = np.random.RandomState(0)
    payloads = [tfrecord.build_example({
        "image_a": rng.randint(0, 256, (32, 48, 3), np.uint8).tobytes(),
        "image_b": rng.randint(0, 256, (32, 48, 3), np.uint8).tobytes(),
        "flow": rng.randn(32, 48, 2).astype(np.float32).tobytes()})
        for _ in range(6)]
    path = tmp_path / "x.tfrecords"
    tfrecord.write_records(path, payloads)
    for raw in (False, True):
        fast = loader.TFRecordFlowDataset(path, 32, 48, raw_uint8=raw)
        pure = loader.TFRecordFlowDataset(path, 32, 48, use_native=False,
                                          raw_uint8=raw)
        assert fast.native and len(fast) == len(pure) == 6
        got = fast.fetch_batch(range(6))
        want = pure.fetch_batch(range(6))
        for k in got:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), k


def test_warp_and_resize_gradients_repeat_on_card(gen):
    """The warp's and the resize's backwards on the card (advanced-
    indexing reads: ``index_put_`` sorts the indices and sums each
    pixel's contributions in that order) are bitwise equal run to run,
    with thousands of samples per pixel, and match the CPU's gradients
    (rtol 1e-4, atol 1e-3: f32 sums of up to ~8000 contributions of a
    pixel, in another order)."""
    from flownet2_tf_tpu_torch.ops import resize, sampling

    img = torch.rand(2, 96, 128, 8, device="cuda", generator=gen)
    x, y = (torch.rand(2, 320, 448, device="cuda", generator=gen) * 5
            for _ in range(2))
    small = torch.rand(8, 40, 56, 2, device="cuda", generator=gen)

    def grads(device):
        # fresh leaves each call (``to`` on the same device is no copy)
        i = img.to(device).clone().requires_grad_()
        i1 = img[:1].to(device).clone().requires_grad_()
        s = small.to(device).clone().requires_grad_()
        xs, ys = x.to(device), y.to(device)
        (sampling.bilinear_gather(i, xs, ys).square().sum()
         + sampling.bilinear_gather_multi(i1, xs, ys).square().sum()
         + resize.resize_bilinear_tf1(s, 320, 448).square().sum()
         ).backward()
        return i.grad, i1.grad, s.grad

    first, second = grads("cuda"), grads("cuda")
    for a, b, c in zip(first, second, grads("cpu")):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.cpu(), c, rtol=1e-4, atol=1e-3)
