"""Parity of the torch port's ops with the JAX package's, on the CPU.

The same numpy arrays, made from a seeded ``RandomState``, go through the
JAX function and its port; the port runs its plain torch versions here.
The CUDA kernel itself is held against its plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_gpu.py``.
"""

import importlib
import os
import stat
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from flownet2_tf_tpu.models import common as jcommon  # noqa: E402
from flownet2_tf_tpu.ops.pallas.correlation_kernel import (  # noqa: E402
    correlation_pallas,
)
from flownet2_tf_tpu.ops.resize import resize_bilinear_tf1 as jresize  # noqa: E402
from flownet2_tf_tpu_torch.models import common  # noqa: E402
from flownet2_tf_tpu_torch.ops import correlation as tcorr  # noqa: E402
from flownet2_tf_tpu_torch.ops import flow_warp as twarp  # noqa: E402
from flownet2_tf_tpu_torch.ops.cuda import _build  # noqa: E402
from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel  # noqa: E402
from flownet2_tf_tpu_torch.ops.resize import resize_bilinear_tf1  # noqa: E402


# the JAX package's ops/__init__ re-exports functions under their module
# names, so its modules are resolved explicitly
jcorr = importlib.import_module("flownet2_tf_tpu.ops.correlation")
jwarp = importlib.import_module("flownet2_tf_tpu.ops.flow_warp")


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "shape,out_hw",
    [
        ((1, 16, 32, 2), (64, 128)),  # up by 4 (predict_flow2 -> flow)
        ((2, 8, 8, 3), (16, 16)),  # up by 2
        ((1, 24, 40, 2), (12, 10)),  # down
        ((1, 7, 9, 1), (13, 22)),  # odd sizes
    ],
)
def test_resize_bilinear_tf1_matches_jax(rng, shape, out_hw):
    x = rng.randn(*shape).astype(np.float32)
    want = np.asarray(jresize(jnp.asarray(x), *out_hw))
    got = resize_bilinear_tf1(_t(x), *out_hw).numpy()
    assert got.shape == want.shape
    # same f32 arithmetic in the same order: agreement to rounding
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_resize_is_not_half_pixel_interpolate(rng):
    """Trap C1: F.interpolate's half-pixel convention differs."""
    x = rng.randn(1, 8, 8, 1).astype(np.float32)
    got = resize_bilinear_tf1(_t(x), 32, 32).numpy()
    half_pixel = torch.nn.functional.interpolate(
        _t(x).permute(0, 3, 1, 2), size=(32, 32), mode="bilinear",
        align_corners=False,
    ).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - half_pixel).max() > 1e-2


# ---------------------------------------------------------------------------
# warps and channel norm
# ---------------------------------------------------------------------------

def _flow(rng, shape, scale):
    # scale well above the frame size sends samples out of frame
    return (rng.randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("border", ["clamp", "zero"])
@pytest.mark.parametrize("scale", [1.5, 12.0])
def test_flow_warp_matches_jax(rng, border, scale):
    image = rng.rand(2, 12, 16, 3).astype(np.float32)
    flow = _flow(rng, (2, 12, 16, 2), scale)
    want = np.asarray(jwarp.flow_warp(jnp.asarray(image), jnp.asarray(flow),
                                      border=border))
    got = twarp.flow_warp(_t(image), _t(flow), border=border).numpy()
    # four-tap lerp, summed in the same order: f32 rounding only
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("border", ["clamp", "zero"])
def test_flow_warp_multi_matches_jax(rng, border):
    image = rng.rand(1, 10, 14, 3).astype(np.float32)
    flows = _flow(rng, (2, 10, 14, 2), 8.0)
    want = np.asarray(jwarp.flow_warp_multi(
        jnp.asarray(image), jnp.asarray(flows), border=border))
    got = twarp.flow_warp_multi(_t(image), _t(flows), border=border).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # and it is the batched single warp of the same image
    single = twarp.flow_warp(_t(np.repeat(image, 2, axis=0)), _t(flows),
                             border=border).numpy()
    np.testing.assert_allclose(got, single, rtol=0, atol=0)


def test_flow_warp_zero_flow_is_identity(rng):
    image = rng.rand(1, 8, 8, 3).astype(np.float32)
    got = twarp.flow_warp(_t(image), torch.zeros(1, 8, 8, 2)).numpy()
    np.testing.assert_array_equal(got, image)


def test_channel_norm_matches_jax(rng):
    x = rng.randn(2, 6, 10, 3).astype(np.float32)
    want = np.asarray(jcommon.channel_norm(jnp.asarray(x)))
    got = common.channel_norm(_t(x)).numpy()
    assert got.shape == (2, 6, 10, 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# correlation
# ---------------------------------------------------------------------------

# the cases of tests/test_pallas_kernels.py, plus the FlowNetC
# displacement range (d=20, s2=2 -> 441 channels) at full channel width
CORR_CASES = [
    ((1, 16, 16, 128), 4, 2),
    ((2, 8, 24, 128), 4, 2),
    ((1, 12, 16, 256), 6, 2),
    ((1, 8, 16, 128), 3, 1),
    ((1, 8, 16, 256), 20, 2),
]


def _corr_inputs(rng, shape):
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("shape,d,s2", CORR_CASES)
def test_correlation_matches_jax_oracle(rng, shape, d, s2):
    a, b = _corr_inputs(rng, shape)
    want = np.asarray(jcorr._correlation_oracle(
        jnp.asarray(a), jnp.asarray(b), 1, d, 1, s2, d))
    got = tcorr.correlation(_t(a), _t(b), 1, d, 1, s2, d).numpy()
    assert got.shape == want.shape == jcorr.correlation_output_shape(
        shape, 1, d, 1, s2, d)
    # f32 channel sums in another order: rounding only
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,d,s2", CORR_CASES)
def test_correlation_matches_pallas_kernel(rng, shape, d, s2):
    a, b = _corr_inputs(rng, shape)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(correlation_pallas(
            jnp.asarray(a), jnp.asarray(b), 1, d, 1, s2, d))
    got = tcorr.correlation(_t(a), _t(b), 1, d, 1, s2, d).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_correlation_bf16_inputs_match_pallas_kernel(rng):
    shape = (1, 8, 16, 128)
    a, b = _corr_inputs(rng, shape)
    a16 = jnp.asarray(a).astype(jnp.bfloat16)
    b16 = jnp.asarray(b).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(correlation_pallas(a16, b16, 1, 4, 1, 2, 4))
    ta = _t(a).to(torch.bfloat16)
    tb = _t(b).to(torch.bfloat16)
    got = tcorr.correlation(ta, tb, 1, 4, 1, 2, 4)
    assert got.dtype == torch.float32
    # bf16 inputs, f32 accumulation: the tolerance of
    # tests/test_pallas_kernels.py for the same case
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize(
    "k,d,s1,s2,pad",
    [(3, 4, 1, 2, 4), (1, 4, 2, 2, 4), (1, 4, 1, 2, 2), (3, 3, 2, 1, 5)],
)
def test_correlation_general_form_matches_jax_oracle(rng, k, d, s1, s2, pad):
    """Outside the kernel's family the CPU takes the plain version in its
    general k/s1/s2/pad form."""
    assert not correlation_kernel.supported(k, d, s1, s2, pad)
    a, b = _corr_inputs(rng, (1, 10, 12, 32))
    want = np.asarray(jcorr._correlation_oracle(
        jnp.asarray(a), jnp.asarray(b), k, d, s1, s2, pad))
    got = tcorr.correlation(_t(a), _t(b), k, d, s1, s2, pad).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_cuda_wrapper_on_cpu_tensors_takes_plain_version(rng):
    """Importing the wrapper needs no nvcc; a CPU tensor takes the plain
    version and launches nothing."""
    a, b = _corr_inputs(rng, (1, 8, 12, 64))  # off the TPU tiling
    before = correlation_kernel.LAUNCHES
    got = correlation_kernel.correlation_cuda(_t(a), _t(b), 4, 2).numpy()
    want = tcorr._correlation_oracle(_t(a), _t(b), 1, 4, 1, 2, 4).numpy()
    np.testing.assert_array_equal(got, want)
    assert correlation_kernel.LAUNCHES == before


def test_cuda_wrapper_rejects_out_of_family_config():
    a = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="multiple of stride_2"):
        correlation_kernel.correlation_cuda(a, a, 5, 2)


# ---------------------------------------------------------------------------
# kernel build (no nvcc here: a stand-in compiler script)
# ---------------------------------------------------------------------------

def _fake_cuda_home(tmp_path, body):
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n{body}\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return str(tmp_path / "cuda")


def test_build_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    home = _fake_cuda_home(
        tmp_path, "sys.stderr.write('error: bad kernel\\n'); sys.exit(2)")
    monkeypatch.setenv("CUDA_HOME", home)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build("correlation")
    assert not os.path.exists(_build.library_path("correlation"))


def test_build_rebuilds_only_when_stale(tmp_path, monkeypatch):
    calls = tmp_path / "calls"
    home = _fake_cuda_home(
        tmp_path,
        f"open({str(calls)!r}, 'a').write('x')\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')",
    )
    monkeypatch.setenv("CUDA_HOME", home)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src = csrc / "correlation.cu"
    src.write_text("// kernel\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    so = _build.build("correlation")
    assert os.path.exists(so) and calls.read_text() == "x"
    _build.build("correlation")
    assert calls.read_text() == "x"  # up to date: no second compile
    newer = os.path.getmtime(so) + 10
    os.utime(src, (newer, newer))
    _build.build("correlation")
    assert calls.read_text() == "xx"


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
