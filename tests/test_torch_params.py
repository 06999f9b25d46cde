"""The weight bridge between the JAX package's parameter trees and the
torch port's modules, on the CPU."""

import functools
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flownet2_tf_tpu.models import common as jcommon  # noqa: E402
from flownet2_tf_tpu.models.registry import MODEL_NAMES  # noqa: E402
from flownet2_tf_tpu.models.registry import get_model as jax_model  # noqa: E402
from flownet2_tf_tpu.training import warmstart as jws  # noqa: E402
from flownet2_tf_tpu_torch.models import common  # noqa: E402
from flownet2_tf_tpu_torch.models.registry import get_model  # noqa: E402
from flownet2_tf_tpu_torch.training import warmstart  # noqa: E402


@pytest.fixture(autouse=True)
def _drop_test_files(tmp_path):
    """Some tests here write FlowNet weights of about 150 MB: delete what
    each test wrote when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def jax_shapes(name):
    """flatten(eval_shape(init)) as key -> shape; zero-stride numpy views
    stand in for the abstract leaves, so nothing is allocated."""
    abstract = jax.eval_shape(jax_model(name).init, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), abstract)
    return {k: tuple(v.shape) for k, v in jws.flatten(tree).items()}


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_param_keys_and_shapes_match_jax(name):
    module = get_model(name).build("cpu")
    assert warmstart.jax_param_shapes(module) == jax_shapes(name)


def test_registry_aliases_match_jax():
    for alias in ("flownet2", "flownet-2", "FlowNet_CSS", "sd"):
        assert get_model(alias).name == jax_model(alias).name


@pytest.mark.parametrize("k,stride", [(7, 2), (3, 1), (1, 1)])
def test_conv_layer_matches_jax(rng, k, stride):
    w = rng.randn(k, k, 5, 8).astype(np.float32) * 0.3
    bias = rng.randn(8).astype(np.float32)
    x = rng.randn(2, 16, 16, 5).astype(np.float32)
    want = np.asarray(jcommon.conv({"weights": jnp.asarray(w),
                                    "biases": jnp.asarray(bias)},
                                   jnp.asarray(x), stride=stride))
    layer = common.Conv(k, 5, 8, stride)
    warmstart.load_jax_params(layer, {"weights": w, "biases": bias})
    with torch.no_grad():
        got = common.nhwc(layer(common.nchw(torch.from_numpy(x)))).numpy()
    assert got.shape == want.shape
    # both f32 without reduced-precision passes; sums in another order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", [True, False])
def test_deconv_layer_matches_jax(rng, act):
    """Trap C2: the forward-conv HWIO kernel maps to a flipped
    conv_transpose2d kernel with padding 1."""
    w = rng.randn(4, 4, 6, 3).astype(np.float32) * 0.3
    bias = rng.randn(3).astype(np.float32)
    x = rng.randn(1, 5, 7, 6).astype(np.float32)
    want = np.asarray(jcommon.deconv({"weights": jnp.asarray(w),
                                      "biases": jnp.asarray(bias)},
                                     jnp.asarray(x), act=act))
    layer = common.Deconv(6, 3, act=act)
    warmstart.load_jax_params(layer, {"weights": w, "biases": bias})
    with torch.no_grad():
        got = common.nhwc(layer(common.nchw(torch.from_numpy(x)))).numpy()
    assert got.shape == want.shape == (1, 10, 14, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,cin,cout,h,w", [(2, 5, 3, 7, 9), (1, 2, 2, 4, 4),
                                            (1, 16, 8, 1, 3)])
def test_deconv_subpixel_is_the_transposed_conv(rng, n, cin, cout, h, w):
    """The f32 path's deconv (one conv2d and an interleave) is
    ``conv_transpose2d(stride=2, padding=1)``, its gradients included: in
    f64 the two agree to rounding."""
    T = functools.partial(torch.tensor, dtype=torch.float64,
                          requires_grad=True)
    x = T(rng.randn(n, cin, h, w))
    k = T(rng.randn(cin, cout, 4, 4))
    bias = T(rng.randn(cout))
    want = torch.nn.functional.conv_transpose2d(x, k, bias, stride=2,
                                                padding=1)
    got = common.deconv_subpixel(x, k, bias)
    assert got.shape == want.shape == (n, cout, 2 * h, 2 * w)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    g = torch.from_numpy(rng.randn(*want.shape))
    for a, b in zip(torch.autograd.grad(got, (x, k, bias), g),
                    torch.autograd.grad(want, (x, k, bias), g)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-11)
    with pytest.raises(ValueError, match="4x4"):
        common.deconv_subpixel(x, k[:, :, :3, :3], bias)


def _tree(module, seed=0):
    return warmstart.random_jax_params(module, seed)


def test_load_raises_on_missing_key():
    module = get_model("s").build("cpu")
    flat = warmstart.flatten(_tree(module))
    del flat["conv3/biases"]
    with pytest.raises(ValueError, match="missing.*conv3/biases"):
        warmstart.load_jax_params(module, flat)


def test_load_raises_on_extra_key():
    module = get_model("s").build("cpu")
    flat = warmstart.flatten(_tree(module))
    flat["conv9/weights"] = np.zeros((3, 3, 1, 1), np.float32)
    with pytest.raises(ValueError, match="extra.*conv9/weights"):
        warmstart.load_jax_params(module, flat)


def test_load_raises_on_shape_mismatch():
    module = get_model("s").build("cpu")
    flat = warmstart.flatten(_tree(module))
    flat["conv2/weights"] = np.zeros((5, 5, 64, 64), np.float32)
    with pytest.raises(ValueError, match="shape mismatch at conv2/weights"):
        warmstart.load_jax_params(module, flat)


def test_npz_round_trip(tmp_path):
    module = get_model("c").build("cpu")
    tree = _tree(module, seed=3)
    flat = warmstart.flatten(tree)
    path = tmp_path / "c.npz"
    np.savez(path, **flat)
    loaded = warmstart.load_params_tree(path)
    assert warmstart.flatten(loaded).keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(warmstart.flatten(loaded)[k], flat[k])
    warmstart.load_jax_params(module, loaded)
    # the conv weights land in OIHW, the biases as they are
    np.testing.assert_array_equal(
        module.conv_redir.weights.detach().numpy(),
        flat["conv_redir/weights"].transpose(3, 2, 0, 1),
    )
    np.testing.assert_array_equal(
        module.deconv2.weights.detach().numpy(),
        flat["deconv2/weights"][::-1, ::-1].transpose(2, 3, 0, 1),
    )
    with pytest.raises(ValueError, match="only .npz"):
        warmstart.load_params_tree(tmp_path / "run_dir")
