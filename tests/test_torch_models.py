"""Per-stage parity of the torch port's models with the JAX package's, on
the CPU, at full published widths and a 64x128 input.

One numpy-seeded FlowNet2 parameter tree, shaped by ``jax.eval_shape``,
feeds both packages; FlowNetC, FlowNetSD and the 12-channel FlowNetS are
its sub-trees. The JAX side runs both its plain path
(``dispatch.use_s2d(False)``) and its default S2D path, which must agree
with the plain one; FlowNetC also runs with the Pallas correlation kernel
in interpret mode, so the port is held against the TPU kernel itself.

Tolerances: each ``predict_flow*`` at rtol 1e-4 and atol 1e-4 * scale,
with scale = max(1, mean |ref|): f32 sums in another order, amplified
through random MSRA weights. Full-resolution flows (``flow`` and the
FlowNet2 branch flows, which carry the x20 scale and several stacked
stages) at the tolerance of tests/test_golden.py:96-99.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from flownet2_tf_tpu.models import flownet_c as jflownet_c  # noqa: E402
from flownet2_tf_tpu.models import flownet_s as jflownet_s  # noqa: E402
from flownet2_tf_tpu.models import flownet_sd as jflownet_sd  # noqa: E402
from flownet2_tf_tpu.models import stacks as jstacks  # noqa: E402
from flownet2_tf_tpu.ops import dispatch  # noqa: E402
from flownet2_tf_tpu_torch.models import flownet_c, flownet_s, flownet_sd  # noqa: E402
from flownet2_tf_tpu_torch.models import stacks  # noqa: E402
from flownet2_tf_tpu_torch.training import warmstart  # noqa: E402

H, W = 64, 128
FULL_RES = ("flow", "flow_css", "flow_sd")


@pytest.fixture(scope="module")
def tree():
    """FlowNet2's JAX-layout tree: numpy-seeded, shaped by eval_shape."""
    abstract = jax.eval_shape(jstacks.init_flownet2, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)

    def draw(s):
        if len(s.shape) == 1:
            return np.zeros(s.shape, np.float32)
        kh, kw, cin, _ = s.shape
        std = np.sqrt(2.0 / (kh * kw * cin))
        return (rng.standard_normal(s.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map(draw, abstract)


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(1)
    return {k: rng.rand(1, H, W, 3).astype(np.float32)
            for k in ("input_a", "input_b")}


def _torch_preds(module, params, inputs):
    warmstart.load_jax_params(module, params)
    if isinstance(inputs, dict):
        inputs = {k: torch.from_numpy(v) for k, v in inputs.items()}
    else:
        inputs = torch.from_numpy(inputs)
    with torch.inference_mode():
        preds = module.eval()(inputs)
    return {k: v.numpy() for k, v in preds.items()}


def _jax_preds(apply, params, inputs, s2d, pallas=False):
    # a fresh jit per configuration: the dispatch knobs are read at
    # trace time, so a shared jit cache would reuse the other trace
    fn = jax.jit(functools.partial(apply))
    with dispatch.use_s2d(s2d):
        if pallas:
            with dispatch.use_implementation("pallas"), \
                    pltpu.force_tpu_interpret_mode():
                preds = fn(params, inputs)
        else:
            preds = fn(params, inputs)
    return {k: np.asarray(v) for k, v in preds.items()}


def _assert_match(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        scale = max(1.0, float(np.abs(want[k]).mean()))
        if k in FULL_RES:
            rtol, atol = 1e-3, 5e-3 * scale
        else:
            rtol, atol = 1e-4, 1e-4 * scale
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


S2D_MODES = [pytest.param(False, id="plain"), pytest.param(True, id="s2d")]


@pytest.mark.parametrize("s2d", S2D_MODES)
def test_flownet_s_matches_jax(tree, s2d):
    """The 12-channel second-stage FlowNetS (its S2D conv1 head is taken
    on the JAX default path)."""
    params = tree["FlowNetCSS"]["FlowNetS"]
    x = np.random.RandomState(2).rand(1, H, W, 12).astype(np.float32)
    got = _torch_preds(flownet_s.FlowNetS(input_channels=12), params, x)
    _assert_match(got, _jax_preds(jflownet_s.apply, params, x, s2d))


@pytest.mark.parametrize(
    "s2d,pallas",
    [(False, False), (True, False), (False, True)],
    ids=["plain", "s2d", "pallas-interpret"],
)
def test_flownet_c_matches_jax(tree, images, s2d, pallas):
    params = tree["FlowNetCSS"]["FlowNetCS"]["FlowNetC"]
    got = _torch_preds(flownet_c.FlowNetC(), params, images)
    _assert_match(got, _jax_preds(jflownet_c.apply, params, images, s2d,
                                  pallas))


@pytest.mark.parametrize("s2d", S2D_MODES)
def test_flownet_sd_matches_jax(tree, images, s2d):
    params = tree["FlowNetSD"]
    got = _torch_preds(flownet_sd.FlowNetSD(), params, images)
    _assert_match(got, _jax_preds(jflownet_sd.apply, params, images, s2d))


@pytest.fixture(scope="module")
def flownet2_torch_preds(tree, images):
    return _torch_preds(stacks.FlowNet2(), tree, images)


@pytest.mark.parametrize("s2d", S2D_MODES)
def test_flownet2_matches_jax(tree, images, flownet2_torch_preds, s2d):
    """The whole slice: CSS + SD branches, double warp, fusion."""
    want = _jax_preds(jstacks.apply_flownet2, tree, images, s2d)
    _assert_match(flownet2_torch_preds, want)
    assert np.isfinite(flownet2_torch_preds["flow"]).all()
