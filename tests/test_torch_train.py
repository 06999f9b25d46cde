"""The torch port's training slice against the JAX package, on the CPU.

The same numpy-seeded inputs go through the JAX function and its port:
the loss path (downsample, channel_norm's gradient, each model's loss),
the correlation gradient (the CUDA backward's plain version), full-loss
gradients of FlowNetS and FlowNetC, Adam + L2 + schedule against optax,
the synthetic data and loader, augmentation, and the trainer itself
(frozen stages, checkpoints, resume, the ``train`` CLI). Each comparison
states its tolerance.
"""

import json
import math
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from flownet2_tf_tpu.data import augmentation as jaug  # noqa: E402
from flownet2_tf_tpu.data import loader as jloader  # noqa: E402
from flownet2_tf_tpu.data import tfrecord as jtfrecord  # noqa: E402
from flownet2_tf_tpu.models import common as jcommon  # noqa: E402
from flownet2_tf_tpu.models import stacks as jstacks  # noqa: E402
from flownet2_tf_tpu.models.registry import get_model as jax_model  # noqa: E402
from flownet2_tf_tpu.ops.correlation import correlation as jcorrelation  # noqa: E402
from flownet2_tf_tpu.ops import dispatch  # noqa: E402
from flownet2_tf_tpu.ops.downsample import downsample as jdownsample  # noqa: E402
from flownet2_tf_tpu.ops.pallas.correlation_kernel import correlation_pallas  # noqa: E402
from flownet2_tf_tpu.training import optim as joptim  # noqa: E402
from flownet2_tf_tpu.training import warmstart as jws  # noqa: E402
from flownet2_tf_tpu_torch import cli  # noqa: E402
from flownet2_tf_tpu_torch.data import augmentation, dataset_configs, loader  # noqa: E402
from flownet2_tf_tpu_torch.models import common, stacks  # noqa: E402
from flownet2_tf_tpu_torch.models.registry import get_model  # noqa: E402
from flownet2_tf_tpu_torch.ops import correlation as tcorr  # noqa: E402
from flownet2_tf_tpu_torch.ops.downsample import downsample  # noqa: E402
from flownet2_tf_tpu_torch.training import optim, warmstart  # noqa: E402
from flownet2_tf_tpu_torch.training.loop import TrainConfig, Trainer  # noqa: E402

T = torch.from_numpy


@pytest.fixture(autouse=True)
def _drop_run_dirs(tmp_path):
    """The trainer tests write full-size checkpoints (~0.5 GB each for
    FlowNetS with its Adam state): delete them when the test ends rather
    than leave them in pytest's retained temp directories."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


# ---------------------------------------------------------------------------
# Loss path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,size", [
    ((2, 64, 96, 2), (8, 12)),    # integer factor 8: average pool
    ((1, 64, 64, 2), (1, 1)),     # the 1x1 predict_flow6 level
    ((2, 20, 30, 3), (7, 11)),    # fractional: area weights
    ((1, 9, 10, 2), (4, 10)),     # fractional rows, identity columns
])
def test_downsample_matches_jax(rng, shape, size):
    x = rng.randn(*shape).astype(np.float32)
    want = np.asarray(jdownsample(jnp.asarray(x), size))
    got = downsample(T(x), size).numpy()
    assert got.shape == want.shape
    # f32 sums of the same terms (TF32 off on both sides)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_channel_norm_gradient_matches_jax_with_exact_zeros(rng):
    x = rng.randn(2, 5, 6, 3).astype(np.float32)
    x[0, :2] = 0.0  # exact zeros: sqrt'(0) is inf without the guard
    w = rng.randn(2, 5, 6, 1).astype(np.float32)
    want = np.asarray(jax.grad(
        lambda v: jnp.sum(jcommon.channel_norm(v) * w))(jnp.asarray(x)))
    xt = T(x).requires_grad_()
    (common.channel_norm(xt) * T(w)).sum().backward()
    got = xt.grad.numpy()
    assert np.isfinite(got).all()
    assert (got[0, :2] == 0.0).all() and (want[0, :2] == 0.0).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # the forward is a bare sqrt
    np.testing.assert_array_equal(
        common.channel_norm(T(x)).numpy(),
        np.sqrt(np.sum(np.square(x), axis=-1, keepdims=True)))


def _level_preds(rng, names_hw, n=2):
    return {name: rng.randn(n, h, w, 2).astype(np.float32)
            for name, (h, w) in names_hw.items()}


@pytest.mark.parametrize("name", ["s", "c", "sd", "cs", "css", "2"])
def test_model_loss_matches_jax(rng, name):
    h, w = 64, 128
    if name == "2":
        levels = {f"predict_flow{k}": (h >> k, w >> k) for k in (2, 1, 0)}
    else:
        levels = {f"predict_flow{k}": (h >> k, w >> k) for k in range(2, 7)}
    preds = _level_preds(rng, levels)
    preds["flow"] = rng.randn(2, h, w, 2).astype(np.float32)  # not a term
    gt = (rng.randn(2, h, w, 2) * 4).astype(np.float32)
    want = float(jax_model(name).loss(
        jnp.asarray(gt), {k: jnp.asarray(v) for k, v in preds.items()}))
    got = float(get_model(name).loss(T(gt), {k: T(v) for k, v in preds.items()}))
    # f32 sums over ~16k pixels in another order
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_registry_losses_and_frozen_scopes_match_jax():
    for name in ("s", "c", "cs", "css", "sd", "2"):
        assert get_model(name).default_frozen == jax_model(name).default_frozen
    assert stacks.FUSION_LOSS_WEIGHTS == jstacks.FUSION_LOSS_WEIGHTS


# ---------------------------------------------------------------------------
# Correlation gradient (the plain version of the CUDA backward)
# ---------------------------------------------------------------------------

CORR_CASES = [  # tests/test_pallas_kernels.py:26-104
    ((1, 16, 16, 128), 4, 2),
    ((2, 8, 24, 128), 4, 2),
    ((1, 12, 16, 256), 6, 2),
    ((1, 8, 16, 128), 3, 1),
    ((1, 8, 12, 64), 4, 2),
]


def _jax_corr_grads(fn, a, b, g):
    return jax.grad(lambda x, y: jnp.sum(fn(x, y) * g), argnums=(0, 1))(a, b)


def _torch_corr_grads(a, b, g, d, s2):
    x, y = T(a).requires_grad_(), T(b).requires_grad_()
    out = tcorr.correlation(x, y, 1, d, 1, s2, d)
    out.backward(T(g))
    return x.grad, y.grad


@pytest.mark.parametrize("shape,d,s2", CORR_CASES)
def test_correlation_gradient_matches_jax(rng, shape, d, s2):
    a = rng.randn(*shape).astype(np.float32)
    b = rng.randn(*shape).astype(np.float32)
    dd = (2 * (d // s2) + 1) ** 2
    g = rng.randn(*shape[:3], dd).astype(np.float32)
    got = _torch_corr_grads(a, b, g, d, s2)
    kw = dict(kernel_size=1, max_displacement=d, stride_1=1, stride_2=s2,
              pad=d)
    want = _jax_corr_grads(lambda x, y: jcorrelation(x, y, **kw),
                           a, b, g)
    with pltpu.force_tpu_interpret_mode():
        want_pallas = _jax_corr_grads(
            lambda x, y: correlation_pallas(x, y, **kw), a, b, g)
    for t, j, p in zip(got, want, want_pallas):
        # f32 sums of D**2 products in another order
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(t.numpy(), np.asarray(p), rtol=1e-5,
                                   atol=1e-6)


def test_correlation_gradient_bf16_matches_jax(rng):
    shape, d, s2 = (1, 8, 16, 128), 4, 2
    a = jnp.asarray(rng.randn(*shape).astype(np.float32)).astype(jnp.bfloat16)
    b = jnp.asarray(rng.randn(*shape).astype(np.float32)).astype(jnp.bfloat16)
    g = rng.randn(*shape[:3], 25).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = _jax_corr_grads(
            lambda x, y: correlation_pallas(x, y, 1, d, 1, s2, d), a, b, g)
    ta = torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
    tb = torch.from_numpy(np.array(b.astype(jnp.float32))).bfloat16()
    x, y = ta.requires_grad_(), tb.requires_grad_()
    tcorr.correlation(x, y, 1, d, 1, s2, d).backward(T(g))
    for t, j in zip((x.grad, y.grad), want):
        assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
        # both sum in f32 and round once to bf16: one bf16 step apart
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j.astype(jnp.float32)),
                                   rtol=2.0 ** -7, atol=1e-6)


# ---------------------------------------------------------------------------
# Full-loss gradients
# ---------------------------------------------------------------------------

WEIGHT_DECAY = 4e-4


@pytest.fixture(scope="module")
def grad_batch():
    rng = np.random.RandomState(5)
    return {
        "input_a": rng.rand(2, 64, 64, 3).astype(np.float32),
        "input_b": rng.rand(2, 64, 64, 3).astype(np.float32),
        "flow": (rng.randn(2, 64, 64, 2) * 3).astype(np.float32),
    }


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("name", ["s", "c"])
def test_full_loss_gradient_matches_jax(grad_batch, name):
    """One full-loss gradient (multi-scale EPE + L2) per leaf, from the
    same JAX-initialised weights: relative L2 error per leaf <= 1e-4 (f32
    sums in another order through the whole network)."""
    jm = jax_model(name)
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0)))
    inputs = {k: grad_batch[k] for k in ("input_a", "input_b")}
    flow = grad_batch["flow"]

    def loss_fn(p):
        preds = jm.apply(p, inputs, training=True)
        return (jm.loss(flow, preds)
                + WEIGHT_DECAY * joptim.l2_regularization(p))

    with dispatch.use_s2d(False):
        want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = jws.flatten(jax.device_get(want))

    model = get_model(name).build("cpu").train()
    warmstart.load_jax_params(model, params)
    preds = model({k: T(v) for k, v in inputs.items()})
    loss = (get_model(name).loss(T(flow), preds)
            + WEIGHT_DECAY * optim.l2_regularization(model))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    with torch.no_grad():  # grads into the weights, then the JAX layout
        for p in model.parameters():
            p.copy_(p.grad)
    got = warmstart.flatten(warmstart.to_jax_params(model))
    assert got.keys() == want.keys()
    errs = {k: _rel_l2(got[k], np.asarray(want[k])) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, (worst, errs[worst])


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

class _TwoScopes(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.A = common.Conv(3, 4, 5)
        self.B = common.Conv(1, 5, 2)


def test_adam_l2_schedule_match_optax(rng):
    """3 steps across an LR boundary, the same data gradients fed to both;
    scope B frozen. Tolerance: f32 Adam arithmetic in another order,
    against updates of lr scale (1e-3)."""
    schedule = {"step_values": [2], "learning_rates": [1e-3, 4e-4],
                "momentum": 0.9, "momentum2": 0.99, "weight_decay": 0.05,
                "max_iter": 10}
    frozen = ("B",)
    model = _TwoScopes()
    tree = warmstart.random_jax_params(model, seed=3)
    tree["A"]["biases"] = rng.randn(5).astype(np.float32)
    tree["B"]["biases"] = rng.randn(2).astype(np.float32)
    warmstart.load_jax_params(model, tree)
    optim.zero_frozen_grads(model, frozen)
    opt, lr_fn = optim.make_optimizer(
        [p for p in model.parameters() if p.requires_grad], schedule)
    frozen_before = {k: v.clone() for k, v in model.B.state_dict().items()}

    jopt, jlr = joptim.make_optimizer(schedule)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    for step in range(3):
        gdata = warmstart.random_jax_params(model, seed=10 + step)
        # JAX: data grads + weight_decay * grad(l2), frozen zeroed
        l2g = jax.grad(lambda p: joptim.l2_regularization(p, frozen))(jparams)
        g = jax.tree_util.tree_map(
            lambda d, r: jnp.asarray(d) + schedule["weight_decay"] * r,
            gdata, l2g)
        g = joptim.zero_frozen_grads(g, frozen)
        updates, jstate = jopt.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        # torch: the same data gradient through a linear term, L2 in the loss
        flat = warmstart.flatten(gdata)
        w_data = np.ascontiguousarray(common.Conv.from_jax(flat["A/weights"]))
        lin = ((model.A.weights * T(w_data)).sum()
               + (model.A.biases * T(flat["A/biases"])).sum())
        loss = lin + schedule["weight_decay"] * optim.l2_regularization(
            model, frozen)
        opt.zero_grad()
        loss.backward()
        assert model.B.weights.grad is None
        optim.set_lr(opt, lr_fn(step))
        assert lr_fn(step) == float(jlr(step))
        opt.step()
    got = warmstart.flatten(warmstart.to_jax_params(model))
    want = jws.flatten(jax.device_get(jparams))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for k, v in model.B.state_dict().items():
        assert torch.equal(v, frozen_before[k])


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_dataset_is_byte_identical(seed):
    kw = dict(size=4, height=64, width=96, seed=seed)
    ours, ref = loader.SyntheticFlowDataset(**kw), jloader.SyntheticFlowDataset(**kw)
    assert len(ours) == len(ref)
    for i in range(len(ref)):
        for k in ("image_a", "image_b", "flow"):
            assert ours[i][k].dtype == ref[i][k].dtype == np.float32
            assert ours[i][k].tobytes() == ref[i][k].tobytes(), (i, k)


def test_dataset_configs_are_a_copy():
    from flownet2_tf_tpu.data import dataset_configs as jcfg

    assert dataset_configs.DATASETS == jcfg.DATASETS


class _Indexed:
    """A dataset whose items name their index."""

    def __len__(self):
        return 10

    def __getitem__(self, i):
        return {"image_a": np.full((1,), i, np.float32)}


def _indices(bl, **kw):
    it = bl.batches(**kw)
    try:
        return [b["image_a"][:, 0].astype(int).tolist()
                for _, b in zip(range(7), it)]
    finally:
        it.close()


def test_batch_loader_order_and_start_batch_match_jax():
    for start in (0, 2, 5):
        ours = loader.BatchLoader(_Indexed(), 3, seed=4, num_workers=2)
        ref = jloader.BatchLoader(_Indexed(), 3, seed=4, num_workers=2)
        assert _indices(ours, start_batch=start) == _indices(
            ref, start_batch=start)
    # start_batch skips exactly: stream[k:] == stream from batch k
    full = _indices(loader.BatchLoader(_Indexed(), 3, seed=4))
    assert _indices(loader.BatchLoader(_Indexed(), 3, seed=4),
                    start_batch=4)[:3] == full[4:7]


# ---------------------------------------------------------------------------
# Augmentation
# ---------------------------------------------------------------------------

def _coeffs(rng, b):
    return {
        "translate": rng.randn(b, 2).astype(np.float32) * 0.1,
        "rotate": rng.randn(b).astype(np.float32) * 0.3,
        "zoom": (1.0 + rng.rand(b) * 0.5).astype(np.float32),
        "squeeze": (1.0 + rng.rand(b) * 0.2).astype(np.float32),
    }


def test_augmentation_geometry_matches_jax(rng):
    b, in_hw, out_hw = 3, (24, 40), (16, 32)
    ca, cb = _coeffs(rng, b), _coeffs(rng, b)
    image = rng.rand(b, *in_hw, 3).astype(np.float32)
    flow = (rng.randn(b, *in_hw, 2) * 3).astype(np.float32)
    j = {k: {n: jnp.asarray(v) for n, v in c.items()} for k, c in
         (("a", ca), ("b", cb))}
    t = {k: {n: T(v) for n, v in c.items()} for k, c in (("a", ca), ("b", cb))}
    th_j = {k: jaug.coeffs_to_affine(j[k], in_hw, out_hw) for k in j}
    th_t = {k: augmentation.coeffs_to_affine(t[k], in_hw, out_hw) for k in t}
    # closed-form 2x3 arithmetic: f32 rounding only
    for k in th_j:
        np.testing.assert_allclose(th_t[k].numpy(), np.asarray(th_j[k]),
                                   rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(
        augmentation.invert_affine(th_t["a"]).numpy(),
        np.asarray(jaug.invert_affine(th_j["a"])), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        augmentation.affine_sample(T(image), th_t["a"], out_hw).numpy(),
        np.asarray(jaug.affine_sample(jnp.asarray(image), th_j["a"], out_hw)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        augmentation.transform_flow(T(flow), th_t["a"], th_t["b"],
                                    out_hw).numpy(),
        np.asarray(jaug.transform_flow(jnp.asarray(flow), th_j["a"],
                                       th_j["b"], out_hw)),
        rtol=1e-4, atol=1e-4)


def test_photometric_and_chromatic_eigen_match_jax(rng):
    b = 2
    image = (rng.rand(b, 8, 10, 3) * 0.8 + 0.1).astype(np.float32)
    photo = {"noise": np.array([0.02, 0.0], np.float32),
             "brightness": np.array([0.03, -0.02], np.float32),
             "gamma": np.array([1.1, 0.9], np.float32),
             "contrast": np.array([0.95, 1.05], np.float32),
             "color": (1.0 + rng.randn(b, 3) * 0.05).astype(np.float32)}
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, image.shape, jnp.float32))
    want = jaug.apply_photometric(
        key, jnp.asarray(image), {k: jnp.asarray(v) for k, v in photo.items()})
    got = augmentation.apply_photometric(
        T(image), {k: T(v) for k, v in photo.items()}, T(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)

    ce = {}
    for name in jaug.CHROMATIC_EIGEN_KEYS:
        n = 3 if name.startswith("col_") else 1
        v = rng.randn(b, n).astype(np.float32) * 0.1
        v = np.exp(v) if name.endswith(("_pow", "_mult")) else v * 0.2
        ce[name] = v if n == 3 else v[:, 0]
    want = jaug.apply_chromatic_eigen(
        jnp.asarray(image), {k: jnp.asarray(v) for k, v in ce.items()})
    got = augmentation.apply_chromatic_eigen(
        T(image), {k: T(v) for k, v in ce.items()})
    # a 3x3 inverse and fractional powers, in f32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_coeff_distributions_frozen_seed():
    """tests/test_data.py::test_coeff_distributions_frozen_seed for the
    port's torch.Generator draws."""
    spec = {"rand_type": "uniform_bernoulli", "exp": False,
            "mean": 0.1, "spread": 0.2, "prob": 0.5}
    val, is_exp = augmentation._sample_coeff(
        torch.Generator().manual_seed(0), spec, 4096, 1)
    v = val.numpy().ravel()
    assert not is_exp
    nz = v[v != 0.0]
    assert nz.min() >= -0.1 - 1e-6 and nz.max() <= 0.3 + 1e-6
    assert 0.4 < np.mean(v == 0.0) < 0.6

    spec_exp = {"rand_type": "gaussian_bernoulli", "exp": True,
                "mean": 0.0, "spread": 0.1, "prob": 1.0}
    val, is_exp = augmentation._sample_coeff(
        torch.Generator().manual_seed(1), spec_exp, 4096, 1)
    assert is_exp
    g = np.exp(val.numpy().ravel())
    assert g.min() > 0
    assert abs(np.log(g).mean()) < 0.01
    assert abs(np.log(g).std() - 0.1) < 0.01


def test_augment_batch_chairs_spec_and_identity(rng):
    pre = dict(dataset_configs.FLYING_CHAIRS_DATASET_CONFIG["PREPROCESS"])
    pre["crop_height"], pre["crop_width"] = 64, 64
    a = rng.rand(2, 80, 96, 3).astype(np.float32)
    bimg = rng.rand(2, 80, 96, 3).astype(np.float32)
    f = (rng.randn(2, 80, 96, 2) * 2).astype(np.float32)
    outs = augmentation.augment_batch(torch.Generator().manual_seed(0),
                                      T(a), T(bimg), T(f), pre)
    again = augmentation.augment_batch(torch.Generator().manual_seed(0),
                                       T(a), T(bimg), T(f), pre)
    for o, o2, c in zip(outs, again, (3, 3, 2)):
        assert o.shape == (2, 64, 64, c) and torch.isfinite(o).all()
        assert torch.equal(o, o2)  # a pure function of the generator seed
    assert 0.0 <= float(outs[0].min()) and float(outs[0].max()) <= 1.0
    # the `cli train --synthetic` spec (empty transforms) at the input
    # size is the identity up to rounding: images (x - 0.5) * 1 + 0.5; the
    # flow (p + f) - p at pixel coordinates p < 128 (f32 step 7.6e-6)
    ident = {"crop_height": 80, "crop_width": 96, "image_a": {},
             "image_b": {}}
    outs = augmentation.augment_batch(torch.Generator().manual_seed(0),
                                      T(a), T(bimg), T(f), ident)
    for o, x, atol in zip(outs, (a, bimg, f), (1e-6, 1e-6, 1e-5)):
        np.testing.assert_allclose(o.numpy(), x, rtol=0, atol=atol)
    # eval-mode center crop, as the JAX package cuts it
    want = jaug.center_crop_batch(a, bimg, f, pre)
    got = augmentation.center_crop_batch(T(a), T(bimg), T(f), pre)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# Init, trainer, checkpoints, CLI
# ---------------------------------------------------------------------------

def test_msra_init_distribution():
    """JAX's init: std sqrt(2/fan_in) x a normal truncated to +-2 (whose
    own std is 0.8796), zero biases; seeded."""
    model = common.msra_init_(get_model("s").build("cpu"),
                              torch.Generator().manual_seed(0))
    w = model.conv6_1.weights.detach().numpy()  # 3x3, 1024 -> 1024
    std = math.sqrt(2.0 / (3 * 3 * 1024))
    assert np.abs(w).max() <= 2.0 * std * (1 + 1e-6)
    assert abs(w.std() / (std * 0.8796) - 1.0) < 0.01
    assert abs(w.mean()) < 0.01 * std
    assert all(float(m.biases.abs().max()) == 0.0
               for m in model.modules() if isinstance(m, common.Conv))
    again = common.msra_init_(get_model("s").build("cpu"),
                              torch.Generator().manual_seed(0))
    assert torch.equal(again.conv1.weights, model.conv1.weights)
    other = common.msra_init_(get_model("s").build("cpu"),
                              torch.Generator().manual_seed(1))
    assert not torch.equal(other.conv1.weights, model.conv1.weights)


SMOKE_SCHEDULE = {"name": "smoke", "step_values": [40],
                  "learning_rates": [3e-4, 1e-4], "momentum": 0.9,
                  "momentum2": 0.999, "weight_decay": 1e-6, "max_iter": 60}


def _cfg(tmp_path, name, **kw):
    # the f32 path these tests were written for (the trainer's default is
    # bf16; tests/test_torch_bf16.py covers that)
    base = dict(model="s", schedule=SMOKE_SCHEDULE,
                log_dir=str(tmp_path / name), device="cpu", log_every=1000,
                checkpoint_every=0, tensorboard=False,
                compute_dtype="float32")
    base.update(kw)
    return TrainConfig(**base)


def _batch(seed, n=2, h=64, w=64):
    ds = loader.SyntheticFlowDataset(size=n, height=h, width=w, seed=seed)
    return {k: np.stack([ds[i][k] for i in range(n)])
            for k in ("image_a", "image_b", "flow")}


def test_warm_started_frozen_cs_step(tmp_path):
    """CS warm-started from a saved C: C's leaves arrive bitwise, a step
    leaves them bitwise unchanged (no gradient enters them) and moves S."""
    c_trainer = Trainer(_cfg(tmp_path, "c", model="c"))
    c_state = c_trainer.init_state()
    c_trainer.save(c_state, wait=True)
    c_flat = warmstart.flatten(warmstart.to_jax_params(c_state.model))

    trainer = Trainer(_cfg(tmp_path, "cs", model="cs"))
    assert trainer.frozen == ("FlowNetC",)
    state = trainer.warm_start(trainer.init_state(),
                               [(str(tmp_path / "c"), "", "FlowNetC")])
    before = warmstart.flatten(warmstart.to_jax_params(state.model))
    assert all(np.array_equal(before[f"FlowNetC/{k}"], v)
               for k, v in c_flat.items())
    metrics = trainer.train_step(state, _batch(0))
    assert math.isfinite(float(metrics["loss"]))
    after = warmstart.flatten(warmstart.to_jax_params(state.model))
    for k in before:
        if k.startswith("FlowNetC/"):
            assert np.array_equal(after[k], before[k]), k
    assert all(p.grad is None for p in state.model.FlowNetC.parameters())
    moved = [k for k in before if k.startswith("FlowNetS/")
             and not np.array_equal(after[k], before[k])]
    assert len(moved) == len([k for k in before if k.startswith("FlowNetS/")])


def test_grad_accum_matches_full_batch(tmp_path):
    """Two equal microbatches average to the full-batch gradient: the
    logged loss, EPE and grad norm agree to f32 reassociation."""
    batch = _batch(1, n=4)
    out = {}
    for accum in (1, 2):
        trainer = Trainer(_cfg(tmp_path, f"ga{accum}", grad_accum=accum,
                               augment=False))
        out[accum] = {k: float(v) for k, v in trainer.train_step(
            trainer.init_state(), batch).items()}
    for k in ("loss", "data_loss", "epe"):
        np.testing.assert_allclose(out[2][k], out[1][k], rtol=1e-5)
    np.testing.assert_allclose(out[2]["grad_norm"], out[1]["grad_norm"],
                               rtol=1e-4)


def test_resume_is_sample_exact(tmp_path):
    """Interrupted at step 2 and resumed to 4 == 4 uninterrupted steps,
    bitwise: same batches (start_batch), same augmentation draws (seeded
    per step), Adam state restored from optimizer.pt."""
    pre = dict(dataset_configs.FLYING_CHAIRS_DATASET_CONFIG["PREPROCESS"])
    pre["crop_height"], pre["crop_width"] = 64, 64

    def run(name, max_steps):
        ds = loader.SyntheticFlowDataset(size=8, height=64, width=96, seed=2)
        bl = loader.BatchLoader(ds, batch_size=2, num_workers=1)
        trainer = Trainer(_cfg(tmp_path, name, checkpoint_every=2,
                               keep_checkpoints=1))
        return trainer.fit(bl, preprocess=pre, max_steps=max_steps)

    assert run("straight", 4).step == 4
    assert run("resumed", 2).step == 2
    assert run("resumed", 4).step == 4
    assert os.listdir(tmp_path / "resumed" / "checkpoints") == ["4"]
    a = warmstart.load_params_tree(tmp_path / "straight")
    b = warmstart.load_params_tree(tmp_path / "resumed")
    fa, fb = warmstart.flatten(a), warmstart.flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert np.array_equal(fa[k], fb[k]), k


def test_jax_package_reads_port_checkpoint(tmp_path):
    trainer = Trainer(_cfg(tmp_path, "run", keep_checkpoints=1))
    state = trainer.init_state()
    trainer.save(state, wait=True)
    state.step = 3
    trainer.save(state, wait=True)
    assert os.listdir(tmp_path / "run" / "checkpoints") == ["3"]
    path = tmp_path / "run" / "checkpoints" / "3" / "params.npz"
    tree = jws.load_params_tree(str(path))  # the JAX package's reader
    abstract = jax.eval_shape(jax_model("s").init, jax.random.PRNGKey(0))
    shapes = {k: tuple(v.shape) for k, v in jws.flatten(
        jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0),
                                                         s.shape),
                               abstract)).items()}
    flat = jws.flatten(tree)
    assert {k: v.shape for k, v in flat.items()} == shapes
    mine = warmstart.flatten(warmstart.to_jax_params(state.model))
    for k in mine:
        np.testing.assert_array_equal(flat[k], mine[k])
    # and the port's own reader takes the run directory
    assert warmstart.flatten(warmstart.load_params_tree(
        tmp_path / "run")).keys() == mine.keys()


def _train_args(tmp_path, *extra):
    return ["train", "--model", "s", "--synthetic", "--synthetic_size", "2",
            "--synthetic_height", "64", "--synthetic_width", "64",
            "--batch_size", "2", "--schedule", "short", "--log_every", "1",
            "--log_dir", str(tmp_path / "run"), "--compute_dtype", "float32",
            *extra]


def test_cli_train_cpu_synthetic_loss_decreases(tmp_path, capsys):
    rc = cli.main(_train_args(tmp_path, "--max_steps", "6",
                              "--checkpoint_every", "3", "--eval_every", "3",
                              "--device", "cpu"))
    assert rc == 0
    lines = [json.loads(line) for line in
             capsys.readouterr().out.splitlines() if line.startswith("{")]
    evals = [r for r in lines if "val_epe" in r]
    assert [r["step"] for r in evals] == [3, 6]
    assert all(math.isfinite(r["val_epe"]) for r in evals)
    recs = [r for r in lines if "loss" in r]
    assert [r["step"] for r in recs] == [1, 2, 3, 4, 5, 6]
    losses = [r["loss"] for r in recs]
    assert all(math.isfinite(x) for x in losses)
    assert np.mean(losses[-2:]) < np.mean(losses[:2]), losses
    assert set(recs[0]) == {"step", "loss", "data_loss", "epe", "grad_norm",
                            "lr", "examples_per_sec"}
    assert sorted(os.listdir(tmp_path / "run" / "checkpoints")) == ["3", "6"]
    # the TensorBoard events are valid TFRecords (CRCs checked)
    events = [f for f in os.listdir(tmp_path / "run")
              if f.startswith("events.out.tfevents")]
    assert len(events) == 1
    records = list(jtfrecord.read_records(tmp_path / "run" / events[0]))
    assert len(records) == 1 + 6 + 2  # header, logged steps, evals


def test_interrupted_fit_saves_its_step(tmp_path):
    """A failure in the data stream after 2 steps: fit re-raises, and the
    interrupt checkpoint holds step 2, which the next fit resumes from."""

    class Failing:
        def batches(self, start_batch=0):
            for i in range(start_batch, 2):
                yield _batch(i)
            raise RuntimeError("stream broke")

    trainer = Trainer(_cfg(tmp_path, "run", augment=False))
    with pytest.raises(RuntimeError, match="stream broke"):
        trainer.fit(Failing(), max_steps=5)
    assert os.listdir(tmp_path / "run" / "checkpoints") == ["2"]
    state, resumed = Trainer(_cfg(tmp_path, "run")).restore_or_init()
    assert resumed and state.step == 2
    assert len(state.optimizer.state) == len(list(state.model.parameters()))


def test_cli_train_refuses_what_is_not_ported(tmp_path):
    # no --synthetic: the default dataset (chairs) is read from disk, and
    # this checkout has neither its TFRecords nor its raw layout
    with pytest.raises(FileNotFoundError, match="no data for flying_chairs"):
        cli.main(["train", "--model", "s", "--device", "cpu", "--data_root",
                  str(tmp_path / "no_chairs_here")])
    # float32 and bfloat16 train (tests/test_torch_bf16.py); no other dtype
    with pytest.raises(SystemExit):
        cli.main(_train_args(tmp_path, "--compute_dtype", "float16"))
    with pytest.raises(ValueError, match="compute_dtype"):
        Trainer(_cfg(tmp_path, "f16", compute_dtype="float16"))
    assert Trainer(_cfg(tmp_path, "bf16", compute_dtype="bfloat16")
                   ).compute_dtype == torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda.is_available"):
            cli.main(_train_args(tmp_path, "--device", "cuda"))
