"""The torch port's bf16 mixed-precision policy against the JAX package's,
on the CPU.

The same numpy-seeded inputs and weights go through the JAX function at
``compute_dtype=jnp.bfloat16`` and its port at ``torch.bfloat16``: single
layers, the per-layer policy table of FlowNet2, ``cast_params_for_inference``
and its guard, each model's forward, the S and C loss gradients, the
trainer at its bf16 default, ``transfer_flow_dtype`` and the CLI.

Tolerances, with the values measured when they were set:

* a feature layer (bf16 in and out, f32 sums inside): within one bf16
  step, rtol 2**-7 (measured with zero biases: 0.004% of outputs one step
  apart, max relative error 7.6e-3); with a bias, atol one bf16 step of
  the largest output (measured 0.55 of it: JAX rounds the conv before
  adding the bias, cuDNN adds it to the f32 sum);
* an f32 layer under the bf16 policy: the f32 tolerance of
  tests/test_torch_models.py, rtol 1e-5;
* a whole model or gradient: the port's distance to the JAX bf16 result
  must be at most the JAX package's own bf16-against-f32 distance on the
  same inputs. Relative L2 per ``predict_flow*``, mean EPE for full-res
  flows; the ratio measured at b2 128x192 was at most 0.85 (FlowNetS
  predict_flow6). For the gradients, relative L2 over all leaves at once
  (measured ratio 0.32 for S, 0.87 for C) and, per leaf, at most 1.5x the
  JAX distance (measured worst 1.34x, ``upsample_flow6to5/biases`` of S,
  whose gradient is a sum of rounded bf16 terms over every pixel).
"""

import functools
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

from flownet2_tf_tpu.models import common as jcommon  # noqa: E402
from flownet2_tf_tpu.models import flownet_c as jflownet_c  # noqa: E402
from flownet2_tf_tpu.models import flownet_s as jflownet_s  # noqa: E402
from flownet2_tf_tpu.models import flownet_sd as jflownet_sd  # noqa: E402
from flownet2_tf_tpu.models import stacks as jstacks  # noqa: E402
from flownet2_tf_tpu.models.registry import get_model as jax_model  # noqa: E402
from flownet2_tf_tpu.ops import dispatch  # noqa: E402
from flownet2_tf_tpu.training import infer as jinfer  # noqa: E402
from flownet2_tf_tpu.training import optim as joptim  # noqa: E402
from flownet2_tf_tpu.training import warmstart as jws  # noqa: E402
from flownet2_tf_tpu_torch import cli  # noqa: E402
from flownet2_tf_tpu_torch.data import loader  # noqa: E402
from flownet2_tf_tpu_torch.models import common, flownet_c, flownet_s  # noqa: E402
from flownet2_tf_tpu_torch.models import flownet_sd, stacks  # noqa: E402
from flownet2_tf_tpu_torch.models.registry import get_model  # noqa: E402
from flownet2_tf_tpu_torch.ops import flow_warp  # noqa: E402
from flownet2_tf_tpu_torch.ops.cuda import correlation_kernel  # noqa: E402
from flownet2_tf_tpu_torch.training import infer, optim, warmstart  # noqa: E402
from flownet2_tf_tpu_torch.training.loop import TrainConfig, Trainer  # noqa: E402
from flownet2_tf_tpu_torch.utils import flowlib  # noqa: E402
from flownet2_tf_tpu_torch.utils.image_io import load_image_pair  # noqa: E402

T = torch.from_numpy
BF16 = torch.bfloat16
ROOT = os.path.join(os.path.dirname(__file__), "..")
SAMPLES = os.path.join(ROOT, "data", "samples")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
H, W = 128, 192
FULL_RES = ("flow", "flow_css", "flow_sd")

@pytest.fixture(autouse=True)
def _drop_test_files(tmp_path):
    """Training runs and FlowNet2 checkpoints here are 150-650 MB each: delete what each test wrote when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)



def _f32(x):
    """A JAX or torch array of any float dtype as an f32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _mean_epe(got, want):
    return float(np.sqrt(((got - want) ** 2).sum(-1)).mean())


def _scope(name):
    return name.replace(".", "/")


def _is_f32_layer(scope):
    """The JAX package's rule: a layer whose scope names a flow head, a flow
    upsampler or an interconv computes in f32."""
    return any(m in scope.split("/")[-1] for m in jcommon._F32_LAYER_MARKERS)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _layer_pair(rng, deconv, cin, cout, k, act, bias=True):
    """A numpy-seeded layer as a JAX param dict and as the port's module."""
    w = (rng.standard_normal((k, k, cin, cout))
         * np.sqrt(2.0 / (k * k * cin))).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1 * bias).astype(np.float32)
    if deconv:
        layer = common.Deconv(cin, cout, act=act, k=k)
    else:
        layer = common.Conv(k, cin, cout, act=act)
    with torch.no_grad():
        layer.weights.copy_(T(np.ascontiguousarray(layer.from_jax(w))))
        layer.biases.copy_(T(b))
    return {"weights": jnp.asarray(w), "biases": jnp.asarray(b)}, layer


@pytest.mark.parametrize("kind,cin,cout,k", [
    ("conv", 64, 128, 3),
    ("deconv", 128, 64, 4),
])
@pytest.mark.parametrize("bias", [False, True], ids=["zero_bias", "bias"])
def test_feature_layer_bf16_matches_jax(rng, kind, cin, cout, k, bias):
    """A feature conv/deconv under the bf16 policy: bf16 in, weights and
    out, within one bf16 step of the JAX layer. With a bias, JAX rounds
    the conv to bf16 before adding it (cuDNN adds it to the f32 sum), so
    where the bias cancels the output, the step is the conv's: atol one
    bf16 step of the largest output."""
    p, layer = _layer_pair(rng, kind == "deconv", cin, cout, k, act=True,
                           bias=bias)
    x = rng.rand(2, 12, 16, cin).astype(np.float32) - 0.5
    jfn = jcommon.conv if kind == "conv" else jcommon.deconv
    want = jfn(p, jnp.asarray(x), compute_dtype=jnp.bfloat16)
    assert want.dtype == jnp.bfloat16
    got = layer(common.nchw(T(x), BF16), BF16)
    assert got.dtype == BF16 and layer.weights.dtype == torch.float32
    got = common.nhwc(got)
    assert got.shape == want.shape
    want = _f32(want)
    atol = 2.0 ** -7 * float(np.abs(want).max()) if bias else 1e-6
    np.testing.assert_allclose(_f32(got), want, rtol=2.0 ** -7, atol=atol)


@pytest.mark.parametrize("kind,cin,cout,k", [
    ("predict_flow", 64, 2, 3),
    ("upsample_flow", 2, 2, 4),
    ("interconv", 130, 64, 3),
])
def test_f32_layers_under_bf16_match_jax(rng, kind, cin, cout, k):
    """Flow heads, flow upsamplers and interconvs stay f32 under the bf16
    policy, and take a bf16 input (the concat) in f32."""
    p, layer = _layer_pair(rng, kind == "upsample_flow", cin, cout, k,
                           act=False)
    x = jnp.asarray(rng.rand(2, 12, 16, cin).astype(np.float32) - 0.5)
    if kind != "upsample_flow":  # upsamplers take the f32 flow
        x = x.astype(jnp.bfloat16)
    if kind == "upsample_flow":
        want = jcommon.deconv(p, x, act=False, compute_dtype=jnp.bfloat16)
    else:
        want = jcommon.conv(p, x, act=False, compute_dtype=jnp.bfloat16,
                            interconv=kind == "interconv")
    assert want.dtype == jnp.float32
    xt = T(_f32(x).copy())
    if kind != "upsample_flow":
        xt = xt.to(BF16)
    got = common.nhwc(layer(common.nchw(xt, BF16), BF16))
    assert got.dtype == torch.float32
    # f32 sums of the same (bf16-exact) inputs in another order
    np.testing.assert_allclose(_f32(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_unsupported_compute_dtype_is_refused():
    layer = common.Conv(3, 4, 4)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        layer(torch.zeros(1, 4, 8, 8), torch.float16)
    with pytest.raises(ValueError, match="compute_dtype"):
        common.compute_dtype_of("float16")
    assert common.compute_dtype_of("bfloat16") == BF16
    assert common.io_dtype(None, True) == torch.float32
    assert common.io_dtype(BF16, False) == torch.float32


@pytest.mark.parametrize("before", [(True, True, False), (False, True, True)])
@pytest.mark.parametrize("cd", [None, torch.float32, BF16])
def test_f32_policy_sets_and_restores_its_flags(before, cd):
    """``f32_policy``: no TF32 for cuDNN convs and matmuls, and cuDNN's
    deterministic algorithms under both policies, the bf16 one included
    (the JAX reference repeats itself bit for bit). The caller's three
    flags come back on exit, also after an exception."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul

    def flags():
        return cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic

    inside = (False, False, True)
    saved = flags()
    try:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic = before
        with common.f32_policy(cd):
            assert flags() == inside
        assert flags() == before
        with pytest.raises(RuntimeError, match="inside"):
            with common.f32_policy(cd):
                assert flags() == inside
                raise RuntimeError("inside")
        assert flags() == before
    finally:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic = saved


def test_f32_policy_layer_rejects_precast_bf16_weights(rng):
    """tests/test_ops_oracle.py:706-730 for the port: an f32-policy layer
    holding bf16 weights raises, naming the layer, rather than run the
    quantized copy as if it were exact."""
    head = common.Conv(3, 4, 2, act=False)
    x = T(rng.rand(1, 4, 8, 8).astype(np.float32))
    feature = common.Conv(3, 4, 4)
    common.cast_params_for_inference(feature)
    assert feature.weights.dtype == BF16
    # consistent context: pre-cast feature weights under the bf16 policy
    assert feature(x, BF16).dtype == BF16
    # the same layer under the f32 policy is refused
    with pytest.raises(ValueError, match=r"Conv\(4->4, k=3.*f32-policy"):
        feature(x)
    # a whole-module cast reaches the flow head too
    head.bfloat16()
    with pytest.raises(ValueError, match="act=False.*f32-policy"):
        head(x.to(BF16), BF16)


# ---------------------------------------------------------------------------
# FlowNet2 per layer, and the ops on its path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree():
    """FlowNet2's JAX-layout tree: numpy-seeded, shaped by eval_shape
    (tests/test_torch_models.py)."""
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
    return {k: rng.rand(2, H, W, 3).astype(np.float32)
            for k in ("input_a", "input_b")}


@pytest.fixture(scope="module")
def flownet2_bf16_trace(tree):
    """One bf16 FlowNet2 forward at 64x128 recording, per layer, the dtype
    that reached it and the dtype it returned; what the warps gathered;
    and what reached the correlation kernel's wrapper."""
    model = warmstart.load_jax_params(stacks.FlowNet2(), tree).eval()
    layers, gathers, corr = {}, [], []

    def hook(name):
        def fn(mod, args, out):
            layers[_scope(name)] = (args[0].dtype, out.dtype,
                                    common.io_dtype(args[1], mod.act))
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in
               model.named_modules()
               if isinstance(m, (common.Conv, common.Deconv))]

    def spy(fn, record):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            record.append(tuple(t.dtype for t in args
                                if isinstance(t, torch.Tensor))
                          + (out.dtype,))
            return out
        return wrapped

    mp = pytest.MonkeyPatch()
    mp.setattr(flow_warp, "bilinear_gather",
               spy(flow_warp.bilinear_gather, gathers))
    mp.setattr(flow_warp, "bilinear_gather_multi",
               spy(flow_warp.bilinear_gather_multi, gathers))
    mp.setattr(correlation_kernel, "correlation_cuda",
               spy(correlation_kernel.correlation_cuda, corr))
    rng = np.random.RandomState(3)
    inputs = {k: T(rng.rand(1, 64, 128, 3).astype(np.float32))
              for k in ("input_a", "input_b")}
    try:
        with torch.inference_mode():
            preds = model(inputs, BF16)
    finally:
        mp.undo()
        for h in handles:
            h.remove()
    return {"layers": layers, "gathers": gathers, "corr": corr,
            "preds": preds, "keys": warmstart.jax_param_shapes(model)}


def test_policy_table_matches_jax(flownet2_bf16_trace):
    """Every FlowNet2 layer computes in the dtype ``_conv_io_dtypes`` gives
    it: f32 for the flow heads, upsamplers and interconvs, bf16 for the
    rest. Feature layers receive bf16 (the concats are cast) except the
    two that read the f32 images; upsamplers receive the f32 flows."""
    layers = flownet2_bf16_trace["layers"]
    scopes = {k.rsplit("/", 1)[0] for k in flownet2_bf16_trace["keys"]}
    assert set(layers) == scopes  # every layer ran once
    entries = {"FlowNetCSS/FlowNetCS/FlowNetC/conv1", "FlowNetSD/conv0"}
    for scope, (seen, out, io) in layers.items():
        f32 = _is_f32_layer(scope)
        want, _ = jcommon._conv_io_dtypes(
            jnp.bfloat16, act=not f32, interconv="interconv" in scope)
        assert str(out).split(".")[-1] == jnp.dtype(want).name, scope
        assert out == io, scope
        if "upsample_flow" in scope:
            assert seen == torch.float32, scope
        elif not f32 or "interconv" in scope:
            assert seen == (torch.float32 if scope in entries else BF16), scope


def test_warps_gather_f32_and_correlation_takes_bf16(flownet2_bf16_trace):
    """Under the bf16 policy the four stack warps gather f32 images at f32
    coordinates, and the correlation wrapper gets FlowNetC's bf16 conv3
    features as they are (no upcast) and returns the f32 cost volume."""
    gathers = flownet2_bf16_trace["gathers"]
    assert len(gathers) == 3  # two stage-2 warps, one double warp
    assert all(d == torch.float32 for g in gathers for d in g)
    assert flownet2_bf16_trace["corr"] == [(BF16, BF16, torch.float32)]
    preds = flownet2_bf16_trace["preds"]
    assert all(v.dtype == torch.float32 for v in preds.values())
    assert all(torch.isfinite(v).all() for v in preds.values())


# ---------------------------------------------------------------------------
# cast_params_for_inference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["s", "2"])
def test_cast_params_for_inference_matches_jax(name):
    """The pre-cast leaves are the JAX function's, by name; the pre-cast
    bf16 forward is bitwise the non-pre-cast one
    (tests/test_models.py:403-427); the JAX-layout tree stays f32."""
    model = get_model(name).build("cpu")
    tree = warmstart.random_jax_params(model, seed=1)
    warmstart.load_jax_params(model, tree)
    jcast = jws.flatten(jcommon.cast_params_for_inference(tree))
    want = {k for k, v in jcast.items() if v.dtype == jnp.bfloat16}

    rng = np.random.RandomState(2)
    inputs = {k: T(rng.rand(1, 64, 128, 3).astype(np.float32))
              for k in ("input_a", "input_b")}
    with torch.inference_mode():
        before = model(inputs, BF16)
    common.cast_params_for_inference(model)
    got = {_scope(k) for k, p in model.named_parameters() if p.dtype == BF16}
    assert got == want and len(got) > 0
    assert {_scope(k) for k, p in model.named_parameters()} == set(jcast)
    with torch.inference_mode():
        after = model(inputs, BF16)
    for k in before:
        assert torch.equal(after[k], before[k]), k

    back = warmstart.flatten(warmstart.to_jax_params(model))
    for k, v in back.items():
        assert v.dtype == np.float32, k
        np.testing.assert_array_equal(v, _f32(jcast[k]), err_msg=k)


# ---------------------------------------------------------------------------
# Per model
# ---------------------------------------------------------------------------

def _torch_preds(module, params, inputs, cd):
    warmstart.load_jax_params(module, params)
    if isinstance(inputs, dict):
        inputs = {k: T(v) for k, v in inputs.items()}
    else:
        inputs = T(inputs)
    with torch.inference_mode():
        preds = module.eval()(inputs, cd)
    return preds


def _jax_preds(apply, params, inputs, cd):
    fn = jax.jit(functools.partial(apply, compute_dtype=cd))
    with dispatch.use_s2d(False):
        return {k: _f32(v) for k, v in fn(params, inputs).items()}


MODELS = {
    "s12": (lambda: flownet_s.FlowNetS(input_channels=12), jflownet_s.apply,
            lambda t: t["FlowNetCSS"]["FlowNetS"]),
    "c": (flownet_c.FlowNetC, jflownet_c.apply,
          lambda t: t["FlowNetCSS"]["FlowNetCS"]["FlowNetC"]),
    "sd": (flownet_sd.FlowNetSD, jflownet_sd.apply, lambda t: t["FlowNetSD"]),
    "2": (stacks.FlowNet2, jstacks.apply_flownet2, lambda t: t),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_model_bf16_matches_jax(tree, images, name):
    """Each model at bf16 against the JAX package's bf16 (plain path), on
    the same inputs: the predictions are f32, and each one's distance to
    JAX is at most JAX's own bf16-against-f32 distance."""
    build, apply, sub = MODELS[name]
    params = sub(tree)
    inputs = images
    if name == "s12":
        inputs = np.random.RandomState(2).rand(2, H, W, 12).astype(np.float32)
    got = _torch_preds(build(), params, inputs, BF16)
    want = _jax_preds(apply, params, inputs, jnp.bfloat16)
    ref = _jax_preds(apply, params, inputs, None)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert got[k].shape == want[k].shape, k
        assert torch.isfinite(got[k]).all(), k
        dist = _mean_epe if k in FULL_RES else _rel_l2
        ours, theirs = dist(_f32(got[k]), want[k]), dist(want[k], ref[k])
        assert ours <= theirs, (k, ours, theirs)


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------

WEIGHT_DECAY = 4e-4


@pytest.mark.parametrize("name", ["s", "c"])
def test_bf16_loss_gradient_matches_jax(name):
    """The bf16 full loss (multi-scale EPE + L2, f32 on the f32 preds) and
    its gradients against ``jax.grad`` at bf16: the gradients land f32 on
    the f32 masters, and their distance to JAX's is bounded by JAX's own
    bf16-against-f32 gradient distance."""
    rng = np.random.RandomState(5)
    inputs = {k: rng.rand(2, 64, 64, 3).astype(np.float32)
              for k in ("input_a", "input_b")}
    flow = (rng.randn(2, 64, 64, 2) * 3).astype(np.float32)
    jm = jax_model(name)
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0)))

    def jax_grads(cd):
        def loss_fn(p):
            preds = jm.apply(p, inputs, training=True, compute_dtype=cd)
            return (jm.loss(flow, preds)
                    + WEIGHT_DECAY * joptim.l2_regularization(p))

        with dispatch.use_s2d(False):
            loss, g = jax.jit(jax.value_and_grad(loss_fn))(params)
        return float(loss), {k: np.asarray(v)
                             for k, v in jws.flatten(jax.device_get(g)).items()}

    want_loss, want = jax_grads(jnp.bfloat16)
    _, ref = jax_grads(None)

    model = get_model(name).build("cpu").train()
    warmstart.load_jax_params(model, params)
    preds = model({k: T(v) for k, v in inputs.items()}, BF16)
    data_loss = get_model(name).loss(T(flow), preds)
    assert data_loss.dtype == torch.float32
    loss = data_loss + WEIGHT_DECAY * optim.l2_regularization(model)
    loss.backward()
    # the loss of the same bf16 forward: rounding-level apart
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-3)
    with torch.no_grad():
        for p in model.parameters():
            assert p.dtype == p.grad.dtype == torch.float32
            p.copy_(p.grad)
    got = warmstart.flatten(warmstart.to_jax_params(model))
    assert got.keys() == want.keys()
    keys = sorted(want)
    cat = lambda d: np.concatenate([d[k].ravel() for k in keys])  # noqa: E731
    ours, theirs = _rel_l2(cat(got), cat(want)), _rel_l2(cat(want), cat(ref))
    assert ours <= theirs, (ours, theirs)
    for k in keys:
        ours, theirs = _rel_l2(got[k], want[k]), _rel_l2(want[k], ref[k])
        assert ours <= 1.5 * theirs, (k, ours, theirs)


# ---------------------------------------------------------------------------
# Trainer and CLI
# ---------------------------------------------------------------------------

SMOKE_SCHEDULE = {"name": "smoke", "step_values": [40],
                  "learning_rates": [3e-4, 1e-4], "momentum": 0.9,
                  "momentum2": 0.999, "weight_decay": 1e-6, "max_iter": 60}


def _cfg(tmp_path, name, **kw):
    base = dict(model="s", schedule=SMOKE_SCHEDULE,
                log_dir=str(tmp_path / name), device="cpu", log_every=1000,
                checkpoint_every=0, tensorboard=False)
    base.update(kw)
    return TrainConfig(**base)


def _batch(seed, n=2, h=64, w=64):
    ds = loader.SyntheticFlowDataset(size=n, height=h, width=w, seed=seed)
    return {k: np.stack([ds[i][k] for i in range(n)])
            for k in ("image_a", "image_b", "flow")}


def _train_args(tmp_path, *extra):
    return ["train", "--model", "s", "--synthetic", "--synthetic_size", "4",
            "--synthetic_height", "64", "--synthetic_width", "64",
            "--batch_size", "2", "--schedule", "short", "--log_every", "1",
            "--no_augment", "--device", "cpu", "--log_dir",
            str(tmp_path / "run"), *extra]


def _records(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith('{"step"') and '"loss"' in line]


def test_cli_train_defaults_to_bf16_with_f32_checkpoints(tmp_path, capsys,
                                                          monkeypatch):
    """``cli train`` with no --compute_dtype trains FlowNetS in bf16 (the
    JAX package's default): 6 steps, finite and falling loss, f32
    checkpoint leaves, and a resume that continues from step 6."""
    assert TrainConfig().compute_dtype == "bfloat16"
    seen = []
    forward = flownet_s.FlowNetS.forward

    def spy(self, inputs, compute_dtype=None):
        seen.append(compute_dtype)
        return forward(self, inputs, compute_dtype)

    monkeypatch.setattr(flownet_s.FlowNetS, "forward", spy)
    assert cli.main(_train_args(tmp_path, "--max_steps", "6",
                                "--checkpoint_every", "3")) == 0
    recs = _records(capsys)
    assert [r["step"] for r in recs] == [1, 2, 3, 4, 5, 6]
    losses = [r["loss"] for r in recs]
    assert all(math.isfinite(x) for x in losses)
    assert np.mean(losses[-2:]) < np.mean(losses[:2]), losses
    assert seen and set(seen) == {BF16}
    flat = warmstart.flatten(warmstart.load_params_tree(tmp_path / "run"))
    assert all(v.dtype == np.float32 for v in flat.values())

    assert cli.main(_train_args(tmp_path, "--max_steps", "8")) == 0
    assert [r["step"] for r in _records(capsys)] == [7, 8]
    assert sorted(os.listdir(tmp_path / "run" / "checkpoints"))[-1] == "8"


def test_unfrozen_bf16_cs_step_has_finite_gradients(tmp_path):
    """Nothing frozen: the bf16 gradient enters FlowNetC through the
    stage-2 warp, the brightness error's channel norm (exact zeros guarded
    by _SafeSqrt) and the correlation. Every gradient is finite."""
    trainer = Trainer(_cfg(tmp_path, "cs", model="cs", frozen=(),
                           augment=False))
    assert trainer.compute_dtype == BF16
    state = trainer.init_state()
    metrics = trainer.train_step(state, _batch(0))
    assert math.isfinite(float(metrics["loss"]))
    assert math.isfinite(float(metrics["grad_norm"]))
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    assert all(g is not None and g.dtype == torch.float32
               and torch.isfinite(g).all() for g in grads.values())
    assert any(float(g.abs().max()) > 0 for k, g in grads.items()
               if k.startswith("FlowNetC."))


def test_transfer_flow_dtype(tmp_path):
    """tests/test_training.py:150-185 for the port: the GT flow crosses as
    float16/bfloat16 and is f32 again on the device; the evaluated EPE
    after 4 steps stays within 5% (f16) and 20% (bf16) of the f32 run's;
    a bad value raises naming the option."""
    epes = {}
    for dt in ("float32", "float16", "bfloat16"):
        ds = loader.SyntheticFlowDataset(size=8, height=64, width=64, seed=3,
                                         max_flow=3.0)
        bl = loader.BatchLoader(ds, batch_size=2, shuffle=False,
                                num_workers=1)
        trainer = Trainer(_cfg(tmp_path, f"tfd_{dt}", transfer_flow_dtype=dt,
                               compute_dtype="float32", augment=False))
        state = trainer.fit(bl, max_steps=4)
        epes[dt] = trainer.evaluate(state, bl, max_batches=2)
        assert np.isfinite(epes[dt])
    assert abs(epes["float16"] - epes["float32"]) < 0.05 * (
        1 + epes["float32"])
    assert abs(epes["bfloat16"] - epes["float32"]) < 0.2 * (
        1 + epes["float32"])
    wire = Trainer(_cfg(tmp_path, "wire", transfer_flow_dtype="bfloat16"))
    batch = _batch(1)
    _, _, flow = wire._to_device(batch, wire.flow_wire_dtype)
    assert flow.dtype == torch.float32
    np.testing.assert_array_equal(
        flow.numpy(), T(batch["flow"]).to(BF16).float().numpy())
    with pytest.raises(ValueError, match="transfer_flow_dtype"):
        Trainer(_cfg(tmp_path, "bad", transfer_flow_dtype="int8"))


def test_cli_test_bf16_flownet2_matches_jax(tmp_path, capsys):
    """``cli test --model 2 --compute_dtype bfloat16 --device cpu`` on the
    bundled pair, FlowNet2(PRNGKey(0)) weights: a finite .flo whose mean
    EPE to the JAX package's bf16 ``test`` flow is at most the JAX bf16
    flow's EPE to the committed f32 golden."""
    params = jax.device_get(jax.jit(jax_model("2").init)(
        jax.random.PRNGKey(0)))
    ckpt = tmp_path / "flownet2.npz"
    np.savez(ckpt, **jws.flatten(params))
    rc = cli.main(["test", "--model", "2", "--ckpt", str(ckpt),
                   "--device", "cpu", "--compute_dtype", "bfloat16",
                   "--input_a", os.path.join(SAMPLES, "0img0.ppm"),
                   "--input_b", os.path.join(SAMPLES, "0img1.ppm"),
                   "--out", str(tmp_path)])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["flow_shape"] == [192, 256, 2]
    got = flowlib.read_flow(tmp_path / "0img0_flow.flo")
    assert np.isfinite(got).all()
    a, b = load_image_pair(os.path.join(SAMPLES, "0img0.ppm"),
                           os.path.join(SAMPLES, "0img1.ppm"))
    want = jinfer.infer_flow("2", jcommon.cast_params_for_inference(params),
                             a, b, compute_dtype="bfloat16")
    golden = np.load(os.path.join(GOLDEN, "flownet_2_seed0.npz"))["flow"]
    ours, theirs = _mean_epe(got, np.asarray(want)), _mean_epe(want, golden)
    assert ours <= theirs, (ours, theirs)
    f32 = infer.infer_flow("2", params, a, b, device="cpu")
    assert _mean_epe(got, f32) > 0  # the bf16 path really ran
