"""The torch port's approximation knobs against the JAX package's, on the
CPU: FlowNet2's half-res fusion (``fusion_res=2``), the bf16 interconvs
(``bf16_interconv``) and the f32 feature precision (``f32_features``),
through the models, the CLI, the bench and a serving artifact.

Weights come from the JAX package's ``model.init(PRNGKey(0))``, exported
with its ``warmstart.flatten``, and feed both packages; inputs are
numpy-seeded. The JAX side runs its plain path (``use_s2d(False)``) under
the dispatch knob that matches the port's build argument
(``use_fusion_res``, ``use_warp_res``, ``use_bf16_interconv``,
``use_f32_features_precision``).

Tolerances, as the files that hold the exact paths set them:

* f32: tests/test_torch_models.py's, each ``predict_flow*`` at rtol 1e-4
  and atol 1e-4 * scale, the full-resolution flows at
  tests/test_golden.py:96-99's rtol 1e-3 and atol 5e-3 * scale;
* bf16: tests/test_torch_bf16.py's, the port's distance to the JAX bf16
  result at most the JAX package's own bf16-against-f32 distance
  (relative L2 per ``predict_flow*``, mean EPE for full-res flows);
* ``f32_features='default'``: on the CPU the port has no TF32, so its
  output is bitwise ``'highest'``'s, and its mean distance to the JAX
  ``'default'`` output is at most the JAX package's own
  default-against-highest distance;
* a served artifact against the eager model: bitwise (the same ops on
  the same device).
"""

import functools
import json
import os
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flownet2_tf_tpu.models import flownet_s as jflownet_s  # noqa: E402
from flownet2_tf_tpu.models import flownet_sd as jflownet_sd  # noqa: E402
from flownet2_tf_tpu.models import stacks as jstacks  # noqa: E402
from flownet2_tf_tpu.models.common import (  # noqa: E402
    cast_params_for_inference as jcast_params_for_inference,
)
from flownet2_tf_tpu.models.registry import get_model as jget_model  # noqa: E402
from flownet2_tf_tpu.ops import dispatch  # noqa: E402
from flownet2_tf_tpu.training import warmstart as jws  # noqa: E402
from flownet2_tf_tpu_torch import cli  # noqa: E402
from flownet2_tf_tpu_torch.models import common  # noqa: E402
from flownet2_tf_tpu_torch.models import flownet_s, registry, stacks  # noqa: E402
from flownet2_tf_tpu_torch.models.registry import get_model  # noqa: E402
from flownet2_tf_tpu_torch.tools import aot, bench, benchlib  # noqa: E402
from flownet2_tf_tpu_torch.training import infer, warmstart  # noqa: E402

T = torch.from_numpy
BF16 = torch.bfloat16
H, W = 64, 128
FULL_RES = ("flow", "flow_css", "flow_sd")


@pytest.fixture(autouse=True)
def _remove_tmp_path(tmp_path):
    """Each test's files (a FlowNet2 artifact is 650 MB) go when it ends."""
    yield
    import shutil

    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def flat():
    """FlowNet2's weights from the JAX package's init, flattened by its
    warmstart.flatten (a flat '/'-keyed tree both packages load)."""
    params = jget_model("2").init(jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in jws.flatten(params).items()}


@pytest.fixture(scope="module")
def jtree(flat):
    return jws.unflatten(flat)


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(1)
    return {k: rng.rand(1, H, W, 3).astype(np.float32)
            for k in ("input_a", "input_b")}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _mean_epe(got, want):
    return float(np.sqrt(((got - want) ** 2).sum(-1)).mean())


def _port(model_name, params, inputs, cd=None, **knobs):
    model = get_model(model_name).build("cpu", **knobs)
    warmstart.load_jax_params(model, params)
    with torch.inference_mode():
        preds = model({k: T(v) for k, v in inputs.items()}, cd)
    return {k: _f32(v) for k, v in preds.items()}


def _jax(apply, params, inputs, cd=None, fusion_res=1, warp_res=1,
         bf16_interconv=False):
    # a fresh jit per configuration: the knobs are read at trace time
    fn = jax.jit(functools.partial(apply, compute_dtype=cd))
    with dispatch.use_s2d(False), dispatch.use_fusion_res(fusion_res), \
            dispatch.use_warp_res(warp_res), \
            dispatch.use_bf16_interconv(bf16_interconv):
        return {k: _f32(v) for k, v in fn(params, inputs).items()}


def _assert_match(got, want):
    """tests/test_torch_models.py's f32 tolerances."""
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


def _assert_bf16_within_jax(got, want, ref):
    """tests/test_torch_bf16.py's bound: the port's distance to the JAX
    bf16 result at most JAX's own bf16-against-f32 distance."""
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.isfinite(got[k]).all(), k
        dist = _mean_epe if k in FULL_RES else _rel_l2
        ours, theirs = dist(got[k], want[k]), dist(want[k], ref[k])
        assert ours <= theirs, (k, ours, theirs)


# ---------------------------------------------------------------------------
# Half-res fusion
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fusion_f32(jtree, images):
    """The JAX f32 half-res-fusion forward (the f32 reference of the bf16
    bound too)."""
    return _jax(jstacks.apply_flownet2, jtree, images, fusion_res=2)


@pytest.mark.parametrize("warp_res", [1, 2])
def test_halfres_fusion_matches_jax(flat, jtree, images, fusion_f32,
                                    warp_res):
    """FlowNet2(fusion_res=2) against ``use_fusion_res(2)``: the fusion
    net runs on the half-res input, so ``predict_flow0`` comes out at
    (1, 32, 64, 2), the final flow at full resolution; the branch flows
    are the full-res ones. At ``warp_res=2`` the stage-2 warps are the
    coarse ones while the fusion's own double warp stays exact, in both
    packages."""
    want = (fusion_f32 if warp_res == 1 else
            _jax(jstacks.apply_flownet2, jtree, images, fusion_res=2,
                 warp_res=warp_res))
    got = _port("2", flat, images, fusion_res=2, warp_res=warp_res)
    assert got["predict_flow0"].shape == (1, H // 2, W // 2, 2)
    assert got["flow"].shape == (1, H, W, 2)
    _assert_match(got, want)
    # the multi-scale fusion loss on the half-res heads: GT downsampled to
    # each head's size in both packages
    gt = np.random.RandomState(5).randn(1, H, W, 2).astype(np.float32)
    mine = stacks.loss_flownet2(T(gt), {k: T(v) for k, v in got.items()})
    theirs = jstacks.loss_flownet2(jnp.asarray(gt), want)
    np.testing.assert_allclose(float(mine), float(theirs), rtol=1e-4)


def test_halfres_fusion_is_another_function(flat, images, fusion_f32):
    """The knob changes what is computed (the full-res fusion's flow
    differs), and a model without a fusion net refuses it while
    ``build_for`` leaves such a model unchanged."""
    full = _port("2", flat, images)
    assert full["predict_flow0"].shape == (1, H, W, 2)
    assert np.abs(full["flow"] - fusion_f32["flow"]).max() > 0
    with pytest.raises(ValueError, match="fusion_res"):
        get_model("css").build("cpu", fusion_res=2)
    with pytest.raises(ValueError, match="fusion_res"):
        stacks.FlowNet2(fusion_res=3)
    assert get_model("css").fusion_res_for(2) == 1
    assert get_model("2").fusion_res_for(2) == 2
    model = get_model("s").build_for("cpu", fusion_res=2, warp_res=2)
    assert isinstance(model, flownet_s.FlowNetS)


def test_halfres_fusion_bf16_within_jax_bound(flat, jtree, images,
                                              fusion_f32):
    """The bf16 half-res fusion against JAX's bf16 under
    ``use_fusion_res(2)``, inside JAX's own bf16-against-f32 distance."""
    got = _port("2", flat, images, BF16, fusion_res=2)
    want = _jax(jstacks.apply_flownet2, jtree, images, jnp.bfloat16,
                fusion_res=2)
    _assert_bf16_within_jax(got, want, fusion_f32)


def test_halfres_fusion_assembly_keeps_the_quarter_pixel_offset():
    """The half-res assembly warps the pooled image by the halved flow
    with no (k-1)/(2k) compensation (``flow_warp._coarse_flow`` is not
    used): a zero flow leaves the pooled image as it is, and the flow
    channels stay in full-res pixels."""
    rng = np.random.RandomState(7)
    a = T(rng.rand(1, 8, 16, 3).astype(np.float32))
    flow2 = torch.zeros(1, 2, 4, 2)
    flow2[..., 0] = 0.25  # 5 px after the x20
    preds = {"predict_flow2": flow2}
    x = stacks._fusion_input_halfres(a, a, preds, preds, torch.float32)
    assert x.shape == (1, 4, 8, 11)
    pooled = a.reshape(1, 4, 2, 8, 2, 3).mean(dim=(2, 4))
    assert torch.equal(x[..., :3], pooled)
    np.testing.assert_allclose(x[..., 3].numpy(), 5.0 * 0.05, rtol=1e-6)
    np.testing.assert_allclose(x[..., 7].numpy(), 5.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# bf16 interconvs
# ---------------------------------------------------------------------------

INTERCONV_MODELS = {
    "sd": (jflownet_sd.apply, lambda t: t["FlowNetSD"],
           lambda f: {k[len("FlowNetSD/"):]: v for k, v in f.items()
                      if k.startswith("FlowNetSD/")}),
    "2": (jstacks.apply_flownet2, lambda t: t, lambda f: f),
}


@pytest.mark.parametrize("name", sorted(INTERCONV_MODELS))
def test_bf16_interconvs_match_jax(flat, jtree, images, name):
    """``bf16_interconv=True`` against ``use_bf16_interconv(True)``: every
    interconv computes in bf16 and every flow head in f32, and the
    predictions stay inside JAX's own bf16-against-f32 distance."""
    apply, sub, sub_flat = INTERCONV_MODELS[name]
    model = get_model(name).build("cpu", bf16_interconv=True)
    warmstart.load_jax_params(model, sub_flat(flat))
    seen = {}
    hooks = [m.register_forward_hook(
                 functools.partial(lambda n, mod, inp, out:
                                   seen.__setitem__(n, out.dtype), n))
             for n, m in model.named_modules()
             if isinstance(m, common.Conv) and ("interconv" in n
                                                or "predict_flow" in n)]
    with torch.inference_mode():
        preds = model({k: T(v) for k, v in images.items()}, BF16)
    for h in hooks:
        h.remove()
    assert {n for n in seen if "interconv" in n}
    for n, dtype in seen.items():
        assert dtype == (BF16 if "interconv" in n else torch.float32), n
    got = {k: _f32(v) for k, v in preds.items()}
    want = _jax(apply, sub(jtree), images, jnp.bfloat16,
                bf16_interconv=True)
    ref = _jax(apply, sub(jtree), images)
    _assert_bf16_within_jax(got, want, ref)
    # the knob changes the bf16 forward
    plain = _port(name, sub_flat(flat), images, BF16)
    assert np.abs(plain["flow"] - got["flow"]).max() > 0


def test_bf16_interconv_precast_matches_jax(flat, jtree, images):
    """``cast_params_for_inference`` of a model built with the knob
    pre-casts the interconvs too: the leaves are JAX's under
    ``use_bf16_interconv(True)``, the pre-cast forward is bitwise the
    non-pre-cast one, and the checkpoint stays f32."""
    model = get_model("2").build("cpu", bf16_interconv=True)
    warmstart.load_jax_params(model, flat)
    with dispatch.use_bf16_interconv(True):
        jcast = jws.flatten(jcast_params_for_inference(jtree))
    want = {k.rsplit("/", 1)[0] for k, v in jcast.items()
            if v.dtype == jnp.bfloat16}
    inputs = {k: T(v) for k, v in images.items()}
    with torch.inference_mode():
        before = model(inputs, BF16)
    common.cast_params_for_inference(model)
    got = {k.rsplit(".", 1)[0].replace(".", "/")
           for k, p in model.named_parameters() if p.dtype == BF16}
    assert got == want
    assert {s for s in got if "interconv" in s} == {
        s for s in want if "interconv" in s} != set()
    with torch.inference_mode():
        after = model(inputs, BF16)
    for k in before:
        assert torch.equal(after[k], before[k]), k
    back = warmstart.flatten(warmstart.to_jax_params(model))
    assert all(v.dtype == np.float32 for v in back.values())


def test_precast_interconv_is_rejected_under_the_other_setting():
    """tests/test_ops_oracle.py:706-729 for the port: an interconv pre-cast
    while it follows the bf16 policy, then run with the knob off, raises
    rather than run its quantized weights as the exact path."""
    rng = np.random.RandomState(0)
    layer = common.Conv(3, 4, 4, act=False, interconv=True)
    with torch.no_grad():
        layer.weights.copy_(T(rng.rand(4, 4, 3, 3).astype(np.float32)))
    x = T(rng.rand(1, 4, 8, 8).astype(np.float32))
    common.cast_params_for_inference(layer)
    assert layer.weights.dtype == BF16
    # consistent setting: bf16 interconv weights are fine
    assert layer(x.to(BF16), BF16).dtype == BF16
    layer.interconv = False  # the knob off: the same weights are refused
    with pytest.raises(ValueError, match="f32-policy.*bf16_interconv"):
        layer(x, BF16)
    # without the knob the interconvs are not pre-cast at all
    plain = common.Conv(3, 4, 4, act=False)
    common.cast_params_for_inference(plain)
    assert plain.weights.dtype == torch.float32


# ---------------------------------------------------------------------------
# f32 feature precision
# ---------------------------------------------------------------------------

def test_f32_features_default_matches_jax(flat, images):
    """``f32_features='default'`` (FlowNetS, as tests/test_models.py:353
    measures it): on the CPU (no TF32) bitwise ``'highest'``. JAX's
    ``'default'`` on this CPU equals its ``'highest'`` (measured distance
    0.0), so the port's ``'default'`` is held to JAX's ``'default'``
    output at the f32 parity tolerance, inside the 0.05 mean bound that
    tests/test_models.py:377 sets between default and highest (measured
    1.9e-6)."""
    params = jget_model("s").init(jax.random.PRNGKey(0))
    sflat = {k: np.asarray(v) for k, v in jws.flatten(params).items()}
    rng = np.random.RandomState(3)
    inputs = {k: rng.rand(1, 64, 64, 3).astype(np.float32)
              for k in ("input_a", "input_b")}
    hi = _port("s", sflat, inputs)
    default = _port("s", sflat, inputs, f32_features="default")
    for k in hi:
        assert np.array_equal(hi[k], default[k]), k
    with dispatch.use_s2d(False), \
            dispatch.use_f32_features_precision("default"):
        jdefault = {k: np.asarray(v) for k, v in
                    jax.jit(jflownet_s.apply)(params, inputs).items()}
    _assert_match(default, jdefault)
    assert np.abs(default["flow"] - jdefault["flow"]).mean() < 0.05
    with pytest.raises(ValueError, match="highest"):
        get_model("s").build("cpu", f32_features="bogus")


@pytest.mark.parametrize("cd", [None, BF16])
def test_f32_features_tf32_scope(monkeypatch, cd):
    """Under ``'default'`` cuDNN's TF32 flag is on exactly around the f32
    path's feature convs and deconvs: the flow heads, upsamplers and
    interconvs see it off, and so does every conv under bf16. After each
    layer, and after the forward, the flags are back where
    ``f32_policy`` (and then the caller) set them."""
    cudnn = torch.backends.cudnn
    model = get_model("sd").build("cpu", f32_features="default")
    by_weight = {id(m.weights): m for m in model.modules()
                 if isinstance(m, common.Conv)}
    seen = []
    real = torch.nn.functional.conv2d

    def spy(x, w, *args, **kw):
        seen.append((cudnn.allow_tf32, by_weight.get(id(w)),
                     tuple(w.shape[:2])))
        return real(x, w, *args, **kw)

    flags = (cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             cudnn.deterministic)
    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    x = {k: torch.rand(1, 64, 64, 3) for k in ("input_a", "input_b")}
    with torch.inference_mode():
        model(x, cd)
    monkeypatch.undo()
    assert (cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            cudnn.deterministic) == flags
    for on, layer, shape in seen:
        if cd is not None:
            assert not on
        elif layer is not None:  # a conv: TF32 for the feature layers
            assert on == layer.act, layer
        else:  # a deconv's sub-pixel conv; the flow upsamplers' are 2 -> 2
            assert on == (shape != (8, 2)), shape
    assert any(on for on, _, _ in seen) == (cd is None)


# ---------------------------------------------------------------------------
# The entry points
# ---------------------------------------------------------------------------

# the other arguments each model subcommand needs; files are never read:
# the model is built, recorded and the command stopped before that
_COMMAND_ARGS = {
    "test": ["--input_a", "a.ppm", "--input_b", "b.ppm", "--ckpt", "c.npz"],
    "eval": ["--ckpt", "c.npz", "--dataset", "synthetic", "--limit", "1"],
    "train": ["--synthetic", "--synthetic_height", "64",
              "--synthetic_width", "64", "--batch_size", "1"],
    "bench": ["--height", "64", "--width", "64"],
    "profile": ["--height", "64", "--width", "64"],
}


class _Built(Exception):
    pass


@pytest.mark.parametrize("command", sorted(_COMMAND_ARGS))
@pytest.mark.parametrize("knob", ["fusion_res", "f32_features",
                                  "bf16_interconv"])
def test_each_command_builds_the_model_with_each_knob(tmp_path, monkeypatch,
                                                      command, knob):
    """``--fusion_res 2``, ``--f32_features default`` and
    ``FLOWNET2_TPU_BF16_INTERCONV=1`` reach the model that ``cli test``,
    ``eval``, ``train``, ``bench`` and ``profile`` build (the refusals
    they replace named ROADMAP item 18)."""
    built = []
    real = registry.ModelSpec.build

    def record(self, *args, **kw):
        built.append(real(self, *args, **kw))
        raise _Built

    monkeypatch.setattr(registry.ModelSpec, "build", record)
    monkeypatch.setattr(warmstart, "load_params_tree", lambda path: {})
    monkeypatch.setattr(infer, "load_params_tree", lambda path: {})
    monkeypatch.setattr(infer, "load_image_pair",
                        lambda a, b: (np.zeros((64, 64, 3), np.float32),) * 2)
    monkeypatch.delenv("FLOWNET2_TPU_BF16_INTERCONV", raising=False)
    flags = {"fusion_res": ["--fusion_res", "2"],
             "f32_features": ["--f32_features", "default"],
             "bf16_interconv": []}[knob]
    if knob == "bf16_interconv":
        monkeypatch.setenv("FLOWNET2_TPU_BF16_INTERCONV", "1")
    argv = [command, "--model", "2", "--device", "cpu",
            *_COMMAND_ARGS[command], *flags]
    if command == "train":
        argv += ["--log_dir", str(tmp_path / "run")]
    if command == "profile":
        argv += ["--trace_dir", str(tmp_path / "trace")]
    with pytest.raises(_Built):
        cli.main(argv)
    (model,) = built
    assert model.fusion_res == (2 if knob == "fusion_res" else 1)
    assert model.fuse_conv0.tf32 == (knob == "f32_features")
    assert not model.predict_flow0.tf32
    assert model.FlowNetSD.interconv5.interconv == (knob == "bf16_interconv")
    assert model.fuse_interconv0.interconv == (knob == "bf16_interconv")


def test_bench_names_its_knobs_and_floors_tf32_at_the_tf32_peak(
        monkeypatch):
    """``run_bench`` times the model the knobs build, names each knob off
    its default in the result (``fusion_res``, as the JAX bench does;
    ``bf16_interconv``; ``f32_features``), and floors the TF32 feature
    layers' counted FLOPs at the card's TF32 peak, the rest at the f32
    peak (the peaks it used in ``peak_tflops``)."""
    out = bench.run_bench("2", 64, 64, iters=1, repeats=1, device="cpu",
                          compute_dtype="bfloat16", fusion_res=2,
                          bf16_interconv=True)
    assert out["fusion_res"] == 2 and out["bf16_interconv"] is True
    assert "f32_features" not in out and "floor_ms_analytic" not in out
    exact = bench.run_bench("s", 64, 64, iters=1, repeats=1, device="cpu",
                            compute_dtype="float32")
    assert not {"fusion_res", "bf16_interconv", "f32_features"} & set(exact)

    split = benchlib.count_flops("2", 1, 64, 64, "float32",
                                 f32_features="default", by_precision=True)
    assert sorted(split) == ["float32", "tf32"] and split["tf32"] > 0
    assert sum(split.values()) == benchlib.count_flops("2", 1, 64, 64,
                                                       "float32")
    assert (benchlib.count_flops("2", 1, 64, 64, "float32", fusion_res=2)
            < benchlib.count_flops("2", 1, 64, 64, "float32"))
    assert benchlib.count_flops("2", 1, 64, 64, "bfloat16",
                                by_precision=True) == {
        "bfloat16": benchlib.count_flops("2", 1, 64, 64, "bfloat16")}

    peaks = benchlib.DEVICE_PEAKS["NVIDIA H100 80GB HBM3"]
    monkeypatch.setattr(benchlib, "device_peaks",
                        lambda device, dtype: (peaks[dtype], peaks["hbm"]))
    out = bench.run_bench("2", 64, 64, iters=1, repeats=1, device="cpu",
                          compute_dtype="float32", f32_features="default",
                          validate=False)
    want = (split["float32"] / peaks["float32"]
            + split["tf32"] / peaks["tf32"]) * 1000.0
    assert out["f32_features"] == "default"
    assert out["peak_tflops"] == {"float32": 67.0, "tf32": 495.0}
    assert out["floor_ms_analytic"] == round(want, 3)


def test_cli_train_halfres_fusion_steps(tmp_path, capsys):
    """``cli train --model 2 --fusion_res 2`` trains the fusion net on its
    half-res input (CSS and SD frozen, as by default): finite losses."""
    rc = cli.main(["train", "--model", "2", "--device", "cpu",
                   "--synthetic", "--synthetic_height", "64",
                   "--synthetic_width", "64", "--synthetic_size", "2",
                   "--batch_size", "1", "--max_steps", "2", "--log_every",
                   "1", "--checkpoint_every", "0", "--no_augment",
                   "--fusion_res", "2", "--log_dir", str(tmp_path / "run")])
    assert rc == 0
    lines = [json.loads(line) for line in
             capsys.readouterr().out.splitlines() if line.startswith("{")]
    losses = [line["loss"] for line in lines if "loss" in line]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_halfres_fusion_artifact_serves_its_eager_model(flat, images,
                                                        tmp_path):
    """``export_serving(..., fusion_res=2)``: ``meta.json`` records it, and
    the served flow is bitwise the eager half-res model's (f32, exact
    warps, on the CPU)."""
    path = tmp_path / "f2_fusion2.flowpak"
    meta = aot.export_serving("2", flat, H, W, path,
                              compute_dtype="float32", warp_mode="full",
                              fusion_res=2, device="cpu")
    assert meta["fusion_res"] == 2
    with zipfile.ZipFile(path) as z:
        assert json.loads(z.read("meta.json"))["fusion_res"] == 2
    served = aot.load_serving(path, device="cpu")(images["input_a"],
                                                  images["input_b"])
    eager = infer.infer_flow("2", flat, images["input_a"],
                             images["input_b"], device="cpu", fusion_res=2)
    assert np.array_equal(served, eager)
    os.remove(path)
