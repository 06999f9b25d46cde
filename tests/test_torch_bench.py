"""The port's measurement entry points against the JAX package's, on the
CPU: ``tools/bench.py`` (``cli bench``), ``tools/benchlib.py`` and
``tools/profiler.py`` (``cli profile``) with the layer scopes.

Times here are CPU times; the tests assert names, keys, counts and the
work done, never a time's size."""

import contextlib
import io
import json
import re
import shutil
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flownet2_tf_tpu.models.registry import get_model as jax_model  # noqa: E402
from flownet2_tf_tpu.ops import dispatch  # noqa: E402
from flownet2_tf_tpu.tools import bench as jbench  # noqa: E402
from flownet2_tf_tpu_torch import cli  # noqa: E402
from flownet2_tf_tpu_torch.models import registry  # noqa: E402
from flownet2_tf_tpu_torch.models.registry import get_model  # noqa: E402
from flownet2_tf_tpu_torch.tools import aot, bench, benchlib  # noqa: E402
from flownet2_tf_tpu_torch.training import loop, warmstart  # noqa: E402


@pytest.fixture(autouse=True)
def _drop_test_files(tmp_path):
    """Some tests here write FlowNet weights of about 150 MB: delete what
    each test wrote when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# tools/bench.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("samples,floor_ms", [
    ([0.0100, 0.0102, 0.0101, 0.0099, 0.0100], 2.0),  # clean
    ([0.0010, 0.0011, 0.0010, 0.0012, 0.0010], 2.0),  # below the floor
    ([0.0100, 0.0200, 0.0110, 0.0120, 0.0100], None),  # high spread
    ([0.0100, 0.0101, 0.0102], None),  # no floor
    ([0.0100, 0.0300], 2.0),  # 2 samples: no spread gate
], ids=["clean", "below_floor", "high_spread", "no_floor", "two_samples"])
def test_check_samples_matches_jax(samples, floor_ms):
    got = bench.check_samples(list(reversed(samples)), floor_ms)
    want = jbench.check_samples(list(reversed(samples)), floor_ms)
    assert got == want
    assert (bench.FLOOR_SAFETY, bench.MAX_SPREAD, bench.MEASURE_ATTEMPTS,
            bench.REFERENCE_PAIRS_PER_SEC) == (
        jbench.FLOOR_SAFETY, jbench.MAX_SPREAD, jbench.MEASURE_ATTEMPTS,
        jbench.REFERENCE_PAIRS_PER_SEC)


def test_run_bench_on_cpu():
    kw = dict(model="s", height=64, width=64, batch=1, iters=2,
              compute_dtype="float32", repeats=2, validate=False)
    theirs = jbench.run_bench(**kw)
    mine = bench.run_bench(**kw, device="cpu")
    assert set(mine) == set(theirs) - {"hbm_gb_xla_opsum_bound"} | {"device"}
    assert mine["metric"] == theirs["metric"] == (
        "flownets_pairs_per_sec_64x64_b1_float32")
    assert mine["unit"] == theirs["unit"]
    assert mine["warp_mode"] == theirs["warp_mode"] == "full"
    assert mine["backend"] == mine["device"] == "cpu"
    assert mine["repeats"] == 2
    assert mine["ms_per_pair"] > 0 and mine["value"] > 0
    # no card, no peaks: no floor and no mfu, never a guessed peak
    assert "floor_ms_analytic" not in mine and "mfu" not in mine
    flops = benchlib.count_flops("s", 1, 64, 64, "float32")
    assert mine["model_tflops_per_pair"] == round(flops / 1e12, 4) > 0


@pytest.mark.parametrize("kw,env,label,k", [
    ({"compute_dtype": "bfloat16"}, {}, "half", 2),
    ({"compute_dtype": "float32"}, {}, "full", 1),
    ({"compute_dtype": "float32", "warp_res": 4},
     {"FLOWNET2_TPU_WARP_RES": "4"}, "k4", 4),
    # an explicit warp_mode pins its warps, whatever the warp_res
    ({"compute_dtype": "bfloat16", "warp_res": 4, "warp_mode": "full"},
     {"FLOWNET2_TPU_WARP_RES": "4"}, "full", 1),
], ids=["bf16_half", "f32_full", "warp_res_4", "full_wins"])
def test_bench_warp_mode(monkeypatch, kw, env, label, k):
    """The JAX package's warp-mode rules (tests/test_tools.py:108), with
    arguments for its env knobs: the label, and the model built at its
    warp grid."""
    from flownet2_tf_tpu.ops.flow_warp import stack_warp_res

    seen = {}

    def fake_measure(model, h, w, b, iters, cd, repeats, warp_mode,
                     validate):
        seen.update(warp_mode=warp_mode, k=stack_warp_res())
        return {}

    monkeypatch.setattr(jbench, "_measure", fake_measure)
    monkeypatch.delenv("FLOWNET2_TPU_WARP_RES", raising=False)
    monkeypatch.delenv("FLOWNET2_TPU_HALF_RES_WARP", raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    jkw = {key: v for key, v in kw.items() if key != "warp_res"}
    jbench.run_bench(**jkw)
    assert seen == {"warp_mode": label, "k": k}

    built = []
    real_build = registry.ModelSpec.build

    def spy(self, device="cpu", warp_res=1, **knobs):
        built.append(warp_res)
        return real_build(self, device, warp_res, **knobs)

    monkeypatch.setattr(registry.ModelSpec, "build", spy)
    out = bench.run_bench(model="cs", height=64, width=64, iters=1,
                          repeats=1, validate=False, device="cpu", **kw)
    assert out["warp_mode"] == label
    assert built == [k, k]  # the timed model and the counted one
    # models without stack warps run unchanged under the flag
    built.clear()
    assert bench.run_bench(model="s", height=64, width=64, iters=1,
                           repeats=1, validate=False, device="cpu",
                           **kw)["warp_mode"] == label
    assert built == [1, 1]


def test_cli_bench_on_cpu(capsys):
    rc = cli.main([
        "bench", "--model", "s", "--height", "64", "--width", "64",
        "--iters", "2", "--compute_dtype", "float32", "--device", "cpu",
    ])
    assert rc == 0
    out = _last_json(capsys)
    assert out["unit"] == "frame_pairs/sec/chip"
    assert out["value"] > 0
    assert out["backend"] == out["device"] == "cpu"
    assert out["repeats"] == 5 and out["warp_mode"] == "full"


def test_bench_main_prints_one_line_with_its_companion(monkeypatch, capsys):
    """``python -m flownet2_tf_tpu_torch.tools.bench``: the bf16 half-res
    headline and its exact-warp companion; the JAX package's env knobs
    are arguments, and a failing companion fails the run."""
    runs = []

    def fake_run(**kw):
        runs.append(kw)
        mode = kw.get("warp_mode") or "half"
        return {"metric": "m", "value": 1.0, "unit": "u",
                "vs_baseline": 0.1, "ms_per_pair": 2.0 if mode == "half"
                else 3.0, "warp_mode": mode, "spread_pct": 1.0,
                "device": "cpu"}

    monkeypatch.setattr(bench, "run_bench", fake_run)
    assert bench.main(["--device", "cpu"]) == 0
    line = _last_json(capsys)
    assert line["warp_mode"] == "half" and line["fullres_ms_per_pair"] == 3.0
    assert runs == [{"warp_mode": None, "device": "cpu"},
                    {"warp_mode": "full", "iters": 8, "repeats": 3,
                     "device": "cpu"}]
    runs.clear()
    assert bench.main(["--device", "cpu", "--fullres"]) == 0
    assert "fullres_ms_per_pair" not in _last_json(capsys)
    assert runs == [{"warp_mode": "full", "device": "cpu"}]

    def failing(**kw):
        if kw.get("warp_mode") == "full":
            raise RuntimeError("companion failed")
        return fake_run(**kw)

    monkeypatch.setattr(bench, "run_bench", failing)
    with pytest.raises(RuntimeError, match="companion failed"):
        bench.main(["--device", "cpu"])


def test_bench_floor_gate_refuses_to_publish(monkeypatch):
    """A median below FLOOR_SAFETY x the analytic floor is re-measured,
    and raises when it never clears it; a spread that never settles is
    published with ``suspect``."""
    monkeypatch.setattr(benchlib, "device_peaks", lambda *a: (1e6, 1e9))
    with pytest.raises(RuntimeError, match="refused to publish"):
        bench.run_bench(model="s", height=64, width=64, iters=1, repeats=1,
                        compute_dtype="float32", device="cpu")
    monkeypatch.setattr(benchlib, "device_peaks", lambda *a: (None, None))
    monkeypatch.setattr(bench, "check_samples",
                        lambda samples, floor_ms: (0.01, 0.5, "spread"))
    out = bench.run_bench(model="s", height=64, width=64, iters=1,
                          repeats=1, compute_dtype="float32", device="cpu")
    assert out["suspect"] == "; ".join(
        f"attempt {i + 1}: spread" for i in range(bench.MEASURE_ATTEMPTS))
    assert out["ms_per_pair"] == 10.0 and out["spread_pct"] == 50.0
    assert "floor_ms_analytic" not in out


# ---------------------------------------------------------------------------
# tools/benchlib.py
# ---------------------------------------------------------------------------

def test_bench_flops_equal_cli_info(capsys):
    assert cli.main(["info", "--model", "2", "--flops", "--height", "64",
                     "--width", "128", "--batch", "2"]) == 0
    info = json.loads(capsys.readouterr().out)
    flops = benchlib.count_flops("2", 2, 64, 128, "bfloat16")
    assert info["gflops_per_batch"] == round(flops / 1e9, 3) > 0
    assert info["flops_counted"] == benchlib.FLOPS_COUNTED
    # the warps and resizes are not counted: the half-res warps count the
    # same; the f32 deconvs' sub-pixel convs add their border row and
    # column (at 64x128 the smallest deconv input is 1x2)
    assert benchlib.count_flops("2", 2, 64, 128, "bfloat16", 2) == flops
    assert flops < benchlib.count_flops("2", 2, 64, 128, "float32") < (
        1.1 * flops)
    # the correlation's formula is in the count
    corr = 2 * 2 * 1 * 2 * 441 * 256  # N H W D^2 C at conv3 (1 x 2)
    with_corr = benchlib.count_flops("c", 2, 64, 128, "float32")
    assert with_corr > corr
    assert benchlib.device_peaks("cpu", "float32") == (None, None)


def test_marginal_ms_on_cpu():
    calls = []
    x = torch.from_numpy(np.random.RandomState(0).rand(384, 384)
                         .astype(np.float32))

    def matmul(a):
        calls.append(1)
        return a @ a

    ms, clock = benchlib.marginal_ms(matmul, x)
    assert clock == "cpu" and ms > 0
    # warm-ups of 2 and 12 calls, then two repeats of both
    assert len(calls) == 3 * (2 + 12)
    # a no-op is below the noise floor: measured again, then clamped
    ms, clock = benchlib.marginal_ms(lambda: None)
    assert (ms, clock) == (0.0, "cpu")


def test_train_step_ms_on_cpu(monkeypatch):
    """``train_step_ms`` times the trainer's own step: its weights after
    the timed steps equal a ``Trainer`` run of as many steps on the same
    batch; with ``remat`` it times as many remat steps."""
    from flownet2_tf_tpu_torch.data.loader import SyntheticFlowDataset

    seen = []
    real_step = loop.Trainer.train_step

    def spy(self, state, batch, preprocess=None):
        seen.append((self, state))
        assert all(isinstance(v, torch.Tensor) for v in batch.values())
        return real_step(self, state, batch, preprocess)

    monkeypatch.setattr(loop.Trainer, "train_step", spy)
    ms, per_s = benchlib.train_step_ms("c", batch=2, height=64, width=64,
                                       compute_dtype="float32", iters=2,
                                       device="cpu")
    monkeypatch.undo()
    assert ms > 0 and per_s == pytest.approx(2 / (ms / 1000.0))
    trainer, state = seen[0]
    assert len(seen) == 2 * (1 + 3) and all(s is state for _, s in seen)
    assert trainer.schedule["name"] == "bench"
    assert trainer.frozen == () and not trainer.config.tensorboard

    ref = loop.Trainer(trainer.config)
    ref_state = ref.init_state()
    ds = SyntheticFlowDataset(size=2, height=64, width=64)
    batch = {k: np.stack([ds[i][k] for i in range(2)])
             for k in ("image_a", "image_b", "flow")}
    for _ in range(len(seen)):
        ref.train_step(ref_state, batch)
    assert ref_state.step == state.step == len(seen)
    for (name, got), want in zip(state.model.named_parameters(),
                                 ref_state.model.parameters()):
        assert torch.equal(got, want), name

    # remat runs on the CPU: the trainer's remat step, as many of them
    del seen[:]
    monkeypatch.setattr(loop.Trainer, "train_step", spy)
    ms, _ = benchlib.train_step_ms("c", batch=2, height=64, width=64,
                                   compute_dtype="float32", iters=2,
                                   remat=True, device="cpu")
    monkeypatch.undo()
    assert ms > 0 and len(seen) == 2 * (1 + 3)
    assert seen[0][0].config.remat and seen[0][1].step == len(seen)
    with pytest.raises(NotImplementedError, match="stop_grad_frozen"):
        benchlib.train_step_ms("c", stop_grad_frozen=True, device="cpu")


# ---------------------------------------------------------------------------
# tools/profiler.py and the layer scopes
# ---------------------------------------------------------------------------

def _jax_scopes(name):
    """The ``jax.named_scope`` components of the op names in the JAX
    forward's HLO text (plain path: no S2D heads, as the port)."""
    m = jax_model(name)
    params = jax.eval_shape(m.init, jax.random.PRNGKey(0))
    img = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)

    def forward(p, a, b):
        return m.apply(p, {"input_a": a, "input_b": b})["flow"]

    with dispatch.use_s2d(False):
        text = jax.jit(forward).lower(params, img, img).as_text(
            dialect="hlo", debug_info=True)
    scopes = set()
    for op_name in set(re.findall(r'op_name="([^"]*)"', text)):
        # jit(...) wrappers and einsum specs are not scopes; the last
        # component is the primitive
        scopes.update(c for c in op_name.split("/")[:-1]
                      if re.fullmatch(r"[A-Za-z_]\w*", c))
    return scopes


@pytest.mark.parametrize("name", ["c", "2"])
def test_profile_scopes_match_jax(tmp_path, capsys, name):
    rc = cli.main(["profile", "--model", name, "--height", "64", "--width",
                   "64", "--iters", "1", "--compute_dtype", "float32",
                   "--device", "cpu", "--trace_dir", str(tmp_path)])
    assert rc == 0
    assert _last_json(capsys) == {"trace_dir": str(tmp_path)}
    with open(tmp_path / "summary.json") as f:
        summary = json.load(f)
    assert (tmp_path / "trace.json").stat().st_size > 0
    # on the CPU every time is a CPU time, never a device time
    assert summary["clock"] == "cpu" and summary["device"] == "cpu"
    assert "kernels" not in summary
    rows = summary["ops"] + summary["scopes"]
    assert rows and all(set(r) == {"name", "cpu_ms", "calls"} for r in rows)
    mine = {r["name"] for r in summary["scopes"]}
    assert mine == _jax_scopes(name) - {"conv0_conv1_s2d"}
    calls = {r["name"]: r["calls"] for r in summary["scopes"]}
    assert calls["correlation"] == 1
    assert calls["refine2"] == (1 if name == "c" else 4)
    assert "flownet2::correlation" in {r["name"] for r in summary["ops"]}


def test_scopes_add_no_graph_node(tmp_path):
    """The scopes are off without a profiler: a traced export of FlowNetC
    holds no profiler node, and its one correlation node."""
    spec = get_model("c")
    tree = warmstart.random_jax_params(spec.build("cpu"), seed=0)
    path = tmp_path / "c.flowpak"
    aot.export_serving("c", tree, 64, 64, path, compute_dtype="float32",
                       warp_mode="full", device="cpu")
    with zipfile.ZipFile(path) as z:
        program = torch.export.load(io.BytesIO(z.read("exported.pt2")))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert not [t for t in targets if "profiler" in t or "record" in t]
    assert targets.count("flownet2.correlation.default") == 1


def test_determinism_ab_settings_restore_the_package():
    """``tools/determinism_ab.py`` swaps the package's ``f32_policy`` and
    the f32 deconv for one cell and puts them back, also after an
    exception; each setting's f32 deconv is the transposed conv."""
    from flownet2_tf_tpu_torch.models import common
    from flownet2_tf_tpu_torch.ops import downsample
    from flownet2_tf_tpu_torch.tools import determinism_ab
    from flownet2_tf_tpu_torch.utils import precision

    holders = (common, loop, downsample, precision)
    policy, forward = precision.f32_policy, common.Deconv.forward
    layer = common.Deconv(3, 2)
    with torch.no_grad():
        layer.weights.normal_(generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 3, 4, 6)
                         .astype(np.float32))
    with torch.no_grad():
        want = layer(x)
    for name in determinism_ab.SETTINGS:
        with pytest.raises(RuntimeError, match="inside"):
            with determinism_ab.setting(name):
                kept = [m.f32_policy is policy for m in holders]
                assert kept == [name in ("port", "deterministic_transposed")
                                ] * len(holders)
                assert (common.Deconv.forward is forward) == (
                    name in ("port", "bf16_default"))
                with common.f32_policy(torch.bfloat16):
                    assert torch.backends.cudnn.deterministic == (
                        name in ("port", "deterministic_transposed"))
                with torch.no_grad():
                    torch.testing.assert_close(layer(x), want, rtol=1e-5,
                                               atol=1e-6)
                raise RuntimeError("inside")
        assert all(m.f32_policy is policy for m in holders)
        assert common.Deconv.forward is forward
    with pytest.raises(ValueError, match="setting"):
        with determinism_ab.setting("fast"):
            pass
    with pytest.raises(SystemExit, match="CUDA") if not (
            torch.cuda.is_available()) else contextlib.nullcontext():
        if not torch.cuda.is_available():
            determinism_ab.main([])
