"""Data parallelism of the port (``parallel/mesh.py``, ``training/loop.py``
under a process group, ``cli train --multihost``) against itself and the
JAX package, on the CPU over gloo; and the warp and resize gradients that
a stacked model trains through, against ``jax.grad``.

Two ranks run in child processes (``tests/_torch_ddp_child.py``), each on
its shard of one seeded global batch of 4 at 64x64. Every child starts in
its own session with its output in a file, is waited on with a timeout
and has its process group killed when the test ends. Tolerances are
stated at each comparison.
"""

import json
import os
import shutil
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flownet2_tf_tpu.models.registry import get_model as jax_model  # noqa: E402
from flownet2_tf_tpu.ops import dispatch  # noqa: E402
from flownet2_tf_tpu.ops import resize as jresize  # noqa: E402
from flownet2_tf_tpu.ops import sampling as jsampling  # noqa: E402
from flownet2_tf_tpu.parallel import mesh as jmesh  # noqa: E402
from flownet2_tf_tpu_torch import cli  # noqa: E402
from flownet2_tf_tpu_torch.models import common  # noqa: E402
from flownet2_tf_tpu_torch.models.registry import get_model  # noqa: E402
from flownet2_tf_tpu_torch.ops import resize, sampling  # noqa: E402
from flownet2_tf_tpu_torch.parallel import mesh  # noqa: E402
from flownet2_tf_tpu_torch.training import optim, warmstart  # noqa: E402
from flownet2_tf_tpu_torch.training.loop import TrainConfig, Trainer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_torch_ddp_child.py")
sys.path.insert(0, os.path.join(REPO, "tests"))
import _mp_child as jchild  # noqa: E402
import _torch_ddp_child as tchild  # noqa: E402

# a child's hard limit (s): two ranks start, train and exit in ~15 s
CHILD_TIMEOUT_S = 150
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "COORDINATOR_ADDRESS", "NUM_PROCESSES",
              "PROCESS_ID")


@pytest.fixture(autouse=True)
def _drop_run_dirs(tmp_path):
    """A FlowNetCS run here writes ~1 GB of parameters: delete them when
    the test ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _global_batch(path):
    """tests/_mp_child.py's global batch (4 x 64x64), as an .npz."""
    np.savez(path, **jchild.global_batch())
    return str(path)


def _run_ranks(tmp_path, spec, world=2):
    """Run ``world`` ranks of the child on ``spec``; returns their
    ([metrics], [parameters]). Every rank runs in its own session with its
    output in a file; its process group is killed when this returns."""
    spec = dict(spec, result=str(tmp_path / "result"))
    spec.setdefault("log_dir", str(tmp_path / "run"))
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(spec))
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    procs, logs = [], []
    try:
        for rank in range(world):
            logs.append(tmp_path / f"rank{rank}.log")
            with open(logs[-1], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, CHILD, str(spec_path)],
                    env=dict(env, RANK=str(rank), WORLD_SIZE=str(world),
                             MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
                    stdout=log, stderr=subprocess.STDOUT,
                    start_new_session=True))
        for rank, proc in enumerate(procs):
            rc = proc.wait(timeout=CHILD_TIMEOUT_S)
            assert rc == 0, (rank, logs[rank].read_text()[-3000:])
    finally:
        for proc in procs:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    metrics, params = [], []
    for rank in range(world):
        with open(f"{spec['result']}.{rank}.json") as f:
            metrics.append(json.load(f))
        with np.load(f"{spec['result']}.{rank}.npz") as z:
            params.append({k: z[k] for k in z.files})
    return metrics, params


def _assert_ranks_bitwise_equal(metrics, params):
    keys = [k for k in metrics[0] if k != "rank"]
    assert [m[k] for m in metrics[1:] for k in keys] == [
        metrics[0][k] for _ in metrics[1:] for k in keys], metrics
    for other in params[1:]:
        assert other.keys() == params[0].keys()
        for k, v in params[0].items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)


def _jax_init(model, path):
    """JAX-initialised weights (PRNGKey(0), the key of
    tests/_mp_child.py) written as a flat .npz; returns (path, tree)."""
    with dispatch.use_s2d(False):
        tree = jax.device_get(jax_model(model).init(jax.random.PRNGKey(0)))
    np.savez(path, **warmstart.flatten(tree))
    return str(path), tree


def _one_process(tmp_path, model, batch_path, params_path, steps=2, **kw):
    """The port's trainer in this process, on the whole global batch:
    (metrics by step, parameters in the JAX layout)."""
    trainer = Trainer(TrainConfig(
        model=model, schedule=tchild.SCHEDULE,
        log_dir=str(tmp_path / "one"), device="cpu",
        compute_dtype="float32", augment=False, tensorboard=False,
        checkpoint_every=0, **kw))
    state = trainer.init_state()
    assert state.ddp is None
    warmstart.load_jax_params(state.model,
                              warmstart.load_params_tree(params_path))
    with np.load(batch_path) as z:
        batch = {k: z[k] for k in z.files}
    out = {}
    for i in range(steps):
        m = trainer.train_step(state, batch)
        for k in ("loss", "data_loss", "epe", "grad_norm"):
            out[f"{k}{i}"] = float(m[k])
    return out, warmstart.flatten(warmstart.to_jax_params(state.model))


def _update_err(got, want, start):
    """max over leaves of |(got - start) - (want - start)| / |want - start|
    in L2."""
    worst = 0.0
    for k, w0 in start.items():
        dw = np.asarray(want[k], np.float64) - w0
        dg = np.asarray(got[k], np.float64) - w0
        if np.linalg.norm(dw) == 0:
            assert np.array_equal(got[k], want[k]), k
            continue
        worst = max(worst, np.linalg.norm(dg - dw) / np.linalg.norm(dw))
    return worst


# ---------------------------------------------------------------------------
# Two ranks against each other, one process and the JAX package's step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["s", "c"])
def two_ranks(request, tmp_path_factory):
    """Two gloo ranks, 2 steps of ``train_step`` on b2 shards of the b4
    batch from JAX-initialised weights (rank 1's model was first
    initialised from another seed). Its files are deleted at the end."""
    model = request.param
    tmp_path = tmp_path_factory.mktemp(f"ddp_{model}")
    batch = _global_batch(tmp_path / "batch.npz")
    params_path, tree = _jax_init(model, tmp_path / "init.npz")
    metrics, params = _run_ranks(tmp_path, {
        "mode": "steps", "model": model, "batch": batch,
        "params": params_path, "steps": 2})
    inits = []
    for rank in range(2):
        with np.load(tmp_path / f"result.init.{rank}.npz") as z:
            inits.append({k: z[k] for k in z.files})
    yield dict(model=model, tmp_path=tmp_path, batch=batch,
               params_path=params_path, tree=tree, metrics=metrics,
               params=params, inits=inits)
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_two_ranks_are_bitwise_equal(two_ranks):
    """Every logged metric (loss, data_loss, epe, grad_norm of both
    steps) and every parameter bitwise equal across the ranks, each rank
    in a group of 2 with its model under DDP."""
    metrics, params = two_ranks["metrics"], two_ranks["params"]
    _assert_ranks_bitwise_equal(metrics, params)
    assert all(m["ddp"] and m["world"] == 2 for m in metrics)


def test_ddp_broadcast_starts_every_rank_from_rank0(two_ranks):
    """Rank 1 initialised its model from seed 1, rank 0 from seed 0: after
    ``init_state`` (DDP's constructor) both hold, bitwise, the
    parameters of a one-process seed-0 init."""
    model = two_ranks["model"]
    seed0 = Trainer(TrainConfig(model=model, device="cpu",
                                tensorboard=False)).init_state()
    seed0 = warmstart.flatten(warmstart.to_jax_params(seed0.model))
    for init in two_ranks["inits"]:
        assert init.keys() == seed0.keys()
        for k, v in seed0.items():
            np.testing.assert_array_equal(init[k], v, err_msg=k)


def test_two_ranks_match_one_process(two_ranks):
    """The two ranks on b2 shards against one process on the b4 batch
    (the same gradient summed in another order): every metric within
    rtol 1e-5, each leaf's update from the shared start within 1e-3
    relative L2 (Adam's first steps move a weight by about the learning
    rate whatever its gradient's size, so a near-zero gradient summed in
    another order may move it the other way)."""
    t = two_ranks
    one, one_params = _one_process(t["tmp_path"], t["model"], t["batch"],
                                   t["params_path"])
    for k, v in one.items():
        np.testing.assert_allclose(t["metrics"][0][k], v, rtol=1e-5,
                                   err_msg=k)
    start = warmstart.flatten(t["tree"])
    assert _update_err(t["params"][0], one_params, start) <= 1e-3


@pytest.mark.parametrize("two_ranks", ["s"], indirect=True)
def test_two_ranks_match_jax_single_process_step(two_ranks):
    """FlowNetS's two ranks against the JAX package's single-process step
    in tests/_mp_child.py::run_steps's configuration (the same weights,
    batch and schedule): loss0 and epe1 to rtol 1e-5, loss1 to rtol 1e-4,
    the parameter checksum sum |p| to rtol 2e-5 (the JAX package holds
    its own two processes to 2e-5)."""
    with dispatch.use_s2d(False):
        ref = jchild.run_steps(jchild.global_batch(),
                               mesh=jmesh.make_mesh(jax.devices()[:1]))
    got = two_ranks["metrics"][0]
    np.testing.assert_allclose(got["loss0"], ref["loss0"], rtol=1e-5)
    np.testing.assert_allclose(got["loss1"], ref["loss1"], rtol=1e-4)
    np.testing.assert_allclose(got["epe1"], ref["epe1"], rtol=1e-5)
    psum = sum(float(np.abs(v).sum()) for v in two_ranks["params"][0].values())
    np.testing.assert_allclose(psum, ref["psum"], rtol=2e-5)


@pytest.mark.parametrize("model,kw", [
    ("s", {"grad_accum": 2}),
    ("c", {"remat": True}),
    ("cs", {}),  # FlowNetC frozen: the model's default
])
def test_two_ranks_grad_accum_remat_and_frozen_stage(tmp_path, model, kw):
    """``grad_accum=2`` (the first microbatch under ``no_sync``), remat
    (non-reentrant checkpoints under DDP) and FlowNetCS with FlowNetC
    frozen (not a trainable parameter, so DDP leaves it alone): ranks
    bitwise equal; metrics within rtol 1e-5 of one process on the whole
    batch with the same options, each leaf's update within 1e-3 relative
    L2; the frozen FlowNetC bitwise its start."""
    batch = _global_batch(tmp_path / "batch.npz")
    params_path, tree = _jax_init(model, tmp_path / "init.npz")
    metrics, params = _run_ranks(tmp_path, {
        "mode": "steps", "model": model, "batch": batch,
        "params": params_path, "steps": 2, **kw})
    _assert_ranks_bitwise_equal(metrics, params)
    one, one_params = _one_process(tmp_path, model, batch, params_path, **kw)
    for k, v in one.items():
        np.testing.assert_allclose(metrics[0][k], v, rtol=1e-5, err_msg=k)
    start = warmstart.flatten(tree)
    assert _update_err(params[0], one_params, start) <= 1e-3
    if model == "cs":
        frozen = [k for k in start if k.startswith("FlowNetC/")]
        assert frozen
        for k in frozen:
            np.testing.assert_array_equal(params[0][k], start[k], err_msg=k)


def test_two_rank_save_then_resume_and_evaluate(tmp_path):
    """``Trainer.fit`` on two ranks: rank 0 alone writes the checkpoint
    (one ``checkpoints/2`` directory), a barrier follows, and a fresh
    trainer's ``restore_or_init`` on each rank resumes at step 2 with
    parameters bitwise the trained ones and equal across ranks. Then
    ``evaluate`` on a different batch per rank returns, on both, the
    mean over the group (rtol 1e-6: one f64 sum of two f32 terms)."""
    batch = _global_batch(tmp_path / "batch.npz")
    metrics, params = _run_ranks(tmp_path, {
        "mode": "fit", "model": "s", "batch": batch, "steps": 2})
    _assert_ranks_bitwise_equal(metrics, params)
    assert metrics[0]["resumed"] and metrics[0]["restored_step"] == 2
    assert metrics[0]["restored_equal"]
    assert sorted(os.listdir(tmp_path / "run" / "checkpoints")) == ["2"]
    log = (tmp_path / "rank0.log").read_text()
    assert '"step": 2' in log  # rank 0 prints the log line
    assert '"step"' not in (tmp_path / "rank1.log").read_text()

    # each rank's own eval batch: the first example of its shard, + rank
    trainer = Trainer(TrainConfig(model="s", device="cpu", tensorboard=False,
                                  compute_dtype="float32",
                                  log_dir=str(tmp_path / "run")))
    state, resumed = trainer.restore_or_init()
    assert resumed
    with np.load(batch) as z:
        full = {k: z[k] for k in z.files}
    vals = [trainer.evaluate(state, tchild.ShardLoader(
        {k: v[2 * r:2 * r + 1] + r for k, v in full.items()}),
        max_batches=1) for r in range(2)]
    np.testing.assert_allclose(metrics[0]["val_epe"], np.mean(vals),
                               rtol=1e-6)


def test_two_rank_interrupted_fit_saves_on_rank0_without_a_barrier(
        tmp_path):
    """A loader that fails after one batch on both ranks: ``fit`` re-raises
    on each, both exit well inside their limit (the interrupt save waits
    on no barrier a dead peer could leave hanging), and rank 0 alone has
    written the step-1 checkpoint, equal to both ranks' parameters."""
    batch = _global_batch(tmp_path / "batch.npz")
    metrics, params = _run_ranks(tmp_path, {
        "mode": "fit", "model": "s", "batch": batch, "steps": 3,
        "fail_after": 1})
    _assert_ranks_bitwise_equal(metrics, params)
    assert metrics[0]["error"] == "loader failed after 1 batches"
    assert sorted(os.listdir(tmp_path / "run" / "checkpoints")) == ["1"]
    with np.load(tmp_path / "run" / "checkpoints" / "1" /
                 warmstart.PARAMS_FILE) as z:
        for k, v in params[0].items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)


def test_multihost_without_launcher_env_fails_fast(monkeypatch, tmp_path):
    """``cli train --multihost`` with no launcher environment raises the
    message naming both sets of variables before it builds anything;
    without ``--multihost`` nothing is initialised."""
    for k in LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="--multihost requires cluster "
                       "coordination env: set RANK, WORLD_SIZE"):
        cli.main(["train", "--multihost", "--model", "s", "--device", "cpu",
                  "--synthetic", "--max_steps", "1",
                  "--log_dir", str(tmp_path / "x")])
    assert not mesh.distributed()
    assert not os.path.exists(tmp_path / "x")
    assert mesh.maybe_initialize_distributed(False) is False
    assert (mesh.process_count(), mesh.process_index()) == (1, 0)


def test_launcher_env_names(monkeypatch):
    """torchrun's names and the JAX package's manual names map to one
    (address, port, world size, rank, local rank); the torchrun names
    win when both are set; a malformed COORDINATOR_ADDRESS raises."""
    for k in LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    assert mesh._launch_env() is None
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("NUM_PROCESSES", "4")
    monkeypatch.setenv("PROCESS_ID", "3")
    assert mesh._launch_env() == ("10.0.0.1", 1234, 4, 3, None)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert mesh._launch_env() == ("10.0.0.1", 1234, 4, 3, 1)
    for k, v in (("RANK", "1"), ("WORLD_SIZE", "2"),
                 ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "29500")):
        monkeypatch.setenv(k, v)
    assert mesh._launch_env() == ("127.0.0.1", 29500, 2, 1, 1)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k)
    monkeypatch.setenv("COORDINATOR_ADDRESS", "nohost")
    with pytest.raises(RuntimeError, match="host:port"):
        mesh._launch_env()


def test_missing_peer_ends_the_rendezvous(tmp_path):
    """Rank 0 of a world of 2 whose peer never comes: the rendezvous
    raises after its timeout (3 s here) and the process exits non-zero
    well inside the test's own limit, instead of waiting forever."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from flownet2_tf_tpu_torch.parallel import mesh; "
            "mesh.maybe_initialize_distributed(True, device='cpu', "
            "timeout_s=3)")
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    env.update(RANK="0", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    log = tmp_path / "rank0.log"
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-c", code, REPO], env=env,
                                stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True)
    try:
        rc = proc.wait(timeout=90)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    assert rc != 0, log.read_text()[-2000:]


@pytest.mark.parametrize("batch,n", [(8, 8), (6, 4), (7, 8), (1, 8), (9, 1)])
def test_mesh_for_batch_keeps_the_jax_rule(batch, n):
    """The largest count up to ``n`` dividing the batch, as the JAX
    package's ``mesh_for_batch`` shrinks its mesh."""
    want = jmesh.mesh_for_batch(batch, jmesh.make_mesh(
        jax.devices()[:n])).devices.size
    assert mesh.mesh_for_batch(batch, n) == want


def test_shard_batch_is_the_local_shard():
    """``shard_batch`` stages this process's batch as it is: the same
    arrays as tensors on the device, dtypes kept (uint8 stays uint8)."""
    rng = np.random.RandomState(0)
    batch = {"image_a": rng.randint(0, 255, (2, 8, 8, 3), np.uint8),
             "flow": rng.rand(2, 8, 8, 2).astype(np.float32)}
    out = mesh.shard_batch(batch, "cpu")
    for k, v in batch.items():
        assert out[k].dtype == torch.from_numpy(v).dtype
        np.testing.assert_array_equal(out[k].numpy(), v)


# ---------------------------------------------------------------------------
# What DDP relies on, in one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,frozen", [
    ("s", None), ("c", None), ("sd", None), ("cs", None), ("css", None),
    ("2", None), ("cs", ()),
])
def test_every_trainable_parameter_takes_a_gradient(model, frozen):
    """DDP runs with ``find_unused_parameters=False``, so every trainable
    parameter must take a gradient in every step: one step's backward at
    64x64 leaves a gradient on each parameter that requires one, and none
    on a frozen one (default frozen scopes, and none frozen)."""
    spec = get_model(model)
    net = spec.build("cpu").train()
    frozen = spec.default_frozen if frozen is None else frozen
    optim.zero_frozen_grads(net, frozen)
    rng = np.random.RandomState(1)
    a, b = (torch.from_numpy(rng.rand(1, 64, 64, 3).astype(np.float32))
            for _ in range(2))
    flow = torch.from_numpy(rng.rand(1, 64, 64, 2).astype(np.float32))
    common.msra_init_(net, torch.Generator().manual_seed(0))
    spec.loss(flow, net({"input_a": a, "input_b": b})).backward()
    trainable = [n for n, p in net.named_parameters() if p.requires_grad]
    assert trainable
    for name, p in net.named_parameters():
        assert (p.grad is not None) == p.requires_grad, name


def test_local_batch_losses_give_the_global_gradient(tmp_path):
    """The loss algebra DDP relies on: the mean over P shards of the
    gradient of each shard's loss (its pixel sum over its local batch) is
    the gradient of the loss on the whole batch (rtol 1e-5, atol 1e-7:
    f32 sums in another order)."""
    params_path, _ = _jax_init("s", tmp_path / "init.npz")
    with np.load(_global_batch(tmp_path / "batch.npz")) as z:
        batch = {k: torch.from_numpy(z[k]) for k in z.files}
    spec = get_model("s")
    net = spec.build("cpu").train()
    warmstart.load_jax_params(net, warmstart.load_params_tree(params_path))

    def grads(sl):
        net.zero_grad(set_to_none=True)
        preds = net({"input_a": batch["image_a"][sl],
                     "input_b": batch["image_b"][sl]})
        spec.loss(batch["flow"][sl], preds).backward()
        return [p.grad.clone() for p in net.parameters()]

    whole = grads(slice(0, 4))
    shards = [grads(slice(0, 2)), grads(slice(2, 4))]
    for w, g0, g1 in zip(whole, *shards):
        torch.testing.assert_close((g0 + g1) / 2, w, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# The warp and resize gradients (their backwards sum in a fixed order)
# ---------------------------------------------------------------------------

def _coords(rng, n, h, w, ho, wo):
    # samples inside, on and beyond the border (clamped), many repeated
    x = rng.uniform(-3, w + 2, (n, ho, wo)).astype(np.float32)
    y = rng.uniform(-3, h + 2, (n, ho, wo)).astype(np.float32)
    x[:, ::3] = np.floor(x[:, ::3])
    return x, y


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("multi", [False, True])
def test_gather_gradient_matches_jax(rng, multi):
    """The gradient of a weighted sum of ``bilinear_gather`` (or
    ``bilinear_gather_multi``: M coordinate sets on one image) w.r.t. the
    image and the coordinates, against ``jax.grad`` of the JAX package's
    op on the same inputs: relative L2 <= 1e-5 (f32 sums in another
    order; each image pixel takes many samples' contributions)."""
    n_img, m = (1, 3) if multi else (2, 2)
    img = rng.rand(n_img, 9, 11, 3).astype(np.float32)
    x, y = _coords(rng, m, 9, 11, 7, 13)
    g = rng.randn(m, 7, 13, 3).astype(np.float32)
    jop = jsampling.bilinear_gather_multi if multi else \
        jsampling.bilinear_gather
    top = sampling.bilinear_gather_multi if multi else \
        sampling.bilinear_gather

    want = jax.grad(lambda i, a, b: jnp.sum(jop(i, a, b) * g),
                    argnums=(0, 1, 2))(jnp.asarray(img), jnp.asarray(x),
                                       jnp.asarray(y))
    ti, tx, ty = (torch.from_numpy(v).requires_grad_() for v in (img, x, y))
    (top(ti, tx, ty) * torch.from_numpy(g)).sum().backward()
    for got, w in zip((ti.grad, tx.grad, ty.grad), want):
        assert _rel_l2(got.numpy(), w) <= 1e-5


@pytest.mark.parametrize("shape,out_hw", [
    ((2, 6, 8, 2), (24, 32)),   # up, as the stacks resize a flow
    ((1, 13, 10, 3), (5, 7)),   # down, fractional
])
def test_resize_gradient_matches_jax(rng, shape, out_hw):
    """The gradient of ``resize_bilinear_tf1`` w.r.t. its input against
    ``jax.grad``: relative L2 <= 1e-6 (each source pixel sums a few
    contributions, in another order)."""
    x = rng.rand(*shape).astype(np.float32)
    g = rng.randn(shape[0], *out_hw, shape[3]).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(
        jresize.resize_bilinear_tf1(v, *out_hw) * g))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    (resize.resize_bilinear_tf1(tx, *out_hw) * torch.from_numpy(g)
     ).sum().backward()
    assert _rel_l2(tx.grad.numpy(), want) <= 1e-6


def test_warp_and_resize_gradients_repeat_across_threads():
    """On the CPU the reads are ``gather`` and ``index_select``, whose
    backwards sum serially: with 4 threads two backwards of the gather
    (shared and per-set images, thousands of samples per pixel) and of
    the resize are bitwise equal. (An advanced-indexing read, the CUDA
    one, would sum with atomics across CPU threads.)"""
    gen = torch.Generator().manual_seed(0)
    img = torch.rand(2, 24, 32, 4, generator=gen)
    x, y = (torch.rand(2, 80, 112, generator=gen) * 5 for _ in range(2))
    small = torch.rand(4, 10, 14, 2, generator=gen)

    def grads():
        i = img.clone().requires_grad_()
        i1 = img[:1].clone().requires_grad_()
        s = small.clone().requires_grad_()
        (sampling.bilinear_gather(i, x, y).square().sum()
         + sampling.bilinear_gather_multi(i1, x, y).square().sum()
         + resize.resize_bilinear_tf1(s, 80, 112).square().sum()
         ).backward()
        return i.grad, i1.grad, s.grad

    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        first, second = grads(), grads()
    finally:
        torch.set_num_threads(threads)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
