"""Training steps as ``Trainer.fit`` runs them, without checkpoints,
TensorBoard or logging in the window.

Set-up builds one ``Trainer`` and its state (``init_state``), fills the
model with the harness's weights, draws a pool of batches on the host
(uint8 frames, as a decoder yields them, and f32 flows, already cropped)
and hands them to the port's ``parallel/mesh.py::DevicePrefetcher``,
which stages batch k+1 on a worker thread while step k runs. Set-up
drives the trainer through its first steps (those the reference
follows) and a few more; the window then runs ``Trainer.train_step`` on
the prefetcher's batches until its time is up, ended by a device
synchronize. Each step's metrics are read only after the window.

Traffic keys: ``dtype``, ``batch``, ``height``, ``width`` (the crop),
``pool`` (batches drawn in set-up, cycled), ``exposure`` (the lowest
and highest of the ladder of exposures that every batch holds, in
batch order), ``checked_steps`` (the
first steps, which the reference follows), ``warmup_steps`` (further
set-up steps), ``trace_steps``, ``f32_features``, ``max_flow``;
the schedule (``lr``, ``beta1``, ``beta2``, ``weight_decay``) is the
configuration's.

Quantities: ``train_examples_per_s`` (examples of every step of the
window over its time).
"""

from __future__ import annotations

import itertools
import tempfile
import time

from portbench.harness import arith, compare, inputs, weights
from portbench.harness.runctx import load_params, sync
from portbench.harness.trace import Tracer
from portbench.reference import flownet as ref


def _schedule(cfg):
    s = cfg["schedule"]
    return {"name": "bench", "step_values": [10**9],
            "learning_rates": [s["lr"], s["lr"]], "momentum": s["beta1"],
            "momentum2": s["beta2"], "weight_decay": s["weight_decay"],
            "max_iter": 10**9}


def _norms(tensors):
    import torch

    names = list(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[k].float())
                        for k in names]).tolist()
    return dict(zip(names, vals))


def _pool(run, device):
    tr = run.traffic
    b = int(tr["batch"])
    lo, hi = tr["exposure"]
    # the same ladder in every batch, from the darkest scene to the
    # brightest: examples differ, as a dataset's do
    ladder = [lo + (hi - lo) * i / max(b - 1, 1) for i in range(b)]
    a, bb, flow = inputs.make_pairs(run.seed, int(tr["pool"]) * b,
                                    tr["height"], tr["width"], device,
                                    float(tr["max_flow"]),
                                    exposure=ladder * int(tr["pool"]))
    a, bb = inputs.to_uint8(a), inputs.to_uint8(bb)
    return [{"image_a": a[i * b:(i + 1) * b], "image_b": bb[i * b:(i + 1) * b],
             "flow": flow[i * b:(i + 1) * b]} for i in range(int(tr["pool"]))]


def _reference_steps(run, batches, device, quant=None):
    """The reference's first steps from the same weights on the same
    batches: (losses, first-gradient norms, change norms)."""
    import torch

    cfg, sched = run.config, run.config["schedule"]
    params = {k: v.clone().requires_grad_(True) for k, v in
              weights.make_params(ref.param_specs(cfg["reference"]),
                                  run.seed, device).items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    state, losses, grad_norms = {}, [], None
    with ref.exact():
        for step, batch in enumerate(batches, start=1):
            loss = ref.train_loss(cfg["reference"], params,
                                  *(batch[k].to(device) for k in
                                    ("image_a", "image_b", "flow")),
                                  sched["weight_decay"], quant)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            losses.append(float(loss.detach()))
            if step == 1:
                grad_norms = _norms(grads)
            ref.adam_update(params, grads, state, step, sched["lr"],
                            sched["beta1"], sched["beta2"], 1e-8)
    change = _norms({k: params[k].detach() - start[k] for k in params})
    return losses, grad_norms, change


def run(run):
    import torch

    from flownet2_tf_tpu_torch.parallel.mesh import DevicePrefetcher
    from flownet2_tf_tpu_torch.training.loop import TrainConfig, Trainer

    tr, cfg = run.traffic, run.config
    device = torch.device(run.device)
    control = run.cell.limits.get("control", {})
    knobs = {"f32_features": tr["f32_features"]}
    by_reference = (run.variant == "control"
                    and control.get("kind") == "reference")
    if run.variant == "control" and control.get("kind") == "program":
        knobs.update(control["knobs"])
    n_checked = int(tr["checked_steps"])
    run.mark("driver_imports")
    batches = _pool(run, device)
    run.mark("inputs")
    if by_reference:
        # the control in the program's place: the reference at a lower
        # precision, held against the reference
        losses, g1, change = _reference_steps(
            run, batches[:n_checked], device,
            compare.QUANT[control["quant"]])
        return _checked(run, batches, device, losses, g1, change,
                        {"attempted": n_checked, "failed": 0, "errors": [],
                         "setup_s": run.setup_s(), "memory_peak_bytes": 0,
                         "quantities": {}})

    with tempfile.TemporaryDirectory() as log_dir:
        # nothing is written there: no checkpoints, no TensorBoard
        trainer = Trainer(TrainConfig(
            model=cfg["model"], schedule=_schedule(cfg), log_dir=log_dir,
            seed=0, compute_dtype=tr["dtype"], augment=False,
            tensorboard=False, checkpoint_every=0, device=str(device),
            device_prefetch="thread", **knobs))
    state = trainer.init_state()
    run.mark("init_state")
    params = weights.make_params(ref.param_specs(cfg["reference"]),
                                 run.seed, device)
    load_params(state.model, params)
    del params
    run.mark("weights")

    def source():
        for i in itertools.count():
            yield batches[i % len(batches)]

    feed = DevicePrefetcher(source(), device, threaded=True)
    named = dict(state.model.named_parameters())
    try:
        metrics = []
        g1 = None
        for step in range(n_checked):
            _, dev = next(feed)
            metrics.append(trainer.train_step(state, dev))
            if step == 0:
                # the first gradient as Adam got it: exp_avg = (1 - b1) g
                beta1 = cfg["schedule"]["beta1"]
                g1 = {k: state.optimizer.state[p]["exp_avg"] / (1 - beta1)
                      for k, p in named.items()
                      if "exp_avg" in state.optimizer.state.get(p, {})}
                g1 = _norms(g1) if g1 else {}
        start = weights.make_params(ref.param_specs(cfg["reference"]),
                                    run.seed, device)
        change = _norms({k: p.detach() - start[k] for k, p in named.items()})
        del start
        losses = [float(m["loss"]) for m in metrics]
        for _ in range(int(tr["warmup_steps"])):
            _, dev = next(feed)
            trainer.train_step(state, dev)
        sync(device)
        run.mark("warmup")
        setup_s = run.setup_s()

        window = []
        tracer = Tracer(device) if run.trace else None
        traced = None
        t_start = time.perf_counter()
        deadline = t_start + run.seconds
        for _, dev in feed:
            window.append(trainer.train_step(state, dev))
            now = time.perf_counter()
            if tracer is not None and traced is None and (
                    now - t_start >= 0.3 * run.seconds or now >= deadline):
                with tracer:
                    for _ in range(int(tr["trace_steps"])):
                        _, dev = next(feed)
                        window.append(trainer.train_step(state, dev))
                traced = int(tr["trace_steps"])
            if time.perf_counter() >= deadline:
                break
        sync(device)
        window_s = time.perf_counter() - t_start
    finally:
        feed.close()
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    finite = [torch.isfinite(m["loss"]).item() for m in window]
    out = {"attempted": len(window), "failed": finite.count(False),
           "errors": [], "setup_s": setup_s,
           "memory_peak_bytes": memory_peak,
           "quantities": {"train_examples_per_s":
                          len(window) * int(tr["batch"]) / window_s}}
    if tracer is not None:
        out["summary"] = _summary(run, tracer, traced)
    del state, trainer, metrics, window, named
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return _checked(run, batches, device, losses, g1, change, out)


def _summary(run, tracer, steps):
    import torch

    tr = run.traffic
    summary = tracer.summary()
    b, h, w = int(tr["batch"]), int(tr["height"]), int(tr["width"])
    dtype = tr["dtype"]
    peaks = arith.peaks_for(torch.cuda.get_device_name(tracer.device)
                            if tracer.on_card else None)
    feat = (b, h // 8, w // 8, 256)
    summary.update(
        items=steps * b, steps=steps,
        flops_per_item=arith.reference_flops(run.config["reference"], 1, h,
                                             w, train=True),
        peak_flops=peaks[dtype] if peaks else None,
        corr_fwd_bound_s=(arith.corr_bound(feat, ref.CORR_D, ref.CORR_S2,
                                           dtype, peaks=peaks)[0]
                          if peaks else None),
        corr_bwd_bound_s=(arith.corr_bound(feat, ref.CORR_D, ref.CORR_S2,
                                           dtype, backward=True,
                                           peaks=peaks)[0]
                          if peaks else None))
    return summary


def _checked(run, batches, device, losses, g1, change, out):
    n = int(run.traffic["checked_steps"])
    r_losses, r_g1, r_change = _reference_steps(run, batches[:n], device)
    loss_rel = max(abs(p - r) / abs(r) for p, r in zip(losses, r_losses))
    if len(losses) != len(r_losses):
        loss_rel = float("inf")
    grad_gap, grad_leaf = compare.leaf_gap(g1 or {}, r_g1)
    moving = compare.moving_leaves(r_g1)
    update_gap, update_leaf = compare.leaf_gap(
        change, {k: v for k, v in r_change.items() if k in moving})
    out["checks"] = {"loss_rel": loss_rel, "grad_gap": grad_gap,
                     "update_gap": update_gap}
    out["info"] = {"grad_gap_leaf": grad_leaf, "update_gap_leaf": update_leaf,
                   "losses": losses, "reference_losses": r_losses,
                   "leaves_left_out": sorted(set(r_g1) - moving)}
    return out

