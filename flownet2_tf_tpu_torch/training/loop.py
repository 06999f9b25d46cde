"""Training runtime: the train step (bf16 policy by default, or f32),
checkpoints, auto-resume, warm starts, frozen stages, metrics and data
parallelism.

Port of ``flownet2_tf_tpu/training/loop.py`` (``TrainConfig``,
``Trainer``), one process per device. What maps to what:

* the jitted pure step -> :meth:`Trainer.train_step`, eager autograd on a
  :class:`TrainState` updated in place (model, Adam, step count), all of
  it under ``models/common.py::f32_policy`` (TF32 off, backward included);
* ``compute_dtype`` (default ``bfloat16``, as in the JAX package) -> the
  model's forward runs the bf16 policy of ``models/common.py`` over f32
  master weights: each feature layer casts its weights to bf16 inside
  its forward, so autograd returns f32 gradients, and Adam, the loss and
  the checkpoints stay f32;
* the dispatch knobs the JAX step reads at trace time (``warp_res``,
  ``fusion_res``, ``bf16_interconv``, ``f32_features``) -> the model's
  build arguments (``ModelSpec.build_for``); ``f32_features='default'``
  turns TF32 on for the feature layers' forward only;
* ``transfer_flow_dtype`` -> the GT flow is cast to float16/bfloat16 on
  the host, crosses to the device narrow and is cast back to f32 there;
* ``_images_to_float`` -> uint8 images (``TFRecordFlowDataset(raw_uint8=
  True)``, what ``load_batch`` reads TFRecords with) cross to the device
  as uint8 and become ``float32 / 255`` there; float batches pass
  through;
* device-side augmentation inside the step -> ``data/augmentation.py`` on
  the device, its draws from a ``torch.Generator`` seeded from
  ``(seed + 17, step, rank)`` (:func:`step_seed`), so a resumed run draws
  what an uninterrupted one would (the JAX package's ``fold_in``) and,
  in a process group, each rank augments its local batch with draws of
  its own, as the JAX step's one key gives each process's slice of the
  global array its own draws;
* ``stop_grad_frozen`` / ``zero_frozen_grads`` -> frozen scopes switched
  to ``requires_grad=False`` and kept out of Adam
  (``training/optim.py::zero_frozen_grads``);
* ``grad_accum`` -> a loop over equal microbatches whose gradients are
  averaged; the batch is augmented once before the split (the JAX package
  draws per microbatch; the distribution is the same);
* orbax -> ``log_dir/checkpoints/<step>/`` holding ``params.npz`` (JAX
  layout, flat '/' keys, read by both packages' ``load_params_tree``) and
  ``optimizer.pt`` (Adam state and step). Orbax's asynchronous manager
  (``enable_async_checkpointing=True``) -> :meth:`Trainer.save`: the
  training thread takes a host snapshot of the step's state (the
  parameters, ``warmstart.layer_params``, and ``optimizer.state_dict()``
  copied into host buffers that every save reuses, pinned on a card),
  which costs it one device-to-host copy of the checkpoint and nothing
  else; a non-daemon writer thread then relays the parameters out to the
  JAX layout, writes
  ``<step>.tmp/``, renames it to ``<step>/`` and prunes to the newest
  ``keep_checkpoints``. One save is in flight at a time, as in
  orbax; ``save(state, wait=True)`` is orbax's ``save`` plus
  ``wait_until_finished``, and a failed write is re-raised on the
  training thread. Auto-resume from the newest is the same, and so is
  the interrupt checkpoint in ``finally``, which waits;
* ``device_prefetch`` -> ``fit`` feeds its steps through
  ``parallel/mesh.py::DevicePrefetcher``: on a card a worker thread pins
  batch k+1 and uploads it on a copy stream while step k runs
  (``'auto'`` is ``'thread'``; ``'inline'`` stages on the training
  thread);
* ``remat`` (``jax.checkpoint`` around the whole forward) -> the models'
  segments under ``torch.utils.checkpoint`` (``models/common.py::
  remat``): each trainable net's encoder convs in groups and each decoder
  level keep only their inputs and are recomputed in the backward, which
  runs inside ``f32_policy`` like the forward;
* ``image_summary_every`` -> every N steps four TensorBoard images of
  one center-cropped example: the inputs and the predicted and GT flows
  (``utils/flowlib.py::flow_to_image``), the prediction from a forward on
  the device under ``torch.no_grad()``;
* the data-parallel mesh -> ``DistributedDataParallel`` whenever the
  process is in a group (``parallel/mesh.py::maybe_initialize_distributed``,
  ``cli train --multihost``; world size 1 included): each process
  trains on the batch its loader yields (its local shard; the global
  batch is that times the process count) and DDP averages the gradients
  over the group. Buffers are not broadcast (the nets have none), frozen
  scopes are not trainable parameters, so DDP leaves them alone, and
  every trainable parameter takes a gradient in every step
  (``find_unused_parameters=False``). The logged ``loss``, ``data_loss``
  and ``epe`` are all-reduced, and ``grad_norm`` is taken on the reduced
  gradients, so every process logs the same numbers; only process 0
  prints them and writes TensorBoard, and only process 0 writes
  checkpoints, from its writer thread, which calls no collective. The
  processes meet at a barrier only where a save is waited for
  (``save(state, wait=True)`` and the end of ``fit``), never behind a
  periodic save. ``restore_or_init`` and ``warm_start`` run on every
  process from the same files. ``evaluate`` reduces its sums over the
  group.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import shutil
import sys
import threading
import time
import traceback
import warnings
from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn

from flownet2_tf_tpu_torch.data import augmentation
from flownet2_tf_tpu_torch.models.common import (
    compute_dtype_of,
    endpoint_error_mean,
    f32_policy,
    msra_init_,
    remat,
)
from flownet2_tf_tpu_torch.models.registry import get_model
from flownet2_tf_tpu_torch.parallel import mesh
from flownet2_tf_tpu_torch.parallel.mesh import DevicePrefetcher
from flownet2_tf_tpu_torch.training import optim
from flownet2_tf_tpu_torch.training.infer import pad_to_multiple, resolve_device
from flownet2_tf_tpu_torch.training.warmstart import (
    PARAMS_FILE,
    apply_warm_starts,
    jax_layout,
    layer_params,
    latest_checkpoint,
    load_jax_params,
    load_params_tree,
    to_jax_params,
)
from flownet2_tf_tpu_torch.utils.schedules import get_schedule, make_lr_schedule

OPTIMIZER_FILE = "optimizer.pt"
TRANSFER_FLOW_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                        "bfloat16": torch.bfloat16}


def _images_to_float(x):
    """[0, 1] float32 images from a device tensor: uint8 becomes ``x /
    255`` by a true division, as the JAX package and the host readers
    compute it (a CUDA division by a Python scalar multiplies by its
    reciprocal, which differs in the last bit for 126 of the 256 values);
    float32 passes through unchanged."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / x.new_full((), 255.0,
                                                 dtype=torch.float32)
    return x.to(torch.float32)


def _use_threaded_prefetch(mode: str) -> bool:
    """``TrainConfig.device_prefetch`` -> whether batches stage on a worker
    thread: ``'thread'`` and ``'auto'`` do, ``'inline'`` does not."""
    if mode not in ("auto", "thread", "inline"):
        raise ValueError(f"device_prefetch must be 'auto'|'thread'|"
                         f"'inline', got {mode!r}")
    return mode != "inline"


@dataclasses.dataclass
class TrainConfig:
    model: str = "s"
    schedule: Any = "long"  # name or schedule dict
    log_dir: str = "./logs/flownet_s"
    seed: int = 0
    compute_dtype: str = "bfloat16"  # 'bfloat16' | 'float32'
    augment: bool = True
    frozen: Optional[Sequence[str]] = None  # None -> model default
    max_steps: Optional[int] = None  # None -> schedule max_iter
    log_every: int = 100
    checkpoint_every: int = 2500
    keep_checkpoints: int = 5
    tensorboard: bool = True
    image_summary_every: int = 0  # 0 = off
    # recompute each trainable net's segments in the backward
    # (models/common.py::remat): about a third more forward work for a
    # lower peak of activation memory
    remat: bool = False
    # split each batch into N equal microbatches, gradients averaged: one
    # update per batch, ~N-fold lower activation memory
    grad_accum: int = 1
    # periodic validation: every N steps the mean EPE of eval batches
    eval_every: int = 0
    eval_batches: int = 4
    # host->device GT-flow dtype: 'float32' (exact), 'float16' or
    # 'bfloat16' (half the flow's bytes on the wire; f32 again on the
    # device, so the loss and augmentation math stay f32)
    transfer_flow_dtype: str = "float32"
    device: str = "cuda"
    # the stack warps' grid factor (1 exact, 2 half, 4 quarter); models
    # without stack warps ignore it
    warp_res: int = 1
    # FlowNet2's fusion grid factor (1 exact, 2 half); other models ignore
    # it
    fusion_res: int = 1
    # the interconvs follow the bf16 compute dtype (FlowNetSD, FlowNet2)
    bf16_interconv: bool = False
    # 'highest' | 'default': TF32 feature layers in the f32 forward (the
    # backward stays full f32)
    f32_features: str = "highest"
    # batch staging: 'auto' | 'thread' | 'inline'. 'thread' pins batch k+1
    # and uploads it on a copy stream from a worker thread while step k
    # runs; 'auto' is 'thread'
    device_prefetch: str = "auto"


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    # the DistributedDataParallel wrapper of ``model`` that runs the
    # training forward when the process is in a group; None outside one
    ddp: Optional[nn.Module] = None


_U64 = 0xFFFF_FFFF_FFFF_FFFF
# odd, so ``rank * _RANK_MIX`` is a bijection on 64-bit ranks
_RANK_MIX = 0x9E37_79B9_7F4A_7C15


def step_seed(seed: int, step: int, rank: int = 0) -> int:
    """The augmentation generator's seed at ``step`` on process ``rank``:
    a pure function of ``(seed + 17, step, rank)``. Rank 0 (and so every
    single-process run) keeps the seed ``(seed + 17, step)``; the other
    ranks XOR it with distinct 64-bit words, so no two ranks share a seed
    at any step."""
    base = (((seed + 17) << 32) + step) & _U64
    return base ^ ((rank * _RANK_MIX) & _U64)


def _tensors(tree):
    """The tensors of nested dicts, lists and tuples, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _with_tensors(tree, tensors):
    """A deep copy of ``tree`` whose tensors, in :func:`_tensors`' order,
    are taken from the iterator ``tensors``."""
    if isinstance(tree, torch.Tensor):
        return next(tensors)
    if isinstance(tree, dict):
        return {k: _with_tensors(v, tensors) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_with_tensors(v, tensors) for v in tree)
    return copy.deepcopy(tree)


class Trainer:
    def __init__(self, config: TrainConfig):
        self.config = config
        self.spec = get_model(config.model)
        self.schedule = (
            get_schedule(config.schedule)
            if isinstance(config.schedule, str)
            else dict(config.schedule)
        )
        self.compute_dtype = compute_dtype_of(config.compute_dtype)
        tfd = str(config.transfer_flow_dtype)
        if tfd not in TRANSFER_FLOW_DTYPES:
            raise ValueError(
                f"transfer_flow_dtype must be one of "
                f"{tuple(TRANSFER_FLOW_DTYPES)}, got {tfd!r}"
            )
        self.flow_wire_dtype = TRANSFER_FLOW_DTYPES[tfd]
        self.device = resolve_device(config.device)
        if (mesh.distributed() and self.device.type == "cuda"
                and self.device.index is None):
            # DDP needs the card by index: the one the group bound
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.frozen = tuple(
            self.spec.default_frozen if config.frozen is None
            else config.frozen
        )
        self.weight_decay = float(self.schedule.get("weight_decay", 0.0))
        self.lr_fn = make_lr_schedule(self.schedule)
        self._threaded_prefetch = _use_threaded_prefetch(
            config.device_prefetch)
        self._updating = False
        # the save in flight (a writer thread) and the error it hit
        self._writer = None
        self._write_error = None
        # the step of the newest checkpoint known complete on disk: the
        # last one this trainer's writer committed, or the one it resumed
        self._on_disk_step = None
        # host copies of the last checkpoint's tensors, reused by the next
        self._snapshot_buffers = []

    # -- state ------------------------------------------------------------

    def init_state(self) -> TrainState:
        """MSRA-initialised model (``torch.Generator`` seeded by
        ``config.seed``) on the device, frozen scopes frozen, Adam over
        the rest, step 0. In a process group the model is wrapped in DDP,
        whose constructor broadcasts process 0's parameters, so every
        process starts from the same ones."""
        cfg = self.config
        model = self.spec.build_for(
            self.device, warp_res=cfg.warp_res, fusion_res=cfg.fusion_res,
            bf16_interconv=cfg.bf16_interconv,
            f32_features=cfg.f32_features).train()
        msra_init_(model, torch.Generator().manual_seed(self.config.seed))
        optim.zero_frozen_grads(model, self.frozen)
        trainable = [p for p in model.parameters() if p.requires_grad]
        optimizer, _ = optim.make_optimizer(trainable, self.schedule)
        ddp = None
        if mesh.distributed():
            with warnings.catch_warnings():
                # newer torch renames the flag; both mean the same here
                warnings.filterwarnings(
                    "ignore", "`broadcast_buffers` is deprecated",
                    FutureWarning)
                ddp = nn.parallel.DistributedDataParallel(
                    model,
                    device_ids=[self.device] if self.device.type == "cuda"
                    else None,
                    broadcast_buffers=False, find_unused_parameters=False)
        return TrainState(model, optimizer, 0, ddp)

    # -- checkpoints --------------------------------------------------------

    def save(self, state: TrainState, wait: bool = False):
        """Checkpoint ``state`` to ``log_dir/checkpoints/<step>/``, as the
        JAX package's ``save(state, wait)`` does through orbax.

        Process 0 first waits for its previous save (one is in flight at
        a time) and re-raises that save's error, if it failed; then it
        copies the state to the host on this thread and hands the copy
        to a writer thread, and returns. The writer writes
        ``<step>.tmp/``, renames it to ``<step>/`` and only then prunes
        to the newest ``keep_checkpoints``; a failed write leaves no
        ``<step>/``. With ``wait`` the call returns once ``<step>/`` is
        complete, and every process of a group then waits for the others
        at a barrier; without ``wait`` there is no barrier. The other
        processes write nothing."""
        if mesh.process_index() == 0:
            self.wait_until_finished()
            params, optimizer = self._snapshot(
                (layer_params(state.model), state.optimizer.state_dict()))
            self._writer = threading.Thread(
                target=self._run_writer,
                args=(state.step, params, optimizer),
                name=f"checkpoint-writer-{state.step}", daemon=False)
            self._writer.start()
            if wait:
                self.wait_until_finished()
        if wait:
            mesh.barrier()

    def _snapshot(self, tree):
        """``tree`` with each tensor copied to the host: copies, all of
        them, because the next ``optimizer.step()`` updates the parameters
        and Adam's moments and step counts in place. The copies land in
        buffers kept from the last save (pinned on a card, so the copy is
        one DMA at the link's rate and touches no new page); a save
        reuses them only after the previous write has ended. They hold one
        checkpoint's worth of host memory for the trainer's life."""
        live = _tensors(tree)
        bufs = self._snapshot_buffers
        if [(b.shape, b.dtype) for b in bufs] != [(t.shape, t.dtype)
                                                  for t in live]:
            pin = self.device.type == "cuda"
            bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                    for t in live]
            self._snapshot_buffers = bufs
        for buf, t in zip(bufs, live):
            buf.copy_(t, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return _with_tensors(tree, iter(bufs))

    def wait_until_finished(self):
        """Return once this trainer's save in flight, if any, is on disk;
        re-raise here, once, the error its writer hit."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        error, self._write_error = self._write_error, None
        if error is not None:
            raise error

    def _run_writer(self, step, params, optimizer):
        # a non-daemon thread: a process that exits normally after
        # save() still finishes the write first
        try:
            self._write_checkpoint(step, params, optimizer)
        except BaseException as e:  # re-raised on the training thread
            e.add_note(f"raised by the checkpoint writer of step {step}: "
                       "the checkpoint was not written")
            self._write_error = e
            # said at once too: a process that exits without waiting
            # would never raise it
            print(f"warning: the checkpoint of step {step} was not "
                  f"written: {e!r}", file=sys.stderr, flush=True)

    def _write_checkpoint(self, step, params, optimizer):
        root = os.path.join(self.config.log_dir, "checkpoints")
        final = os.path.join(root, str(step))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            np.savez(os.path.join(tmp, PARAMS_FILE), **jax_layout(params))
            torch.save({"step": step, "optimizer": optimizer},
                       os.path.join(tmp, OPTIMIZER_FILE))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        self._on_disk_step = step
        steps = sorted(int(e) for e in os.listdir(root) if e.isdigit())
        for old in steps[:-max(1, self.config.keep_checkpoints)]:
            shutil.rmtree(os.path.join(root, str(old)))

    def _save_on_interrupt(self, state, error):
        """``fit``'s body raised ``error``: process 0 lets the write in
        flight end, then saves the step it has unless that step is the
        newest complete on disk, and waits for the write, with no barrier,
        which a peer that died would never reach. So a step whose write
        failed (``error`` may be that failure) is written once more."""
        self._wait_noting(error)
        if self._updating:
            # an exception inside optimizer.step() may have left the
            # parameters half updated: keep the last good checkpoint
            print("warning: interrupt checkpoint skipped - the failing "
                  "step was inside the optimizer update; the newest "
                  "checkpoint on disk is unchanged", flush=True)
        elif state.step != self._on_disk_step:
            self._wait_noting(error, state)

    def _wait_noting(self, error, state=None):
        """Save ``state`` if given, then wait for the write in flight; a
        writer error found here is printed and noted on ``error``, which
        propagates."""
        try:
            if state is not None:
                self.save(state)
            self.wait_until_finished()
        except Exception as write_error:
            print("warning: a checkpoint write failed while fit was "
                  "handling another error:", file=sys.stderr, flush=True)
            traceback.print_exception(write_error, file=sys.stderr)
            error.add_note(f"a checkpoint write failed too: {write_error!r}")

    def restore_or_init(self):
        """Auto-resume from the newest checkpoint in log_dir, else init.
        Returns ``(state, resumed)``. Waits for this trainer's save in
        flight first."""
        self.wait_until_finished()
        state = self.init_state()
        latest = latest_checkpoint(self.config.log_dir)
        if latest is None:
            return state, False
        load_jax_params(state.model, load_params_tree(latest))
        saved = torch.load(os.path.join(latest, OPTIMIZER_FILE),
                           map_location=self.device, weights_only=True)
        state.optimizer.load_state_dict(saved["optimizer"])
        state.step = int(saved["step"])
        self._on_disk_step = state.step
        return state, True

    def warm_start(self, state: TrainState, checkpoints) -> TrainState:
        """Load prior-stage checkpoints into sub-scopes: ``checkpoints`` is
        ``{path: (src_scope, dst_scope)}`` or ``[(path, src, dst), ...]``
        ('' selects the root), as in ``warmstart.apply_warm_starts``.
        Waits for this trainer's save in flight first."""
        self.wait_until_finished()
        tree = apply_warm_starts(to_jax_params(state.model), checkpoints)
        load_jax_params(state.model, tree)
        return state

    # -- the step -----------------------------------------------------------

    def _to_device(self, batch, flow_wire=torch.float32):
        """The batch as f32 device tensors: images cross in their own
        dtype (uint8 or float32) and are converted on the device; the flow
        crosses as ``flow_wire`` (cast on the host) and is cast back on the
        device. Tensors already on the device (a prefetched batch) stay
        there."""
        image_a, image_b, flow = (
            batch[k] if isinstance(batch[k], torch.Tensor)
            else torch.as_tensor(np.asarray(batch[k]))
            for k in ("image_a", "image_b", "flow"))
        return (_images_to_float(image_a.to(self.device)),
                _images_to_float(image_b.to(self.device)),
                flow.to(flow_wire).to(self.device).float())

    def _wire(self, batch):
        """The host batch with its flow cast to the wire dtype, for the
        upload (``transfer_flow_dtype``)."""
        if self.flow_wire_dtype == torch.float32:
            return batch
        flow = batch["flow"]
        if not isinstance(flow, torch.Tensor):
            flow = torch.from_numpy(np.asarray(flow))
        return {**batch, "flow": flow.to(self.flow_wire_dtype)}

    def _loss(self, state, image_a, image_b, flow):
        # In a group each process's loss divides its pixel sum S_r by its
        # local batch b = B / P, and DDP averages the gradients over the P
        # processes: (1/P) sum_r grad(S_r / b) = grad(sum_r S_r / B), the
        # gradient of the JAX package's loss on the global batch B. The L2
        # term is the same on every process, so its average is itself.
        forward = state.ddp if state.ddp is not None else state.model
        with remat(self.config.remat):
            preds = forward({"input_a": image_a, "input_b": image_b},
                            self.compute_dtype)
        data_loss = self.spec.loss(flow, preds)
        reg = optim.l2_regularization(state.model, self.frozen)
        total = data_loss + self.weight_decay * reg
        epe = endpoint_error_mean(flow, preds["flow"])
        return total, data_loss, epe

    def train_step(self, state: TrainState, batch, preprocess=None):
        """One update on ``batch`` (numpy dict); returns the step's
        metrics as 0-d device tensors (``lr`` a float), read at log time."""
        cfg = self.config
        accum = max(1, int(cfg.grad_accum))
        image_a, image_b, flow = self._to_device(batch, self.flow_wire_dtype)
        # The JAX package refuses a global batch that does not divide its
        # mesh; here each process takes its own local batch whole, so
        # there is nothing to divide and no such error.
        if image_a.shape[0] % accum:
            raise ValueError(
                f"grad_accum={accum} must divide the batch size "
                f"({image_a.shape[0]}): each step runs {accum} equal "
                "microbatches"
            )
        with f32_policy(self.compute_dtype):
            if cfg.augment and preprocess is not None:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(step_seed(cfg.seed, state.step,
                                          mesh.process_index()))
                image_a, image_b, flow = augmentation.augment_batch(
                    gen, image_a, image_b, flow, preprocess)
            state.optimizer.zero_grad(set_to_none=True)
            sums = torch.zeros(3, device=self.device)
            micro = list(zip(image_a.chunk(accum), image_b.chunk(accum),
                             flow.chunk(accum)))
            for i, (a, b, f) in enumerate(micro):
                # DDP reduces the gradients once, in the last backward
                sync = state.ddp is None or i == len(micro) - 1
                with contextlib.nullcontext() if sync else state.ddp.no_sync():
                    total, data_loss, epe = self._loss(state, a, b, f)
                    (total / accum).backward()
                sums += torch.stack([total, data_loss, epe]).detach()
            if state.ddp is not None:
                # equal local batches: the mean of the processes' means
                torch.distributed.all_reduce(sums)
                sums /= mesh.process_count()
            # after DDP's reduce: the global gradient on every process
            grads = [p.grad for group in state.optimizer.param_groups
                     for p in group["params"] if p.grad is not None]
            grad_norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            lr = self.lr_fn(state.step)
            optim.set_lr(state.optimizer, lr)
            self._updating = True
            state.optimizer.step()
            self._updating = False
        state.step += 1
        sums = sums / accum
        return {"loss": sums[0], "data_loss": sums[1], "epe": sums[2],
                "grad_norm": grad_norm, "lr": lr}

    def _write_image_summaries(self, writer, state, batch, device_batch,
                               preprocess, step):
        """TensorBoard images of the batch's first example, center-cropped
        (``augmentation.center_crop_batch``): ``input_a``, ``input_b``,
        ``pred_flow`` and ``gt_flow`` (``flowlib.flow_to_image``). The
        forward runs on the device copy on the live parameters under
        ``torch.no_grad()``; only the predicted flow crosses to the host,
        and the other three images come from the host batch."""
        from flownet2_tf_tpu_torch.utils.flowlib import flow_to_image

        def example(b):
            a, bb, f = (b[k][:1] if isinstance(b[k], torch.Tensor)
                        else torch.from_numpy(np.asarray(b[k][:1]))
                        for k in ("image_a", "image_b", "flow"))
            a, bb, f = _images_to_float(a), _images_to_float(bb), f.float()
            if preprocess is not None:
                a, bb, f = augmentation.center_crop_batch(a, bb, f,
                                                          preprocess)
            return a, bb, f

        image_a, image_b, flow_gt = example(batch)
        dev_a, dev_b, _ = example(device_batch)
        with torch.no_grad(), f32_policy(self.compute_dtype):
            pred = state.model({"input_a": dev_a, "input_b": dev_b},
                               self.compute_dtype)["flow"]
        pred = pred[0].cpu().numpy()
        writer.image("input_a", np.uint8(
            np.clip(image_a[0].numpy(), 0, 1) * 255), step)
        writer.image("input_b", np.uint8(
            np.clip(image_b[0].numpy(), 0, 1) * 255), step)
        writer.image("pred_flow", flow_to_image(pred), step)
        writer.image("gt_flow", flow_to_image(flow_gt[0].numpy()), step)
        writer.flush()

    # -- the loop -----------------------------------------------------------

    def evaluate(self, state: TrainState, eval_loader, max_batches=None):
        """Mean full-res EPE over validation batches (edge-padded to %64
        and cropped back, like inference). In a process group the sums and
        counts are reduced over it, so every process returns the same
        value."""
        max_batches = max_batches or self.config.eval_batches
        total, n = 0.0, 0
        batches = eval_loader.batches(epochs=1)
        try:
            with torch.no_grad(), f32_policy(self.compute_dtype):
                for batch in batches:
                    image_a, image_b, flow = self._to_device(batch)
                    a, h, w = pad_to_multiple(image_a)
                    b, _, _ = pad_to_multiple(image_b)
                    pred = state.model({"input_a": a, "input_b": b},
                                       self.compute_dtype)["flow"]
                    total += float(endpoint_error_mean(
                        flow, pred[:, :h, :w, :]))
                    n += 1
                    if n >= max_batches:
                        break
        finally:
            batches.close()
        if mesh.distributed():
            stats = torch.tensor([total, n], dtype=torch.float64,
                                 device=self.device)
            torch.distributed.all_reduce(stats)
            total, n = stats[0].item(), int(stats[1].item())
        if n == 0:
            print("warning: validation loader yielded no batches "
                  "(split smaller than batch size?)", flush=True)
            return None
        return total / n

    def fit(self, loader, preprocess=None, max_steps=None, state=None,
            warm_start_checkpoints=None, eval_loader=None) -> TrainState:
        cfg = self.config
        if max_steps is None:
            max_steps = (cfg.max_steps if cfg.max_steps is not None
                         else int(self.schedule["max_iter"]))
        saved_step = None
        if state is None:
            state, resumed = self.restore_or_init()
            if resumed:
                saved_step = state.step
            elif warm_start_checkpoints:
                state = self.warm_start(state, warm_start_checkpoints)

        chief = mesh.process_index() == 0
        writer = None
        if cfg.tensorboard and chief:
            from flownet2_tf_tpu_torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(cfg.log_dir)
        # Sample-exact resume: restart the stream at the batch the
        # interrupted run would have consumed next. Batch k+1 is staged on
        # the device while step k runs (TrainConfig.device_prefetch).
        batches = DevicePrefetcher(
            loader.batches(start_batch=state.step), self.device,
            threaded=self._threaded_prefetch, transform=self._wire)
        t_last = time.perf_counter()
        examples_since = 0
        body_error = None
        try:
            for batch, device_batch in batches:
                if state.step >= max_steps:
                    break
                metrics = self.train_step(state, device_batch, preprocess)
                step = state.step
                examples_since += batch["image_a"].shape[0]

                if step % cfg.log_every == 0 or step == max_steps:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    now = time.perf_counter()
                    metrics["examples_per_sec"] = examples_since / max(
                        now - t_last, 1e-9)
                    t_last, examples_since = now, 0
                    if chief:
                        print(json.dumps({"step": step, **{
                            k: round(v, 6) for k, v in metrics.items()}}),
                            flush=True)
                    if writer:
                        writer.scalars(metrics, step)
                        writer.flush()
                if (eval_loader is not None and cfg.eval_every
                        and step % cfg.eval_every == 0):
                    val_epe = self.evaluate(state, eval_loader)
                    if val_epe is not None and chief:
                        print(json.dumps({"step": step,
                                          "val_epe": round(val_epe, 6)}),
                              flush=True)
                        if writer:
                            writer.scalar("val_epe", val_epe, step)
                            writer.flush()
                if (writer and cfg.image_summary_every
                        and step % cfg.image_summary_every == 0):
                    self._write_image_summaries(writer, state, batch,
                                                device_batch, preprocess,
                                                step)
                if cfg.checkpoint_every and step % cfg.checkpoint_every == 0:
                    self.save(state)
                    saved_step = step
            if state.step != saved_step:
                self.save(state)
            # the newest checkpoint complete, then every process together
            self.wait_until_finished()
            mesh.barrier()
        except BaseException as e:
            body_error = e
            raise
        finally:
            batches.close()
            if body_error is not None:
                self._save_on_interrupt(state, body_error)
            if writer:
                writer.close()
        return state
