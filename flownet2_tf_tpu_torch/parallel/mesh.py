"""The process group of data-parallel training, device staging of host
batches (``DevicePrefetcher``), and the device lists of multi-device
serving (``serving_devices``, ``scatter_gather``).

Port of ``flownet2_tf_tpu/parallel/mesh.py``. The JAX package runs one
program over a device mesh; the port runs one process per card, joined
by ``torch.distributed`` (NCCL on CUDA, gloo on the CPU), and the
trainer wraps its model in ``DistributedDataParallel``
(``training/loop.py``). What maps to what:

* ``maybe_initialize_distributed`` -> ``init_process_group`` from the
  launcher's environment: torchrun's ``RANK``/``WORLD_SIZE``/
  ``LOCAL_RANK``/``MASTER_ADDR``/``MASTER_PORT``, or the JAX package's
  manual ``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/``PROCESS_ID``, with
  an explicit timeout, so that a missing peer ends the run instead of
  holding it;
* ``jax.process_count``/``process_index`` -> :func:`process_count`,
  :func:`process_index`; :func:`shutdown_distributed` destroys the group;
* ``shard_batch`` keeps the JAX contract: under several processes the
  batch each loader yields is this process's local shard, and the global
  batch is the local batch times the process count;
* ``make_mesh``, ``batch_sharding``, ``replicated_sharding`` and
  ``replicate`` shard one process's arrays over several devices; one
  process per card has nothing to shard in training, so they have no
  counterpart there. ``mesh_for_batch``'s rule (the largest device count
  that divides the batch) stays as a plain function of counts. Serving
  in one process does span devices: :func:`serving_devices` is the
  explicit device list of an artifact's replicas or of spatial bands
  (``jax.devices()[:n]``), and :func:`visible_devices` a platform's
  whole list (``jax.devices()``).

Parity note on the data: the JAX package's ``cli train`` does not shard
the data stream per process, and neither does the port: every process's
loader yields the same batches. Each process augments its batch with
draws of its own (:func:`shard_batch`).

On a CUDA device ``DevicePrefetcher``'s worker thread stages batch k+1
while the trainer runs step k: it pins each host array
(``Tensor.pin_memory``), uploads it with ``non_blocking=True`` on a copy
stream of its own and records an event there. The consumer's stream
waits on that event before it touches the batch, and each device tensor
is marked used by the consumer's stream (``record_stream``), so the
caching allocator does not hand its memory to the copy stream again
while a step still reads it. The pinned buffers come from PyTorch's
caching host allocator, which keeps a block out of reuse until the copy
that reads it has completed. Arrays keep their dtype: uint8 images cross
as uint8 and become floats on the device
(``training/loop.py::_images_to_float``). On the CPU the worker stages
plain tensors.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import queue
import threading

import numpy as np
import torch
import torch.distributed as dist

# how long a rendezvous or a collective may wait for a peer (s)
DIST_TIMEOUT_S = 300.0

_NO_ENV = (
    "--multihost requires cluster coordination env: set RANK, WORLD_SIZE, "
    "MASTER_ADDR and MASTER_PORT (torchrun sets them; LOCAL_RANK picks the "
    "card), or COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID (the JAX "
    "package's manual names)"
)


def _launch_env():
    """(address, port, world size, rank, local rank or None) from the
    launcher's environment, or None when it names no process group."""
    env = os.environ
    if all(env.get(k) for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                 "MASTER_PORT")):
        local = env.get("LOCAL_RANK")
        return (env["MASTER_ADDR"], int(env["MASTER_PORT"]),
                int(env["WORLD_SIZE"]), int(env["RANK"]),
                int(local) if local else None)
    if all(env.get(k) for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES",
                                 "PROCESS_ID")):
        host, _, port = env["COORDINATOR_ADDRESS"].rpartition(":")
        if not host or not port.isdigit():
            raise RuntimeError(
                f"COORDINATOR_ADDRESS must be host:port, got "
                f"{env['COORDINATOR_ADDRESS']!r}")
        local = env.get("LOCAL_RANK")
        return (host, int(port), int(env["NUM_PROCESSES"]),
                int(env["PROCESS_ID"]), int(local) if local else None)
    return None


def maybe_initialize_distributed(enable: bool = False, device="cuda",
                                 backend=None,
                                 timeout_s: float = DIST_TIMEOUT_S) -> bool:
    """Join the process group the launcher's environment names; returns
    whether initialization ran (False, and nothing done, when ``enable``
    is false).

    ``backend`` defaults to NCCL when ``device`` is CUDA and gloo on the
    CPU (gloo also carries CUDA tensors, through the host). On CUDA this
    process takes ``cuda:LOCAL_RANK`` (``PROCESS_ID`` modulo the cards
    when only the JAX names are set) and binds the group to it. Without
    such an environment it raises at once, and a rendezvous or collective
    that waits on a missing peer raises after ``timeout_s``.
    """
    if not enable:
        return False
    spec = _launch_env()
    if spec is None:
        raise RuntimeError(_NO_ENV)
    addr, port, world, rank, local = spec
    cuda = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    kwargs = {}
    if cuda:
        if local is None:
            local = rank % max(1, torch.cuda.device_count())
        torch.cuda.set_device(local)
        if backend == "nccl":
            kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=float(timeout_s)),
        **kwargs)
    return True


def distributed() -> bool:
    """Whether this process is in an initialized process group."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Processes in the group (1 outside one)."""
    return dist.get_world_size() if distributed() else 1


def process_index() -> int:
    """This process's rank (0 outside a group)."""
    return dist.get_rank() if distributed() else 0


def barrier():
    """Wait for every process of the group; nothing outside one."""
    if distributed():
        dist.barrier()


def shutdown_distributed():
    """Leave the process group, if this process is in one."""
    if distributed():
        dist.destroy_process_group()


def mesh_for_batch(batch_size: int, n_devices: int) -> int:
    """The largest device count, at most ``n_devices``, that divides
    ``batch_size`` (the JAX package's mesh shrinking rule)."""
    n = max(1, int(n_devices))
    while n > 1 and batch_size % n:
        n -= 1
    return n


def visible_devices(platform) -> list:
    """Every device of ``platform`` this process sees: ``cuda:0`` ...
    ``cuda:{k-1}``, or the one CPU device (the JAX package's
    ``jax.devices()``)."""
    if torch.device(platform).type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def serving_devices(platform, n: int, devices=None, *,
                    kind: str = "data_parallel", visible=None) -> list:
    """The ``n`` devices that serve the ``n`` replicas (or bands) of an
    artifact, the counterpart of the JAX package's ``jax.devices()[:n]``.

    ``devices``: an explicit list of ``n`` devices of ``platform``, taken
    as given (repeats allowed: several replicas on one card). Else
    ``cuda:0`` ... ``cuda:{n-1}``, or ``n`` replicas on the CPU (a torch
    process has one CPU device, as the JAX package's host platform is one
    device split into virtual ones in its tests). ``kind`` names what
    needs them in the refusal; ``visible`` is the count of cards, by
    default ``torch.cuda.device_count()``. Raises ValueError when fewer
    cards are visible than asked for: no fallback to the CPU or to fewer
    replicas."""
    platform = torch.device(platform).type
    n = int(n)
    if platform == "cuda":
        k = torch.cuda.device_count() if visible is None else int(visible)
    else:
        k = n
    if devices is None:
        if platform == "cuda" and k < n:
            raise ValueError(f"artifact needs {n} devices ({kind}); only {k} "
                             "visible")
        return [torch.device(platform, i) if platform == "cuda"
                else torch.device("cpu") for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"artifact needs {n} devices ({kind}); got a list "
                         f"of {len(devices)}: {[str(d) for d in devices]}")
    other = [str(d) for d in devices if d.type != platform]
    if other:
        raise ValueError(f"devices {other} are not on the platform "
                         f"{platform} of this graph")
    if platform == "cuda":
        devices = [d if d.index is not None else torch.device("cuda", 0)
                   for d in devices]
        absent = [str(d) for d in devices if d.index >= k]
        if absent:
            raise ValueError(f"devices {absent} asked for ({kind}); only {k} "
                             "visible")
    return devices


def scatter_gather(fns, devices, inputs, out_device):
    """``fns[i]`` on the i-th of ``len(devices)`` contiguous shards of
    ``inputs`` (tensors split along the batch), each shard put on
    ``devices[i]``; every call is enqueued before any result is read
    (no host sync between them). Returns the outputs concatenated in
    order on ``out_device``: the JAX package's batch-sharded call over a
    mesh, with an explicit list of devices."""
    n = len(devices)
    per = inputs[0].shape[0] // n
    shards = [[x[i * per:(i + 1) * per].to(d, non_blocking=True)
               for x in inputs] for i, d in enumerate(devices)]
    outs = []
    for fn, d, shard in zip(fns, devices, shards):
        with (torch.cuda.device(d) if d.type == "cuda"
              else contextlib.nullcontext()):
            outs.append(fn(*shard))
    if n == 1:
        return outs[0].to(out_device)
    return torch.cat([o.to(out_device) for o in outs])


def shard_batch(batch, device):
    """This process's batch as tensors on ``device``, each in its own
    dtype. Under several processes it is the process's local shard: the
    global batch is its size times :func:`process_count`, and DDP
    averages the shards' gradients.

    Every process's loader yields the same batches, so the shards start
    equal; the trainer augments each one with draws seeded by the
    process's rank (``training/loop.py::step_seed``). The JAX step
    augments the global array with one key, which gives each process's
    slice draws of its own; a ``torch.Generator`` cannot reproduce JAX's
    draws, so the port keeps that structure (distinct draws per rank),
    not the numbers."""
    device = torch.device(device)
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(v))).to(device)
            for k, v in batch.items()}


class DevicePrefetcher:
    """Stages host batches on the device from a background thread.

    Yields ``(host_batch, device_batch)`` pairs in the source's order.
    Exceptions in the source iterator or the transfer reach the consumer
    as the errors they are. Call :meth:`close` (or exhaust it) to stop
    the worker; ``close`` joins the worker before it closes the source
    (the worker runs the source generator's frame: closing a generator
    another thread is running raises). ``threaded=False`` keeps the
    interface and stages each batch inline on the consumer's thread.
    ``transform`` maps each host batch before it is staged (the
    trainer's flow wire cast); the pair holds the untransformed one.
    """

    _DONE = object()

    def __init__(self, batches, device, depth: int = 2,
                 threaded: bool = True, transform=None):
        self._src = batches
        self._device = torch.device(device)
        self._transform = transform or (lambda batch: batch)
        self._threaded = bool(threaded)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" and self._threaded
                        else None)
        if not self._threaded:
            self._it = iter(batches)
            self._thread = None
            return
        self._q = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="device-prefetch", daemon=True)
        self._thread.start()

    def _stage(self, host_batch):
        """The transformed batch as tensors on the device, each in its own
        dtype, and on CUDA the event recorded after their uploads (pinned,
        asynchronous, on the copy stream when threaded, else on the
        current stream); None off CUDA."""
        if self._device.type != "cuda":
            return shard_batch(self._transform(host_batch),
                               self._device), None
        # staged on the host first: pinned, then uploaded on the stream
        tensors = shard_batch(self._transform(host_batch), "cpu")
        stream = self._stream or torch.cuda.current_stream(self._device)
        with torch.cuda.stream(stream):
            out = {k: (t if t.is_cuda else t.pin_memory()).to(
                self._device, non_blocking=True) for k, t in tensors.items()}
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def _run(self):
        def put(item):
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            for host_batch in self._src:
                if self._stop.is_set():
                    return
                device_batch, event = self._stage(host_batch)
                if not put((host_batch, device_batch, event)):
                    return
            put((self._DONE, None, None))
        except BaseException as e:  # forwarded to the consumer
            put((e, None, None))

    def __iter__(self):
        return self

    def __next__(self):
        if not self._threaded:
            host_batch = next(self._it)
            return host_batch, self._stage(host_batch)[0]
        while True:
            try:
                item, device_batch, event = self._q.get(timeout=0.2)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    raise StopIteration from None
        if item is self._DONE:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for t in device_batch.values():
                t.record_stream(consumer)
        return item, device_batch

    def close(self):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=10.0)
        close = getattr(self._src, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                pass
