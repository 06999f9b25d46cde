"""Device staging of host batches: ``DevicePrefetcher``.

Port of ``flownet2_tf_tpu/parallel/mesh.py::DevicePrefetcher`` for one
device. The rest of that module (the data-parallel mesh, batch sharding,
replication, multi-host initialisation) maps to DDP and is not ported yet
(ROADMAP Queue 1 item 15).

On a CUDA device a worker thread stages batch k+1 while the trainer runs
step k: it pins each host array (``Tensor.pin_memory``), uploads it with
``non_blocking=True`` on a copy stream of its own and records an event
there. The consumer's stream waits on that event before it touches the
batch, and each device tensor is marked used by the consumer's stream
(``record_stream``), so the caching allocator does not hand its memory
to the copy stream again while a step still reads it. The pinned buffers
come from PyTorch's caching host allocator, which keeps a block out of
reuse until the copy that reads it has completed. Arrays keep their
dtype: uint8 images cross as uint8 and become floats on the device
(``training/loop.py::_images_to_float``). On the CPU the worker stages
plain tensors.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch


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

    def __init__(self, batches, device="cpu", depth: int = 2,
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
        tensors = {k: v if isinstance(v, torch.Tensor)
                   else torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in self._transform(host_batch).items()}
        if self._device.type != "cuda":
            return {k: t.to(self._device) for k, t in tensors.items()}, None
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
