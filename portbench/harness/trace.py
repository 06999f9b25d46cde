"""The traced stretch of a ``--trace 1`` run, reduced to a summary that the
per-layer readers (``portbench/metrics/*.py``) take their numbers from.

``torch.profiler`` records host ops, the program's scopes
(``models/common.py::scope``, a ``record_function`` while a profiler
runs) and the card's kernels, copies and sets. Every device activity is
tied to the host op that launched it by the profiler's correlation id:
the runtime call with the same id gives the host thread and time of
the launch, and every host op and scope open on that thread at that
time is an ancestor of the activity. That is ``tools/profiler.py::
summarize``'s attribution (a scope's time is the device time of the
kernels launched inside it), taken per launch instead of from
``key_averages()``.

The summary holds:

* ``window_s``: the traced stretch, from the opening of the harness's
  ``portbench.traced`` scope to its close, which follows a device
  synchronize; ``busy_s``: the union of device activity inside it;
* ``kernels``: device seconds per kernel name;
* ``chains``: ``{ancestor names: device seconds}``, for
  :meth:`Summary.device_s_under`;
* ``calls``: per host op or scope name, how often it was entered, a
  call nested in one of its own name not counted again;
* ``gaps``: idle device time by what the driving thread was running,
  its innermost host op (``"(between ops)"`` where it ran none).
"""

from __future__ import annotations

import collections
import time

import torch

WINDOW_SCOPE = "portbench.traced"
_DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST = ("cpu_op", "user_annotation")
_NO_OP = "(between ops)"


class Summary(dict):
    """The reduced trace (a dict) and what the driver adds to it: the
    cell's items and shapes (``items``, ``steps``, ``flops_per_item``,
    ``peak_flops``, ``corr_calls`` ...)."""

    def device_s_under(self, names):
        """Device seconds of the activity launched under any host op or
        scope in ``names``, each activity counted once."""
        names = set(names)
        return sum(s for chain, s in self["chains"].items()
                   if names.intersection(chain))


# device-side sync records, which are no work on the card
_SYNC = ("Stream Sync", "Event Sync", "Context Sync", "Stream Wait Event",
         "Device Synchronize")


def _kind(e, annotations):
    """``"host"`` (an op or a scope), ``"launch"`` (a runtime or driver
    call), ``"device"`` (a kernel, copy or set) or None, from the event's
    activity type where the profiler gives one, else from its device
    and its link to a host op."""
    if hasattr(e, "activity_type"):
        at = e.activity_type()
        at = at if isinstance(at, str) else str(at).split(".")[-1].lower()
        if at in _HOST:
            return "host"
        if at in ("cuda_runtime", "cuda_driver"):
            return "launch"
        return "device" if at in _DEVICE_WORK else None
    if str(e.device_type()).endswith("CPU"):
        return "launch" if e.linked_correlation_id() > 0 else "host"
    if e.is_user_annotation() or e.name() in annotations or \
            e.name() in _SYNC:
        return None
    return "device"


class Tracer:
    """Trace a stretch: ``with tracer: ...`` around the stretch's items.
    The stretch opens and closes with a device synchronize."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.prof = None
        self._scope = None

    def _sync(self):
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._scope = torch.profiler.record_function(WINDOW_SCOPE)
        self._scope.__enter__()
        return self

    def __exit__(self, *exc):
        self._sync()
        self._scope.__exit__(None, None, None)
        self.prof.__exit__(*exc)
        return False

    def summary(self):
        t0 = time.perf_counter()
        out = summarize(self.prof.profiler.kineto_results.events())
        out["reduce_s"] = time.perf_counter() - t0
        return out


def _ancestor_chains(host_by_tid, queries):
    """For each ``(tid, t, key)`` query, the names of the host intervals
    open on ``tid`` at ``t``, outermost first. Intervals on one thread
    nest; the sweep keeps the open ones on a stack."""
    out = {}
    by_tid = collections.defaultdict(list)
    for tid, t, key in queries:
        by_tid[tid].append((t, key))
    for tid, qs in by_tid.items():
        events = host_by_tid.get(tid, [])
        qs.sort()
        stack, i = [], 0
        for t, key in qs:
            while i < len(events) and events[i][0] <= t:
                start, end, name = events[i]
                while stack and stack[-1][1] < start:
                    stack.pop()
                stack.append((start, end, name))
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            out[key] = tuple(name for _, end, name in stack if end >= t)
    return out


def _calls(host_by_tid):
    """Entries per name, a call nested in one of its own name not
    counted again."""
    calls = collections.Counter()
    for events in host_by_tid.values():
        stack = []
        for start, end, name in events:
            while stack and stack[-1][1] < start:
                stack.pop()
            if all(n != name for _, _, n in stack):
                calls[name] += 1
            stack.append((start, end, name))
    return dict(calls)


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def summarize(events):
    """The :class:`Summary` of a profiler's raw (kineto) events."""
    events = list(events)
    annotations = {e.name() for e in events
                   if str(e.device_type()).endswith("CPU")
                   and e.is_user_annotation()}
    host = collections.defaultdict(list)
    host_at = {}  # a host op's correlation id -> (thread, start)
    launch_at = {}  # a launch's correlation id -> (thread, start)
    device = []
    window = None
    window_tid = None
    census = collections.Counter()
    for e in events:
        kind = _kind(e, annotations)
        census[str(kind)] += 1
        if kind == "host":
            start, end = e.start_ns(), e.end_ns()
            tid = e.start_thread_id()
            name = e.name()
            if name == WINDOW_SCOPE:
                window, window_tid = (start, end), tid
                continue
            host[tid].append((start, end, name))
            host_at[e.correlation_id()] = (tid, start)
        elif kind == "launch":
            launch_at[e.correlation_id()] = (e.start_thread_id(),
                                             e.start_ns())
        elif kind == "device":
            device.append((e.start_ns(), e.end_ns(), e.name(),
                           e.correlation_id(), e.linked_correlation_id()))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SCOPE} scope")
    for events_ in host.values():
        events_.sort(key=lambda x: (x[0], -x[1]))
    w0, w1 = window

    # where each activity was launched: the host op the profiler links it
    # to, else the launch call with its correlation id
    queries = []
    for i, (_, _, _, corr, linked) in enumerate(device):
        where = host_at.get(linked) if linked else None
        where = where or launch_at.get(corr)
        if where is not None:
            queries.append((where[0], where[1], i))
    chains_of = _ancestor_chains(host, queries)
    chains = collections.Counter()
    kernels = collections.Counter()
    spans = []
    for i, (s, e, name, _, _) in enumerate(device):
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        sec = (e - s) * 1e-9
        kernels[name] += sec
        chains[chains_of.get(i, ())] += sec
        spans.append((s, e))
    busy = _merge(spans)
    busy_s = sum(e - s for s, e in busy) * 1e-9

    # idle gaps inside the window, by the driving thread's innermost op
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    gap_chains = _ancestor_chains(
        host, [(window_tid, s, j) for j, (s, _) in enumerate(gaps)])
    idle = collections.Counter()
    for j, (s, e) in enumerate(gaps):
        chain = gap_chains.get(j, ())
        idle[chain[-1] if chain else _NO_OP] += (e - s) * 1e-9
    return Summary(
        window_s=(w1 - w0) * 1e-9, busy_s=busy_s, kernels=dict(kernels),
        chains=dict(chains), calls=_calls(host), gaps=dict(idle),
        unlinked=len(device) - len(queries), events=dict(census))


def top(table, n=10, width=120):
    """The ``n`` largest ``[name, seconds]`` of a table, names cut to
    ``width`` characters."""
    rows = sorted(table.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:width], sec] for name, sec in rows]

