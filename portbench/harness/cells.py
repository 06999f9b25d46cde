"""Finding a cell by name: ``BENCHMARK.json`` names it, and everything
that belongs to one configuration, traffic mix, cell or per-layer metric
sits in a file of its own under ``portbench/``, found by that name:

* ``configs/<config>.json``: the model, its source and its sizes;
* ``traffic/<traffic>.json``: the mix, naming its driver
  (``drivers/<driver>.py``) and that driver's parameters;
* ``limits/<config>.<traffic>.json``: the limit of each number that
  decides ``correct``, the readings it was set from, and the control;
* ``metrics/<metric>.py``: a reader, ``read(summary)``, of one per-layer
  metric from the traced stretch.

A later cell, mix or metric is new files and new entries in
``BENCHMARK.json``; no file here changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    bench_dir: str


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(root, workload):
    """The cell ``workload`` of ``root``'s ``BENCHMARK.json``, its files
    read from ``root``'s ``portbench/``. Raises ``KeyError`` for a name
    not there."""
    bench_dir = os.path.join(root, "portbench")
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"there are {[w['name'] for w in bench['workloads']]}")
    config = _json(os.path.join(bench_dir, "configs",
                                entry["config"] + ".json"))
    traffic = _json(os.path.join(bench_dir, "traffic",
                                 entry["traffic"] + ".json"))
    limits = _json(os.path.join(bench_dir, "limits", workload + ".json"))

    def here(metric):
        return workload in metric.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if here(m)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if here(m) and m["moves"] in moved]
    return Cell(workload, int(entry["chips"]), config, traffic, limits, e2e,
                per_layer, bench_dir)


def load_driver(name, bench_dir):
    return _load(os.path.join(bench_dir, "drivers", name + ".py"),
                 "portbench_driver_" + name)


def load_reader(name, bench_dir):
    """The ``read(summary)`` of per-layer metric ``name``."""
    return _load(os.path.join(bench_dir, "metrics", name + ".py"),
                 "portbench_metric_" + name.replace(".", "_")).read


def _load(path, module_name):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
