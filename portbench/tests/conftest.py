"""Fixtures of the benchmark's CPU tests: a checkout in a temporary
directory that holds ``BENCHMARK.json``, a copy of ``portbench/`` and the
port (a link), with tiny cells added as new files only."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# tiny versions of the cells' mixes: the drivers' parameters at CPU size
TINY_TRAFFIC = {
    "tiny-f32-b1": {"driver": "infer_closed", "dtype": "float32", "batch": 1,
                    "height": 60, "width": 120, "pool": 2, "warp_res": 1,
                    "fusion_res": 1, "bf16_interconv": False,
                    "f32_features": "highest", "warmup_requests": 1,
                    "sample_requests": 2, "trace_requests": 2,
                    "max_flow": 4.0},
    "tiny-bf16-b2": {"driver": "infer_closed", "dtype": "bfloat16",
                     "batch": 2, "height": 64, "width": 128, "pool": 4,
                     "warp_res": 2, "fusion_res": 1, "bf16_interconv": False,
                     "f32_features": "highest", "warmup_requests": 1,
                     "sample_requests": 2, "trace_requests": 1,
                     "max_flow": 4.0},
    "tiny-train-bf16": {"driver": "train_steps", "dtype": "bfloat16",
                        "batch": 2, "height": 64, "width": 128, "pool": 4,
                        "checked_steps": 3, "warmup_steps": 1,
                        "trace_steps": 1, "f32_features": "highest",
                        "max_flow": 4.0, "exposure": [0.125, 1.0]},
    "tiny-train-f32": {"driver": "train_steps", "dtype": "float32",
                       "batch": 2, "height": 64, "width": 128, "pool": 4,
                       "checked_steps": 3, "warmup_steps": 1,
                       "trace_steps": 1, "f32_features": "highest",
                       "max_flow": 4.0, "exposure": [0.125, 1.0]},
}
# each tiny cell borrows the limits file of the cell it shrinks
TINY_CELLS = {
    "flownet2.tiny-f32-b1": "flownet2.sintel-f32-b1",
    "flownet2.tiny-bf16-b2": "flownet2.sintel-bf16-b8",
    "flownetc.tiny-train-bf16": "flownetc.things-bf16-b16",
    "flownetc.tiny-train-f32": "flownetc.things-f32-b8",
}
# a per-layer metric added as a new file
NEW_METRIC = '''"""Pairs in the traced stretch (a test's new metric)."""


def read(summary):
    return float(summary["items"])
'''


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "x") as f:  # new files only
        f.write(text)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """The checkout with the tiny cells added; returns its root."""
    root = str(tmp_path_factory.mktemp("checkout"))
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(REPO, "flownet2_tf_tpu_torch"),
               os.path.join(root, "flownet2_tf_tpu_torch"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, mix in TINY_TRAFFIC.items():
        _write(os.path.join(root, "portbench", "traffic", name + ".json"),
               json.dumps(dict(mix, why="a CPU test's tiny mix")))
    for cell, like in TINY_CELLS.items():
        with open(os.path.join(REPO, "portbench", "limits",
                               like + ".json")) as f:
            limits = f.read()
        _write(os.path.join(root, "portbench", "limits", cell + ".json"),
               limits)
        config, traffic = cell.split(".", 1)
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "a CPU test's tiny cell"})
        entry = next(w for w in bench["workloads"] if w["name"] == like)
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if entry["name"] in metric.get("workloads", []):
                metric["workloads"].append(cell)
    _write(os.path.join(root, "portbench", "metrics",
                        "traced_pairs.infer.py"), NEW_METRIC)
    bench["per_layer"].append({
        "name": "traced_pairs.infer", "unit": "pairs", "better": "higher",
        "source": "program_counter", "layer": "inference entry",
        "moves": "request_ms_p95",
        "workloads": ["flownet2.tiny-f32-b1", "flownet2.tiny-bf16-b2"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return root
