"""Run one cell of the benchmark of ``flownet2_tf_tpu_torch`` on this
machine's card and print its result as the last line of standard output.

    python3 portbench/run.py --workload flownet2.sintel-f32-b1 \\
        --seed 12345 --seconds 30 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read from a traced stretch of the window. Run from
the root of a checkout that holds ``BENCHMARK.json``, this folder and the
port. Nothing is written but the port's own build directory inside the
checkout (its CUDA library, built by the first run there) and an empty
temporary directory that a training run's ``Trainer`` is given as its
log directory and never writes to. Exits non-zero, with no result, without
a CUDA card, without the port beside this folder, or where the process
loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "flownet2_tf_tpu_torch"
# compared with the part of each loaded module's name before the first dot
FORBIDDEN = ("jax", "jaxlib", "flax", "flownet2_tf_tpu")


def forbidden_modules():
    """The loaded top-level modules that this benchmark must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _fail(msg, code=2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None, device=None, variant=None, root=ROOT):
    """Run a cell and print its result; returns the exit code.
    ``device`` None asks for the card (the benchmark's runs); the tests
    pass ``"cpu"``. ``variant``: ``"control"`` or a fault's name
    (``harness/faults.py``), for the readings and the tests. ``root``:
    the checkout that holds ``BENCHMARK.json``, ``portbench/`` and the
    port."""
    args = _parse(argv)
    if not os.path.isfile(os.path.join(root, PORT, "__init__.py")):
        return _fail(f"the port ({PORT}/) is not beside portbench/")
    if root not in sys.path:
        sys.path.insert(0, root)
    import torch

    t_torch = time.perf_counter()
    from portbench.harness import cells

    try:
        cell = cells.load_cell(root, args.workload)
    except (KeyError, FileNotFoundError) as e:
        return _fail(str(e))
    if device is None:
        if not torch.cuda.is_available():
            return _fail("torch.cuda.is_available() is False: this "
                         "benchmark runs on a CUDA card only")
        if torch.cuda.device_count() < cell.chips:
            return _fail(f"{args.workload} needs {cell.chips} cards, "
                         f"{torch.cuda.device_count()} visible")
        device = "cuda:0"
    result, notes = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             device, variant, T_PROCESS,
                             {"torch_import": t_torch - T_PROCESS,
                              "cells_and_cuda_check":
                              time.perf_counter() - t_torch})
    print(json.dumps(notes), flush=True)
    found = forbidden_modules()
    if found:
        return _fail(f"this process loaded {found}: the benchmark measures "
                     "the port alone", 3)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def run_cell(cell, seed, seconds, trace, device, variant=None,
             t_start=None, steps_before=None):
    """One run of ``cell``: ``(result line, notes)``, the notes holding
    the set-up breakdown (``steps_before``: its steps before this call),
    what the checks found and the card's power limit."""
    import time as _time

    import torch

    from portbench.harness import cells, faults, runctx
    from portbench.harness import trace as tracing

    if torch.device(device).type == "cuda" and torch.cuda.is_initialized():
        # a later run in one process (the readings) starts its own peak
        torch.cuda.reset_peak_memory_stats(torch.device(device))
    run = runctx.Run(cell, seed, seconds, trace, device, variant,
                     t_start=_time.perf_counter() if t_start is None
                     else t_start)
    for step, sec in (steps_before or {}).items():
        run.breakdown[step] = sec
    if steps_before:
        run._last = run.t_start + sum(steps_before.values())
    driver = cells.load_driver(cell.traffic["driver"], cell.bench_dir)
    fault = faults.FAULTS.get(variant)
    with fault() if fault else contextlib.nullcontext():
        out = driver.run(run)

    on_card = torch.device(device).type == "cuda"
    checks = {name: {"value": out["checks"].get(name), "limit": lim["limit"]}
              for name, lim in cell.limits["checks"].items()}
    correct = (not out["errors"] and out["failed"] == 0
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    quantities = dict(out["quantities"], setup_s=out["setup_s"])
    metrics = {}
    if trace:
        summary = out["summary"]
        for m in cell.per_layer:
            value = cells.load_reader(m["name"], cell.bench_dir)(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = quantities.get(m["name"].split(".")[0])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": bool(correct), "attempted": out["attempted"],
        "failed": out["failed"], "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": 1,
            "memory_peak_bytes": out["memory_peak_bytes"]},
    }
    if trace:
        result["device"].update(busy_s=summary["busy_s"],
                                window_s=summary["window_s"])
        result["breakdown"] = {
            "device_ops": tracing.top(summary["kernels"]),
            "idle_gaps": tracing.top(summary["gaps"])}
    result["checks"] = checks
    notes = {"setup_breakdown": run.breakdown, "info": out.get("info", {}),
             "errors": out["errors"],
             "power_limit": _power_limit() if on_card else None}
    if trace:
        notes["trace_reduce_s"] = summary["reduce_s"]
        notes["unlinked_device_ops"] = summary["unlinked"]
        notes["trace_events"] = summary["events"]
    return result, notes


def _power_limit():
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e!r}"


if __name__ == "__main__":
    sys.exit(main())
