"""Each driver end to end on the CPU at a tiny size, in cells that a
temporary checkout adds as new files only; faults planted under the
timed path come out as not correct."""

from __future__ import annotations

import filecmp
import json
import os

import pytest

from conftest import REPO, TINY_CELLS

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(capsys, root, cell, trace, variant=None, seed=2147483651):
    from portbench import run

    capsys.readouterr()
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.5", "--trace", str(trace)], device="cpu",
                  variant=variant, root=root)
    out = capsys.readouterr()
    return rc, out.out.strip().splitlines(), out.err.strip().splitlines()


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_a_run_ends_in_the_result_line(capsys, tiny_root, cell, trace):
    rc, out, err = _run(capsys, tiny_root, cell, trace)
    assert rc == 0, err
    result = json.loads(out[-1])
    keys = list(result)
    assert keys[:5] == RESULT_KEYS and keys[-1] == "checks"
    assert set(keys) <= set(RESULT_KEYS) | {"breakdown", "checks"}
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["device"]["platform"] == "cpu"
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    if trace:
        # on the CPU no device time: only the idle share and the test's
        # own metric can be read; a reader with nothing to read is left out
        assert set(result["metrics"]) <= {
            m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", [cell])}
        assert result["device"]["busy_s"] == 0.0
        assert result["device"]["window_s"] > 0
        assert len(result["breakdown"]["idle_gaps"]) <= 10
    else:
        want = {m["name"] for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])}
        assert set(result["metrics"]) == want
        assert all(m["value"] > 0 for m in result["metrics"].values())
    # the numbers compared are the last lines of standard error
    checks = result["checks"]
    assert err[-len(checks):] == [
        f"check {k}: {c['value']} (limit {c['limit']})"
        for k, c in checks.items()]


def test_a_new_metric_is_a_new_file(capsys, tiny_root):
    rc, out, _ = _run(capsys, tiny_root, "flownet2.tiny-f32-b1", 1)
    assert rc == 0
    assert json.loads(out[-1])["metrics"]["traced_pairs.infer"]["value"] == 2


def test_the_tiny_cells_changed_no_file(tiny_root):
    """The cells, mixes and the metric were added as new files: every
    file the repository's benchmark has is there unchanged."""
    here = os.path.join(REPO, "portbench")
    for dirpath, dirs, files in os.walk(here):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "tests")]
        for name in files:
            if name.endswith(".pyc"):
                continue
            path = os.path.join(dirpath, name)
            copy = os.path.join(tiny_root, "portbench",
                                os.path.relpath(path, here))
            assert filecmp.cmp(path, copy, shallow=False), path


@pytest.mark.parametrize("cell,fault", [
    ("flownet2.tiny-f32-b1", "altered_answer"),
    ("flownet2.tiny-bf16-b2", "altered_answer"),
    ("flownetc.tiny-train-bf16", "unchanged_state"),
    ("flownetc.tiny-train-bf16", "half_batch"),
    ("flownetc.tiny-train-f32", "unchanged_state"),
    ("flownetc.tiny-train-f32", "half_batch"),
])
def test_a_broken_timed_path_is_not_correct(capsys, tiny_root, cell, fault):
    rc, out, err = _run(capsys, tiny_root, cell, 0, variant=fault)
    assert rc == 0, err
    result = json.loads(out[-1])
    assert result["correct"] is False, result["checks"]
