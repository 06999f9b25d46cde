"""What a run loads, where it runs, and what the reference imports."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "flownet2_tf_tpu"}


def _python(code, cwd, timeout=300):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def test_a_run_loads_no_jax_and_no_jax_package(tiny_root):
    """After a whole run in a fresh process, no loaded module's top-level
    name, compared whole, is JAX's or the JAX package's (the port's own
    name begins with the JAX package's)."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {tiny_root!r})\n"
        "from portbench import run\n"
        "rc = run.main(['--workload', 'flownet2.tiny-f32-b1', '--seed', "
        "'5000000001', '--seconds', '0.3', '--trace', '0'], device='cpu', "
        f"root={tiny_root!r})\n"
        "top = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'rc': rc, 'top': top}))\n")
    proc = _python(code, tiny_root)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["rc"] == 0
    assert "flownet2_tf_tpu_torch" in out["top"]
    assert not FORBIDDEN & set(out["top"])


def test_the_reference_imports_nothing_of_the_port():
    ref_dir = os.path.join(REPO, "portbench", "reference")
    for name in os.listdir(ref_dir):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ref_dir, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & (FORBIDDEN | {"flownet2_tf_tpu_torch"}), \
                (name, tops)
    proc = _python(
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from portbench.reference import flownet\n"
        "from portbench.harness import arith\n"
        "arith.reference_flops('flownet2', 1, 64, 128)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n", REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "flownet2_tf_tpu_torch" not in proc.stdout
    assert "'jax'" not in proc.stdout


def test_no_card_no_result(capsys):
    from portbench import run

    capsys.readouterr()
    rc = run.main(["--workload", "flownet2.sintel-f32-b1", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out == ""
    assert "CUDA" in out.err


def test_bench_files_alone_give_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the files under
    ``paths`` (no port beside them) exits non-zero with no result."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "flownet2.sintel-f32-b1", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env={k: v for k, v in os.environ.items()
                          if k != "PYTHONPATH"})
    assert proc.returncode != 0
    assert proc.stdout == ""
