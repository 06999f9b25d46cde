"""Readings for the limits of ``correct``: the numbers compared, over many
seeds, for the program, its control or a fault planted in it, in one
process (set-up's imports and builds are paid once).

    python3 portbench/readings.py --workload flownet2.sintel-f32-b1 \\
        --variant control --seeds 11,12,13 --seconds 3 --out readings.jsonl

``--variant``: ``program``, ``control`` (the limits file names it) or a
fault of ``harness/faults.py``. Each seed's line (checks, ``correct``,
what the comparison found) is printed and appended to ``--out``. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--variant", default="program")
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import run
    from portbench.harness import cells

    cell = cells.load_cell(ROOT, args.workload)
    variant = None if args.variant == "program" else args.variant
    for seed in (int(s) for s in args.seeds.split(",")):
        result, notes = run.run_cell(cell, seed, args.seconds, False,
                                     "cuda:0", variant)
        line = {"workload": args.workload, "variant": args.variant,
                "seed": seed, "correct": result["correct"],
                "checks": {k: c["value"] for k, c in
                           result["checks"].items()},
                "metrics": {k: m["value"] for k, m in
                            result["metrics"].items()},
                "info": notes["info"], "errors": notes["errors"]}
        print(json.dumps(line), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
