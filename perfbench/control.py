#!/usr/bin/env python3
"""Read a cell's check numbers for the program and for its control on
several seeds, in one process, to set the check's limits from.

    python3 perfbench/control.py --workload <cell> --seeds <n> [<n> ...] [--seconds 0.001]

Each seed builds the cell as ``run.py`` does and runs the window (by
default one pass, the whole scene); the check then reads the program's
numbers (the lower readings) and the control's: the reference put in the
program's place one precision below the configuration's (TF32 for the
float32 detector and verifier, float8 for the bf16 matcher), held by the
same rules (the upper readings). One JSON line per seed goes to standard
output; the benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1e-3)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    for seed in args.seeds:
        res = run.run_cell(bench, args.workload, seed, args.seconds, False, control=True)
        print(json.dumps({"seed": seed, "program": {k: v["value"] for k, v in res["checks"].items()},
                          "control": res["control"], "pairs_per_s": res["metrics"]["pairs_per_s"]["value"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
