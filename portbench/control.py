#!/usr/bin/env python3
"""Readings of the numbers compared, for setting their limits: the program's
and the control's (the reference put in the program's place one precision
below the configuration's, ``harness/check.py``) on many seeds, one process.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        --seconds 3

Each seed is a whole run of the cell (set-up, a short window at the cell's
own load, the followed steps) whose capture both are judged on; one JSON
line a seed, then one line with each number's largest program reading and
smallest control reading. The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    from portbench.harness import runner

    worst, least = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        r = runner.run_cell(args.workload, seed, args.seconds, control=True)
        program = {k: c["value"] for k, c in r["checks"].items()}
        print(json.dumps({"seed": seed, "program": program,
                          "control": r["control"],
                          "correct": r["correct"]}), flush=True)
        for k, v in program.items():
            worst[k] = max(worst.get(k, 0.0), v)
        for k, v in r["control"].items():
            least[k] = min(least.get(k, float("inf")), v)
    print(json.dumps({"workload": args.workload, "program_max": worst,
                      "control_min": least}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
