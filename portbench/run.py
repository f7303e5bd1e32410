#!/usr/bin/env python3
"""Run one cell of the port's benchmark once on the card and print its
result as one JSON line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is ``workloads/<name>.json``. Without a CUDA card, or with fewer
cards than the cell asks for, it prints no result and exits with 2. With
``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics read from a profiler trace; in both the
numbers of the check against the plain reference, each beside its limit,
come last (``checks``), and again as the last lines of standard error.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness import catalog

    chips = int(catalog.load_json("workloads", args.workload)["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s), found "
              f"{found}; no result", file=sys.stderr)
        return 2
    from portbench.harness import runner

    result = runner.run_cell(args.workload, args.seed, args.seconds,
                             trace=bool(args.trace), device="cuda",
                             started=STARTED)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
