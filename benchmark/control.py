"""The control of the benchmark's comparison, on the card.

    python3 benchmark/control.py --workload bn254-2p20.single \
        --seeds 11 12 13 --seconds 3 [--lambda 127]

Runs the cell once a seed, in one process, with the program at the
soundness level ``--lambda`` in place of the configuration's (127: one
column fewer an opening, the step below the configuration's guarantee),
and prints a line a seed: the compared numbers, each beside its limit,
and ``correct``, which has to come out false.  ``--lambda`` equal to the
configuration's gives the sound readings the same way.  The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--lambda", dest="lambda_", type=int, default=127)
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    from harness.cell import run_cell

    for seed in args.seeds:
        out, checks = run_cell(ROOT, args.workload, seed, args.seconds, False,
                               time.perf_counter(), lambda_=args.lambda_)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "lambda": args.lambda_, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": {n: v for n, v, _ in checks}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
