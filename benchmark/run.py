"""Run one cell of the benchmark of ``ligero_tpu_torch`` once.

    python3 benchmark/run.py --workload bn254-2p20.single --seed 7 \
        --seconds 10 --trace 0

From the root of a checkout, on a machine with the cards the cell asks
for.  Set-up (imports, CUDA, the kernel library, the circuit made from the
seed and compiled, one warm round) is timed as ``setup_s``; then the cell's
client proves and verifies fresh witnesses for ``--seconds``; then the
checks (every verdict, a tampered proof, a sample of proofs against the
plain reference in ``benchmark/reference``).  The last line of standard
output is the result's JSON object: the end-to-end metrics with
``--trace 0``, the per-layer ones (read from ``torch.profiler`` and the
program's phase timer) with ``--trace 1``.  The compared numbers, each
beside its limit, are also the last lines of standard error.  Exits 1,
printing no result, without enough cards or where a module of JAX or of
the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for path in (HERE, ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)
    import torch

    from harness.cell import Cell, blocked_modules, run_cell

    chips = int(Cell.find(ROOT, args.workload).workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    out, checks = run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), T_START)
    found = blocked_modules()
    if found:
        print(f"run.py: modules of JAX or the JAX package were loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        return 1
    for name, value, limit in checks:
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
