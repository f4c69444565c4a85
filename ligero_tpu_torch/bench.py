"""The port's benchmark: RS-encode + Merkle-commit throughput of the
prover's compute core on one device, in field elements a second.

    python -m ligero_tpu_torch.bench [--field bn254_fr | bls12_377_fq]
                                     [--scale large | medium | small]
                                     [--device cpu]

The counterpart of the top-level ``bench.py`` (the JAX package's, which it
leaves as it is): the same metric, the same unit of work
(``parallel.make_prover_core``: iNTT_k and NTT_n of every row with the
canonical epilogue, Blake2s of every column, the SHA-256 tree, and the
combination lc = r^T preenc) at the same scales, ``LIGERO_BENCH_SCALE`` or
``--scale``: ``large`` 2048 x 512 -> 4096, ``medium`` 1024 x 256 -> 2048,
``small`` 64 x 64 -> 512 (rows 4m x k message columns -> n = 8k codeword
columns), over BN254 Fr unless ``--field`` says BLS12-377 Fq.  On the card
(the default device) the kernels of ``csrc/`` run; ``--device cpu`` runs
their plain versions.

A canary runs first and a failure exits non-zero with no number: each of
the core's outputs against a plain version on the same inputs (U on a
sample of rows against ``ntt.ntt_ref``, the Blake2s leaves of a sample of
columns against ``hashlib`` over those columns' serialisation, the host
golden of ``hashes.column_hash``, the root against ``hashops.tree_flat``
of the leaves, lc against ``cuda_lc.row_combine_ref``), and the device
``F::rand`` sampler against the host one.  The canary's call is the
warm-up (the kernels build there); then the timed calls, each on fresh
inputs made on the device beforehand, CUDA synchronised around each (CUDA
events on the card); the best of :data:`ITERS` calls gives the value.

It prints one JSON line (under 2000 characters: no attached records),
with the card's name and power limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

METRIC = "RS-encode + Merkle-commit throughput (single chip)"
#: (4m rows, k message columns); n = 8 k, as the JAX package's bench
SCALES = {"large": (2048, 512), "medium": (1024, 256), "small": (64, 64)}
#: rows of U, and columns of the leaves, held against the plain chain
CANARY_ROWS, CANARY_COLS = 16, 64
#: draws of the sampler canary (the JAX bench's count)
CANARY_DRAWS = 100_000
#: timed calls, each on fresh inputs
ITERS = 5


def card_line(device: torch.device) -> str | None:
    """``nvidia-smi``'s name and power limit of the card (None on the
    CPU)."""
    if device.type != "cuda":
        return None
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60)
        return res.stdout.strip() or f"nvidia-smi: {res.stderr.strip()}"
    except OSError as e:
        return f"nvidia-smi: {e}"


def random_inputs(field, four_m: int, k: int, gen, device):
    """(preenc (4m, k, L), r (4m, L)): random limbs below p in Montgomery
    form's range (the top limb cut under p's), made on ``device``."""
    L = field.num_limbs
    top = field.p >> (16 * (L - 1))

    def elems(shape):
        limbs = torch.randint(0, 1 << 16, tuple(shape) + (L,), generator=gen,
                              dtype=torch.int32, device=device)
        limbs[..., L - 1] = torch.remainder(limbs[..., L - 1], top)
        return limbs

    return elems((four_m, k)), elems((four_m,))


def canary(field, fn, preenc, r, k: int, n: int, device) -> dict:
    """The core's outputs against the plain versions on the same inputs;
    the device sampler against the host one.  Returns the maximum
    differences (all must be 0)."""
    from .engine import cuda_lc, hashops, ntt
    from .engine.devsampler import fr_sample
    from .sampling import rand_field_elements_limbs

    def err(got, want) -> int:
        return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())

    u, leaves, root, lc = fn(preenc, r)
    four_m = preenc.shape[0]
    rows = torch.linspace(0, four_m - 1, min(CANARY_ROWS, four_m),
                          device=device).long()
    cols = np.linspace(0, n - 1, min(CANARY_COLS, n)).astype(np.int64)
    u_plain = ntt.ntt_ref(field, ntt.ntt_ref(field, preenc.index_select(
        0, rows), k, inverse=True), n, canon_out=True)
    # a column's leaf: Blake2s of the u64 LE row count, then each element's
    # 16-bit limbs little-endian
    u_cols = u[:, torch.from_numpy(cols).to(device)].cpu().numpy()
    host_leaves = np.stack([np.frombuffer(hashlib.blake2s(
        four_m.to_bytes(8, "little") + u_cols[:, j].astype("<u2").tobytes()
    ).digest(), dtype="<u4") for j in range(len(cols))]).astype(np.int32)
    seed = bytes(range(32))
    host = torch.from_numpy(rand_field_elements_limbs(
        field, CANARY_DRAWS, seed).astype(np.int32))
    return {"u_rows": err(u.index_select(0, rows), u_plain),
            "leaves": err(leaves[torch.from_numpy(cols).to(device)].cpu(),
                          torch.from_numpy(host_leaves)),
            "root": err(root, hashops.tree_flat(leaves)[-8:]),
            "lc": err(lc, cuda_lc.row_combine_ref(field, r, preenc)),
            "sampler": err(fr_sample(field, CANARY_DRAWS, seed, device).cpu(),
                           host)}


def run(field, four_m: int, k: int, device, iters: int) -> dict:
    """The canary, then the timed calls: a dict for the JSON line
    (``canary_failed`` set where the canary found a difference)."""
    from .parallel import make_prover_core

    n = 8 * k
    fn = make_prover_core(field, four_m, k, n, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    preenc, r = random_inputs(field, four_m, k, gen, device)
    checks = canary(field, fn, preenc, r, k, n, device)
    canary_s = time.perf_counter() - t0
    if any(checks.values()):
        return {"canary_failed": checks}
    inputs = [random_inputs(field, four_m, k, gen, device)
              for _ in range(iters)]
    cuda = device.type == "cuda"
    times = []
    for preenc, r in inputs:
        if cuda:
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            torch.cuda.synchronize(device)
            start.record()
            fn(preenc, r)
            stop.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(stop) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(preenc, r)
            times.append(time.perf_counter() - t0)
    best = min(times)
    return {"value": four_m * n / best, "step_s": best,
            "median_step_s": sorted(times)[len(times) // 2],
            "canary_s": canary_s, "canary": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--field", default="bn254_fr",
                    choices=["bn254_fr", "bls12_377_fq"])
    ap.add_argument("--scale", default=os.environ.get("LIGERO_BENCH_SCALE",
                                                      "large"),
                    choices=sorted(SCALES))
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu'")
    args = ap.parse_args(argv)

    from .engine.backend import resolve_device
    from .fields import FIELDS

    field = FIELDS[args.field]
    device = resolve_device(args.device)
    four_m, k = SCALES[args.scale]
    res = run(field, four_m, k, device, ITERS)
    config = {"rows_4m": four_m, "k": k, "n": 8 * k, "scale": args.scale,
              "field": field.name, "device": str(device),
              "card": card_line(device), "torch": torch.__version__}
    if "canary_failed" in res:
        print(json.dumps({"metric": "CANARY FAILED", "config": config,
                          "canary": res["canary_failed"]}), file=sys.stderr)
        return 1
    line = json.dumps({
        "metric": METRIC, "value": round(res["value"], 1),
        "unit": "field elems/s",
        "config": {**config, "iters": ITERS,
                   "step_s": round(res["step_s"], 6),
                   "median_step_s": round(res["median_step_s"], 6),
                   "canary_s": round(res["canary_s"], 3),
                   "canary": "ok " + json.dumps(res["canary"])}})
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
