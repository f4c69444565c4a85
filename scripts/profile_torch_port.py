#!/usr/bin/env python3
"""Where the PyTorch/CUDA port's prove and verify spend their time.

    python3 scripts/profile_torch_port.py [--log2-gates 20] [--device cuda]
                                          [--zk] [--lambda 128] [--out FILE]

Builds the synthetic circuit of ``--log2-gates`` gates (seed 0), compiled
with ``zk=True`` under ``--zk`` (proofs then share one fixed ``zk_seed``;
small circuits need a reduced ``--lambda`` to fit the blinding), then for
each of prove and verify: one warm-up call, three unprofiled walls,
one call under the phase timer (CUDA synchronised at phase boundaries) and
one call under ``torch.profiler``.  From the profiled call's device events
it reports the device busy time (the union of kernel and copy intervals),
the time and launch count per kernel group, and the device idle share
against both the profiled wall and the median unprofiled wall.  The
profiler adds host time to every launch, so the share against the
profiled wall overstates idleness; the share against the unprofiled wall
pairs a busy time and a wall from different calls.  Both are printed.

Prints one JSON object (also written to ``--out``).  Neither JAX nor the
JAX package is ever imported.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# the port runs without JAX and without the JAX package: make any import fail
sys.modules["jax"] = None
sys.modules["ligero_tpu"] = None
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPEATS = 3
# every __global__ function of ligero_tpu_torch/csrc (tests/test_torch_imports.py
# holds this list against the sources)
PORT_KERNELS = ("ntt_pass_kernel", "ntt_stage_kernel", "blake2s_cols_kernel",
                "sha256_tree_kernel", "sha256_chain_probe_kernel",
                "mont_mul_kernel", "row_combine_partial", "row_combine_finish")
ZK_SEED = bytes(range(32))


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _wall(torch, device, fn) -> float:
    _sync(torch, device)
    t0 = time.perf_counter()
    fn()
    _sync(torch, device)
    return time.perf_counter() - t0


def nvidia_smi_line() -> str | None:
    """The card's name and power limit, as nvidia-smi reports them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else None


def _group(name: str) -> str:
    for kernel in PORT_KERNELS:
        if kernel in name:
            return kernel
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return name.split()[0].lower()
    return "torch ops"


def device_breakdown(prof) -> tuple[float | None, dict]:
    """(busy ms: union of device intervals, {group: [launches, ms]}) of a
    profiled call; busy is None when the trace holds no device event."""
    from torch.autograd import DeviceType

    spans, groups = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end  # microseconds
        spans.append((start, end))
        g = groups.setdefault(_group(ev.name), [0, 0.0])
        g[0] += 1
        g[1] += (end - start) / 1e3
    if not spans:
        return None, groups
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy / 1e3, {k: [v[0], round(v[1], 3)] for k, v in groups.items()}


def profile_call(torch, device, lig, fn) -> dict:
    fn()  # warm-up
    walls = [_wall(torch, device, fn) for _ in range(REPEATS)]
    lig.timer.reset()
    lig.timer.enabled = True
    fn()
    lig.timer.enabled = False
    phases = {k: round(v * 1e3, 1) for k, v in
              sorted(lig.timer.totals.items(), key=lambda kv: -kv[1])}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        wall_prof = _wall(torch, device, fn)
    busy_ms, groups = device_breakdown(prof)
    median = statistics.median(walls)

    def idle(wall_s):
        return None if busy_ms is None else 1.0 - busy_ms / (wall_s * 1e3)

    return {"walls_s": walls, "median_wall_s": median, "phases_ms": phases,
            "profiled_wall_s": wall_prof, "device_busy_ms": busy_ms,
            "idle_share_vs_profiled_wall": idle(wall_prof),
            "idle_share_vs_median_wall": idle(median),
            "device_groups": groups}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2-gates", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--zk", action="store_true")
    ap.add_argument("--lambda", dest="lambda_", type=int, default=128)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    from ligero_tpu_torch import BN254_FR, LigeroCircuit, test_sponge
    from ligero_tpu_torch.synthetic import generate_random_circuit
    from ligero_tpu_torch.utils.profiling import PhaseTimer

    field = BN254_FR
    circ, outs, vars_ = generate_random_circuit(field, 1 << args.log2_gates,
                                                seed=0)
    lig = LigeroCircuit(circ, outs, lambda_=args.lambda_, zk=args.zk,
                        device=args.device, timer=PhaseTimer())
    device = lig.device
    sponge = test_sponge(field)
    kw = {"zk_seed": ZK_SEED} if args.zk else {}

    def prove():
        return lig.prove(vars_, sponge.clone(), **kw)

    proof = prove()  # includes the one-time COO upload
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    record = {
        "log2_gates": args.log2_gates, "zk": args.zk, "m": lig.m, "k": lig.k,
        "n": lig.n, "t": lig.t, "blind_t": lig.blind_t, "d2": lig.d2,
        "device": str(device),
        "nvidia_smi": nvidia_smi_line() if device.type == "cuda" else None,
        "torch": torch.__version__,
        "prove": profile_call(torch, device, lig, prove),
        "verify": profile_call(torch, device, lig,
                               lambda: lig.verify(proof, sponge.clone())),
    }
    if device.type == "cuda":
        record["peak_device_memory_gib"] = (
            torch.cuda.max_memory_allocated(device) / 2**30)
    if not lig.verify(proof, sponge.clone()):
        print("profile_torch_port: the honest proof did not verify",
              file=sys.stderr)
        return 1
    text = json.dumps(record, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
