#!/usr/bin/env python3
"""Times the port's NTT, Blake2s column hash and row combination wrappers
of one source tree on the card, at the shapes of the kernel table in
PERF.md.

    python3 scripts/time_kernels.py TREE LABEL [--only ntt|blake|lc]
                                    [--reps 3] [--blocks-per-sm B ...]

TREE is the root of a checkout (this one, ``.``, or an earlier commit
unpacked with ``git archive`` into an ignored directory).  Its own
``ligero_tpu_torch`` is imported and built, so two trees timed in turns in
one call (parent, change, change, parent) compare on the same card.  Each
case is one wrapper call at one shape; it is checked against the first
call's result, then timed ``--reps`` times, each rep as the CUDA-event time
over a few back-to-back calls and the device time of the kernel alone
(torch.profiler's self device time of the kernel's launches, divided by
the calls; null where the trace dropped some of the launches).  Each NTT
case also gets the least time the card could take for its work and the
share of it the device time reaches (``chip_smoke.ntt_work`` and
``bound``, this checkout's, so that two trees share one count), and the
SM clock and power draw nvidia-smi reads while the case runs; the run
records the registers and spill ptxas gave each ``ntt.cu`` instantiation
(the tree's ``nvcc.log``).  Beside each single int32 or 16-bit row
combination, a PyTorch reduction (``amax``) over the same matrix gives
the read rate the card reaches on those bytes.  ``--blocks-per-sm`` times
the row combination once more at each given ``cuda_lc.BLOCKS_PER_SM``
(the chunking's aim; trees that chunk by this constant only).  Prints a
line ``CASE name {json}`` a case and, last, one JSON object with every
case, the card's name and power limit (nvidia-smi) and the build time.
Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

KERNEL_SYMBOLS = {"ntt": "ntt", "blake": "blake2s", "lc": "row_combine"}
#: (label, rows, w, n, inverse, canon_out, 16-bit in, 16-bit out): the
#: 2^20-gate transforms (m = 1025, k = 2048, n = 16384; zk: b = 468, d2 =
#: 8192) and the 16-bit entries on a 1024-row chunk
NTT_CASES = (("NTT_n", 4100, 2048, 16384, False, True, False, False),
             ("iNTT_k", 4100, 2048, 2048, True, False, False, False),
             ("NTT_2k", 4100, 2048, 4096, False, False, False, False),
             ("zk NTT_d2 of k + b", 4100, 2516, 8192, False, False, False,
              False),
             ("zk NTT_d2 of k", 4100, 2048, 8192, False, False, False, False),
             ("zk encode", 4103, 8192, 16384, False, True, False, False),
             ("chunk NTT_n 16 in/out", 1024, 2048, 16384, False, True, True,
              True),
             ("chunk iNTT_k 16 in/out", 1024, 2048, 2048, True, False, True,
              True),
             ("chunk NTT_2k 16 in", 1024, 2048, 4096, False, False, True,
              False),
             ("chunk zk NTT_n 16 in/out", 1024, 2516, 16384, False, True,
              True, True))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLAKE_CASES = ((1, 4100, 16384), (3, 4100, 16384), (1, 2052, 4096),
               (3, 2052, 4096))
#: (batch, rows, k, 16-bit matrix, r per column)
LC_CASES = ((1, 4100, 2048, False, False), (1, 4100, 2516, False, False),
            (1, 1024, 2048, True, False), (1, 1024, 2516, True, False),
            (3, 4100, 2048, False, False), (2, 4100, 2048, False, False),
            (3, 2052, 1024, False, False), (2, 2052, 1492, False, False),
            (1, 4100, 2048, False, True), (1, 8196, 4096, False, False))
STREAM_CHUNK = 1024


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree")
    ap.add_argument("label")
    ap.add_argument("--only", choices=("ntt", "blake", "lc"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--blocks-per-sm", type=int, nargs="*", default=[])
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    sys.modules["jax"] = None
    sys.modules["ligero_tpu"] = None
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ligero_tpu_torch.engine import (cuda_build, cuda_hash, cuda_lc,
                                         cuda_ntt, fieldops)
    from ligero_tpu_torch.fields import BLS12_377_FQ, BN254_FR
    sys.path.insert(0, REPO)
    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: needs a CUDA device")
    t0 = time.perf_counter()
    cuda_build.library()
    out = {"label": args.label, "tree": os.path.abspath(args.tree),
           "build_s": time.perf_counter() - t0,
           "smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip(), "cases": {}}
    if args.only in (None, "ntt"):
        with open(cuda_build.LOG_PATH) as f:
            out["ptxas_ntt"] = chip_smoke.ptxas_lines(
                f.read(), ("ntt_pass_kernel", "ntt_stage_kernel"))
        for line in out["ptxas_ntt"]:
            print("PTXAS", line, flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)

    def elems(field, *shape):
        L = field.num_limbs
        x = torch.randint(0, 1 << 16, shape + (L,), generator=gen,
                          dtype=torch.int32, device="cuda")
        x[..., L - 1] %= field.p >> (16 * (L - 1))
        return x

    def timed(fn, symbol, calls):
        fn()
        torch.cuda.synchronize()
        reps = []
        for _ in range(args.reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(calls):
                fn()
            b.record()
            torch.cuda.synchronize()
            dev, count = 0.0, 0
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            for ev in prof.key_averages():
                if symbol in ev.key:
                    t = getattr(ev, "self_device_time_total", None)
                    dev += t if t is not None else ev.self_cuda_time_total
                    count += ev.count
            # a trace that dropped some of the kernel's records: None
            whole = dev > 0 and count % calls == 0
            reps.append({"event_ms": a.elapsed_time(b) / calls,
                         "device_ms": dev / 1e3 / calls if whole else None})
        return reps

    def clocked(fn):
        """Median SM clock (MHz) and power draw (W) that nvidia-smi reads
        every 100 ms while fn runs back to back for 1.5 s (the second
        half's samples: the card under the load)."""
        smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        t_end = time.perf_counter() + 1.5
        while time.perf_counter() < t_end:
            fn()
            torch.cuda.synchronize()
        smi.terminate()
        rows = [line.split(",") for line in smi.communicate()[0].splitlines()
                if line.count(",") == 1]
        rows = rows[len(rows) // 2:]
        if not rows:
            return {"sm_mhz": None, "power_w": None}
        mhz = sorted(float(r[0]) for r in rows)
        watts = sorted(float(r[1]) for r in rows)
        return {"sm_mhz": mhz[len(mhz) // 2], "power_w": watts[len(watts) // 2]}

    def record(key, reps):
        out["cases"][key] = reps
        print("CASE", key, json.dumps(reps), flush=True)

    def stream(field, u16):
        rows, n, _ = u16.shape
        hs = cuda_hash.ColumnHashStream(field, n, rows, u16.device)
        for r0 in range(0, rows, STREAM_CHUNK):
            hs.absorb(u16[r0:r0 + STREAM_CHUNK], min(STREAM_CHUNK, rows - r0))
        return hs.digests()

    for field in (BN254_FR, BLS12_377_FQ):
        f = field.name
        if args.only in (None, "ntt"):
            sym = KERNEL_SYMBOLS["ntt"]
            for label, rows, w, n, inv, canon, in16, out16 in NTT_CASES:
                x = elems(field, rows, w)
                if in16:
                    x = fieldops.narrow16(x)

                def fn():
                    return cuda_ntt.ntt(field, x, n, inv, canon, out16)
                first = fn()
                reps = timed(fn, sym, 3)
                assert torch.equal(fn(), first), label
                work = chip_smoke.ntt_work(field, rows, w, n, inv or canon,
                                           in16, out16)
                bound_ms, by = chip_smoke.bound(*work)
                load = clocked(fn)
                for rep in reps:
                    rep.update(bound_ms=bound_ms, bound_by=by, share=(
                        None if rep["device_ms"] is None
                        else bound_ms / rep["device_ms"]), **load)
                record(f"{f} ntt {label} {rows}x{w}->{n}", reps)
                del x, first
                torch.cuda.empty_cache()
        if args.only in (None, "blake"):
            sym = KERNEL_SYMBOLS["blake"]
            for B, rows, n in BLAKE_CASES:
                u = elems(field, B * rows, n)
                first = cuda_hash.blake2s_columns(field, u, B)
                record(f"{f} blake {B}x{rows}x{n}", timed(
                    lambda: cuda_hash.blake2s_columns(field, u, B), sym, 3))
                if B == 1 and n == 16384:
                    u16 = fieldops.narrow16(u)
                    assert torch.equal(stream(field, u16), first)
                    record(f"{f} stream16 {rows}x{n}/{STREAM_CHUNK}",
                           timed(lambda: stream(field, u16), sym, 3))
                    del u16
                del u, first
                torch.cuda.empty_cache()
            if field is BN254_FR:
                u16 = fieldops.narrow16(elems(field, 8196, 32768))
                record(f"{f} stream16 8196x32768/{STREAM_CHUNK}",
                       timed(lambda: stream(field, u16), sym, 3))
                del u16
                torch.cuda.empty_cache()
        if args.only in (None, "lc"):
            sym = KERNEL_SYMBOLS["lc"]
            default = getattr(cuda_lc, "BLOCKS_PER_SM", None)
            for B, rows, k, m16, percol in LC_CASES:
                mats = elems(field, B, rows, k)
                if m16:
                    mats = fieldops.narrow16(mats)
                r = elems(field, B, rows, k) if percol else elems(field, B, rows)
                if B == 1:
                    def fn():
                        return cuda_lc.row_combine(field, r[0], mats[0])
                else:
                    def fn():
                        return cuda_lc.row_combine_batch(field, r, mats)
                first = fn()
                name = (f"{f} lc {B}x{rows}x{k}{' m16' if m16 else ''}"
                        f"{' percol' if percol else ''}")
                record(name, timed(fn, sym, 10))
                if B == 1 and not percol:
                    # the same bytes read by a PyTorch reduction: the read
                    # rate the card reaches on this matrix
                    record(f"{name} read", timed(lambda: mats.amax(),
                                                 "reduce_kernel", 10))
                for bps in args.blocks_per_sm:
                    cuda_lc.BLOCKS_PER_SM = bps
                    assert torch.equal(fn(), first), (name, bps)
                    record(f"{name} bps={bps}", timed(fn, sym, 10))
                    cuda_lc.BLOCKS_PER_SM = default
                del mats, r, first
                torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
