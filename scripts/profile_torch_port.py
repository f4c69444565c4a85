#!/usr/bin/env python3
"""Where the PyTorch/CUDA port's prove and verify spend their time.

    python3 scripts/profile_torch_port.py [--log2-gates 20] [--device cuda]
                                          [--field bn254_fr] [--zk]
                                          [--mt default|poseidon]
                                          [--lambda 128] [--batch B]
                                          [--mesh D] [--spot] [--vs-streaming]
                                          [--out FILE]
    python3 scripts/profile_torch_port.py --malloc-ab [--out FILE]

Builds the synthetic circuit of ``--log2-gates`` gates (seed 0) over
``--field`` (BN254 Fr, or BLS12-377 Fq: the kernels' two fields), compiled
with ``zk=True`` under ``--zk`` (proofs then share one fixed ``zk_seed``;
small circuits need a reduced ``--lambda`` to fit the blinding) and
committed with ``--mt`` (the default Blake2s/SHA-256 commitment, or
``LigeroMTPoseidonParams``: BN254 Fr only), then for
each of prove and verify: one warm-up call, three walls, and one call
under the phase timer, recorded as each phase's host wall (``phases_ms``;
the timer sets no barrier, so a phase's device work is not in it) and
count (``phase_counts``) and the timer's counters (``counters``: the
bytes of every host -> device and device -> host copy by phase,
``h2d.bytes@<phase>`` and ``d2h.bytes@<phase>``).  The device's busy and
idle time, and each phase's device work, come from a trace of the
program's spans: ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds 51 --trace 1``, or ``utils.profiling.trace`` around a call.

The verifier is profiled as it runs (its r_i codewords at the opened
columns from the full NTT_n and a gather); with ``--spot``, where the spot
evaluation applies (BN254 Fr: 16-limb fields only), once more with
``engine/spot.py``'s spot evaluation in that step's place, with its own
peak device memory.  With
``--batch B`` the same measurements are taken of ``prove_batch`` over B
copies of the witness (under zk: B different seeds) and of ``verify_batch``
over the B proofs, with proofs per second beside the single calls'.  Each
call's peak device memory stands beside the port's estimate of it in the
instance's mode (``encode_mode`` and ``chunk_rows``, recorded): in direct
mode ``TorchBackend.direct_bytes`` for the provers and ``verify_bytes`` for
the verifiers; past the direct mode's reach (2^23 gates over BLS12-377,
2^24 over BN254 on an 80 GB card) ``resident_bytes`` in resident mode and
``streaming_bytes`` in streaming mode for the prover, and
``streaming_verify_bytes`` for the verifier; the resident and streaming
estimates at the instance's chunking are recorded beside them in either
mode.  The script fails where a peak exceeds its estimate.  With
``--vs-streaming``, an instance in resident mode is profiled again in
streaming mode (the same compiled instance, ``LigeroCircuit.from_compiled``
under a budget at its streaming estimate), its proof byte-equal to the
resident one.  With ``--mesh D`` the instance runs over D shards
(``parallel.ShardedBackend``; on a host with fewer cards than D a card
holds several), in the mode its estimates per physical device give, and
each physical device's peak stands beside its own estimate
(``device_bytes``, ``stream_device_bytes``).

``--malloc-ab`` runs this profile (BN254 Fr on ``--device``, the other
options at their defaults) in a subprocess at each size of
``MALLOC_AB_GATES`` (2^20 gates, direct mode; 2^24, resident mode), in
turns with ``LIGERO_MALLOC_TUNE=0`` and without it (off, on, on, off: the
import-time malloc tuning of ``ligero_tpu_torch``), and prints each run's
``witness+preenc`` (the timed call's), its prove and verify walls, and
the host's resident memory: the process's peak (``ru_maxrss``) and what
it holds after the last verify.

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


def profile_call(torch, devices, lig, fn) -> dict:
    """``devices``: the physical devices of the instance (the first one's
    synchronisation brackets the walls; every one's peak is read)."""
    device = devices[0]
    fn()  # warm-up
    if device.type == "cuda":
        for dev in devices:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
    walls = [_wall(torch, device, fn) for _ in range(REPEATS)]
    lig.timer.reset()
    lig.timer.enabled = True
    fn()
    lig.timer.enabled = False
    phases = {k: round(v * 1e3, 1) for k, v in
              sorted(lig.timer.totals.items(), key=lambda kv: -kv[1])}
    counts = {k: lig.timer.counts[k] for k in phases}
    peaks = ({str(dev): torch.cuda.max_memory_allocated(dev) / 2**30
              for dev in devices} if device.type == "cuda" else None)
    return {"walls_s": walls, "median_wall_s": statistics.median(walls),
            "phases_ms": phases, "phase_counts": counts,
            "counters": dict(sorted(lig.timer.counters.items())),
            "peak_device_memory_gib": max(peaks.values()) if peaks else None,
            "peaks_gib": peaks}


#: the import-time malloc tuning's A/B: off, on, on, off, at 2^20 and 2^24
#: gates
MALLOC_TURNS = ("0", "1", "1", "0")
MALLOC_AB_GATES = (20, 24)


def host_rss_gib() -> dict:
    """This process's resident host memory: its peak and its present size."""
    import resource
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return {"peak": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
            "now": pages * os.sysconf("SC_PAGE_SIZE") / 2**30}


def malloc_ab(device: str, out) -> int:
    """``--malloc-ab``: the profile of each size in subprocesses, with and
    without the import-time malloc tuning, in turns; one JSON record of
    every run (also written to ``out``)."""
    runs = []
    for log2 in MALLOC_AB_GATES:
        for i, tune in enumerate(MALLOC_TURNS):
            env = dict(os.environ)
            env.pop("LIGERO_MALLOC_TUNE", None)
            if tune == "0":
                env["LIGERO_MALLOC_TUNE"] = "0"
            path = f"{out or 'profile'}.malloc{tune}.2e{log2}.{i}.json"
            cmd = [sys.executable, os.path.abspath(__file__), "--log2-gates",
                   str(log2), "--device", device, "--out", path]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, env=env, stdout=subprocess.DEVNULL,
                                 stderr=subprocess.PIPE, text=True)
            if res.returncode != 0:
                print(f"profile_torch_port: the 2^{log2} run with "
                      f"LIGERO_MALLOC_TUNE={tune} failed:\n"
                      f"{res.stderr[-3000:]}", file=sys.stderr)
                return 1
            with open(path) as f:
                rec = json.load(f)
            if rec["malloc_tuned"] != (tune == "1"):
                print(f"profile_torch_port: LIGERO_MALLOC_TUNE={tune} but "
                      f"malloc_tuned is {rec['malloc_tuned']}",
                      file=sys.stderr)
                return 1
            run = {"log2_gates": log2, "malloc_tune": tune == "1",
                   "process_s": time.perf_counter() - t0,
                   "nvidia_smi": rec["nvidia_smi"],
                   "witness_preenc_ms": rec["prove"]["phases_ms"].get(
                       "witness+preenc"),
                   "prove_walls_s": rec["prove"]["walls_s"],
                   "prove_median_s": rec["prove"]["median_wall_s"],
                   "verify_walls_s": rec["verify"]["walls_s"],
                   "verify_median_s": rec["verify"]["median_wall_s"],
                   "host_rss_gib": rec["host_rss_gib"]}
            print(f"2^{log2} malloc tuning {'on ' if run['malloc_tune'] else 'off'}"
                  f": witness+preenc {run['witness_preenc_ms']} ms, prove "
                  f"walls {run['prove_walls_s']}, verify walls "
                  f"{run['verify_walls_s']}, host RSS peak "
                  f"{run['host_rss_gib']['peak']:.3f} GiB, after verify "
                  f"{run['host_rss_gib']['now']:.3f} GiB", flush=True)
            runs.append(run)
    text = json.dumps({"malloc_ab": runs}, indent=1)
    if out:
        with open(out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2-gates", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--field", default="bn254_fr",
                    choices=["bn254_fr", "bls12_377_fq"])
    ap.add_argument("--zk", action="store_true")
    ap.add_argument("--mt", default="default", choices=["default", "poseidon"])
    ap.add_argument("--spot", action="store_true",
                    help="also profile the verify with the spot evaluation")
    ap.add_argument("--lambda", dest="lambda_", type=int, default=128)
    ap.add_argument("--batch", type=int, default=0,
                    help="also profile prove_batch and verify_batch of B")
    ap.add_argument("--mesh", type=int, default=0,
                    help="run over a mesh of D shards of the device(s)")
    ap.add_argument("--vs-streaming", action="store_true",
                    help="in resident mode, profile streaming mode too")
    ap.add_argument("--malloc-ab", action="store_true",
                    help="profile with and without the malloc tuning")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.malloc_ab:
        return malloc_ab(args.device, args.out)

    import torch

    from ligero_tpu_torch import FIELDS, LigeroCircuit, native, test_sponge
    from ligero_tpu_torch.engine import spot
    from ligero_tpu_torch.engine.backend import TorchBackend
    from ligero_tpu_torch.ligero.types import LigeroMTPoseidonParams
    from ligero_tpu_torch.parallel import ShardedBackend
    from ligero_tpu_torch.synthetic import generate_random_circuit
    from ligero_tpu_torch.utils.profiling import PhaseTimer

    field = FIELDS[args.field]
    circ, outs, vars_ = generate_random_circuit(field, 1 << args.log2_gates,
                                                seed=0)
    mt = LigeroMTPoseidonParams(field) if args.mt == "poseidon" else None
    place = {"device": args.device}
    if args.mesh:
        cards = (torch.cuda.device_count() if args.device.startswith("cuda")
                 else 0)
        place = {"backend": ShardedBackend(field, [
            f"cuda:{i % cards}" if cards else args.device
            for i in range(args.mesh)])}
    lig = LigeroCircuit(circ, outs, lambda_=args.lambda_, zk=args.zk,
                        timer=PhaseTimer(), mt_params=mt, **place)
    device = lig.device
    devices = lig.backend.mesh.physical if args.mesh else [device]
    sponge = test_sponge(field)
    kw = {"zk_seed": ZK_SEED} if args.zk else {}

    def prove():
        return lig.prove(vars_, sponge.clone(), **kw)

    proof = prove()  # includes the one-time COO upload
    dims = (lig.num_rows, lig.k, lig.n, len(lig.state.a_vals), lig.blind_t,
            lig.d2)

    be = lig.backend

    def estimates(batch=1):
        """The mode's estimates of the prover's and the verifier's live
        sets for ``batch`` proofs (streaming mode proves one at a time and
        verifies in parts of ``max_verify_batch``), beside direct mode's."""
        out = {"direct_bytes_gib": be.direct_bytes(*dims, batch=batch) / 2**30,
               "verify_bytes_gib": be.verify_bytes(*dims[:4],
                                                   batch=batch) / 2**30}
        if lig.chunk_rows and not args.mesh:
            for mode in ("resident", "streaming"):
                out[f"{mode}_bytes_gib"] = getattr(be, f"{mode}_bytes")(
                    *dims, chunk_rows=lig.chunk_rows,
                    poseidon=args.mt == "poseidon") / 2**30
        if args.mesh:
            streaming = lig.encode_mode == "streaming"
            part = min(batch, max(1, be.max_verify_batch(*dims[:4],
                                                         lig.chunk_rows)))
            prover = (be.stream_device_bytes(*dims, chunk_rows=lig.chunk_rows)
                      if streaming else be.device_bytes(*dims, batch=batch))
            verifier = (be.stream_device_bytes(
                *dims[:4], chunk_rows=lig.chunk_rows, verifier=True,
                batch=part) if streaming
                else be.device_bytes(*dims[:4], verifier=True, batch=batch))
            out["prover_estimates_gib"] = {d: v / 2**30
                                           for d, v in prover.items()}
            out["verifier_estimates_gib"] = {d: v / 2**30
                                             for d, v in verifier.items()}
            out["prover_estimate_gib"] = max(prover.values()) / 2**30
            out["verifier_estimate_gib"] = max(verifier.values()) / 2**30
        elif lig.encode_mode in ("resident", "streaming"):
            part = min(batch, max(1, be.max_verify_batch(*dims[:4],
                                                         lig.chunk_rows)))
            # the mode's own estimate: under the Poseidon commitment the
            # sponge states stand beside a chunk's codewords
            out["prover_estimate_gib"] = out[
                f"{lig.encode_mode}_bytes_gib"]
            out["verifier_estimate_gib"] = be.streaming_verify_bytes(
                *dims[:4], lig.chunk_rows, part) / 2**30
        else:
            out["prover_estimate_gib"] = out["direct_bytes_gib"]
            out["verifier_estimate_gib"] = out["verify_bytes_gib"]
        return out

    record = {
        "field": field.name, "log2_gates": args.log2_gates, "zk": args.zk,
        "mt": args.mt, "encode_mode": lig.encode_mode,
        "chunk_rows": lig.chunk_rows, **estimates(),
        "mesh": ([str(d) for d in be.mesh.devices] if args.mesh else None),
        "m": lig.m, "k": lig.k,
        "n": lig.n, "t": lig.t, "blind_t": lig.blind_t, "d2": lig.d2,
        "device": str(device),
        "nvidia_smi": nvidia_smi_line() if device.type == "cuda" else None,
        "torch": torch.__version__, "malloc_tuned": native.MALLOC_TUNED,
        "prove": profile_call(torch, devices, lig, prove),
        "verify": profile_call(torch, devices, lig,
                               lambda: lig.verify(proof, sponge.clone())),
    }
    record["peak_device_memory_gib"] = (
        max(record[call]["peak_device_memory_gib"]
            for call in ("prove", "verify")) if device.type == "cuda" else None)
    record["host_rss_gib"] = host_rss_gib()
    if (args.spot and spot.spot_ok(field, lig.n)
            and lig.encode_mode == "direct"):
        # the same verify with the spot evaluation as its ntt_columns
        lig.backend.ntt_columns = lambda coeffs, n, js: spot.spot_eval(
            lig.field, lig.backend.asarray(coeffs), js, n)
        try:
            record["verify_spot_eval"] = profile_call(
                torch, devices, lig, lambda: lig.verify(proof, sponge.clone()))
        finally:
            del lig.backend.ntt_columns
    if args.batch:
        B = args.batch
        seeds = [bytes([i]) * 32 for i in range(B)] if args.zk else None
        proofs = lig.prove_batch([vars_] * B, sponge, zk_seeds=seeds)
        record["batch"] = B
        record["batch_estimates"] = estimates(B)
        record["prove_batch"] = profile_call(
            torch, devices, lig,
            lambda: lig.prove_batch([vars_] * B, sponge, zk_seeds=seeds))
        record["verify_batch"] = profile_call(
            torch, devices, lig, lambda: lig.verify_batch(proofs, sponge))
        for single, batched in (("prove", "prove_batch"),
                                ("verify", "verify_batch")):
            record[batched]["per_second"] = B / record[batched]["median_wall_s"]
            record[single]["per_second"] = 1 / record[single]["median_wall_s"]
        if lig.verify_batch(proofs, sponge) != [True] * B:
            print("profile_torch_port: verify_batch rejected an honest proof",
                  file=sys.stderr)
            return 1
    if not lig.verify(proof, sponge.clone()):
        print("profile_torch_port: the honest proof did not verify",
              file=sys.stderr)
        return 1
    if args.vs_streaming and lig.encode_mode == "resident":
        # the same compiled instance in streaming mode, at the same chunking
        budget = be.streaming_bytes(*dims, chunk_rows=lig.chunk_rows,
                                    poseidon=args.mt == "poseidon")
        card = TorchBackend.memory_budget
        TorchBackend.memory_budget = lambda self: budget
        try:
            lig_s = LigeroCircuit.from_compiled(lig.state, timer=PhaseTimer(),
                                                mt_params=mt, **place)
        finally:
            TorchBackend.memory_budget = card
        del lig
        if device.type == "cuda":
            torch.cuda.empty_cache()
        lig = lig_s
        record["streaming"] = {
            "encode_mode": lig.encode_mode, "chunk_rows": lig.chunk_rows,
            "prover_estimate_gib": budget / 2**30,
            "verifier_estimate_gib": record["verifier_estimate_gib"],
            "prove": profile_call(torch, devices, lig, prove),
            "verify": profile_call(torch, devices, lig,
                                   lambda: lig.verify(proof, sponge.clone()))}
        if prove().to_bytes(field) != proof.to_bytes(field):
            print("profile_torch_port: the streaming proof differs from the "
                  "resident one", file=sys.stderr)
            return 1
    # the mode and its estimates beside the prove's peak, on stderr
    print(f"profile_torch_port: {record['encode_mode']} mode, chunks of "
          f"{record['chunk_rows']} rows; prove peak "
          f"{record['prove']['peak_device_memory_gib']} GiB, prover estimate "
          f"{record['prover_estimate_gib']} GiB (resident_bytes "
          f"{record.get('resident_bytes_gib')}, streaming_bytes "
          f"{record.get('streaming_bytes_gib')})", file=sys.stderr)
    text = json.dumps(record, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    if device.type == "cuda":
        # each call's peak against the estimate of its live set (a mesh:
        # each physical device's against its own)
        for call, key, est in (
                ("prove", "prover_estimate", record),
                ("verify", "verifier_estimate", record),
                ("prove_batch", "prover_estimate",
                 record.get("batch_estimates")),
                ("verify_batch", "verifier_estimate",
                 record.get("batch_estimates"))):
            if call not in record:
                continue
            if call in ("prove", "verify") and "streaming" in record:
                stream = record["streaming"]
                for dev, peak in stream[call]["peaks_gib"].items():
                    if peak > stream[key + "_gib"]:
                        print(f"profile_torch_port: the streaming {call} peak "
                              f"on {dev}, {peak:.2f} GiB, exceeds the "
                              f"estimate {stream[key + '_gib']:.2f} GiB",
                              file=sys.stderr)
                        return 1
            for dev, peak in record[call]["peaks_gib"].items():
                limit = (est[key + "s_gib"][dev] if args.mesh
                         else est[key + "_gib"])
                if peak > limit:
                    print(f"profile_torch_port: the {call} peak on {dev}, "
                          f"{peak:.2f} GiB, exceeds the estimate "
                          f"{limit:.2f} GiB", file=sys.stderr)
                    return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
