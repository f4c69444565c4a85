#!/usr/bin/env python3
"""One rank of a multi-process run of the PyTorch port: the counterpart of
``scripts/multihost_worker.py`` on ``torch.distributed``.

    python3 scripts/torch_multihost_worker.py PROCESS_ID NUM_PROCESSES PORT \
        OUT_FILE [--field bn254_fr] [--mode core,direct,streaming,zk] \
        [--device cpu | cuda:0] [--backend gloo | nccl] [--core 4M,K,N] \
        [--gates G] [--stream-gates G] [--stream-chunk ROWS] \
        [--num-vars V] [--circuit-seed S] [--warm]

Start NUM_PROCESSES of them, one a process id, on one free localhost PORT.
Each joins the process group (``parallel.multihost.initialize``), takes
the global row mesh (``global_row_mesh``, one device a rank) and runs, on
the same seeded inputs as every other rank, the runs ``--mode`` names:

* ``core`` (``core:FIELD`` in another field): the sharded prover core at
  4M x K -> N (default 16 x 16 -> 128) on random limbs from
  ``numpy.random.default_rng(42)``: its replicated root and lc;
* ``direct``: a plain proof of ``generate_random_circuit(F, G, num_vars=V,
  seed=S)`` (by default G = 300, V = 8, S = 9: the JAX worker's circuit) in
  direct mode over the mesh;
* ``streaming``: the same (with ``--stream-gates``, another size) in
  streaming mode over the mesh, forced by a memory budget at the mesh's
  streaming estimate for ``--stream-chunk``-row chunks (default: the
  largest that leaves more chunks than ranks);
* ``zk``: a zk proof of that circuit in direct mode (lambda 10: the
  300-gate circuit is too small for the blinding at 128; zk seed bytes
  0..31);
* ``batch``: ``prove_batch`` of two plain proofs of that circuit's witness
  in direct mode (each must equal the single proof), ``verify_batch``.

Every proof is verified on every rank (``--warm``: after a first prove
and verify, outside the record, which took A's upload and the tables).
OUT_FILE gets one JSON object:
the core's root and lc in hex, each proof's SHA-256, length and verdict
(its bytes in OUT_FILE.<run>.bin), each run's wall, its launches of each
kernel, the rank's peak device memory against its estimate (CUDA), and the
bytes the collectives staged through host memory.  ``--device`` is the
rank's device (default: the card of ``LOCAL_RANK``; on a host with one
card give ``cuda:0`` and ``--backend gloo``, since NCCL refuses two ranks
on one GPU).  Neither JAX nor the JAX package is imported.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZK_SEED, ZK_LAMBDA = bytes(range(32)), 10
#: proofs of the ``batch`` run
BATCH = 2
#: the kernels' launch counters, by the name the smoke's record uses
COUNTERS = (("ntt", "cuda_ntt", "launches"),
            ("mont_mul", "cuda_mont", "launches"),
            ("blake2s_cols", "cuda_hash", "launches"),
            ("row_combine", "cuda_lc", "launches"),
            ("sha256_tree", "cuda_tree", "launches"),
            ("poseidon_cols", "cuda_poseidon", "launches"),
            ("blake2s_stream", "cuda_hash", "stream_launches"),
            ("poseidon_stream", "cuda_poseidon", "stream_launches"),
            ("ntt16", "cuda_ntt", "launches16"),
            ("row_combine16", "cuda_lc", "launches16"))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("process_id", type=int)
    ap.add_argument("num_processes", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("out_file")
    ap.add_argument("--field", default="bn254_fr")
    ap.add_argument("--mode", default="core,direct,streaming,zk")
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--core", default="16,16,128")
    ap.add_argument("--gates", type=int, default=300)
    ap.add_argument("--stream-gates", type=int, default=None)
    ap.add_argument("--stream-chunk", type=int, default=0)
    ap.add_argument("--num-vars", type=int, default=8)
    ap.add_argument("--circuit-seed", type=int, default=9)
    ap.add_argument("--warm", action="store_true")
    return ap.parse_args(argv)


def counters():
    import importlib
    return {name: getattr(importlib.import_module(
        f"ligero_tpu_torch.engine.{mod}"), attr)
        for name, mod, attr in COUNTERS}


class Run:
    """One run's launch counts, wall and device peak: counts set to 0 and
    the peak reset just before, read just after."""

    def __init__(self, torch, device):
        self.torch, self.device = torch, device
        self.cuda = device.type == "cuda"

    def __enter__(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)
            self.torch.cuda.empty_cache()
            self.torch.cuda.reset_peak_memory_stats(self.device)
        for c in counters().values():
            c.reset()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)
        self.wall = time.perf_counter() - self.t0
        self.launches = {name: c.count for name, c in counters().items()}
        self.peak = (self.torch.cuda.max_memory_allocated(self.device)
                     if self.cuda else None)
        return False


def core_inputs(field, four_m: int, k: int, seed: int = 42):
    """Seeded inputs of the core, the same on every rank: random 16-bit
    limbs from ``numpy.random.default_rng(seed)``, the top limb cut under
    p's (so every element lies below p), as host arrays."""
    import numpy as np
    L = field.num_limbs
    rng = np.random.default_rng(seed)
    top = field.p >> (16 * (L - 1))
    preenc = rng.integers(0, 1 << 16, (four_m, k, L), dtype=np.uint32)
    r = rng.integers(0, 1 << 16, (four_m, L), dtype=np.uint32)
    for a in (preenc, r):
        a[..., L - 1] %= top
    return preenc, r


def forced_budget(be, state, chunk_rows: int) -> tuple[int, int]:
    """A memory budget under the mesh's direct estimate of the compiled
    instance ``state``: its streaming estimate for ``chunk_rows``-row
    chunks (0: the largest multiple of 4 rows that leaves more chunks than
    ranks)."""
    dims = (state.num_rows, state.k, state.n, len(state.a_vals),
            state.blind_t, state.d2)
    data = state.num_rows - (3 if state.zk else 0)
    cr = chunk_rows or 4 * max(1, (data // (be.D + 1)) // 4)
    budget = be.streaming_bytes(*dims, chunk_rows=cr)
    if budget >= be.direct_bytes(*dims):
        raise RuntimeError(f"streaming at {cr} rows does not lie under the "
                           "direct estimate")
    return budget, cr


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    # the ranks share the host's cores with each other (and, in the tests,
    # with the suite's workers)
    torch.set_num_threads(1)
    from ligero_tpu_torch import LigeroCircuit
    from ligero_tpu_torch.engine.backend import TorchBackend
    from ligero_tpu_torch.fields import FIELDS
    from ligero_tpu_torch.ligero.compile import (DEFAULT_SECURITY_LEVEL,
                                                 compile_circuit)
    from ligero_tpu_torch.parallel import (ShardedBackend,
                                           make_sharded_prover_core)
    from ligero_tpu_torch.parallel.multihost import (global_row_mesh,
                                                     initialize, shutdown)
    from ligero_tpu_torch.sponge import test_sponge
    from ligero_tpu_torch.synthetic import generate_random_circuit

    field = FIELDS[args.field]
    initialize(f"localhost:{args.port}", args.num_processes, args.process_id,
               backend=args.backend, device=args.device)
    mesh = global_row_mesh(args.device)
    if mesh.comm is None:
        raise SystemExit("one process and no --backend: no process group")
    dev = mesh.devices[0]
    modes = [m for m in args.mode.split(",") if m]
    out = {"rank": mesh.rank, "size": mesh.size, "device": str(dev),
           "backend": torch.distributed.get_backend(), "field": field.name,
           "runs": {}}
    comm = mesh.comm

    def record(name: str, run: Run, **extra) -> None:
        out["runs"][name] = {"wall_s": run.wall, "launches": run.launches,
                             "peak_bytes": run.peak,
                             "staged_bytes": comm.staged_bytes, **extra}
        comm.staged_bytes = 0

    for name in modes:
        if name.split(":")[0] != "core":
            continue
        cf = FIELDS[name.split(":")[1]] if ":" in name else field
        four_m, k, n = (int(v) for v in args.core.split(","))
        preenc, r = core_inputs(cf, four_m, k)
        fn = make_sharded_prover_core(cf, mesh, four_m, k, n)
        with Run(torch, dev) as run:
            u_blocks, leaves, root, lc = fn(preenc, r)
        record(name, run, shape=[four_m, k, n], field=cf.name,
               root=root.cpu().numpy().view(np.uint32).astype(">u4")
               .tobytes().hex(),
               lc=lc.cpu().numpy().view(np.uint32).astype("<u4")
               .tobytes().hex(),
               block_rows=int(u_blocks[0].shape[0]),
               leaf_rows=int(leaves[0].shape[0]))
        del u_blocks, leaves, fn

    sponge = test_sponge(field)
    for name in (m for m in modes if m.split(":")[0] != "core"):
        gates = (args.stream_gates or args.gates if name == "streaming"
                 else args.gates)
        zk, batch = name == "zk", BATCH if name == "batch" else 1
        circ, outs, vars_ = generate_random_circuit(
            field, gates, num_vars=args.num_vars, seed=args.circuit_seed)
        state = compile_circuit(circ, outs, ZK_LAMBDA if zk
                                else DEFAULT_SECURITY_LEVEL, zk=zk)
        be = ShardedBackend(field, mesh)
        extra = {"gates": gates}
        if name == "streaming":
            budget, _ = forced_budget(be, state, args.stream_chunk)
            card = TorchBackend.memory_budget
            TorchBackend.memory_budget = lambda self: budget
            try:
                lig = LigeroCircuit.from_compiled(state, backend=be)
            finally:
                TorchBackend.memory_budget = card
            extra["chunk_rows"] = lig.chunk_rows
        else:
            lig = LigeroCircuit.from_compiled(state, backend=be)
        if lig.encode_mode != ("streaming" if name == "streaming"
                               else "direct"):
            raise RuntimeError(f"{name}: {lig.encode_mode} mode")
        dims = (lig.num_rows, lig.k, lig.n, len(lig.state.a_vals),
                lig.blind_t, lig.d2)
        if lig.encode_mode == "streaming":
            est = be.stream_device_bytes(*dims, chunk_rows=lig.chunk_rows)
            vest = be.stream_device_bytes(*dims[:4],
                                          chunk_rows=lig.chunk_rows,
                                          verifier=True)
        else:
            est = be.device_bytes(*dims, batch=batch)
            vest = be.device_bytes(*dims[:4], verifier=True, batch=batch)
        prove_kw = {"zk_seed": ZK_SEED} if zk else {}
        if args.warm:                   # A's upload, the tables
            lig.verify(lig.prove(vars_, sponge.clone(), **prove_kw),
                       sponge.clone())
        comm.staged_bytes = 0
        with Run(torch, dev) as run:
            proofs = (lig.prove_batch([vars_] * batch, sponge) if batch > 1
                      else [lig.prove(vars_, sponge.clone(), **prove_kw)])
        data = {p.to_bytes(field) for p in proofs}
        if len(data) != 1:
            raise RuntimeError(f"{name}: the batch's proofs differ")
        data = data.pop()
        with open(f"{args.out_file}.{name}.bin", "wb") as f:
            f.write(data)
        record(name, run, sha256=hashlib.sha256(data).hexdigest(),
               bytes=len(data), estimate_bytes=est[str(dev)],
               mode=lig.encode_mode, proofs=batch, **extra)
        with Run(torch, dev) as vrun:
            ok = all(lig.verify_batch(proofs, sponge) if batch > 1
                     else [lig.verify(proofs[0], sponge.clone())])
        out["runs"][name].update(
            verified=bool(ok), verify_wall_s=vrun.wall,
            verify_peak_bytes=vrun.peak, verify_estimate_bytes=vest[str(dev)],
            verify_launches=vrun.launches,
            verify_staged_bytes=comm.staged_bytes)
        comm.staged_bytes = 0
        del lig, be, proofs, state
    with open(args.out_file, "w") as f:
        json.dump(out, f)
    torch.distributed.barrier()
    shutdown()
    print(f"rank {mesh.rank}: ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
