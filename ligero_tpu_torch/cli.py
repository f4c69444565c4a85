"""Command-line interface: prove and verify circom R1CS instances from disk.

The counterpart of ``ligero_tpu/cli.py``: parse an ``.r1cs``, load or
compute a witness, prove, serialize, verify, without writing Python.

    python -m ligero_tpu_torch info   --r1cs circuit.r1cs
    python -m ligero_tpu_torch prove  --r1cs circuit.r1cs --witness w.wtns \\
                                      --out proof.bin [--zk] [--cpu]
    python -m ligero_tpu_torch prove  --r1cs c.r1cs --wasm c.wasm --input in.json
    python -m ligero_tpu_torch verify --r1cs circuit.r1cs --proof proof.bin
    python -m ligero_tpu_torch warmup --r1cs circuit.r1cs
    python -m ligero_tpu_torch serve  --port 8037

Every verb runs on the CUDA device and raises where there is none;
``--cpu`` asks for the kernels' plain PyTorch versions on the host.
Proofs are non-interactive under the deterministic Fiat-Shamir sponge (the
reference's ``test_sponge()`` Poseidon parameters), so any two parties
produce and check the same transcript; ``verify`` exits 0 on success and 1
on a rejected proof.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _field(name: str):
    from .fields import FIELDS
    try:
        return FIELDS[name]
    except KeyError:
        raise SystemExit(f"unknown field {name!r}; one of {sorted(FIELDS)}")


def _device(args):
    return "cpu" if args.cpu else None


def _build(args, field):
    """Parse the R1CS and compile it to a LigeroCircuit."""
    from .circuit.arithmetic import ArithmeticCircuit
    from .circuit.r1cs import parse_r1cs
    from .ligero import LigeroCircuit

    cs = parse_r1cs(args.r1cs, field)
    circuit, outputs = ArithmeticCircuit.from_constraint_system(cs, field)
    lig = LigeroCircuit(circuit, outputs, lambda_=args.security,
                        rate_inv=args.rate_inv, zk=args.zk,
                        device=_device(args))
    return cs, circuit, lig


def _witness(args, field) -> list[int]:
    """Load (.wtns/.json) or compute (wasm + inputs) the full witness
    vector, leading R1CS constant 1 included."""
    from .circuit.r1cs import (compute_witness_wasm, load_witness_json,
                               load_witness_wtns)
    if args.witness:
        if args.witness.endswith(".json"):
            return load_witness_json(args.witness, field)
        return load_witness_wtns(args.witness, field)
    if args.wasm and args.input:
        with open(args.input) as f:
            inputs = json.load(f)
        return compute_witness_wasm(args.wasm, inputs, field)
    raise SystemExit("need --witness FILE or --wasm FILE --input FILE")


def _shape(lig) -> dict:
    return {"m": lig.m, "k": lig.k, "n": lig.n, "t": lig.t}


def cmd_info(args) -> int:
    field = _field(args.field)
    cs, circuit, lig = _build(args, field)
    print(json.dumps({
        "r1cs": args.r1cs,
        "field": field.name,
        "device": str(lig.device),
        "constraints": cs.num_constraints,
        "wires": cs.num_instance + cs.num_witness,
        "nodes": circuit.num_nodes(),
        **_shape(lig),
        "rate": f"1/{args.rate_inv}",
        "committed_matrix": f"{lig.num_rows}x{lig.n}",
        "security_lambda": args.security,
        "zk": bool(args.zk),
    }, indent=1))
    return 0


def cmd_prove(args) -> int:
    field = _field(args.field)
    from .sponge import test_sponge
    _, _, lig = _build(args, field)
    wit = _witness(args, field)
    vars_ = list(enumerate(wit[1:], start=1))
    zk_seed = bytes.fromhex(args.zk_seed) if args.zk_seed else None
    t0 = time.time()
    proof = lig.prove(vars_, test_sponge(field), zk_seed=zk_seed)
    prove_s = time.time() - t0
    blob = proof.to_bytes(field)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(json.dumps({"proof": args.out, "bytes": len(blob),
                      "prove_s": round(prove_s, 3),
                      "device": str(lig.device), **_shape(lig)}))
    return 0


def cmd_warmup(args) -> int:
    """Build the kernel library (kept in the package's build directory, so
    later processes find it), upload the constraint matrix, and run one
    throwaway prove and verify of the instance's shapes."""
    field = _field(args.field)
    _, _, lig = _build(args, field)
    stats = lig.warmup()
    print(json.dumps({"warmed": args.r1cs, "device": str(lig.device),
                      **_shape(lig), **stats}))
    return 0


def cmd_verify(args) -> int:
    field = _field(args.field)
    from .ligero import LigeroProof
    from .sponge import test_sponge
    _, _, lig = _build(args, field)
    with open(args.proof, "rb") as f:
        blob = f.read()
    t0 = time.time()
    try:
        proof = LigeroProof.from_bytes(blob, field)
    except ValueError as e:
        print(json.dumps({"verified": False, "error": f"malformed: {e}"}))
        return 1
    ok = lig.verify(proof, test_sponge(field))
    print(json.dumps({"verified": bool(ok),
                      "verify_s": round(time.time() - t0, 3),
                      "device": str(lig.device)}))
    return 0 if ok else 1


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--field", default="bn254_fr",
                   help="scalar field (default bn254_fr, circom's field)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the host with the kernels' plain PyTorch "
                        "versions (default: the CUDA device)")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--r1cs", required=True, help="circom .r1cs binary")
    _add_device(p)
    p.add_argument("--security", type=int, default=128, metavar="LAMBDA")
    p.add_argument("--rate-inv", type=int, default=8,
                   help="RS inverse rate n/k (power of two; reference: 8)")
    p.add_argument("--zk", action="store_true",
                   help="zero-knowledge mode (blinded rows + mask rows; an "
                        "extension, the reference is non-zk)")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ligero_tpu_torch",
        description="Ligero SNARK prover/verifier on PyTorch and CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info", help="print compiled instance parameters")
    _add_common(p)

    p = sub.add_parser("prove", help="prove an R1CS instance")
    _add_common(p)
    p.add_argument("--witness", help=".wtns or witness .json")
    p.add_argument("--wasm", help="circom witness-generator .wasm")
    p.add_argument("--input", help="circom input.json (with --wasm)")
    p.add_argument("--out", default="proof.bin")
    p.add_argument("--zk-seed", metavar="HEX",
                   help="pin the zk mask RNG seed (default: fresh random)")

    p = sub.add_parser("verify", help="verify a serialized proof")
    _add_common(p)
    p.add_argument("--proof", required=True)

    p = sub.add_parser("warmup", help="build the kernels and run one "
                       "throwaway prove + verify of this instance")
    _add_common(p)

    p = sub.add_parser("serve", help="run the HTTP prover service")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8037)
    _add_device(p)

    args = ap.parse_args(argv)
    if args.cmd == "serve":
        from .server import ProverService, serve
        serve(args.host, args.port,
              ProverService(field=_field(args.field), device=_device(args)))
        return 0
    return {"info": cmd_info, "prove": cmd_prove,
            "verify": cmd_verify, "warmup": cmd_warmup}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
