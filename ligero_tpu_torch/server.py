"""Prover service: a minimal HTTP daemon around compiled circuits.

The counterpart of ``ligero_tpu/server.py``: a long-lived process keeps the
kernel library loaded, every registered circuit compiled and its
constraint matrix on the device, so a request pays only for its own prove
or verify.

    python -m ligero_tpu_torch serve --port 8037 [--cpu]

The service runs on the CUDA device and raises at start where there is
none; ``--cpu`` (``ProverService(device="cpu")``) asks for the host.

API (JSON over HTTP, stdlib-only on both ends):

    GET  /health                -> {"status": "ok", "device", "circuits"}
    POST /circuits              {"name", "r1cs": <path>, ["zk", "rate_inv",
                                 "security"]} -> instance params
    POST /prove                 {"name", "witness": [ints] | "inputs": {...}
                                 (+ "wasm": <path>), ["zk_seed": hex]}
                                -> {"proof": hex, "prove_s": ...}
                                or {"name", "witnesses": [[ints], ...]} ->
                                {"proofs": [hex, ...]} (one batched schedule)
    POST /verify                {"name", "proof": hex} -> {"verified": bool}
                                or {"name", "proofs": [hex, ...]} ->
                                {"verified": [bool, ...]} (shared transforms)
    POST /warmup                {"name"} -> one throwaway prove + verify

Single-threaded by design: requests against one device serialize anyway,
and the Fiat-Shamir sponge is cheap host work.  Proofs are deterministic
(fixed ``test_sponge`` transcript), so the service is stateless above the
compiled-circuit registry.
"""

from __future__ import annotations

import json
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

from .engine.backend import resolve_device
from .fields import BN254_FR


class ProverService:
    """Compiled-circuit registry + prove/verify execution on one device."""

    def __init__(self, field=None, device=None):
        self.field = field or BN254_FR
        self.device = resolve_device(device)
        self._circuits: dict[str, object] = {}

    def register(self, name: str, r1cs: str, zk: bool = False,
                 rate_inv: int = 8, security: int = 128) -> dict:
        from .circuit.arithmetic import ArithmeticCircuit
        from .circuit.r1cs import parse_r1cs
        from .ligero import LigeroCircuit

        cs = parse_r1cs(r1cs, self.field)
        circuit, outputs = ArithmeticCircuit.from_constraint_system(
            cs, self.field)
        lig = LigeroCircuit(circuit, outputs, lambda_=security,
                            rate_inv=rate_inv, zk=zk, device=self.device)
        self._circuits[name] = lig
        return {"name": name, "constraints": cs.num_constraints,
                "m": lig.m, "k": lig.k, "n": lig.n, "t": lig.t, "zk": zk}

    def _get(self, name: str):
        if name not in self._circuits:
            raise KeyError(f"unknown circuit {name!r}; POST /circuits first")
        return self._circuits[name]

    def _assignment(self, witness) -> list[tuple[int, int]]:
        return [(i, int(v) % self.field.p)
                for i, v in enumerate(witness[1:], start=1)]

    def _sponge(self):
        from .sponge import test_sponge
        return test_sponge(self.field)

    def prove(self, name: str, witness=None, inputs=None, wasm=None,
              zk_seed: str | None = None) -> dict:
        lig = self._get(name)
        if witness is None:
            if inputs is None or wasm is None:
                raise ValueError("need witness, or inputs + wasm")
            from .circuit.r1cs import compute_witness_wasm
            witness = compute_witness_wasm(wasm, inputs, self.field)
        t0 = time.time()
        proof = lig.prove(self._assignment(witness), self._sponge(),
                          zk_seed=bytes.fromhex(zk_seed) if zk_seed else None)
        blob = proof.to_bytes(self.field)
        return {"proof": blob.hex(), "bytes": len(blob),
                "prove_s": round(time.time() - t0, 4)}

    def prove_batch(self, name: str, witnesses) -> dict:
        """B proofs of one circuit through ``LigeroCircuit.prove_batch``."""
        lig = self._get(name)
        assignments = [self._assignment(w) for w in witnesses]
        t0 = time.time()
        proofs = lig.prove_batch(assignments, self._sponge())
        dt = time.time() - t0
        blobs = [p.to_bytes(self.field) for p in proofs]
        return {"proofs": [b.hex() for b in blobs],
                "prove_s": round(dt, 4),
                "proofs_per_s": round(len(blobs) / dt, 3) if dt else None}

    def _parse(self, proof_hex: str):
        from .ligero import LigeroProof
        return LigeroProof.from_bytes(bytes.fromhex(proof_hex), self.field)

    def verify(self, name: str, proof_hex: str) -> dict:
        lig = self._get(name)
        t0 = time.time()
        try:
            proof = self._parse(proof_hex)
        except ValueError as e:
            return {"verified": False, "error": f"malformed: {e}"}
        ok = bool(lig.verify(proof, self._sponge()))
        return {"verified": ok, "verify_s": round(time.time() - t0, 4)}

    def verify_batch(self, name: str, proofs_hex) -> dict:
        """B verdicts through ``LigeroCircuit.verify_batch``; a malformed
        blob gets False without failing the batch."""
        lig = self._get(name)
        t0 = time.time()
        verdicts = [False] * len(proofs_hex)
        parsed = []
        for i, ph in enumerate(proofs_hex):
            try:
                parsed.append((i, self._parse(ph)))
            except ValueError:
                pass
        batch = lig.verify_batch([p for _, p in parsed], self._sponge())
        for (i, _), ok in zip(parsed, batch):
            verdicts[i] = bool(ok)
        dt = time.time() - t0
        return {"verified": verdicts, "verify_s": round(dt, 4),
                "proofs_per_s": round(len(proofs_hex) / dt, 3) if dt else None}

    def warmup(self, name: str) -> dict:
        """``LigeroCircuit.warmup`` of a registered circuit: after it the
        first real request finds the kernels built and every table made."""
        return {"warmed": name, **self._get(name).warmup()}

    def health(self) -> dict:
        return {"status": "ok", "field": self.field.name,
                "device": str(self.device),
                "circuits": sorted(self._circuits)}


def make_handler(service: ProverService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def do_GET(self):
            if self.path == "/health":
                return self._send(200, service.health())
            return self._send(404, {"error": "not found"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/circuits":
                    return self._send(200, service.register(
                        req["name"], req["r1cs"], zk=req.get("zk", False),
                        rate_inv=req.get("rate_inv", 8),
                        security=req.get("security", 128)))
                if self.path == "/prove":
                    if "witnesses" in req:
                        return self._send(200, service.prove_batch(
                            req["name"], req["witnesses"]))
                    return self._send(200, service.prove(
                        req["name"], witness=req.get("witness"),
                        inputs=req.get("inputs"), wasm=req.get("wasm"),
                        zk_seed=req.get("zk_seed")))
                if self.path == "/warmup":
                    return self._send(200, service.warmup(req["name"]))
                if self.path == "/verify":
                    if "proofs" in req:
                        return self._send(200, service.verify_batch(
                            req["name"], req["proofs"]))
                    return self._send(200, service.verify(req["name"],
                                                          req["proof"]))
                return self._send(404, {"error": "not found"})
            except (KeyError, ValueError, TypeError, FileNotFoundError) as e:
                # a request the service cannot act on: a missing or ill-typed
                # field, an unknown circuit, a malformed file
                return self._send(400, {"error": str(e)})

    return Handler


def serve(host: str = "127.0.0.1", port: int = 8037,
          service: ProverService | None = None) -> None:
    service = service or ProverService()
    httpd = HTTPServer((host, port), make_handler(service))
    print(f"ligero prover service on http://{host}:{port} "
          f"(field {service.field.name}, device {service.device})", flush=True)
    httpd.serve_forever()
