"""The recorded digests of the JAX package's proofs that the port keeps for
machines without the JAX package (ligero_tpu_torch/testdata/
golden_proofs.json, read by chip_smoke.py on the card).

Every entry is recomputed here from the JAX package's numpy golden path, so
the file cannot go stale unnoticed, and the port's proof on the CPU must
have the same bytes.  Tolerance: none.

    python tests/test_torch_golden.py --write     # regenerate the file
"""

import hashlib
import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from ligero_tpu.circuit import ArithmeticCircuit  # noqa: E402
from ligero_tpu.engine.backend import Backend  # noqa: E402
from ligero_tpu.fields import BN254_FR, FIELDS  # noqa: E402
from ligero_tpu.ligero import LigeroCircuit as RefCircuit  # noqa: E402
from ligero_tpu.ligero.types import (  # noqa: E402
    LigeroMTPoseidonParams as RefPoseidon)
from ligero_tpu.sponge import test_sponge  # noqa: E402
from ligero_tpu.synthetic import generate_random_circuit  # noqa: E402
from ligero_tpu_torch import LigeroCircuit, convert  # noqa: E402
from ligero_tpu_torch.fields import FIELDS as PORT_FIELDS  # noqa: E402
from ligero_tpu_torch.ligero.types import LigeroMTPoseidonParams  # noqa: E402

import torch  # noqa: E402

# the suite runs in several worker processes that share the host's cores, and
# these tests run many small tensor ops: one intra-op thread each, or the
# workers' thread pools spin against each other
torch.set_num_threads(1)

PATH = os.path.join(REPO, "ligero_tpu_torch", "testdata", "golden_proofs.json")
ZK_SEED = bytes(range(32)).hex()
ZK_LAMBDA = 20   # small circuits cannot fit the blinding at lambda = 128

CASES = [
    {"name": "x^3 - 26 == 1", "circuit": "cube", "lambda": 128, "zk": False},
    {"name": "2^8 gates", "circuit": "synthetic", "gates": 256,
     "num_vars": 64, "seed": 8, "lambda": 128, "zk": False},
    {"name": "2^10 gates", "circuit": "synthetic", "gates": 1024,
     "num_vars": 64, "seed": 10, "lambda": 128, "zk": False},
    {"name": "zk 2^8 gates", "circuit": "synthetic", "gates": 256,
     "num_vars": 64, "seed": 8, "lambda": ZK_LAMBDA, "zk": True,
     "zk_seed": ZK_SEED},
    {"name": "zk 2^10 gates", "circuit": "synthetic", "gates": 1024,
     "num_vars": 64, "seed": 10, "lambda": ZK_LAMBDA, "zk": True,
     "zk_seed": ZK_SEED},
    # BLS12-377 Fq, the kernels' second field
    {"name": "BLS12-377 2^8 gates", "field": "bls12_377_fq",
     "circuit": "synthetic", "gates": 256, "num_vars": 64, "seed": 8,
     "lambda": 128, "zk": False},
    {"name": "BLS12-377 2^10 gates", "field": "bls12_377_fq",
     "circuit": "synthetic", "gates": 1024, "num_vars": 64, "seed": 10,
     "lambda": 128, "zk": False},
    {"name": "BLS12-377 zk 2^8 gates", "field": "bls12_377_fq",
     "circuit": "synthetic", "gates": 256, "num_vars": 64, "seed": 8,
     "lambda": ZK_LAMBDA, "zk": True, "zk_seed": ZK_SEED},
    {"name": "BLS12-377 zk 2^10 gates", "field": "bls12_377_fq",
     "circuit": "synthetic", "gates": 1024, "num_vars": 64, "seed": 10,
     "lambda": ZK_LAMBDA, "zk": True, "zk_seed": ZK_SEED},
    # committed with the Poseidon params (BN254 Fr only)
    {"name": "Poseidon 2^8 gates", "mt": "poseidon", "circuit": "synthetic",
     "gates": 256, "num_vars": 64, "seed": 8, "lambda": 128, "zk": False},
    {"name": "Poseidon zk 2^8 gates", "mt": "poseidon", "circuit": "synthetic",
     "gates": 256, "num_vars": 64, "seed": 8, "lambda": ZK_LAMBDA, "zk": True,
     "zk_seed": ZK_SEED},
]


def case_field(case):
    """The JAX package's field of a case (BN254 Fr where it names none)."""
    return FIELDS[case.get("field", BN254_FR.name)]


def reference_case(case):
    """(circuit, outputs, prove call) on JAX-package objects."""
    F = case_field(case)
    kw = {"zk_seed": bytes.fromhex(case["zk_seed"])} if case["zk"] else {}
    if case["circuit"] == "cube":
        c = ArithmeticCircuit(F)
        x = c.new_variable_with_label("x")
        c.add(c.pow(x, 3), c.constant(-26))
        return c, [c.last()], lambda lig, sp: lig.prove_with_labels(
            [("x", 3)], sp, **kw)
    circ, outs, vars_ = generate_random_circuit(
        F, case["gates"], num_vars=case["num_vars"], seed=case["seed"])
    return circ, outs, lambda lig, sp: lig.prove(vars_, sp, **kw)


def reference_proof_bytes(case) -> bytes:
    F = case_field(case)
    circ, outs, prove = reference_case(case)
    mt = RefPoseidon(F) if case.get("mt") == "poseidon" else None
    ref = RefCircuit(circ, outs, lambda_=case["lambda"], zk=case["zk"],
                     backend=Backend(F), mt_params=mt)
    return prove(ref, test_sponge(F)).to_bytes(F)


def load():
    with open(PATH) as f:
        return json.load(f)["proofs"]


def test_file_lists_exactly_the_cases():
    stored = [{k: v for k, v in e.items() if k not in ("length", "sha256")}
              for e in load()]
    assert stored == CASES


@pytest.mark.parametrize("index", range(len(CASES)))
def test_golden_digest_matches_jax_package_and_port(index):
    case, entry = CASES[index], load()[index]
    data = reference_proof_bytes(case)
    assert len(data) == entry["length"]
    assert hashlib.sha256(data).hexdigest() == entry["sha256"]
    circ, outs, prove = reference_case(case)
    F = case_field(case)
    mt = (LigeroMTPoseidonParams(PORT_FIELDS[F.name])
          if case.get("mt") == "poseidon" else None)
    port = LigeroCircuit(convert.circuit_from_reference(circ), outs,
                         lambda_=case["lambda"], zk=case["zk"], device="cpu",
                         mt_params=mt)
    assert prove(port, test_sponge(F)).to_bytes(PORT_FIELDS[F.name]) == data


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit(__doc__)
    import jax
    jax.config.update("jax_platforms", "cpu")
    proofs = []
    for case in CASES:
        data = reference_proof_bytes(case)
        proofs.append(dict(case, length=len(data),
                           sha256=hashlib.sha256(data).hexdigest()))
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    with open(PATH, "w") as f:
        json.dump({"about": "SHA-256 digests of LigeroProof.to_bytes of the "
                   "JAX package's numpy golden path (test sponge); "
                   "regenerate with tests/test_torch_golden.py --write",
                   "proofs": proofs}, f, indent=1)
        f.write("\n")
    print(f"wrote {len(proofs)} entries to {PATH}")
