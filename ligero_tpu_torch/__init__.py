"""ligero-tpu on PyTorch and CUDA: the Ligero SNARK's prove -> verify path
(plain and zk) with hand-written Hopper kernels (``csrc/``).

A package of its own: it imports ``torch``, ``numpy``, the standard library
and itself, never ``jax`` and nothing of the JAX package ``ligero_tpu``.
Its host modules (fields, circuits, sponge, ChaCha, sampling, Merkle,
hashes, proofs, the g++ host-kernel bridge) are its own copies, held
against the JAX package's by the tests.

    from ligero_tpu_torch import (BN254_FR, ArithmeticCircuit, LigeroCircuit,
                                  test_sponge)
    lig = LigeroCircuit(circuit, outputs)            # on the CUDA device
    lig = LigeroCircuit(circuit, outputs, zk=True, device="cpu")
    proof = lig.prove_with_labels([("x", 3)], sponge.clone())
    assert lig.verify(proof, sponge.clone())
    proofs = lig.prove_batch(witnesses, sponge)      # B proofs, shared bulk work
    verdicts = lig.verify_batch(proofs, sponge)

``python -m ligero_tpu_torch info | prove | verify | warmup | serve`` (``cli``,
``server``) drive the same path from circom ``.r1cs`` files
(``circuit.r1cs``).
"""

from .fields import BLS12_377_FQ, BN254_FR, FIELDS, FieldSpec

__all__ = [
    "BN254_FR", "BLS12_377_FQ", "FIELDS", "FieldSpec",
    "ArithmeticCircuit", "Expression", "LigeroCircuit", "LigeroProof",
    "test_sponge",
]


def __getattr__(name):
    # lazy imports keep ``import ligero_tpu_torch`` light
    if name in ("ArithmeticCircuit", "Expression"):
        from . import circuit
        return getattr(circuit, name)
    if name in ("LigeroCircuit", "LigeroProof"):
        from . import ligero
        return getattr(ligero, name)
    if name == "test_sponge":
        from .sponge import test_sponge
        return test_sponge
    raise AttributeError(name)
