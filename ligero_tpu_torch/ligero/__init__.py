from .compile import CompiledInstance, calculate_t, compile_circuit
from .core import LigeroCircuit
from .proof import (InterleavedProof, LigeroProof, LinearConstraintsProof,
                    QuadraticConstraintsProof)

__all__ = ["CompiledInstance", "InterleavedProof", "LigeroCircuit",
           "LigeroProof", "LinearConstraintsProof",
           "QuadraticConstraintsProof", "calculate_t", "compile_circuit"]
