"""Carry a compiled instance from the JAX package into the port.

Ligero has no weights; the state that can be carried across is the host
compile of a circuit.  :func:`from_reference` takes a compiled JAX-package
``LigeroCircuit`` as an object handed in by the caller, reads only plain
data from it (field name, node list, variable and constant maps, output
indices, dimensions, zk parameters and the COO arrays of A) and rebuilds
the port's own ``ArithmeticCircuit`` and :class:`CompiledInstance` from
them.  This module imports nothing of the JAX package; the tests use it
to show that the port's own compile gives the same instance.
"""

from __future__ import annotations

import numpy as np

from .circuit.arithmetic import ArithmeticCircuit
from .fields import FIELDS
from .ligero.compile import CompiledInstance


def circuit_from_reference(ref_circuit) -> ArithmeticCircuit:
    """The port's own ``ArithmeticCircuit`` with the nodes, constants and
    variables of a JAX-package one."""
    circuit = ArithmeticCircuit(FIELDS[ref_circuit.field.name])
    circuit.nodes = [tuple(node) for node in ref_circuit.nodes]
    circuit.constants = {int(v): int(i)
                         for v, i in ref_circuit.constants.items()}
    circuit.variables = {str(s): int(i)
                         for s, i in ref_circuit.variables.items()}
    return circuit


def compiled_state(ref) -> CompiledInstance:
    """Host state of a JAX-package ``LigeroCircuit`` as the port's own
    :class:`CompiledInstance`."""
    circuit = circuit_from_reference(ref.circuit)
    rows, cols, vals = ref._a_fast.to_coo()
    return CompiledInstance(
        field=circuit.field, circuit=circuit,
        outputs=[int(o) for o in ref.outputs],
        one_index=int(ref.one_index), one_found=bool(ref.one_found),
        rate_inv=int(ref.rate_inv), m=int(ref.m), k=int(ref.k), n=int(ref.n),
        t=int(ref.t), zk=bool(ref.zk), blind_t=int(ref.blind_t),
        d2=int(ref.d2), a_rows=np.asarray(rows, dtype=np.int64),
        a_cols=np.asarray(cols, dtype=np.int64),
        a_vals=[int(v) for v in vals])


def from_reference(ref, device=None):
    """A port ``LigeroCircuit`` on ``device`` for the instance that ``ref``
    (a JAX-package ``LigeroCircuit``) compiled."""
    from .ligero.core import LigeroCircuit
    return LigeroCircuit.from_compiled(compiled_state(ref), device=device)
