"""Synthetic circuit/witness generators for scale testing and benchmarks.

The port's own copy of ``ligero_tpu/synthetic.py``, same names and structure;
the tests hold the two against each other on the same inputs.

Covers BASELINE.json config #5 ("synthetic 2^20-gate random R1CS"): a
random DAG of add/mul gates over random witness variables, with one final
output gate nudged to evaluate to exactly 1 (Ligero proves every output
equals 1, reference src/ligero/mod.rs:370-414).
"""

from __future__ import annotations

import random

from .circuit.arithmetic import ArithmeticCircuit
from .fields import FieldSpec


def generate_random_circuit(field: FieldSpec, num_gates: int,
                            num_vars: int = 64, seed: int = 0,
                            mul_fraction: float = 0.5):
    """Returns (circuit, outputs, var_assignment) with a valid witness."""
    rng = random.Random(seed)
    p = field.p
    c = ArithmeticCircuit(field)
    c.constant(1)
    var_indices = c.new_variables(num_vars)
    values: list = [1]
    var_assignment = []
    for idx in var_indices:
        v = rng.randrange(1, p)
        var_assignment.append((idx, v))
        values.append(v)

    # random DAG of gates over recent nodes (bounded fan-in window keeps the
    # evaluation cache-friendly without changing the protocol shape)
    window = 4096
    for _ in range(num_gates - 1):
        n = len(values)
        lo = max(1, n - window)
        a = rng.randrange(lo, n)
        b = rng.randrange(lo, n)
        if rng.random() < mul_fraction:
            c.mul(a, b)
            values.append(values[a] * values[b] % p)
        else:
            c.add(a, b)
            values.append((values[a] + values[b]) % p)

    # force the final output to 1: out = last + (1 - value(last))
    last_gate = c.last()
    fix = c.constant((1 - values[-1]) % p)
    out = c.add(last_gate, fix)
    return c, [out], var_assignment
