"""The benchmark's inputs: a synthetic random R1CS circuit and its witnesses.

A frozen copy of the program's ``synthetic.generate_random_circuit`` DAG
(BASELINE.json config #5): node 0 the constant 1, then the witness
variables, then gates over the nodes before them, each operand drawn from
the last ``fan_in_window`` nodes (never the constant), a multiplication
with probability ``mul_fraction``, else an addition; drawn with numpy from
the run's seed, all gates at once.  The output differs: instead of
``last + fix``, where ``fix`` is a constant worked out by evaluating the
whole DAG for one witness, the output gate adds the first and the last
variable, and each witness draws the last as one minus the first.  Any
draw then satisfies the circuit (Ligero proves every output equals 1)
without the benchmark evaluating the DAG, and every proof in a run proves
a witness of its own.  An addition, because the protocol's constraint
layout leaves a multiplication output's operand rows empty, so that a
product output never verifies.
"""

from __future__ import annotations

import random

import numpy as np

from reference.check import ADD, CONST, MUL, VAR, Circuit


def make_circuit(cfg: dict, seed: int) -> Circuit:
    """The configuration's circuit for ``seed``: ``2 ** log2_gates``
    gates in all."""
    num_vars, window = cfg["num_vars"], cfg["fan_in_window"]
    dag = (1 << cfg["log2_gates"]) - 1
    rng = np.random.default_rng([seed % 2**64, 0])
    first = 1 + num_vars
    ids = np.arange(first, first + dag, dtype=np.int64)
    lo = np.maximum(1, ids - window)
    lefts = rng.integers(lo, ids)
    rights = rng.integers(lo, ids)
    is_mul = rng.random(dag) < cfg["mul_fraction"]
    total = first + dag + 1
    kinds = np.empty(total, np.uint8)
    kinds[0], kinds[1:first] = CONST, VAR
    kinds[first:first + dag] = np.where(is_mul, MUL, ADD)
    kinds[-1] = ADD
    ops_l = np.zeros(total, np.int64)
    ops_r = np.zeros(total, np.int64)
    ops_l[first:first + dag], ops_r[first:first + dag] = lefts, rights
    ops_l[-1], ops_r[-1] = 1, num_vars
    return Circuit(kinds, ops_l, ops_r, {0: 1}, [total - 1],
                   list(range(1, first)))


def witness(p: int, circuit: Circuit, seed: int, stream: str,
            index: int) -> dict:
    """Draw ``index`` of ``stream``: {variable node: value}, every value
    from [1, p), the last variable one minus the first."""
    rnd = random.Random(f"{seed}/{stream}/{index}")
    nodes = circuit.var_nodes
    vals = {node: rnd.randrange(1, p) for node in nodes[:-1]}
    vals[nodes[-1]] = (1 - vals[nodes[0]]) % p
    return vals
