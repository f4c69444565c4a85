"""Witness evaluation into the 4m x k pre-encoding matrix (host).

Evaluates the normalised circuit on a witness and lays out the solution
vectors x | y | z | w (x, y, z: the operands and result of every
multiplication gate; w: every non-constant node) as Montgomery limbs,
like ``LigeroCircuit._build_preenc`` of ``ligero_tpu/ligero/core.py``
(``_solution_vectors``, ``_native_cache_build``,
``_preenc_mont_limbs_native``).  The circuit evaluation is inherently
sequential host work: it runs in the g++ host kernels (``native``) when
they build, and in Python otherwise; both give the same limbs.
"""

from __future__ import annotations

import warnings

import numpy as np

from .. import native
from ..circuit.arithmetic import ADD, CONST, MUL, VAR
from .compile import CompiledInstance


def _warn_bad_outputs(bad: list[int]) -> None:
    if bad:
        warnings.warn(
            f"witness does not satisfy the circuit: output node(s) {bad[:5]} "
            "do not evaluate to 1 — the proof will fail verification",
            stacklevel=4)


class WitnessLayout:
    """Per-circuit index arrays for the native evaluation path."""

    def __init__(self, st: CompiledInstance):
        nodes = st.circuit.nodes
        nn = len(nodes)
        self.kinds = np.zeros(nn, dtype=np.uint8)
        self.lefts = np.zeros(nn, dtype=np.int64)
        self.rights = np.zeros(nn, dtype=np.int64)
        const_idx, const_vals = [], []
        for i, node in enumerate(nodes):
            if node[0] == ADD:
                self.kinds[i], self.lefts[i], self.rights[i] = 1, node[1], node[2]
            elif node[0] == MUL:
                self.kinds[i], self.lefts[i], self.rights[i] = 2, node[1], node[2]
            elif node[0] == CONST:
                const_idx.append(i)
                const_vals.append(node[1])
        self.const_idx = np.asarray(const_idx, dtype=np.int64)
        self.const_vals = native.ints_to_u64_limbs(const_vals,
                                                   st.field.num_u64_limbs)
        native.to_mont_inplace(st.field, self.const_vals)
        self.sel = np.asarray([i for i, nd in enumerate(nodes)
                               if nd[0] != CONST or i == 0], dtype=np.int64)
        sel_nodes = [nodes[i] for i in self.sel]
        self.is_mul = np.asarray([nd[0] == MUL for nd in sel_nodes], dtype=bool)
        self.mul_left = np.asarray([nd[1] if nd[0] == MUL else 0
                                    for nd in sel_nodes], dtype=np.int64)
        self.mul_right = np.asarray([nd[2] if nd[0] == MUL else 0
                                     for nd in sel_nodes], dtype=np.int64)


def _preenc_native(st: CompiledInstance, lay: WitnessLayout,
                   var_assignment) -> np.ndarray:
    field, nl = st.field, st.field.num_u64_limbs
    nodes = st.circuit.nodes
    vals = np.zeros((len(nodes), nl), dtype=np.uint64)
    have = np.zeros(len(nodes), dtype=np.uint8)
    vals[lay.const_idx] = lay.const_vals
    have[lay.const_idx] = 1
    var_idx, var_vals = [], []
    for i, v in var_assignment:
        if nodes[i][0] != VAR:
            raise ValueError("Value supplied for non-variable node")
        var_idx.append(i)
        var_vals.append(v % field.p)
    if var_idx:
        vv = native.ints_to_u64_limbs(var_vals, nl)
        native.to_mont_inplace(field, vv)
        idx = np.asarray(var_idx, dtype=np.int64)
        vals[idx] = vv
        have[idx] = 1
    native.eval_circuit_mont(field, lay.kinds, lay.lefts, lay.rights, vals, have)
    one_mont = native.ints_to_u64_limbs([field.R], nl)[0]
    _warn_bad_outputs([o for o in st.outputs
                       if not np.array_equal(vals[o], one_mont)])
    mk = st.m * st.k
    stacked = np.zeros((4 * mk, nl), dtype=np.uint64)
    x, y, z, w = (stacked[i * mk:(i + 1) * mk] for i in range(4))
    sel, is_mul = lay.sel, lay.is_mul
    w[:len(sel)] = vals[sel]
    x[:len(sel)][is_mul] = vals[lay.mul_left[is_mul]]
    y[:len(sel)][is_mul] = vals[lay.mul_right[is_mul]]
    z[:len(sel)][is_mul] = vals[sel[is_mul]]
    limbs16 = native.u64_to_u16_view(stacked, field.num_limbs)
    return limbs16.reshape(4 * st.m, st.k, field.num_limbs)


def _preenc_python(st: CompiledInstance, var_assignment) -> np.ndarray:
    circuit = st.circuit
    trace = circuit.evaluation_trace_multioutput(var_assignment, st.outputs)
    if any(v is None for v in trace):
        raise ValueError("Uninitialised node: the circuit must only contain "
                         "nodes the outputs depend on")
    _warn_bad_outputs([o for o in st.outputs if trace[o] != 1])
    x, y, z, w = [], [], [], []
    for i, (val, node) in enumerate(zip(trace, circuit.nodes)):
        if node[0] == CONST and i != 0:
            continue
        w.append(val)
        if node[0] == MUL:
            x.append(trace[node[1]])
            y.append(trace[node[2]])
            z.append(val)
        else:
            x.append(0)
            y.append(0)
            z.append(0)
    mk = st.m * st.k
    for vec in (x, y, z, w):
        vec.extend([0] * (mk - len(vec)))
    return st.field.ints_to_mont_limbs(x + y + z + w).reshape(
        4 * st.m, st.k, st.field.num_limbs)


class WitnessEvaluator:
    """Builds the (4m, k, L) Montgomery pre-encoding matrix of a witness
    (normalised-index assignment)."""

    def __init__(self, st: CompiledInstance):
        self.st = st
        self._layout: WitnessLayout | None = None

    def preenc(self, var_assignment) -> np.ndarray:
        if not native.available():
            return _preenc_python(self.st, var_assignment)
        if self._layout is None:
            self._layout = WitnessLayout(self.st)
        return _preenc_native(self.st, self._layout, var_assignment)
