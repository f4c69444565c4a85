"""Arithmetic-circuit IR: flat DAG of constant/variable/add/mul nodes.

The port's own copy of ``ligero_tpu/circuit/arithmetic.py``, same names and structure;
the tests hold the two against each other on the same inputs.

Functional equivalent of the reference IR
(reference src/arithmetic_circuit/mod.rs:11-520), re-designed for a
Python host:

* nodes are plain tuples in an append-only list —
  ``("const", v) | ("var", label) | ("add", l, r) | ("mul", l, r)``;
* evaluation is an **iterative** explicit-stack walk (the reference's
  recursive ``inner_evaluate``, mod.rs:247-271, stack-overflows on deep
  circuits — a real cost at 2^20 gates);
* constants are de-duplicated through a value->index map exactly like the
  reference constructor (mod.rs:76-84), because constant identity determines
  node numbering and therefore the whole Ligero matrix layout.

Observed reference quirks preserved deliberately:

* ``pow(node, 0)`` returns the base, not 1 (mod.rs:164-200: the zero
  exponent yields an empty bit list and ``pow_binary`` returns ``node``);
* duplicate variable assignments: the last one wins (mod.rs:293-301);
* ``evaluate_multioutput`` returns values in node-index order and
  collapses duplicated output indices (mod.rs:381-387).
"""

from __future__ import annotations

from ..fields import FieldSpec

CONST = "const"
VAR = "var"
ADD = "add"
MUL = "mul"


class ArithmeticCircuit:
    def __init__(self, field: FieldSpec):
        self.field = field
        self.nodes: list[tuple] = []
        self.constants: dict[int, int] = {}   # value -> node index
        self.variables: dict[str, int] = {}   # label -> node index

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def num_nodes(self) -> int:
        return len(self.nodes)

    def num_constants(self) -> int:
        return len(self.constants)

    def num_variables(self) -> int:
        return len(self.variables)

    def num_gates(self) -> int:
        return sum(1 for n in self.nodes if n[0] in (ADD, MUL))

    def last(self) -> int:
        return len(self.nodes) - 1

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def _push(self, node: tuple) -> int:
        self.nodes.append(node)
        return len(self.nodes) - 1

    def constant(self, value: int) -> int:
        value %= self.field.p
        idx = self.constants.get(value)
        if idx is not None:
            return idx
        idx = self._push((CONST, value))
        self.constants[value] = idx
        return idx

    def new_variable_with_label(self, label: str) -> int:
        idx = self._push((VAR, label))
        if label in self.variables:
            raise ValueError(f"Variable label already in use: {label}")
        self.variables[label] = idx
        return idx

    def new_variable(self) -> int:
        return self.new_variable_with_label(f"var_{self.num_variables()}")

    def new_variables(self, num: int) -> list[int]:
        return [self.new_variable() for _ in range(num)]

    def get_variable(self, label: str) -> int:
        return self.variables[label]

    def add(self, left: int, right: int) -> int:
        n = len(self.nodes)
        assert left < n and right < n, "operand not in circuit"
        return self._push((ADD, left, right))

    def mul(self, left: int, right: int) -> int:
        n = len(self.nodes)
        assert left < n and right < n, "operand not in circuit"
        return self._push((MUL, left, right))

    def add_unchecked(self, left: int, right: int) -> int:
        return self._push((ADD, left, right))

    def mul_unchecked(self, left: int, right: int) -> int:
        return self._push((MUL, left, right))

    def add_nodes(self, indices) -> int:
        it = iter(indices)
        acc = next(it)
        for idx in it:
            acc = self.add(acc, idx)
        return acc

    def mul_nodes(self, indices) -> int:
        it = iter(indices)
        acc = next(it)
        for idx in it:
            acc = self.mul(acc, idx)
        return acc

    def _pow_binary(self, node: int, bits: list[bool]) -> int:
        # square-and-multiply; the leading 1 bit is folded into the init
        current = node
        for bit in bits[1:]:
            current = self.mul_unchecked(current, current)
            if bit:
                current = self.mul_unchecked(current, node)
        return current

    def pow(self, node: int, exponent: int) -> int:
        assert node < self.num_nodes()
        # big-endian bits without leading zeros; exponent 0 -> empty ->
        # returns the base (reference quirk, mod.rs:171-179)
        bits = [] if exponent == 0 else \
            [b == "1" for b in bin(exponent)[2:]]
        return self._pow_binary(node, bits)

    pow_bigint = pow

    def indicator(self, node: int) -> int:
        """x^(p-1): 0 if x == 0 else 1."""
        bits = [b == "1" for b in bin(self.field.p - 1)[2:]]
        return self._pow_binary(node, bits)

    def minus(self, node: int) -> int:
        return self.mul(self.constant(self.field.p - 1), node)

    def scalar_product(self, left, right) -> int:
        products = [self.mul_unchecked(l, r) for l, r in zip(left, right)]
        return self.add_nodes(products)

    # ------------------------------------------------------------------
    # evaluation (iterative, memoized)
    # ------------------------------------------------------------------
    def _seed_assignments(self, vars_: list[tuple[int, int]]) -> list:
        assignments: list = [None] * len(self.nodes)
        for i, node in enumerate(self.nodes):
            if node[0] == CONST:
                assignments[i] = node[1]
        for index, value in vars_:
            if self.nodes[index][0] != VAR:
                raise ValueError("Value supplied for non-variable node")
            assignments[index] = value % self.field.p
        return assignments

    def _inner_evaluate(self, target: int, assignments: list) -> None:
        p = self.field.p
        nodes = self.nodes
        stack = [target]
        while stack:
            i = stack[-1]
            if assignments[i] is not None:
                stack.pop()
                continue
            node = nodes[i]
            kind = node[0]
            if kind == VAR:
                raise ValueError(f"Uninitialised variable: {node[1]}")
            left, right = node[1], node[2]
            lv, rv = assignments[left], assignments[right]
            if lv is not None and rv is not None:
                stack.pop()
                assignments[i] = (lv + rv) % p if kind == ADD else (lv * rv) % p
            else:
                if lv is None:
                    stack.append(left)
                if rv is None:
                    stack.append(right)

    def evaluation_trace(self, vars_: list[tuple[int, int]], node: int) -> list:
        assignments = self._seed_assignments(vars_)
        self._inner_evaluate(node, assignments)
        return assignments

    def evaluation_trace_multioutput(self, vars_, outputs: list[int]) -> list:
        assignments = self._seed_assignments(vars_)
        for node in outputs:
            self._inner_evaluate(node, assignments)
        return assignments

    def _labels_to_indices(self, vars_):
        return [(self.get_variable(lbl), v) for lbl, v in vars_]

    def evaluation_trace_with_labels(self, vars_, node: int) -> list:
        return self.evaluation_trace(self._labels_to_indices(vars_), node)

    def evaluation_trace_multioutput_with_labels(self, vars_, outputs) -> list:
        return self.evaluation_trace_multioutput(self._labels_to_indices(vars_), outputs)

    def evaluate_node(self, vars_, node: int) -> int:
        return self.evaluation_trace(vars_, node)[node]

    def evaluate_node_with_labels(self, vars_, node: int) -> int:
        return self.evaluation_trace_with_labels(vars_, node)[node]

    def evaluate(self, vars_) -> int:
        return self.evaluate_node(vars_, self.last())

    def evaluate_with_labels(self, vars_) -> int:
        return self.evaluate_node_with_labels(vars_, self.last())

    def evaluate_multioutput(self, vars_, outputs: list[int]) -> list[int]:
        trace = self.evaluation_trace_multioutput(vars_, outputs)
        out_set = set(outputs)
        return [v for i, v in enumerate(trace) if i in out_set and v is not None]

    def evaluate_multioutput_with_labels(self, vars_, outputs) -> list[int]:
        return self.evaluate_multioutput(self._labels_to_indices(vars_), outputs)

    # -- debug trace printers (reference mod.rs:409-451) ----------------
    def _format_trace(self, trace: list) -> str:
        lines = [f"Arithmetic circuit with {self.num_nodes()} nodes:"]
        for index, (node, value) in enumerate(zip(self.nodes, trace)):
            if node[0] == CONST:
                lines.append(f"\t{index}: Constant = {node[1]}")
            else:
                val = str(value) if value is not None else "not set"
                lines.append(f"\t{index}: {node_str(node)} = {val}")
        return "\n".join(lines)

    def print_evaluation_trace(self, vars_, node: int) -> None:
        print(self._format_trace(self.evaluation_trace(vars_, node)))

    def print_evaluation_trace_multioutput(self, vars_, outputs) -> None:
        print(self._format_trace(
            self.evaluation_trace_multioutput(vars_, outputs)))

    # ------------------------------------------------------------------
    # R1CS compilation (reference mod.rs:455-520)
    # ------------------------------------------------------------------
    @classmethod
    def from_constraint_system(cls, cs, field: FieldSpec) -> tuple["ArithmeticCircuit", list[int]]:
        """Compile an R1CS into outputs asserting ``Az∘Bz - Cz + 1 = 1``."""
        circuit = cls(field)
        one = circuit.constant(1)
        circuit.new_variables(cs.num_instance + cs.num_witness - 1)

        def rows(matrix):
            return [circuit._compile_sparse_scalar_product(row) for row in matrix]

        a = rows(cs.a)
        b = rows(cs.b)
        c = rows(cs.c)

        ab = [circuit.mul(x, y) for x, y in zip(a, b)]
        minus_one = circuit.constant(field.p - 1)
        minus_c = [circuit.mul(x, minus_one) for x in c]
        outputs = [circuit.add_nodes([prod, mc, one])
                   for prod, mc in zip(ab, minus_c)]
        return circuit, outputs

    def _compile_sparse_scalar_product(self, sparse_row) -> int:
        # first intern all constants (in row order), then emit products
        interned = [(self.constant(c), var_index) for c, var_index in sparse_row]
        products = []
        for c_index, var_index in interned:
            if c_index == 0 or var_index == 0:
                # 1 * x => x ; c * 1 => c  (node 0 is the constant one)
                products.append(c_index + var_index)
            else:
                products.append(self.mul(c_index, var_index))
        return self.add_nodes(products)

    def __str__(self) -> str:
        lines = [f"Arithmetic circuit with {self.num_nodes()} nodes:"]
        for i, node in enumerate(self.nodes):
            if node[0] == CONST:
                lines.append(f"\t{i}: Constant({node[1]})")
            else:
                lines.append(f"\t{i}: {node_str(node)}")
        return "\n".join(lines)


def filter_constants(nodes: list[tuple]) -> tuple[list[tuple], dict[int, int]]:
    """De-duplicate constant nodes, remapping gate operand indices.

    Mirrors reference src/arithmetic_circuit/mod.rs:546-607 including
    its handling of inputs with forward references.
    """
    constants: dict[int, int] = {}
    filtered_indices: dict[int, int] = {}
    removed = 0
    for i, node in enumerate(nodes):
        if node[0] == CONST:
            if node[1] in constants:
                removed += 1
            else:
                constants[node[1]] = i - removed
                filtered_indices[i] = i - removed
        else:
            filtered_indices[i] = i - removed

    new_nodes: list[tuple] = []
    for i, node in enumerate(nodes):
        kind = node[0]
        if kind == CONST:
            if i in filtered_indices:
                new_nodes.append(node)
        elif kind == VAR:
            new_nodes.append(node)
        else:
            def remap(j: int) -> int:
                tgt = nodes[j]
                if tgt[0] == CONST:
                    return constants[tgt[1]]
                return filtered_indices[j]
            new_nodes.append((kind, remap(node[1]), remap(node[2])))
    return new_nodes, constants


def node_str(node: tuple) -> str:
    """Display form of a node (reference Node::Display, mod.rs:523-532)."""
    if node[0] == CONST:
        return f"Constant({node[1]})"
    if node[0] == VAR:
        return str(node[1])
    op = "+" if node[0] == ADD else "*"
    return f"node({node[1]}) {op} node({node[2]})"
