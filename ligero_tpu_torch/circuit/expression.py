"""Operator-overloaded expression front-end compiled to the circuit IR.

The port's own copy of ``ligero_tpu/circuit/expression.py``, same names and structure;
the tests hold the two against each other on the same inputs.

Functional equivalent of reference src/expression/mod.rs: expressions
are shared by *object identity* (the reference uses ``Rc`` pointer
identity, src/expression/mod.rs:109-111), and ``to_arithmetic_circuit``
lays nodes out in reverse insertion order of a pre-order DFS, then
de-duplicates constants — reproducing the exact node numbering the
reference's golden tests assert (src/expression/tests.rs:210-344).

Preserved quirks:

* ``pow(0)`` returns the base expression, not 1 (src/expression/mod.rs:156);
* ``-e`` compiles to ``Constant(-1) * e``;
* ``a - b`` compiles to ``a + (-1 * b)``;
* int operands are promoted to field constants on either side (Python has
  no orphan-rule constraint, so both ``1 + e`` and ``e + 1`` work — a
  strict superset of the reference's `i32`-left / `F`-right rule).
"""

from __future__ import annotations

from ..fields import FieldSpec
from .arithmetic import ADD, CONST, MUL, VAR, ArithmeticCircuit, filter_constants


class Expression:
    __slots__ = ("kind", "value", "label", "left", "right", "field")

    def __init__(self, kind: str, field: FieldSpec, value=None, label=None,
                 left=None, right=None):
        self.kind = kind
        self.field = field
        self.value = value
        self.label = label
        self.left = left
        self.right = right

    # -- constructors ------------------------------------------------------
    @staticmethod
    def constant(value: int, field: FieldSpec) -> "Expression":
        return Expression(CONST, field, value=value % field.p)

    @staticmethod
    def variable(label: str, field: FieldSpec) -> "Expression":
        return Expression(VAR, field, label=label)

    # -- helpers -----------------------------------------------------------
    def _promote(self, other) -> "Expression":
        if isinstance(other, Expression):
            return other
        if isinstance(other, int):
            return Expression.constant(other, self.field)
        return NotImplemented

    # -- operators ---------------------------------------------------------
    def __add__(self, other):
        rhs = self._promote(other)
        if rhs is NotImplemented:
            return NotImplemented
        return Expression(ADD, self.field, left=self, right=rhs)

    def __radd__(self, other):
        lhs = self._promote(other)
        if lhs is NotImplemented:
            return NotImplemented
        return Expression(ADD, self.field, left=lhs, right=self)

    def __mul__(self, other):
        rhs = self._promote(other)
        if rhs is NotImplemented:
            return NotImplemented
        return Expression(MUL, self.field, left=self, right=rhs)

    def __rmul__(self, other):
        lhs = self._promote(other)
        if lhs is NotImplemented:
            return NotImplemented
        return Expression(MUL, self.field, left=lhs, right=self)

    def __neg__(self):
        return Expression.constant(self.field.p - 1, self.field) * self

    def __sub__(self, other):
        rhs = self._promote(other)
        if rhs is NotImplemented:
            return NotImplemented
        return self + (-rhs)

    def __rsub__(self, other):
        lhs = self._promote(other)
        if lhs is NotImplemented:
            return NotImplemented
        return lhs + (-self)

    def pow(self, exponent: int) -> "Expression":
        if exponent == 0:
            return self  # reference quirk
        bits = bin(exponent)[2:]
        current = self
        for bit in bits[1:]:
            current = current * current
            if bit == "1":
                current = current * self
        return current

    @staticmethod
    def scalar_product(a: list["Expression"], b: list["Expression"]) -> "Expression":
        terms = [x * y for x, y in zip(a, b)]
        return Expression.sum(terms)

    @staticmethod
    def sparse_scalar_product(a: list[tuple[int, int]], b: list["Expression"]) -> "Expression":
        terms = [b[i] * c for c, i in a]
        return Expression.sum(terms)

    @staticmethod
    def sum(exprs: list["Expression"]) -> "Expression":
        it = iter(exprs)
        acc = next(it)
        for e in it:
            acc = acc + e
        return acc

    @staticmethod
    def product(exprs: list["Expression"]) -> "Expression":
        it = iter(exprs)
        acc = next(it)
        for e in it:
            acc = acc * e
        return acc

    def __repr__(self) -> str:
        """Reference Display parity (src/expression/mod.rs:273-287):
        ``Kind(args)<identity>``, with ``id()`` standing in for the
        reference's ``Rc`` pointer hash."""
        h = id(self)
        if self.kind == VAR:
            return f"Variable({self.label})<{h}>"
        if self.kind == CONST:
            return f"Constant({self.value})<{h}>"
        op = "Add" if self.kind == ADD else "Mul"
        return f"{op}({id(self.left)}, {id(self.right)})<{h}>"

    # -- compilation -------------------------------------------------------
    def _update_map(self, nodes: dict[int, tuple[int, tuple]]) -> None:
        """Pre-order DFS keyed by object identity (iterative)."""
        stack = [self]
        while stack:
            expr = stack.pop()
            key = id(expr)
            if key in nodes:
                continue
            if expr.kind == VAR:
                nodes[key] = (len(nodes), (VAR, expr.label))
            elif expr.kind == CONST:
                nodes[key] = (len(nodes), (CONST, expr.value))
            else:
                nodes[key] = (len(nodes), (expr.kind, id(expr.left), id(expr.right)))
                # preserve the reference's a-then-b recursion order
                stack.append(expr.right)
                stack.append(expr.left)

    def to_arithmetic_circuit(self) -> ArithmeticCircuit:
        nodes: dict[int, tuple[int, tuple]] = {}
        self._update_map(nodes)
        total = len(nodes)
        ptr_to_idx = {ptr: total - counter - 1 for ptr, (counter, _) in nodes.items()}

        ordered = sorted(nodes.values(), key=lambda cn: -cn[0])
        laid_out: list[tuple] = []
        for _, node in ordered:
            if node[0] in (ADD, MUL):
                laid_out.append((node[0], ptr_to_idx[node[1]], ptr_to_idx[node[2]]))
            else:
                laid_out.append(node)

        filtered, constants = filter_constants(laid_out)
        circuit = ArithmeticCircuit(self.field)
        circuit.nodes = filtered
        circuit.constants = constants
        circuit.variables = {n[1]: i for i, n in enumerate(filtered) if n[0] == VAR}
        return circuit
