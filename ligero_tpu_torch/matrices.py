"""Host-side sparse/dense matrices over a prime field.

The port's own copy of ``ligero_tpu/matrices.py``, same names and structure;
the tests hold the two against each other on the same inputs.

Functional equivalent of reference src/matrices/mod.rs.  The sparse
matrix is the row-list-of-``(value, col)`` structure used for the Ligero
constraint matrix A; the dense matrix only backs small host-side tests —
the protocol's dense data lives in device limb arrays.
"""

from __future__ import annotations

from .fields import FieldSpec


class SparseMatrix:
    def __init__(self, field: FieldSpec, num_cols: int,
                 rows: list[list[tuple[int, int]]] | None = None):
        self.field = field
        self.num_cols = num_cols
        self.rows: list[list[tuple[int, int]]] = rows if rows is not None else []

    @classmethod
    def from_rows(cls, field, rows, num_cols):
        return cls(field, num_cols, [list(r) for r in rows])

    def num_rows(self) -> int:
        return len(self.rows)

    def push_row(self, row: list[tuple[int, int]]) -> None:
        self.rows.append(row)

    def push_empty_row(self) -> None:
        self.rows.append([])

    def push_empty_rows(self, num: int) -> None:
        self.rows.extend([] for _ in range(num))

    @classmethod
    def identity(cls, field, size: int) -> "SparseMatrix":
        return cls(field, size, [[(1, i)] for i in range(size)])

    @classmethod
    def zero(cls, field, num_rows: int, num_cols: int) -> "SparseMatrix":
        return cls(field, num_cols, [[] for _ in range(num_rows)])

    def h_stack(self, other: "SparseMatrix") -> "SparseMatrix":
        assert self.num_rows() == other.num_rows(), "row number mismatch"
        shift = self.num_cols
        rows = [own + [(v, j + shift) for v, j in theirs]
                for own, theirs in zip(self.rows, other.rows)]
        return SparseMatrix(self.field, self.num_cols + other.num_cols, rows)

    def v_stack(self, other: "SparseMatrix") -> "SparseMatrix":
        assert self.num_cols == other.num_cols, "column number mismatch"
        return SparseMatrix(self.field, self.num_cols, self.rows + other.rows)

    def __neg__(self) -> "SparseMatrix":
        p = self.field.p
        return SparseMatrix(self.field, self.num_cols,
                            [[((-v) % p, j) for v, j in row] for row in self.rows])

    def row_mul(self, vec: list[int]) -> list[int]:
        """v^T · M — ``vec`` pairs with rows (reference mod.rs:100-110)."""
        p = self.field.p
        result = [0] * self.num_cols
        for c, row in zip(vec, self.rows):
            if c == 0:
                continue
            for value, col in row:
                result[col] = (result[col] + c * value) % p
        return result

    def to_coo(self):
        """(row_idx, col_idx, values) arrays for device-side sparse matvec."""
        import numpy as np
        rows_idx, cols_idx, vals = [], [], []
        for i, row in enumerate(self.rows):
            for v, j in row:
                rows_idx.append(i)
                cols_idx.append(j)
                vals.append(v)
        return (np.asarray(rows_idx, dtype=np.int32),
                np.asarray(cols_idx, dtype=np.int32), vals)

    def __eq__(self, other) -> bool:
        return (isinstance(other, SparseMatrix)
                and self.num_cols == other.num_cols
                and self.rows == other.rows)

    def __repr__(self) -> str:
        return f"SparseMatrix({self.num_rows()}x{self.num_cols}, nnz={sum(map(len, self.rows))})"


class CooMatrix:
    """COO sparse matrix — the prover's fast path for ``r^T · A``.

    Same values as the row-list :class:`SparseMatrix` (which remains the
    golden structural representation, reference mod.rs:63-143) but
    assembled directly as index arrays; entry order is unspecified and
    every consumer reduces with commutative exact mod-p sums.
    """

    def __init__(self, field, n_rows: int, n_cols: int, rows, cols, vals):
        import numpy as np
        self.field = field
        self.n_rows = n_rows
        self.num_cols = n_cols
        self.rows_idx = np.ascontiguousarray(rows, dtype=np.int32)
        self.cols_idx = np.ascontiguousarray(cols, dtype=np.int32)
        self.vals = vals  # Python ints (field elements)

    def num_rows(self) -> int:
        return self.n_rows

    def to_coo(self):
        return self.rows_idx, self.cols_idx, self.vals

    def row_mul(self, vec: list[int]) -> list[int]:
        """v^T · M (host fallback; the native C++ kernel consumes
        :meth:`to_coo` directly)."""
        p = self.field.p
        result = [0] * self.num_cols
        for r, c, v in zip(self.rows_idx, self.cols_idx, self.vals):
            x = vec[r]
            if x:
                result[c] = (result[c] + x * v) % p
        return result

    def __repr__(self) -> str:
        return f"CooMatrix({self.n_rows}x{self.num_cols}, nnz={len(self.vals)})"


class DenseMatrix:
    def __init__(self, field: FieldSpec, rows: list[list[int]]):
        self.field = field
        self.rows = rows

    def row_mul(self, vec: list[int]) -> list[int]:
        p = self.field.p
        result = [0] * len(self.rows[0])
        for c, row in zip(vec, self.rows):
            for j, v in enumerate(row):
                result[j] = (result[j] + c * v) % p
        return result

    def num_columns(self) -> int:
        return len(self.rows[0])

    def columns(self) -> list[list[int]]:
        return [list(col) for col in zip(*self.rows)]

    def column(self, j: int) -> list[int]:
        return [row[j] for row in self.rows]

    @classmethod
    def rand(cls, field: FieldSpec, num_rows: int, num_cols: int,
             rng=None) -> "DenseMatrix":
        """Uniform random matrix (reference DenseMatrix::rand,
        reference src/matrices/mod.rs:151-160; test-only there)."""
        import random as _random
        rng = rng or _random
        return cls(field, [[rng.randrange(field.p) for _ in range(num_cols)]
                           for _ in range(num_rows)])
