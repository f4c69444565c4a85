"""Helpers for the port's opened column sets, which a proof holds as one
(ncols, rows, L) ``<u2`` limb array a set (``ligero_tpu_torch/ligero/proof.py``;
the JAX package holds lists of ints)."""

import numpy as np


def bumped(field, columns: np.ndarray, col: int, row: int) -> np.ndarray:
    """A copy of ``columns`` whose element (col, row) is raised by one mod
    p, written through ``field.int_to_limbs``; asserts that no other
    element differs."""
    out = columns.copy()
    value = field.limbs_to_int(columns[col, row])
    out[col, row] = field.int_to_limbs((value + 1) % field.p)
    changed = np.argwhere((out != columns).any(axis=-1)).tolist()
    assert changed == [[col, row]], changed
    return out


def as_ints(field, columns: np.ndarray) -> list[list[int]]:
    """A column set as lists of ints, as the JAX package holds it."""
    return [field.limbs_to_ints(col) for col in columns]
