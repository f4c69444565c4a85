"""circom R1CS ingestion: native ``.r1cs`` binary parser + witness loaders.

The port's own copy of ``ligero_tpu/circuit/r1cs.py``, same names and structure;
the tests hold the two against each other on the same inputs.

The reference delegates this to ark-circom (wasmer-JIT'd witness wasm +
r1cs parsing; reference src/reader.rs).  Here the ``.r1cs`` binary
(iden3 spec) is parsed directly, and the constraint rows are normalised the
way ark-relations' ``LinearCombination``/``to_matrices`` would emit them:

* wire 0 is the constant one; wires ``[1, num_instance)`` are the public
  outputs+inputs; the rest are private (column index == circom wire id);
* terms within a row are sorted by wire id ascending, duplicate wires are
  coefficient-summed, and zero coefficients are dropped (ark-relations
  keeps LCs sorted/compact and ``make_row`` filters zeros).

Witness loading supports circom's ``witness.json`` (decimal strings) and
binary ``.wtns``; ``compute_witness_wasm`` runs a circom witness ``.wasm``
on the in-tree WASM interpreter (``wasm_interp``, through
``circuit/witness.py``).
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field as dc_field

from ..fields import FieldSpec


@dataclass
class ConstraintSystem:
    """Thin R1CS container (ark-relations ``ConstraintSystem`` analogue)."""

    field: FieldSpec
    num_instance: int   # includes the leading constant-one variable
    num_witness: int
    a: list[list[tuple[int, int]]] = dc_field(default_factory=list)
    b: list[list[tuple[int, int]]] = dc_field(default_factory=list)
    c: list[list[tuple[int, int]]] = dc_field(default_factory=list)

    @property
    def num_constraints(self) -> int:
        return len(self.a)


def _normalize_row(row: list[tuple[int, int]], p: int) -> list[tuple[int, int]]:
    acc: dict[int, int] = {}
    for coeff, wire in row:
        acc[wire] = (acc.get(wire, 0) + coeff) % p
    return [(c, w) for w, c in sorted(acc.items()) if c != 0]


def parse_r1cs(path: str, field: FieldSpec) -> ConstraintSystem:
    """Parse an iden3 ``.r1cs`` binary file.

    Rejecting parser for untrusted files (the CLI and the HTTP service
    feed it user paths): every malformation — bad magic, truncation,
    wrong prime, absurd counts — raises ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return _parse_r1cs_inner(data, field)
    except ValueError:
        raise
    except (struct.error, IndexError, KeyError, OverflowError) as e:
        raise ValueError(f"malformed r1cs file: {e}") from e


def _parse_r1cs_inner(data: bytes, field: FieldSpec) -> ConstraintSystem:
    def require(cond: bool, msg: str) -> None:
        if not cond:
            raise ValueError(f"malformed r1cs file: {msg}")

    require(data[:4] == b"r1cs", "bad r1cs magic")
    version, n_sections = struct.unpack_from("<II", data, 4)
    require(version == 1, f"unsupported r1cs version {version}")
    require(n_sections <= 64, "absurd section count")

    sections: dict[int, tuple[int, int]] = {}
    off = 12
    for _ in range(n_sections):
        require(off + 12 <= len(data), "truncated section header")
        sec_type, = struct.unpack_from("<I", data, off)
        size, = struct.unpack_from("<Q", data, off + 4)
        require(off + 12 + size <= len(data), "section exceeds file size")
        sections[sec_type] = (off + 12, size)
        off += 12 + size
    require(1 in sections and 2 in sections,
            "missing header or constraints section")

    # header
    h_off, h_size = sections[1]
    require(h_size >= 4, "truncated header section")
    fs, = struct.unpack_from("<I", data, h_off)
    require(4 + fs + 16 + 8 + 4 <= h_size, "truncated header section")
    prime = int.from_bytes(data[h_off + 4:h_off + 4 + fs], "little")
    require(prime == field.p,
            f"r1cs prime does not match field {field.name}")
    o = h_off + 4 + fs
    n_wires, n_pub_out, n_pub_in, _n_prv_in = struct.unpack_from("<IIII", data, o)
    # n_labels: u64, n_constraints: u32
    n_constraints, = struct.unpack_from("<I", data, o + 16 + 8)

    num_instance = 1 + n_pub_out + n_pub_in
    num_witness = n_wires - num_instance
    require(num_witness >= 0, "wire counts inconsistent")

    # constraints
    c_off, c_size = sections[2]
    pos, c_end = c_off, c_off + c_size
    a_rows, b_rows, c_rows = [], [], []
    for _ in range(n_constraints):
        lcs = []
        for _ in range(3):
            require(pos + 4 <= c_end, "truncated constraints section")
            n_terms, = struct.unpack_from("<I", data, pos)
            pos += 4
            require(pos + n_terms * (4 + fs) <= c_end,
                    "truncated constraints section")
            terms = []
            for _ in range(n_terms):
                wire, = struct.unpack_from("<I", data, pos)
                require(wire < n_wires, "term wire id out of range")
                coeff = int.from_bytes(data[pos + 4:pos + 4 + fs], "little")
                pos += 4 + fs
                terms.append((coeff, wire))
            lcs.append(_normalize_row(terms, field.p))
        a_rows.append(lcs[0])
        b_rows.append(lcs[1])
        c_rows.append(lcs[2])

    return ConstraintSystem(field, num_instance, num_witness, a_rows, b_rows, c_rows)


def load_witness_json(path: str, field: FieldSpec) -> list[int]:
    with open(path) as f:
        values = json.load(f)
    return [int(v) % field.p for v in values]


def load_witness_wtns(path: str, field: FieldSpec) -> list[int]:
    """Parse an iden3 binary ``.wtns`` witness file (rejecting parser:
    malformed untrusted files raise ``ValueError``)."""
    def require(cond: bool, msg: str) -> None:
        if not cond:
            raise ValueError(f"malformed wtns file: {msg}")

    with open(path, "rb") as f:
        data = f.read()
    require(data[:4] == b"wtns", "bad wtns magic")
    require(len(data) >= 12, "truncated wtns header")
    _version, n_sections = struct.unpack_from("<II", data, 4)
    require(n_sections <= 64, "absurd section count")
    off = 12
    out: list[int] = []
    fs = None
    for _ in range(n_sections):
        require(off + 12 <= len(data), "truncated section header")
        sec_type, = struct.unpack_from("<I", data, off)
        size, = struct.unpack_from("<Q", data, off + 4)
        require(off + 12 + size <= len(data), "section exceeds file size")
        body = off + 12
        if sec_type == 1:
            require(size >= 4, "truncated wtns header section")
            fs, = struct.unpack_from("<I", data, body)
            require(4 + fs <= size, "truncated wtns header section")
            prime = int.from_bytes(data[body + 4:body + 4 + fs], "little")
            require(prime == field.p, "wtns prime mismatch")
        elif sec_type == 2:
            require(fs is not None and fs > 0,
                    "wtns data section before header")
            n = size // fs
            out = [int.from_bytes(data[body + i * fs:body + (i + 1) * fs], "little")
                   for i in range(n)]
        off += 12 + size
    return out


def compute_witness_wasm(wasm_path: str, inputs: dict, field: FieldSpec) -> list[int]:
    """Run a circom witness ``.wasm`` on the in-tree WASM interpreter.

    ``inputs``: signal name -> int or list of ints (circom input.json
    semantics).

    Untrusted-input boundary (CLI / HTTP service): a malformed or
    non-circom wasm raises ``ValueError`` (never a bare
    AssertionError / IndexError / KeyError from the interpreter).
    """
    from .witness import compute_witness
    try:
        return compute_witness(wasm_path, inputs, field)
    except ValueError:
        raise
    except (AssertionError, IndexError, KeyError, struct.error,
            ZeroDivisionError, TypeError, OverflowError,
            RecursionError) as e:
        raise ValueError(
            f"malformed or unsupported witness wasm: "
            f"{type(e).__name__}: {e}") from e


def read_constraint_system(r1cs_path: str, field: FieldSpec,
                           wasm_path: str | None = None):
    """Equivalent of the reference's ``read_constraint_system``
    (reference src/reader.rs:6-19).

    Returns the ConstraintSystem; when ``wasm_path`` is given, also
    returns a witness-computation closure (what the reference gets from
    ark-circom): ``(cs, compute)`` with ``compute(inputs) -> list[int]``.
    """
    cs = parse_r1cs(r1cs_path, field)
    if wasm_path is None:
        return cs
    return cs, lambda inputs: compute_witness_wasm(wasm_path, inputs, field)


def repeated_squaring_constraint_system(field: FieldSpec,
                                        squarings: int = 10) -> ConstraintSystem:
    """In-tree equivalent of ``repeated_squaring_10.circom`` (the reference
    ships the source but no compiled ``.r1cs``; no reference test uses it —
    SURVEY.md §8).  Mirrors circom-2 compilation of that template: wires
    ``[1, y, x, tmp0..tmp_{s-2}]`` (y public output, x private input), one
    squaring constraint per ``tmp_i <== prev * prev`` with the final
    ``y <== tmp_{s-1}`` linear assignment folded into the last constraint
    (circom's linear-substitution optimisation, as seen in cube.r1cs)."""
    cs = ConstraintSystem(field, num_instance=2, num_witness=squarings)
    x_wire = 2
    prev = x_wire
    for i in range(squarings):
        out_wire = 1 if i == squarings - 1 else 3 + i  # y for the last
        cs.a.append([(1, prev)])
        cs.b.append([(1, prev)])
        cs.c.append([(1, out_wire)])
        prev = out_wire if out_wire != 1 else prev
        if i < squarings - 1:
            prev = 3 + i
    return cs


def repeated_squaring_witness(field: FieldSpec, x: int,
                              squarings: int = 10) -> list[int]:
    """Witness vector [1, y, x, tmp0..tmp_{s-2}] for the circuit above."""
    p = field.p
    tmps = []
    v = x % p
    for _ in range(squarings):
        v = v * v % p
        tmps.append(v)
    return [1, tmps[-1], x % p] + tmps[:-1]
