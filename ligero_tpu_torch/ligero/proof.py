"""Ligero proof objects + canonical serialization.

The port's own copy of ``ligero_tpu/ligero/proof.py``, same names and structure;
the tests hold the two against each other on the same inputs.

Mirrors reference src/ligero/mod.rs:96-144 structurally; adds binary
(de)serialization, which the reference lacks entirely (its ``LigeroProof``
derives no serializer — noted as a gap in SURVEY.md §5.4).

Layout notes: each sub-proof redundantly carries its own ``t`` opened
columns and Merkle paths, faithfully to the reference (mod.rs:96-144 keeps
three independent openings; nothing is shared or deduplicated).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..fields import FieldSpec
from ..merkle import MerklePath
from ..utils.profiling import span


@dataclass
class InterleavedProof:
    preenc_u_lc: list[int]
    columns: list[list[int]]
    paths: list[MerklePath]


@dataclass
class LinearConstraintsProof:
    polynomial: list[int]  # trimmed coefficient vector (canonical ints)
    columns: list[list[int]]
    paths: list[MerklePath]


@dataclass
class QuadraticConstraintsProof:
    polynomial: list[int]
    columns: list[list[int]]
    paths: list[MerklePath]


@dataclass
class LigeroProof:
    u_root: bytes
    interleaved: InterleavedProof
    linear: LinearConstraintsProof
    quadratic: QuadraticConstraintsProof

    # ------------------------------------------------------------------
    # serialization (framework extension; ark-style u64-LE length prefixes)
    # ------------------------------------------------------------------
    def to_bytes(self, field: FieldSpec) -> bytes:
        """The canonical encoding; a profiler span ``proof.to_bytes``, its
        three column sets ``columns.to_bytes`` inside it."""
        with span("proof.to_bytes"):
            return self._to_bytes(field)

    def _to_bytes(self, field: FieldSpec) -> bytes:
        sz = field.serialized_size
        out = bytearray()

        def put_bytes(b: bytes):
            out.extend(struct.pack("<Q", len(b)))
            out.extend(b)

        def put_fvec(v: list[int]):
            out.extend(struct.pack("<Q", len(v)))
            for x in v:
                out.extend(int(x).to_bytes(sz, "little"))

        def put_paths(paths: list[MerklePath]):
            out.extend(struct.pack("<Q", len(paths)))
            for p in paths:
                out.extend(struct.pack("<Q", p.leaf_index))
                put_bytes(p.leaf_sibling_hash)
                out.extend(struct.pack("<Q", len(p.auth_path)))
                for h in p.auth_path:
                    put_bytes(h)

        def put_columns(cols: list[list[int]]):
            with span("columns.to_bytes"):
                out.extend(struct.pack("<Q", len(cols)))
                for c in cols:
                    put_fvec(c)

        put_bytes(self.u_root)
        put_fvec(self.interleaved.preenc_u_lc)
        put_columns(self.interleaved.columns)
        put_paths(self.interleaved.paths)
        put_fvec(self.linear.polynomial)
        put_columns(self.linear.columns)
        put_paths(self.linear.paths)
        put_fvec(self.quadratic.polynomial)
        put_columns(self.quadratic.columns)
        put_paths(self.quadratic.paths)
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes, field: FieldSpec) -> "LigeroProof":
        """Rejecting deserializer (ark ``CanonicalDeserialize`` discipline):
        truncated buffers and non-canonical field encodings (>= p) raise
        ``ValueError`` instead of silently yielding malleable proofs.  A
        profiler span ``proof.from_bytes``, its three column sets
        ``columns.from_bytes`` inside it."""
        with span("proof.from_bytes"):
            return cls._from_bytes(data, field)

    @classmethod
    def _from_bytes(cls, data: bytes, field: FieldSpec) -> "LigeroProof":
        sz = field.serialized_size
        pos = 0

        def get_u64():
            nonlocal pos
            if pos + 8 > len(data):
                raise ValueError("truncated proof buffer")
            v, = struct.unpack_from("<Q", data, pos)
            pos += 8
            return v

        def get_bytes():
            nonlocal pos
            n = get_u64()
            if pos + n > len(data):
                raise ValueError("truncated proof buffer")
            b = data[pos:pos + n]
            pos += n
            return b

        def get_fvec():
            nonlocal pos
            n = get_u64()
            if pos + n * sz > len(data):
                raise ValueError("truncated proof buffer")
            v = [int.from_bytes(data[pos + i * sz:pos + (i + 1) * sz], "little")
                 for i in range(n)]
            pos += n * sz
            if any(x >= field.p for x in v):
                raise ValueError("non-canonical field element (>= p)")
            return v

        def get_paths():
            n = get_u64()
            paths = []
            for _ in range(n):
                leaf_index = get_u64()
                sibling = get_bytes()
                m = get_u64()
                auth = [get_bytes() for _ in range(m)]
                paths.append(MerklePath(leaf_index, sibling, auth))
            return paths

        def get_columns():
            with span("columns.from_bytes"):
                n = get_u64()
                return [get_fvec() for _ in range(n)]

        u_root = get_bytes()
        inter = InterleavedProof(get_fvec(), get_columns(), get_paths())
        lin = LinearConstraintsProof(get_fvec(), get_columns(), get_paths())
        quad = QuadraticConstraintsProof(get_fvec(), get_columns(), get_paths())
        if pos != len(data):
            # strict canonical encoding: one proof <-> one byte string
            raise ValueError("trailing bytes after proof")
        return cls(u_root, inter, lin, quad)
