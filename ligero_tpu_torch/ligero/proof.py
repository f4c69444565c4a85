"""Ligero proof objects + canonical serialization.

The port's own copy of ``ligero_tpu/ligero/proof.py``, same names and structure;
the tests hold the two against each other on the same inputs.

Mirrors reference src/ligero/mod.rs:96-144 structurally; adds binary
(de)serialization, which the reference lacks entirely (its ``LigeroProof``
derives no serializer — noted as a gap in SURVEY.md §5.4).

Layout notes: each sub-proof redundantly carries its own ``t`` opened
columns and Merkle paths, faithfully to the reference (mod.rs:96-144 keeps
three independent openings; nothing is shared or deduplicated).

Opened columns are held as the wire holds them.  A column set is one
``numpy`` array of shape (ncols, rows, L), dtype ``<u2``
(:data:`COLUMN_DTYPE`): each element's L canonical 16-bit limbs, least
significant first.  The wire encodes a column as a u64 row count followed
by ``rows x serialized_size`` little-endian bytes, and for every field the
port runs ``serialized_size`` is 2 L, so a column's elements in that array
are byte for byte its wire encoding: ``to_bytes`` writes each column's
bytes as they lie and ``from_bytes`` hands back read-only views of the
buffer, checked < p with numpy.  No opened element becomes a Python int on
either side (the JAX package holds them as lists of ints; the bytes are the
same).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ..fields import FieldSpec
from ..merkle import MerklePath
from ..utils.profiling import span

#: dtype of an opened column set: little-endian 16-bit limbs, the wire's
#: byte order
COLUMN_DTYPE = np.dtype("<u2")
_U64 = struct.Struct("<Q")
_WORD = (1 << 64) - 1


@dataclass
class InterleavedProof:
    """``columns``: the t opened columns, a (t, rows, L) ``COLUMN_DTYPE``
    array of canonical limbs (rows = 4m, 4m + 3 under zk), each column's
    elements in its wire layout (module docstring)."""
    preenc_u_lc: list[int]
    columns: np.ndarray
    paths: list[MerklePath]


@dataclass
class LinearConstraintsProof:
    """``columns``: as :class:`InterleavedProof`'s."""
    polynomial: list[int]  # trimmed coefficient vector (canonical ints)
    columns: np.ndarray
    paths: list[MerklePath]


@dataclass
class QuadraticConstraintsProof:
    """``columns``: as :class:`InterleavedProof`'s."""
    polynomial: list[int]
    columns: np.ndarray
    paths: list[MerklePath]


def _element_size(field: FieldSpec) -> int:
    """Bytes of an element on the wire, which must be its 16-bit limbs."""
    sz = field.serialized_size
    if sz != 2 * field.num_limbs:
        raise ValueError(f"{field.name}: a {sz}-byte element is not its "
                         f"{field.num_limbs} 16-bit limbs")
    return sz


def _canonical(words: np.ndarray, p: int) -> bool:
    """Whether every element of ``words`` (..., W little-endian u64 words)
    is below ``p``: a compare from the top word down, each word over the
    elements still equal to p above it (none, for honest columns, past the
    top word)."""
    for i in reversed(range(words.shape[-1])):
        pw = np.uint64((p >> (64 * i)) & _WORD)
        w = words[..., i]
        if not (w >= pw).any():
            return True
        if (w > pw).any():
            return False
        words = words[w == pw]
    return False                      # an element equal to p


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
        three column sets ``columns.to_bytes`` inside it.  A column set
        that is not a (ncols, rows, L) ``COLUMN_DTYPE`` array raises
        ``ValueError``."""
        with span("proof.to_bytes"):
            return self._to_bytes(field)

    def _to_bytes(self, field: FieldSpec) -> bytes:
        sz = _element_size(field)
        parts: list = []             # joined once: one copy of the columns

        def put_bytes(b: bytes):
            parts.append(_U64.pack(len(b)))
            parts.append(b)

        def put_fvec(v: list[int]):
            parts.append(_U64.pack(len(v)))
            parts.extend(int(x).to_bytes(sz, "little") for x in v)

        def put_paths(paths: list[MerklePath]):
            parts.append(_U64.pack(len(paths)))
            for p in paths:
                parts.append(_U64.pack(p.leaf_index))
                put_bytes(p.leaf_sibling_hash)
                parts.append(_U64.pack(len(p.auth_path)))
                for h in p.auth_path:
                    put_bytes(h)

        def put_columns(cols: np.ndarray):
            with span("columns.to_bytes"):
                if (not isinstance(cols, np.ndarray) or cols.ndim != 3
                        or cols.shape[2] != field.num_limbs
                        or cols.dtype != COLUMN_DTYPE):
                    raise ValueError(
                        f"a column set is a (ncols, rows, {field.num_limbs}) "
                        f"{COLUMN_DTYPE} array")
                parts.append(_U64.pack(cols.shape[0]))
                rows = _U64.pack(cols.shape[1])
                for col in cols:
                    parts.append(rows)
                    parts.append(np.ascontiguousarray(col))

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
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, data: bytes, field: FieldSpec) -> "LigeroProof":
        """Rejecting deserializer (ark ``CanonicalDeserialize`` discipline):
        truncated buffers, trailing bytes and non-canonical field encodings
        (>= p) raise ``ValueError`` instead of silently yielding malleable
        proofs, and so does a column set whose columns differ in height
        (``"ragged column set"``: one array cannot hold it).  The column
        sets are read-only views of ``data`` (copied first where it is not
        ``bytes``).  A profiler span ``proof.from_bytes``, its three column
        sets ``columns.from_bytes`` inside it."""
        with span("proof.from_bytes"):
            return cls._from_bytes(data, field)

    @classmethod
    def _from_bytes(cls, data: bytes, field: FieldSpec) -> "LigeroProof":
        sz = _element_size(field)
        if not isinstance(data, bytes):
            data = bytes(data)      # the column views need an immutable buffer
        pos = 0

        def get_u64():
            nonlocal pos
            if pos + 8 > len(data):
                raise ValueError("truncated proof buffer")
            v, = _U64.unpack_from(data, pos)
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

        def get_columns() -> np.ndarray:
            """(ncols, rows, L) over the columns' bytes in ``data``: column
            j's elements start 8 bytes past its row count, and the next
            column's row count follows its last element."""
            nonlocal pos
            with span("columns.from_bytes"):
                n = get_u64()
                start, rows = pos, None
                for _ in range(n):
                    height = get_u64()
                    if rows is None:
                        rows = height
                    elif height != rows:
                        raise ValueError("ragged column set")
                    if pos + height * sz > len(data):
                        raise ValueError("truncated proof buffer")
                    pos += height * sz
                rows, first = rows or 0, start + 8 if n else start
                strides = (8 + rows * sz, sz)
                words = np.ndarray((n, rows, sz // 8), "<u8", buffer=data,
                                   offset=first, strides=strides + (8,))
                if not _canonical(words, field.p):
                    raise ValueError("non-canonical field element (>= p)")
                return np.ndarray((n, rows, field.num_limbs), COLUMN_DTYPE,
                                  buffer=data, offset=first,
                                  strides=strides + (2,))

        u_root = get_bytes()
        inter = InterleavedProof(get_fvec(), get_columns(), get_paths())
        lin = LinearConstraintsProof(get_fvec(), get_columns(), get_paths())
        quad = QuadraticConstraintsProof(get_fvec(), get_columns(), get_paths())
        if pos != len(data):
            # strict canonical encoding: one proof <-> one byte string
            raise ValueError("trailing bytes after proof")
        return cls(u_root, inter, lin, quad)
