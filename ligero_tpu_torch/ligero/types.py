"""Merkle-tree parameter plumbing (API parity with the reference).

The port's own copy of ``ligero_tpu/ligero/types.py``, same names and structure;
the tests hold the two against each other on the same inputs.

The reference abstracts its commitment hashers behind ``LigeroMTParams``
(reference src/ligero/types.rs:15-46): a leaf hasher, a two-to-one
inner-node hasher, and a column hasher, with the concrete
``LigeroMTTestParams`` instantiating leaf = identity, two-to-one =
SHA-256, column = Blake2s-256 over the compressed column encoding.

The port's ``LigeroCircuit`` commits with the default
:class:`LigeroMTTestParams` only (the Blake2s column kernel and the SHA-256
tree kernel) and takes no params object until the Poseidon commitment is
ported (ROADMAP.md queue 1 #14).  :class:`LigeroMTPoseidonParams` keeps its
host hashers, which the tests hold against the JAX package's; its device
path raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields import FieldSpec
from ..hashes import column_hash, sha256_compress


@dataclass(frozen=True)
class LigeroMTTestParams:
    """Default commitment configuration (Blake2s leaves + SHA-256 tree).

    This is the reference's ``LigeroMTTestParams`` (types.rs:30-46); it is
    the only configuration with device commit kernels, which compute
    bit-identical digests to these host functions.
    """

    def col_hash(self, field: FieldSpec, column: list[int]) -> bytes:
        return column_hash(field, column)

    def two_to_one(self, left: bytes, right: bytes) -> bytes:
        return sha256_compress(left, right)

    def leaf_hash(self, leaf: bytes) -> bytes:  # LeafIdentityHasher
        return leaf


@dataclass(frozen=True)
class LigeroMTPoseidonParams:
    """Algebraic commitment: Poseidon column hash + Poseidon two-to-one.

    Digests are 32-byte little-endian canonical field elements, so they
    compose with the byte-oriented Merkle plumbing unchanged.  Uses the
    same ark test-sponge Poseidon parameters as the Fiat–Shamir sponge
    (an extension — the reference's types.rs fixes Blake2s/SHA-256 and
    only abstracts them at the type level)."""

    field: FieldSpec

    def _sponge(self):
        from ..sponge import test_sponge
        return test_sponge(self.field)

    def col_hash(self, field: FieldSpec, column: list[int]) -> bytes:
        sp = self._sponge()
        sp.absorb_field_elems([int(c) for c in column])
        out = sp.squeeze_native_field_elements(1)[0]
        return int(out).to_bytes(32, "little")

    def two_to_one(self, left: bytes, right: bytes) -> bytes:
        sp = self._sponge()
        # digests are canonical field elements (or the empty padding leaf)
        sp.absorb_field_elems([int.from_bytes(left, "little") % self.field.p,
                               int.from_bytes(right, "little") % self.field.p])
        out = sp.squeeze_native_field_elements(1)[0]
        return int(out).to_bytes(32, "little")

    def leaf_hash(self, leaf: bytes) -> bytes:
        return leaf

    # -- device fast path ---------------------------------------------------
    def device_col_digests(self, backend, u_source):
        """Batched device column digests.  On the CPU there is none (the
        host per-column loop is the golden path), so this returns None as
        the JAX package does off the device; on a CUDA backend the batched
        Poseidon column sponges (``ligero_tpu/engine/poseidon_cols.py``)
        are not ported yet (ROADMAP.md queue 1 #14)."""
        if backend.device.type == "cpu":
            return None
        raise NotImplementedError(
            "Poseidon Merkle-tree commitment on a CUDA device is not ported "
            "yet (ROADMAP.md queue 1 #14)")


def is_default_mt_params(params) -> bool:
    """True iff ``params`` is the stock Blake2s/SHA-256 configuration
    (the only one the fused device commit kernels implement)."""
    return type(params) is LigeroMTTestParams
