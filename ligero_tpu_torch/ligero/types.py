"""Merkle-tree parameter plumbing (API parity with the reference).

The port's own copy of ``ligero_tpu/ligero/types.py``, same names and structure;
the tests hold the two against each other on the same inputs.

The reference abstracts its commitment hashers behind ``LigeroMTParams``
(reference src/ligero/types.rs:15-46): a leaf hasher, a two-to-one
inner-node hasher, and a column hasher, with the concrete
``LigeroMTTestParams`` instantiating leaf = identity, two-to-one =
SHA-256, column = Blake2s-256 over the compressed column encoding.

The port's ``LigeroCircuit`` takes ``mt_params``: the default
:class:`LigeroMTTestParams` commits through the Blake2s column kernel and
the SHA-256 tree kernel, :class:`LigeroMTPoseidonParams` through the
Poseidon sponge kernel (``device_col_digests``, ``device_tree_levels``), on
the CPU through its plain version.  The host hashers (``col_hash``,
``two_to_one``) are the oracle of the tests and check the verifier's
Merkle paths.  Poseidon digests are 32-byte elements: over BLS12-377 Fq the
device methods raise ``ValueError`` (the JAX package's ``col_hash`` fails
there too, with ``OverflowError``).
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

    # -- the commitment on the device -------------------------------------
    def check_backend(self, backend):
        """The sponge config for ``backend``'s field; ``ValueError``, before
        any launch, where that is not these params' field or its elements
        do not fit a 32-byte digest."""
        from ..engine.poseidon_cols import check_config
        from ..sponge import test_poseidon_config
        if backend.field.p != self.field.p:
            raise ValueError(f"{self.field.name} Poseidon params over a "
                             f"{backend.field.name} backend")
        cfg = test_poseidon_config(self.field)
        check_config(self.field, cfg)
        return cfg

    def device_col_digests(self, backend, u_source,
                           batch: int = 1) -> list[bytes]:
        """Column digests of ``batch`` stacked (rows, n, L) canonical limb
        matrices, a (batch rows, n, L) array, on ``backend``'s device, all
        batch n sponges side by side in one launch
        (``engine/poseidon_cols.py``): the CUDA kernel on the card (a build
        or launch failure raises), the plain version on the CPU.  Matrix
        after matrix, bit-identical to :meth:`col_hash` of each column.
        Over a mesh, one launch a device for its block of whole columns
        (``backend.column_digests``).  A ``StreamedCodewords`` (the
        resident or streaming mode's U, one proof) goes a part at a time,
        its codewords held (resident) or re-encoded (streaming;
        ``backend.part_codewords``), their real rows absorbed into the
        columns' sponge states (``cuda_poseidon.PoseidonColumnStream``, the
        chunked kernel entry), as the default commitment's streamed Blake2s
        absorbs them."""
        from ..engine import cuda_poseidon, poseidon_cols
        from ..engine.devmatrix import StreamedCodewords
        cfg = self.check_backend(backend)
        if isinstance(u_source, StreamedCodewords):
            if batch != 1:
                raise ValueError("streaming mode commits one proof at a time")
            n = u_source.n
            stream = cuda_poseidon.PoseidonColumnStream(
                self.field, cfg, n, u_source.rows, backend.device)
            for coeffs, real, held in u_source.parts():
                stream.absorb(backend.part_codewords(coeffs, real, held, n),
                              real)
            return poseidon_cols.digests_to_bytes(stream.digests())
        return poseidon_cols.digests_to_bytes(backend.column_digests(
            u_source, batch, lambda block: poseidon_cols.poseidon_columns(
                self.field, cfg, block)))

    def device_tree_levels(self, backend, leaves: list[bytes],
                           batch: int = 1) -> list:
        """The Merkle levels above ``batch`` trees whose leaves (a power of
        two each) stand tree after tree in ``leaves``, one launch a level
        for all of them on ``backend``'s device: level i holds every
        tree's nodes of that level, tree after tree.  Of one tree, what
        ``create_merkle_tree(leaves, two_to_one=self.two_to_one).levels``
        holds."""
        from ..engine import poseidon_cols
        cfg = self.check_backend(backend)
        limbs = backend.asarray(poseidon_cols.bytes_to_digests(
            leaves, self.field.num_limbs))
        return [poseidon_cols.digests_to_bytes(level) for level in
                poseidon_cols.tree_levels(self.field, cfg, limbs.reshape(
                    batch, len(leaves) // batch, -1))]


def is_default_mt_params(params) -> bool:
    """True iff ``params`` is the stock Blake2s/SHA-256 configuration
    (the only one the fused device commit kernels implement)."""
    return type(params) is LigeroMTTestParams
