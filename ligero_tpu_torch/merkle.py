"""Binary Merkle tree with ark-crypto-primitives layout semantics.

The port's own copy of ``ligero_tpu/merkle.py``, same names and structure;
the tests hold the two against each other on the same inputs.

Matches the reference's commitment scheme (reference src/ligero/mod.rs:536-551):

* leaves are Blake2s column digests; the leaf hash is the identity
  (``LeafIdentityHasher``), so ``leaf_digest == leaf``;
* inner nodes are SHA-256 of the concatenated 32-byte child digests
  (``ByteDigestConverter`` + ``Sha256`` two-to-one CRH);
* ``create_merkle_tree`` (ark-poly-commit) pads the leaf list to a power
  of two with default (empty) leaves — a no-op here since ``n = 8k``;
* ``Path { leaf_sibling_hash, auth_path (root-side first), leaf_index }``.

The tree accepts precomputed digests, so the digest computation itself can
run on the device (JAX kernels) with only the byte arrays crossing back.
"""

from __future__ import annotations

from dataclasses import dataclass

from .hashes import sha256_compress


@dataclass
class MerklePath:
    leaf_index: int
    leaf_sibling_hash: bytes
    auth_path: list[bytes]  # ordered from the root's child level downwards

    def verify(self, root: bytes, leaf: bytes, two_to_one=sha256_compress) -> bool:
        """ark ``Path::verify`` with the identity leaf hasher.

        ``two_to_one`` swaps the inner-node hasher (LigeroMTParams
        genericity, reference types.rs:15-46); default SHA-256."""
        index = self.leaf_index
        sibling = self.leaf_sibling_hash
        if index & 1 == 0:
            node = two_to_one(leaf, sibling)
        else:
            node = two_to_one(sibling, leaf)
        index >>= 1
        for level_sibling in reversed(self.auth_path):
            if index & 1 == 0:
                node = two_to_one(node, level_sibling)
            else:
                node = two_to_one(level_sibling, node)
            index >>= 1
        return node == root


class MerkleTree:
    """Tree over a power-of-two list of 32-byte leaf digests."""

    def __init__(self, leaves: list[bytes], inner_levels: list[list[bytes]] | None = None,
                 two_to_one=sha256_compress):
        n = len(leaves)
        assert n >= 2 and n & (n - 1) == 0, "leaf count must be a power of two >= 2"
        self.leaves = list(leaves)
        if inner_levels is None:
            levels = []
            cur = self.leaves
            while len(cur) > 1:
                cur = [two_to_one(cur[2 * i], cur[2 * i + 1])
                       for i in range(len(cur) // 2)]
                levels.append(cur)
            self.levels = levels  # levels[0] just above leaves, levels[-1] = [root]
        else:
            self.levels = inner_levels

    @property
    def root(self) -> bytes:
        return self.levels[-1][0]

    def generate_proof(self, index: int) -> MerklePath:
        sibling = self.leaves[index ^ 1]
        auth = []
        idx = index >> 1
        # from the level just above the leaf-pair hashes up to below the root
        for level in self.levels[:-1]:
            auth.append(level[idx ^ 1])
            idx >>= 1
        auth.reverse()  # ark stores root-side first
        return MerklePath(leaf_index=index, leaf_sibling_hash=sibling, auth_path=auth)


def create_merkle_tree(leaves: list[bytes], two_to_one=sha256_compress) -> MerkleTree:
    """ark-poly-commit ``create_merkle_tree``: pad to a power of two with
    default (empty) leaves, then build."""
    n = len(leaves)
    target = 1 if n == 0 else 1 << (n - 1).bit_length()
    if target != n:
        leaves = list(leaves) + [b""] * (target - n)
    return MerkleTree(leaves, two_to_one=two_to_one)
