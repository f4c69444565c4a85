"""The SHA-256 Merkle tree of the port: the plain version
(ligero_tpu_torch.engine.hashops.tree_flat / tree_root, the CPU path of the
sha256_tree kernel's wrapper) against the JAX package's level-by-level
reference (HashKernel.sha256_two_to_one on numpy, the oracle of
sha256_tree_root_pallas) and against hashlib.  Tolerance: none, bits."""

import hashlib
import os
import re

import numpy as np
import pytest
import torch

from ligero_tpu.engine.hashops import HashKernel
from ligero_tpu_torch.engine import cuda_tree, hashops
from ligero_tpu_torch.merkle import MerkleTree

# the suite runs in several worker processes that share the host's cores, and
# these tests run many small tensor ops: one intra-op thread each, or the
# workers' thread pools spin against each other
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [2, 4, 8, 64, 512, 1024, 2048, 4096]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rand_leaves(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)


def t(leaves: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(leaves.view(np.int32))


def reference_flat(leaves: np.ndarray) -> np.ndarray:
    """The JAX package's levels on numpy: LE leaves, byte-swapped once,
    then sha256_two_to_one level by level."""
    hk = HashKernel(np)
    level = leaves.astype("<u4").view(np.uint8).view(">u4").astype(np.uint32)
    level = level.reshape(-1, 8)
    parts = [leaves.reshape(-1)]
    while level.shape[0] > 1:
        level = np.asarray(hk.sha256_two_to_one(level[0::2], level[1::2]),
                           dtype=np.uint32)
        parts.append(level.reshape(-1))
    return np.concatenate(parts)


def hashlib_levels(leaves: np.ndarray) -> list[list[bytes]]:
    cur = [leaves[i].astype("<u4").tobytes() for i in range(leaves.shape[0])]
    levels = []
    while len(cur) > 1:
        cur = [hashlib.sha256(cur[2 * i] + cur[2 * i + 1]).digest()
               for i in range(len(cur) // 2)]
        levels.append(cur)
    return levels


@pytest.mark.parametrize("n", SIZES)
def test_tree_flat_matches_jax_package_levels(n):
    leaves = rand_leaves(n, n)
    got = hashops.tree_flat(t(leaves)).numpy().view(np.uint32)
    assert got.shape == (8 * (2 * n - 1),)
    assert np.array_equal(got, reference_flat(leaves))


@pytest.mark.parametrize("n", SIZES)
def test_tree_flat_and_root_match_hashlib(n):
    leaves = rand_leaves(100 + n, n)
    flat = hashops.tree_flat(t(leaves)).numpy()
    got_leaves, got_levels = hashops.digest_lists(flat, n)
    want_levels = hashlib_levels(leaves)
    assert got_leaves == [leaves[i].astype("<u4").tobytes() for i in range(n)]
    assert got_levels == want_levels
    root = hashops.tree_root(t(leaves)).numpy().view(np.uint32)
    assert root.astype(">u4").tobytes() == want_levels[-1][0]
    tree = MerkleTree(got_leaves, inner_levels=got_levels)
    assert tree.root == MerkleTree(got_leaves).root
    for j in (0, n - 1, n // 2):
        assert tree.generate_proof(j).verify(tree.root, got_leaves[j])


@pytest.mark.parametrize("n", [2, 64, 2048])
def test_wrapper_takes_plain_version_on_cpu(n):
    leaves = t(rand_leaves(7, n))
    before = cuda_tree.launches.count
    assert torch.equal(cuda_tree.tree_flat(leaves), hashops.tree_flat(leaves))
    assert torch.equal(cuda_tree.tree_root(leaves), hashops.tree_root(leaves))
    assert cuda_tree.launches.count == before


def test_kernel_source_constants_match_the_schedule():
    """The round constants and the folded padding-block schedule written
    out in csrc/sha256_tree.cu are SHA_K and SHA_K + W_pad of the plain
    version."""
    with open(os.path.join(REPO, "ligero_tpu_torch", "csrc",
                           "sha256_tree.cu")) as f:
        src = f.read()

    def table(name):
        body = re.search(name + r"\[64\] = \{(.*?)\};", src, re.S).group(1)
        return [int(x, 16) for x in re.findall(r"0x([0-9a-f]{8})u", body)]

    assert table("SHA_K") == hashops._SHA_K
    assert table("PAD_KW") == [(k + w) & 0xFFFFFFFF for k, w in
                               zip(hashops._SHA_K, hashops._PAD_SCHEDULE)]
    assert hashops._PAD_SCHEDULE[:16] == [0x80000000] + [0] * 14 + [512]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4, 512, 1024, 2048, 16384, 65536])
def test_tree_kernel_matches_plain(cuda, n):
    before = cuda_tree.launches.count
    for rep in range(20):
        leaves = t(rand_leaves(1000 * rep + n, n))
        got = cuda_tree.tree_flat(leaves.to(cuda))
        assert torch.equal(got.cpu(), hashops.tree_flat(leaves)), (n, rep)
    assert cuda_tree.launches.count == before + 20
    assert torch.equal(cuda_tree.tree_root(leaves.to(cuda)).cpu(),
                       hashops.tree_root(leaves))


@pytest.mark.cuda
def test_tree_kernel_rejects_bad_shapes(cuda):
    for shape in [(3, 8), (1, 8), (4, 7)]:
        with pytest.raises(ValueError):
            cuda_tree.tree_flat(torch.zeros(shape, dtype=torch.int32,
                                            device=cuda))
    with pytest.raises(TypeError):
        cuda_tree.tree_flat(torch.zeros((4, 8), dtype=torch.int64, device=cuda))
